"""The collectives of a sharded fit: the port's only calls into
torch.distributed once a problem is built.

Counterparts of the psums of the JAX package's shard_map call sites, one
for one:

  psum(x, mesh, "cols")   the level grams, each column block's partial
                          (insider_tpu/train/als.py:442-465
                          _shard_level_gram); the dense gram F F^T
  psum(x, mesh, "rows")   the column grams and Xty, each row block's
                          partial (insider_tpu/ops/col_update.py:247-269
                          _shard_gram_xty); the dense R^T R and R^T data;
                          the level sums at build time, which then hold
                          whole columns, as JAX's P(None, 'cols') does
  psum(x, mesh, "world")  the row Xty, each block's partial, D carried by
                          row block 0 (als.py:405-439 _shard_row_xty);
                          a segment-sum confounder's level systems; the
                          eval and loss sums
  pmax(x, mesh, "world")  the largest level count
  gather_cols(F, mesh, M) F's column blocks, at the end of a fit and at
                          each checkpoint (als.py:878-893 _to_host)

and for the covariates (insider_tpu/train/als.py:593-628, where GSPMD
inserts them) the level-size counts and covariate constants at build
time, over 'rows', and each covariate's K-space system, its sums over the
rows over 'rows' and its contractions over the columns over 'cols'.
psum_many reduces several tensors in one all-reduce, and count counts
the ranks where a flag holds (under debug_checks, a block update that is
not finite; a checkpoint rank 0 could not write; a checkpoint found to
resume from), which also holds every rank until the last reaches it.

Each returns its input unchanged when mesh is None or the axis's group has
one rank, and otherwise reduces in place, in its input's dtype (f32 for
grams and Xty, f64 for the eval and loss sums), on the current stream of
its input's device: torch.distributed orders a collective after the work
queued there, and the work queued after it waits for it.  Every rank
gets the same bits of a sum.

Gloo, which two ranks sharing one card use, takes CUDA tensors for
all_reduce but not for every collective, so gather_cols is built from
all_reduce: each rank writes its block into zeros and the blocks are
summed, which is exact (x + 0 = x).  No collective moves kernel work off
the card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from insider_tpu_torch.sharding.distributed import block_bounds


def _group(mesh, axis: str):
    """The process group of `axis`, or None where nothing is to be
    reduced."""
    if mesh is None:
        return None
    return mesh.groups[axis]


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of x over the ranks of `axis` ("rows", "cols" or "world")."""
    group = _group(mesh, axis)
    if group is None:
        return x
    x = x.contiguous()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def psum_many(xs, mesh, axis: str):
    """psum of each tensor of xs (all of one dtype and device), in one
    all-reduce of their concatenation; the list itself where there is
    nothing to reduce."""
    group = _group(mesh, axis)
    if group is None or not xs:
        return list(xs)
    flat = torch.cat([x.reshape(-1) for x in xs])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    out = torch.split(flat, [x.numel() for x in xs])
    return [o.view(x.shape) for o, x in zip(out, xs)]


def pmax(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The largest x over the ranks of `axis`, element by element."""
    group = _group(mesh, axis)
    if group is None:
        return x
    x = x.contiguous()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def gather_cols(F: torch.Tensor, mesh, n_cols: int) -> torch.Tensor:
    """The (K, n_cols) matrix whose column blocks are the ranks' (K, block)
    F, on every rank (the column blocks of the ranks of one row block)."""
    group = _group(mesh, "cols")
    if group is None:
        return F
    c0, c1 = block_bounds(n_cols, mesh.cfg.cols, mesh.c)
    full = torch.zeros((F.shape[0], n_cols), dtype=F.dtype, device=F.device)
    full[:, c0:c1] = F
    dist.all_reduce(full, op=dist.ReduceOp.SUM, group=group)
    return full



def count(flag: bool, mesh, device) -> int:
    """The number of ranks of the mesh on which `flag` is true, the same
    on every rank (int(flag) without a mesh): a one-element all-reduce on
    `device`, read on the host, so it returns only once every rank has
    reached it.  Every decision a rank could take alone (a raise, a
    checkpoint found) is taken from it, so no rank leaves a path that
    another stays in."""
    group = _group(mesh, "world")
    if group is None:
        return int(bool(flag))
    x = torch.full((1,), float(bool(flag)), device=device)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return int(x.item())
