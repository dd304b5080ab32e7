"""The alternating-minimization loop on one device.

Counterpart of insider_tpu/train/als.py (`optimize()`, src/optimize.cpp:
256-422), for the model X ~= (sum_v E_v V_v + C W) F: per iteration, block
Gauss-Seidel ridge updates of every confounder's level factor V_v, then of
each continuous covariate's coefficient row of W, then the elastic-net
column update of F; every `check_every` iterations a boundary evaluates the
loss and applies the reference's convergence protocol (relative-loss stop,
sub_tol decay ladder), and with a checkpoint path saves the state there.

An iteration is a sequence of kernel launches on the problem's device; on
the card the fit runs the first eagerly and the rest as replays of one
CUDA graph of it (train/graph.py, graph_route).  Masked problems
(partition=1, tuning): the level grams (kernels/row.level_gram) of every
fast confounder in one launch, one
row_xty per fast confounder with a batched K x K Cholesky solve, one
covariate CD kernel launch per continuous covariate (kernels/ctns.ctns_cd,
ops/continuous), and the masked column update (ops/col_update: the fused
FSS or CD kernel, or col_gram_xty + the streamed FSS or CD kernel for
K > 32); a boundary runs the fused eval kernel (kernels/eval.masked_eval).
Dense problems (partition=0): plain row updates with the shared gram
F F^T, the covariates' closed-form K x K solves, and the shared-gram FSS
or CD kernel; a boundary sums the whole residual.  A confounder without
per-problem constants (past the fast route's memory budgets, or every
one when the problem is built with precompute=False) takes the
segment-sum update on the add-back residual (ops/row_update), and a
covariate without them the update on that residual (ops/continuous).
The masks are stored as f32 or uint8 (build_problem's mask_dtype); the
kernels read either as it is stored.
Cold CD (col_solver="cd", cd_warm_start=False) sweeps each column update in
one coordinate order from draw_perm.  A dispatch runs
boundaries_per_dispatch boundaries back to back (one where the JAX
package takes its single-boundary path), each decided on the device with
the host's f64 formulas (_run_boundary_chain); the host reads their sums
once a dispatch and decides each again: the same fit, bit for bit, at
every boundaries_per_dispatch.  Under
FitConfig.debug_checks every block update is checked for finiteness on
the host (NonFiniteError names the block).  On CPU tensors every kernel
wrapper runs its plain version.

A sharded problem (build_problem(sharding=...), build_problem_distributed)
is fitted by every rank of a torch.distributed group, each on its row x
column block (sharding/mesh.py), with the same kernels and every setting
of the one-process fit: the level grams summed over the column blocks,
each row Xty over every rank (D on row block 0), a segment-sum
confounder's (L, K, K) and (L, K) level systems over every rank, each
covariate's K-space system over its blocks (ops/continuous), the column
update's grams over the row blocks (ops/col_update), the boundary sums
over every rank in f64 (sharding/comm.py holds every collective); the
rest runs on every rank alike.  Checkpoints hold the whole F, written by
rank 0; debug_checks raise on every rank alike.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from insider_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from insider_tpu_torch.config import (FitConfig, ShardingConfig,
                                      decay_from_delta_loss)
from insider_tpu_torch.kernels.eval import masked_eval
from insider_tpu_torch.kernels.row import level_gram, level_order, row_xty
from insider_tpu_torch.model.state import InsiderState, init_state
from insider_tpu_torch.ops import col_update, continuous, losses, row_update
from insider_tpu_torch.ops.row_update import (_ridge_solve_batched,
                                              one_hot_levels)
from insider_tpu_torch.sharding import comm
from insider_tpu_torch.sharding.distributed import (
    make_global_array, make_global_array_from_callback)
from insider_tpu_torch.sharding.mesh import (MAT, Mesh, make_mesh,
                                             shard_problem_arrays)
from insider_tpu_torch.train import graph

logger = logging.getLogger("insider_tpu_torch")


def disable_tf32() -> None:
    """Keep TF32 out of every f32 contraction.  The JAX package runs every
    real x real contraction at f32 HIGHEST; TF32 keeps ~3 decimal digits,
    and a gram must never see it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass
class Problem:
    """One fit problem, staged on `device`.

    Per confounder v: codes[v] (N,) int32 level codes.  The row constants
    (insider_tpu/train/als.py:343-402) exist for a confounder on the fast
    route only, whose one-hot E_v and (L_v, M) level sums fit the budgets
    _FAST_E_BYTES and _FAST_LM_BYTES; the others (and every confounder of
    a problem built with precompute=False) have None in d and row_order,
    and take the segment-sum update (ops/row_update).  Masked:
    d[v] = E_v^T (mask .* data) (L_v, M), and mw_cat stacks the fast
    confounders' E_v^T mask, in confounder order, into one (sum L, M)
    matrix, which the level-gram kernel reads in one launch
    (max_level_count, its largest count, sets the kernel's count planes),
    and row_order[v] holds confounder v's rows sorted by level
    (kernels/row.level_order), which the row_xty kernel reads in place of
    the codes; segment_max_count, the largest level of the confounders
    without constants, sets the count planes of their level grams
    (kernels/row.level_gram on their (L_v, M) mask counts).  Dense: d[v] =
    E_v^T data, and counts[v] (L_v,) the level sizes of every confounder.  With P continuous covariates, ctns (N, P)
    and, unless built with precompute=False, their constants: masked
    ctns_q = (c^2)^T mask
    and ctns_bc = c^T (mask .* data), dense ctns_dc = c^T data, each
    (P, M), and ctns_cc = c^T c (P,) (insider_tpu/train/als.py:386-402).
    """

    data: torch.Tensor          # (N, M) f32, NaNs zeroed
    train_mask: torch.Tensor    # (N, M) f32 or uint8 0/1
    test_mask: torch.Tensor     # (N, M) f32 or uint8 0/1
    codes: List[torch.Tensor]
    n_levels: Tuple[int, ...]
    masked: bool
    d: List[Optional[torch.Tensor]]
    mw_cat: Optional[torch.Tensor] = None       # masked, fast confounders
    max_level_count: Optional[float] = None     # masked only: mw_cat.max()
    row_order: Optional[List[Optional[Tuple[torch.Tensor, ...]]]] = None
    counts: Optional[List[Optional[torch.Tensor]]] = None  # dense only
    segment_max_count: Optional[float] = None   # masked, segment confounders
    ctns: Optional[torch.Tensor] = None         # (N, P) or None
    ctns_q: Optional[torch.Tensor] = None       # masked, (P, M)
    ctns_bc: Optional[torch.Tensor] = None      # masked, (P, M)
    ctns_dc: Optional[torch.Tensor] = None      # dense, (P, M)
    ctns_cc: Optional[torch.Tensor] = None      # dense, (P,)
    # Sharded (build_problem(sharding=...), build_problem_distributed):
    # this rank's place in the layout and the whole matrix's (N, M); the
    # tensors above are then this rank's blocks (see Mesh).
    mesh: Optional[Mesh] = None
    global_shape: Optional[Tuple[int, int]] = None
    # "bernoulli_block" where the masks came from callbacks (the per-block
    # splitter, data/native.split_mask_block), else None.
    split_variant: Optional[str] = None

    def fast(self) -> List[int]:
        """The confounders that take the fast route (their constants)."""
        return [v for v, d in enumerate(self.d) if d is not None]

    @property
    def shape(self):
        """The whole matrix's (N, M), sharded or not."""
        return self.global_shape or tuple(self.data.shape)

    @property
    def device(self):
        return self.data.device


def resolve_device(device) -> torch.device:
    """The device a problem lives on.  "cuda" (the default of the entry
    points) runs the CUDA kernels and needs a card; "cpu" runs their plain
    PyTorch versions.  Nothing falls back from one to the other."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} (the default) needs an NVIDIA GPU and "
            "torch.cuda.is_available() is False; pass device=\"cpu\" to run "
            "the plain PyTorch versions of the kernels on the CPU")
    return device


def check_dtype(dtype) -> None:
    """The reference's build_problem dtype: the port computes in f32 and
    takes it as numpy's, torch's or None; anything else raises."""
    if dtype is None or dtype is torch.float32:
        return
    try:
        if np.dtype(dtype) == np.float32:
            return
    except TypeError:
        pass
    raise NotImplementedError(
        f"dtype={dtype!r}: the port computes in float32 only (numpy's or "
        "torch's float32, or None)")


def mask_storage(mask_dtype) -> torch.dtype:
    """The dtype the indicator matrices are stored in, for the reference's
    mask_dtype (numpy's, torch's or the JAX package's dtype, or its name):
    float32 for None (the reference's default); uint8 for any 1-byte dtype
    (bool, int8, uint8: the memory-lean mode, a quarter of the bytes,
    insider_tpu/train/als.py:218); float32 for any wider one.  The masks
    hold 0 and 1, which every numeric dtype holds exactly, so the stored
    values, and the fit, are the same whatever the dtype; the kernels read
    float32 or uint8, and a plain torch op that needs float32 casts them
    itself."""
    if mask_dtype is None:
        return torch.float32
    if isinstance(mask_dtype, torch.dtype):
        size = mask_dtype.itemsize
    elif str(mask_dtype) == "bfloat16":   # numpy knows it only by ml_dtypes
        size = 2
    else:
        try:
            dt = np.dtype(mask_dtype)
        except TypeError:
            dt = None
        if dt is None or not (dt.kind in "biufc" or dt.name == "bfloat16"):
            raise TypeError(f"mask_dtype={mask_dtype!r} is not a numeric "
                            "dtype")
        size = dt.itemsize
    return torch.uint8 if size == 1 else torch.float32


# Memory budgets of the fast row route, the JAX package's
# (insider_tpu/train/als.py:326-327): a confounder whose one-hot E (N, L)
# or two (L, M) level-sum matrices would pass them takes the segment-sum
# update instead, with no per-problem constants.
_FAST_E_BYTES = 256 * 1024 * 1024
_FAST_LM_BYTES = 512 * 1024 * 1024

# The precompute runs over column chunks when its (N, M) f32 transients
# (the widened mask and mask .* data of a chunk) would pass this budget
# (insider_tpu/train/als.py:330-351).
_PRECOMPUTE_TRANSIENT_BYTES = 1 * 1024 * 1024 * 1024


def precompute_chunk(N: int, M: int) -> int:
    """Columns of one precompute chunk: all M within the budget, else
    max(1024, budget // (4 N) rounded down to a multiple of 256)."""
    if N * M * 4 <= _PRECOMPUTE_TRANSIENT_BYTES:
        return M
    return max(1024, _PRECOMPUTE_TRANSIENT_BYTES // (4 * N) // 256 * 256)


def fast_route(N: int, M: int, L: int) -> bool:
    """True when a confounder of L levels takes the fast row route."""
    return N * L * 4 <= _FAST_E_BYTES and 2 * L * M * 4 <= _FAST_LM_BYTES


def _densify(confounder) -> Tuple[List[np.ndarray], List[int]]:
    """Each confounder column's labels as int32 codes 0..L-1 in sorted
    order, and the L of each (the reference's unique() indexing,
    src/optimize.cpp:296-313)."""
    confounder = np.asarray(confounder)
    codes_np, n_levels = [], []
    for c in range(confounder.shape[1]):
        levels, inv = np.unique(confounder[:, c], return_inverse=True)
        codes_np.append(inv.reshape(-1).astype(np.int32))
        n_levels.append(int(levels.size))
    return codes_np, n_levels


def build_problem(data: np.ndarray, confounder: np.ndarray,
                  train_indicator: np.ndarray, test_indicator: np.ndarray,
                  ctns_confounder: Optional[np.ndarray] = None,
                  masked: bool = True, dtype=torch.float32, sharding=None,
                  mask_dtype=None, precompute: bool = True, *,
                  device="cuda") -> Problem:
    """Stage host arrays on `device` and precompute the row constants.

    confounder: (N, C) integer level codes per discrete confounder (any
    labels; densified per column as the reference's `unique()` indexing,
    src/optimize.cpp:296-313).  ctns_confounder: (N, P) continuous
    covariates (a 1-D array is one column), or None.  masked=False
    builds the dense (partition=0) problem, whose updates read every
    element.  mask_dtype: the masks' storage, float32 for None or a
    wider dtype, uint8 for a 1-byte one (mask_storage).  precompute=False builds no row constants: every
    confounder and covariate then takes the segment-sum update
    (insider_tpu/train/als.py:191), the memory-lean mode for shapes near
    the card's memory.  With precompute, each confounder within the fast
    route's budgets (fast_route) gets its constants, and they are built
    over column chunks (precompute_chunk), so no (N, M) f32 transient
    larger than a chunk exists.  The positional parameters are the JAX
    package's, in its order: dtype takes f32 only (check_dtype).
    sharding: a ShardingConfig; every rank of the process group calls
    build_problem with the same host arrays, and keeps its own block
    (sharding/mesh.py) on its device; the level sums and sizes and the
    covariate constants are then summed over the row blocks (the problem's
    collectives), and every route is chosen from the whole matrix's shape,
    so every rank takes the same one.  device (keyword-only): "cuda"
    (default; raises without a card) or "cpu"; under a sharding each
    rank's card (sharding/mesh.make_mesh).
    """
    check_dtype(dtype)
    mdt = mask_storage(mask_dtype)
    codes_np, n_levels = _densify(confounder)
    global_shape = tuple(np.shape(data))
    disable_tf32()
    device = resolve_device(device)
    mesh = (None if sharding is None
            else make_mesh(sharding, device, global_shape))
    arrays = shard_problem_arrays(mesh, data, train_indicator,
                                  test_indicator, codes_np, ctns_confounder,
                                  mdt, device=device)
    return _finish_problem(arrays, n_levels, masked, mesh, global_shape,
                           precompute)


def _finish_problem(arrays, n_levels, masked: bool, mesh: Optional[Mesh],
                    global_shape, precompute: bool) -> Problem:
    data_t, train_t, test_t, codes, ctns = arrays
    problem = Problem(data=data_t, train_mask=train_t, test_mask=test_t,
                      codes=codes, n_levels=tuple(n_levels), masked=masked,
                      d=[None] * len(codes), ctns=ctns, mesh=mesh,
                      global_shape=(None if mesh is None
                                    else tuple(global_shape)))
    if precompute:
        _precompute_row_constants(problem)
    # the level sizes of the confounders without constants, so no iteration
    # counts them (a bincount reads its largest code on the host): dense,
    # each level's (the fast ones' came from the precompute); masked, the
    # largest.  Under a sharding each rank counts its rows, summed over
    # the row blocks.
    segment = [v for v, dv in enumerate(problem.d) if dv is None]
    sizes = comm.psum_many(
        [torch.bincount(codes[v].long(), minlength=problem.n_levels[v])
         .to(torch.float32) for v in segment], mesh, "rows")
    if masked:
        problem.segment_max_count = max((float(s.max()) for s in sizes),
                                        default=None)
    else:
        problem.counts = problem.counts or [None] * len(codes)
        for v, cv in zip(segment, sizes):
            problem.counts[v] = cv
    return problem


def build_problem_distributed(data, train_indicator, test_indicator, codes,
                              n_levels: Tuple[int, ...],
                              global_shape: Tuple[int, int],
                              sharding: ShardingConfig,
                              ctns_confounder=None, n_ctns: int = 0,
                              masked: bool = True, dtype=torch.float32,
                              mask_dtype=None, precompute: bool = True, *,
                              device="cuda") -> Problem:
    """Build a sharded Problem with no process ever holding the whole
    matrix (insider_tpu/train/als.py:253-321).

    Each of data, train_indicator and test_indicator is either this rank's
    block, covering exactly sharding/distributed.process_block(mesh, MAT,
    global_shape) (host_row_block x host_col_block), or a callable
    cb(index) -> numpy block, called once with the tuple of slices of this
    rank's block (data/native.file_ingest_callbacks reads them from a raw
    file).  codes: one per confounder, this rank's rows of the level codes
    or a callable cb((row_slice,)); they must be dense in [0, n_levels[v])
    over the whole matrix already (a rank's own np.unique would number the
    levels otherwise than the others'), so n_levels is given.  The level
    counts and sums and the largest count are then made global by the
    problem's collectives, and every route is chosen from global_shape, so
    every rank takes the same one.  split_variant is "bernoulli_block"
    when the masks come from callbacks.  ctns_confounder: the continuous
    covariates, this rank's rows (N_block, n_ctns) (a 1-D block is one
    column) or a callable cb((row_slice, slice(None))), and n_ctns their
    number P, which a callable needs (insider_tpu/train/als.py:261-262,
    312).  precompute, masked and device as build_problem.
    """
    check_dtype(dtype)
    mdt = mask_storage(mask_dtype)
    N, M = global_shape
    if ctns_confounder is not None and not callable(ctns_confounder):
        ctns_confounder = np.asarray(ctns_confounder)
        if ctns_confounder.ndim == 1:
            ctns_confounder = ctns_confounder[:, None]
        n_ctns = n_ctns or ctns_confounder.shape[1]
    if ctns_confounder is not None and n_ctns < 1:
        raise ValueError("build_problem_distributed: a ctns_confounder "
                         "callback needs n_ctns, the number of covariates")
    disable_tf32()
    device = resolve_device(device)
    mesh = make_mesh(sharding, device, (N, M))

    def local(x, spec, shape, np_dtype):
        if callable(x):
            return make_global_array_from_callback(shape, mesh, spec, x,
                                                   np_dtype=np_dtype)
        return make_global_array(np.asarray(x, np_dtype), mesh, spec,
                                 global_shape=shape)

    np_mask = np.uint8 if mdt is torch.uint8 else np.float32
    arrays = (local(data, MAT, (N, M), np.float32),
              local(train_indicator, MAT, (N, M), np_mask),
              local(test_indicator, MAT, (N, M), np_mask),
              [local(c, ("rows",), (N,), np.int32) for c in codes],
              None if ctns_confounder is None else local(
                  ctns_confounder, ("rows", None), (N, n_ctns), np.float32))
    problem = _finish_problem(arrays, n_levels, masked, mesh, (N, M),
                              precompute)
    problem.split_variant = ("bernoulli_block" if callable(train_indicator)
                             else None)
    return problem


def _precompute_row_constants(problem: Problem) -> None:
    """Fill in the row constants of `problem` (see Problem), column chunk
    by column chunk (insider_tpu/train/als.py:343-402): each chunk's mask
    is widened to f32 and multiplied into the data once, and every
    constant's columns of that chunk are contracted from them.  The routes
    and the chunk are chosen from the whole matrix's shape; under a
    sharding the level sums, the counts and the covariate constants of
    the rank's rows are then summed over the row blocks, and the largest
    count taken over every rank."""
    data, mask, C = problem.data, problem.train_mask, problem.ctns
    N, M = problem.shape
    mesh = problem.mesh
    fast = [v for v, L in enumerate(problem.n_levels) if fast_route(N, M, L)]
    sizes = [problem.n_levels[v] for v in fast]
    dev = data.device
    E_cat = (torch.cat([one_hot_levels(problem.codes[v], L).T
                        for v, L in zip(fast, sizes)]).contiguous()
             if fast else None)                   # (sum L, N)
    Lsum = sum(sizes)
    width = data.shape[1]                         # this rank's columns

    def zeros(rows):
        return torch.zeros((rows, width), dtype=torch.float32, device=dev)

    d_cat = zeros(Lsum)
    mw_cat = zeros(Lsum) if problem.masked else None
    P = 0 if C is None else C.shape[1]
    q, bc, dc = (zeros(P), zeros(P), None) if problem.masked else (
        None, None, zeros(P))
    chunk = precompute_chunk(N, M)
    for c0 in range(0, width, chunk):
        c1 = min(c0 + chunk, width)
        x, m = data[:, c0:c1], None
        if problem.masked:
            m = mask[:, c0:c1].to(torch.float32).contiguous()
            x = m * x                                  # wx, this chunk only
        if fast:
            d_cat[:, c0:c1] = torch.matmul(E_cat, x)
            if problem.masked:
                mw_cat[:, c0:c1] = torch.matmul(E_cat, m)
        if P and problem.masked:
            q[:, c0:c1] = torch.matmul((C * C).T, m)
            bc[:, c0:c1] = torch.matmul(C.T, x)
        elif P:
            dc[:, c0:c1] = torch.matmul(C.T, x)
        del x, m                 # before the next chunk's are allocated
    d_cat = comm.psum(d_cat, mesh, "rows")
    d = list(torch.split(d_cat, sizes, dim=0)) if fast else []
    for v, dv in zip(fast, d):
        problem.d[v] = dv
    if problem.masked:
        problem.row_order = [None] * len(problem.codes)
        for v in fast:
            problem.row_order[v] = level_order(problem.codes[v],
                                               problem.n_levels[v])
        if fast:
            problem.mw_cat = comm.psum(mw_cat, mesh, "rows")
            problem.max_level_count = float(comm.pmax(
                problem.mw_cat.max(), mesh, "world"))
        if P:
            problem.ctns_q, problem.ctns_bc = comm.psum_many([q, bc], mesh,
                                                             "rows")
    else:
        counts = (list(torch.split(comm.psum(E_cat.sum(dim=1), mesh, "rows"),
                                   sizes)) if fast else [])
        problem.counts = [None] * len(problem.codes)
        for v, cv in zip(fast, counts):
            problem.counts[v] = cv
        if P:
            problem.ctns_dc, problem.ctns_cc = comm.psum_many(
                [dc, torch.sum(C * C, dim=0)], mesh, "rows")


class NonFiniteError(RuntimeError):
    """A block update produced a NaN or an infinity (FitConfig.debug_checks).
    The message names the block, as the JAX package's checkify error
    does."""


def _check_finite(config: FitConfig, tag: str, x: torch.Tensor,
                  mesh: Optional[Mesh] = None) -> None:
    """Under config.debug_checks, raise NonFiniteError unless every value of
    x is finite (one host sync); otherwise nothing.  Under a mesh x is this
    rank's block or replica, and the flag is counted over every rank
    (comm.count), so every rank raises the same error or none does
    (insider_tpu/train/als.py:465-475 checks the whole array)."""
    if config.debug_checks and comm.count(
            not bool(torch.isfinite(x).all()), mesh, x.device):
        raise NonFiniteError(f"non-finite values produced by {tag}")


def _row_factor(problem: Problem, state: InsiderState) -> torch.Tensor:
    """R = sum_v V_v[codes_v] + C W  (src/optimize.cpp:365-373)."""
    R = state.cfd_factors[0][problem.codes[0]]
    for v in range(1, len(problem.codes)):
        R = R + state.cfd_factors[v][problem.codes[v]]
    if problem.ctns is not None:
        R = R + torch.matmul(problem.ctns, state.ctns_factor)
    return R


def _update_covariates(problem: Problem, config: FitConfig, W: torch.Tensor,
                       R: torch.Tensor, F: torch.Tensor,
                       gram: Optional[torch.Tensor]) -> torch.Tensor:
    """Each continuous covariate's coefficient row of W (P, K) in turn,
    Gauss-Seidel against the row factor R = sum_v V_v[codes_v] + C W that
    holds the new confounder factors (src/optimize.cpp:341-350,
    insider_tpu/train/als.py:593-628): masked, one ctns_cd launch each, on
    the per-problem constants or, in a problem built without them, on the
    add-back residual; dense (gram = F F^T), the closed form, likewise.
    Under a mesh each system is summed over the blocks (ops/continuous),
    so W stays the same on every rank.  Returns the new W."""
    mesh = problem.mesh
    rows = list(W.unbind(0))
    for j in range(len(rows)):
        c = problem.ctns[:, j]
        R_minus = R - torch.outer(c, rows[j])
        if problem.masked and problem.ctns_q is not None:
            w = continuous.update_ctns_row_masked_fast(
                problem.ctns_q[j], problem.ctns_bc[j], problem.train_mask,
                R_minus, F, c, rows[j], config.lambda1, tol=config.ctns_tol,
                max_sweeps=config.max_ctns_sweeps, mesh=mesh)
        elif problem.masked:
            w = continuous.update_ctns_row_masked(
                problem.data - losses.predict(R_minus, F),
                problem.train_mask, F, c, rows[j], config.lambda1,
                tol=config.ctns_tol, max_sweeps=config.max_ctns_sweeps,
                mesh=mesh)
        elif problem.ctns_dc is not None:
            w = continuous.update_ctns_row_dense_fast(
                problem.ctns_dc[j], problem.ctns_cc[j], R_minus, F, gram, c,
                config.lambda1, mesh=mesh)
        else:
            w = continuous.update_ctns_row_dense(
                problem.data - losses.predict(R_minus, F), F, gram, c,
                config.lambda1, mesh=mesh)
        _check_finite(config,
                      f"continuous update W[{j}] (optimize_continuous_v2)", w,
                      mesh)
        rows[j] = w
        R = R_minus + torch.outer(c, w)
    return torch.stack(rows)


def _row_block_d(D: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """A confounder's level sums D as this rank's share of the row Xty:
    D on row block 0, zeros on the others, so the sum over every rank
    carries D once, exactly, for any number of row blocks
    (insider_tpu/train/als.py:405-439)."""
    return D if mesh is None or mesh.r == 0 else torch.zeros_like(D)


def update_row_factor(xtx: torch.Tensor, codes: torch.Tensor,
                      R_minus: torch.Tensor, mask: torch.Tensor,
                      D: torch.Tensor, F: torch.Tensor,
                      lam: float, row_order=None,
                      mesh: Optional[Mesh] = None) -> torch.Tensor:
    """One confounder's masked per-level ridge update -> (L, K).

    Counterpart of insider_tpu/ops/row_update.update_row_factor_masked_fast
    with its level grams `xtx` (L, K, K) precomputed (kernels/row.level_gram
    runs once for every confounder): Xty from the row_xty kernel, then the
    batched SPD solve.  row_order: these codes' rows sorted by level
    (Problem.row_order), or None to derive them.  Under a mesh, row_xty
    runs on this rank's block and its partial Xty is summed over every
    rank; the solve then runs on every rank, on the same inputs.
    """
    xty = row_xty(codes, R_minus, mask, _row_block_d(D, mesh), F, row_order)
    return _ridge_solve_batched(xtx, comm.psum(xty, mesh, "world"), lam)


def draw_perm(generator: torch.Generator, K: int) -> torch.Tensor:
    """The coordinate order of one cold-CD column update: a (K,) int64
    permutation from a CPU generator, so a fit on the card and one on the
    CPU sweep in the same orders.  The JAX package draws it from its PRNG
    key (insider_tpu/ops/col_update.py:439-443), which torch cannot
    reproduce; tests replace this function to inject an order."""
    return torch.randperm(K, generator=generator)


def _col_kw(config: FitConfig, perm: Optional[torch.Tensor]) -> dict:
    """The column update's solver arguments.  "auto" and "fss": FSS and
    its polish.  "cd" with cd_warm_start: FSS and a polish of up to
    max_cd_sweeps sweeps (insider_tpu/ops/col_update.py:402-416).  Cold
    "cd": the coordinate order `perm` and at most max_cd_sweeps sweeps
    (perm is None only at alpha == 0, where the update solves ridge)."""
    if config.col_solver == "cd" and not config.cd_warm_start:
        return dict(perm=perm, max_cd_sweeps=config.max_cd_sweeps)
    if config.col_solver == "cd":
        return dict(max_fss_outer=config.max_fss_outer, fss_polish=True,
                    max_fss_polish_sweeps=config.max_cd_sweeps)
    return dict(max_fss_outer=config.max_fss_outer,
                fss_polish=config.fss_polish,
                max_fss_polish_sweeps=config.max_fss_polish_sweeps)


def _als_iteration(problem: Problem, config: FitConfig, state: InsiderState,
                   sub_tol_eff: float,
                   perm: Optional[torch.Tensor] = None) -> InsiderState:
    """One full ALS iteration (src/optimize.cpp:325-379).  perm: the
    cold-CD coordinate order of this iteration's column update."""
    if not problem.masked:
        return _als_iteration_dense(problem, config, state, sub_tol_eff,
                                    perm)
    F = state.column_factor
    mask = problem.train_mask
    R = _row_factor(problem, state)

    # every fast confounder's level grams use the same F: one launch for all
    level_xtx = [None] * len(problem.codes)
    fast = problem.fast()
    if fast:
        xtx_cat = comm.psum(
            level_gram(problem.mw_cat, F, problem.max_level_count),
            problem.mesh, "cols")
        for v, xtx in zip(fast, torch.split(
                xtx_cat, [problem.n_levels[v] for v in fast], dim=0)):
            level_xtx[v] = xtx

    cfd_new = list(state.cfd_factors)
    for v, codes in enumerate(problem.codes):
        R_minus = R - cfd_new[v][codes]
        if level_xtx[v] is not None:
            V = update_row_factor(level_xtx[v], codes, R_minus, mask,
                                  problem.d[v], F, config.lambda1,
                                  problem.row_order[v], problem.mesh)
        else:
            # the rank's (L, K, K) and (L, K) systems, summed over every
            # rank: the (L, M) level sums never leave the rank
            XtX, Xty = comm.psum_many(row_update.masked_level_system(
                problem.data - losses.predict(R_minus, F), mask, F, codes,
                problem.n_levels[v], problem.segment_max_count),
                problem.mesh, "world")
            V = _ridge_solve_batched(XtX, Xty, config.lambda1)
        _check_finite(config, f"row update V[{v}] (optimize_row)", V,
                      problem.mesh)
        cfd_new[v] = V
        R = R_minus + V[codes]

    W = state.ctns_factor
    if problem.ctns is not None:
        W = _update_covariates(problem, config, W, R, F, None)

    # rebuild the row factor exactly, then update the columns (:365-376)
    R = _row_factor(problem, InsiderState(cfd_new, W, F))
    F_new = col_update.update_columns_masked(
        problem.data, mask, R, F, config.lambda2, config.alpha, sub_tol_eff,
        mesh=problem.mesh, **_col_kw(config, perm))
    _check_finite(config, "column update F (optimize_col)", F_new,
                  problem.mesh)
    return InsiderState(cfd_new, W, F_new)


def _als_iteration_dense(problem: Problem, config: FitConfig,
                         state: InsiderState, sub_tol_eff: float,
                         perm: Optional[torch.Tensor] = None) -> InsiderState:
    """One dense (partition=0) ALS iteration: every level's gram is its
    size times F F^T (insider_tpu/train/als.py:576-587, 647-658).  Under a
    mesh F F^T is summed over the column blocks, each level's Xty over
    every rank (D on row block 0; a segment-sum confounder's from its
    rank's level sums), and R^T R and R^T data over the row blocks
    (ops/col_update); the level sizes are the whole matrix's
    (Problem.counts)."""
    F = state.column_factor
    mesh = problem.mesh
    gram = comm.psum(torch.matmul(F, F.T), mesh, "cols")
    R = _row_factor(problem, state)
    cfd_new = list(state.cfd_factors)
    for v, codes in enumerate(problem.codes):
        R_minus = R - cfd_new[v][codes]
        L = problem.n_levels[v]
        if problem.d[v] is not None:
            xty = row_update.dense_level_xty(
                one_hot_levels(codes, L), _row_block_d(problem.d[v], mesh),
                R_minus, F)
            V = _ridge_solve_batched(problem.counts[v][:, None, None] * gram,
                                     comm.psum(xty, mesh, "world"),
                                     config.lambda1)
        else:
            XtX, Xty = row_update.dense_level_system(
                problem.data - losses.predict(R_minus, F), F, gram, codes, L,
                problem.counts[v])
            V = _ridge_solve_batched(XtX, comm.psum(Xty, mesh, "world"),
                                     config.lambda1)
        _check_finite(config, f"row update V[{v}] (optimize_row)", V, mesh)
        cfd_new[v] = V
        R = R_minus + V[codes]

    W = state.ctns_factor
    if problem.ctns is not None:
        W = _update_covariates(problem, config, W, R, F, gram)

    R = _row_factor(problem, InsiderState(cfd_new, W, F))
    F_new = col_update.update_columns_dense(
        problem.data, R, F, config.lambda2, config.alpha, sub_tol_eff,
        mesh=mesh, **_col_kw(config, perm))
    _check_finite(config, "column update F (optimize_col)", F_new, mesh)
    return InsiderState(cfd_new, W, F_new)


def _evaluate(problem: Problem, state: InsiderState) -> torch.Tensor:
    """The boundary metrics as one (7,) f64 vector (losses.pack_metrics).
    Under a mesh each rank sums its block (the masked_eval kernel on it),
    and one f64 sum over every rank finishes the vector: the replicated
    V's squares come from rank 0 and F's sums from row block 0, so each
    factor counts once; every rank gets the same bits, and so decides the
    boundary alike."""
    R = _row_factor(problem, state)
    if problem.masked:
        ev = masked_eval(problem.data, problem.train_mask, problem.test_mask,
                         R, state.column_factor)
    else:
        ev = losses.evaluate_dense(
            problem.data - losses.predict(R, state.column_factor))
    reg = losses.regularization_sums(state.cfd_factors, state.ctns_factor,
                                     state.column_factor)
    vec = losses.pack_metrics(ev, reg)
    mesh = problem.mesh
    if mesh is None:
        return vec
    own = torch.tensor([True] * 4 + [mesh.rank == 0] + [mesh.r == 0] * 2,
                       device=vec.device)
    return comm.psum(torch.where(own, vec, 0.0), mesh, "world")


def _stage_state(problem: Problem, state: InsiderState) -> InsiderState:
    """The initial state on a sharded problem's rank: the whole state
    given or drawn alike on every rank, with F cut to the rank's columns
    (insider_tpu/train/als.py:849-875 _stage_state_global)."""
    mesh = problem.mesh
    if mesh is None:
        return state
    M = problem.shape[1]
    F = state.column_factor
    if F.shape[1] != M:
        raise ValueError(f"a sharded fit starts from the whole (K, {M}) F, "
                         f"got {tuple(F.shape)}")
    _, (c0, c1) = mesh.block(problem.shape)
    return InsiderState(list(state.cfd_factors), state.ctns_factor,
                        F[:, c0:c1].contiguous())


@contextlib.contextmanager
def _profiled(device, path):
    """The block under torch.profiler (the card's kernels too, where the
    problem lives there), its trace written to `path` as Chrome JSON."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(path)


def _draw_perms(perm_gen: Optional[torch.Generator], K: int,
                n: int) -> Optional[torch.Tensor]:
    """n cold-CD coordinate orders (n, K), one an iteration, drawn in
    order (draw_perm), or None when the fit is not cold CD."""
    if perm_gen is None:
        return None
    return torch.stack([draw_perm(perm_gen, K) for _ in range(n)])


def _run_steps(problem: Problem, config: FitConfig, state: InsiderState,
               n: int, sub_tol_eff, perms: Optional[torch.Tensor],
               done: torch.Tensor) -> InsiderState:
    """n ALS iterations, eagerly: every kernel launched from the host (the
    JAX package's _run_steps, insider_tpu/train/als.py:666, is one jitted
    fori_loop; train/graph.py captures one iteration instead).  perms: the
    cold-CD orders (n, K), row i for iteration i, or None; sub_tol_eff a
    float or a 0-d f32 tensor on the problem's device; done: a 0-d bool
    tensor, once set the state is kept (graph.freeze)."""
    for i in range(n):
        new = _als_iteration(problem, config, state, sub_tol_eff,
                             None if perms is None else perms[i])
        state = graph.freeze(done, state, new)
    return state


class _EagerSteps:
    """The iterations of a fit, launched eagerly (_run_steps): on the CPU,
    under a sharding or debug_checks.  done: the boundary chain's stop
    flag (a 0-d bool tensor)."""

    graphed = False
    capture_s = 0.0

    def __init__(self, problem: Problem, config: FitConfig,
                 state: InsiderState):
        self.problem, self.config, self.state = problem, config, state
        self.done = torch.zeros((), dtype=torch.bool, device=problem.device)
        self.pinned = []

    def steps(self, n: int, sub_tol_eff, perms=None) -> None:
        if perms is not None and self.problem.device.type == "cuda":
            # one copy a call from pinned memory, no wait for the device
            perms = perms.pin_memory().to(self.problem.device,
                                          non_blocking=True)
        self.state = _run_steps(self.problem, self.config, self.state, n,
                                sub_tol_eff, perms, self.done)


class _GraphSteps:
    """The iterations of a fit on the card: the first eagerly, the others
    as replays of one captured iteration (graph.IterationGraph, made at
    the first call)."""

    graphed = True

    def __init__(self, problem: Problem, config: FitConfig,
                 state: InsiderState):
        self.problem, self.config = problem, config
        self._state, self.graph = state, None
        self.capture_s = 0.0
        self.pinned = []
        self.done = torch.zeros((), dtype=torch.bool, device=problem.device)

    @property
    def state(self) -> InsiderState:
        return self._state if self.graph is None else self.graph.state

    def steps(self, n: int, sub_tol_eff, perms=None) -> None:
        dev = self.problem.device
        if perms is not None:
            # pinned, so each replay's order is copied without a wait;
            # kept until the dispatch's metrics are read
            # (_run_boundary_chain empties the list)
            perms = perms.pin_memory()
            self.pinned.append(perms)
        if self.graph is None:
            # the first iteration eagerly, then the capture of the next
            self.graph = graph.IterationGraph(
                self.problem, self.config, self._state, _als_iteration,
                float(sub_tol_eff),
                None if perms is None else perms[0].to(dev,
                                                       non_blocking=True),
                self.done)
            self.capture_s = self.graph.capture_s
            self._state = None
            n, perms = n - 1, None if perms is None else perms[1:]
        self.graph.tol.copy_(sub_tol_eff)
        self.graph.run(n, perms)


def graph_route(problem: Problem, config: FitConfig) -> bool:
    """Whether a fit of `problem` runs its iterations as replays of one
    CUDA graph (train/graph.py), decided from the problem and the config
    before the first iteration: on the card with no sharding (a collective
    of the CPU's gloo group cannot be captured; NCCL's wait for a machine
    with more than one card) and no debug_checks (a host check a block).
    Every route of the iteration is captured: masked and dense, fast and
    segment-sum rows, covariates, FSS, cold CD and ridge columns at every
    K the card takes."""
    return (problem.device.type == "cuda" and problem.mesh is None
            and not config.debug_checks)


# The sub_tol decay ladder's rungs (config.decay_from_delta_loss), largest
# first.
_RUNGS = (1e-1, 1e-2, 1e-3, 1e-4, 1e-5, 1e-6)


def _device_loss(vec: torch.Tensor, config: FitConfig) -> torch.Tensor:
    """losses.finalize_loss's loss from a pack_metrics vector, on its
    device in f64: the host's operations in the host's order, each a
    correctly rounded torch op (a division by 2 is exact either way), so
    it gives the host's bits."""
    c2 = config.lambda2 * (1.0 - config.alpha)
    c1 = config.lambda2 * config.alpha
    return (vec[0] / 2.0 + (vec[4] * config.lambda1) / 2.0
            + (vec[5] * c2) / 2.0 + vec[6] * c1)


def _device_decay(delta: torch.Tensor) -> torch.Tensor:
    """config.decay_from_delta_loss on the device, in f64.  delta / 1000 by
    a tensor: a CUDA division by a host scalar multiplies by its
    reciprocal, which would round otherwise than the host."""
    d = delta / torch.full((), 1000.0, dtype=torch.float64,
                           device=delta.device)
    out = torch.ones_like(d)
    for t in _RUNGS:                      # the smallest rung d reaches
        out = torch.where(d <= t, t, out)
    return out


class _StopFlags:
    """Each chained boundary's `done`, copied to pinned host memory as the
    boundary ends, so the host can stop enqueueing boundaries k + 2 on
    once boundary k has stopped, waiting only for boundary k while k + 1
    keeps the device busy."""

    def __init__(self, n: int, device: torch.device):
        self.cuda = device.type == "cuda"
        self.host = torch.zeros(n, dtype=torch.bool, pin_memory=self.cuda)
        self.events = []

    def record(self, k: int, done: torch.Tensor) -> None:
        self.host[k].copy_(done, non_blocking=True)
        if self.cuda:
            self.events.append(torch.cuda.Event())
            self.events[-1].record()

    def stopped(self, k: int) -> bool:
        if self.cuda:
            self.events[k].synchronize()
        return bool(self.host[k])


def _run_boundary_chain(problem: Problem, config: FitConfig, steps, n: int,
                        n_chunks: int, decay: float, pre_loss: float,
                        perm_gen: Optional[torch.Generator]):
    """One dispatch: up to n_chunks boundaries of n iterations each, back
    to back, with no host sync between them (insider_tpu/train/als.py:759
    _run_boundary_chain; n_chunks is 1 where the JAX package takes its
    single-boundary path).  Each boundary runs at the tolerance
    f32(sub_tol * decay), then its eval, and decides in f64 on the device,
    with the host's own formulas in the host's order: its loss
    (_device_loss), delta = pre - loss, the next decay (_device_decay),
    and whether it stops (delta / pre < global_tol, or the loss not
    finite).  Once a boundary stops, `done` is set and the later
    boundaries' iterations keep the state as it is; the host stops
    enqueueing two boundaries after (_StopFlags).  One copy to the host at
    the end: the (n_chunks, 9) f64 block of each boundary's 7 sums, its
    next decay and its stop.

    Returns (the block's rows of the boundaries up to the stop, the
    iterations run after it)."""
    dev = problem.device
    K = steps.state.latent_dim

    def f64(x):
        return torch.full((), x, dtype=torch.float64, device=dev)

    decay_t, pre_t = f64(decay), f64(pre_loss)
    done = steps.done
    done.zero_()
    block = torch.zeros((n_chunks, 9), dtype=torch.float64, device=dev)
    flags = _StopFlags(n_chunks, dev)
    gen_states, ran = [], 0
    for k in range(n_chunks):
        if k >= 2 and flags.stopped(k - 2):
            break
        gen_states.append(None if perm_gen is None else perm_gen.get_state())
        steps.steps(n, (decay_t * config.sub_tol).to(torch.float32),
                    _draw_perms(perm_gen, K, n))
        ran += 1
        vec = _evaluate(problem, steps.state)
        loss = _device_loss(vec, config)
        delta = pre_t - loss
        live = ~done
        stop = live & (~torch.isfinite(loss)
                       | (delta / pre_t < config.global_tol))
        block[k, :7] = vec
        block[k, 7] = _device_decay(delta)
        block[k, 8] = stop.double()
        decay_t = torch.where(live, block[k, 7], decay_t)
        pre_t = torch.where(live, loss, pre_t)
        done |= stop
        flags.record(k, done)
    rows = block.cpu().numpy()
    steps.pinned = []
    stops = np.flatnonzero(rows[:ran, 8])
    n_live = ran if stops.size == 0 else int(stops[0]) + 1
    if perm_gen is not None and n_live < ran:
        # the generator as after the live boundaries' draws, as an
        # unchained fit leaves it
        perm_gen.set_state(gen_states[n_live])
    return rows[:n_live], (ran - n_live) * n


def _found(path: str, mesh: Optional[Mesh], device) -> bool:
    """Whether the checkpoint at `path` exists, decided alike on every
    rank: a file that some ranks see and others do not raises ValueError
    on every rank."""
    n = comm.count(os.path.exists(path), mesh, device)
    world = 1 if mesh is None else mesh.cfg.n_devices
    if 0 < n < world:
        raise ValueError(f"checkpoint {path!r} exists on {n} of {world} "
                         "ranks: every rank must read one path on a file "
                         "system they share")
    return n > 0


def _save_boundary(problem: Problem, path: str, state: InsiderState,
                   it: int, loss: float, extra: dict,
                   generator: Optional[torch.Generator]) -> None:
    """Checkpoint a boundary (checkpoint.save_checkpoint).  Under a mesh
    every rank gathers F, rank 0 alone writes the whole state, and every
    rank then waits for its write (comm.count), so no rank can return and
    read the file of an earlier boundary while rank 0 still writes; a
    write that failed, by any exception, raises on every rank: rank 0's
    own exception there, an OSError naming the file on the others."""
    mesh = problem.mesh
    if mesh is None:
        save_checkpoint(path, state, it=it, loss=loss, extra=extra,
                        generator=generator)
        return
    F = comm.gather_cols(state.column_factor, mesh, problem.shape[1])
    error = None
    if mesh.rank == 0:
        try:
            save_checkpoint(path, InsiderState(state.cfd_factors,
                                               state.ctns_factor, F),
                            it=it, loss=loss, extra=extra,
                            generator=generator)
        except Exception as e:  # re-raised below, once every rank knows
            error = e
    if comm.count(error is not None, mesh, problem.device):
        raise error or OSError(f"rank 0 could not write the checkpoint "
                               f"{path!r}")


@dataclasses.dataclass
class OptimizeResult:
    row_matrices: List[np.ndarray]
    ctns_factor: Optional[np.ndarray]
    column_factor: np.ndarray
    train_rmse: float
    test_rmse: float
    loss: float
    n_iter: int
    history: List[dict]
    state: InsiderState
    # True when the run was aborted because the loss went NaN/Inf.
    diverged: bool = False
    # True iff the relative-loss stop fired (src/optimize.cpp:405).
    converged: bool = False
    # True when the iterations ran as replays of one CUDA graph
    # (graph_route), with capture_s the seconds its warm-up and capture
    # took; wasted_iters: iterations a chained dispatch ran after its stop
    # (their state discarded).
    graphed: bool = False
    capture_s: float = 0.0
    wasted_iters: int = 0


def optimize(problem: Problem, config: FitConfig,
             state: Optional[InsiderState] = None,
             log_jsonl: Optional[str] = None, verbose: bool = True,
             progress_callback: Optional[Callable[[dict], None]] = None,
             checkpoint_path: Optional[str] = None, resume: bool = False,
             profile_dir: Optional[str] = None, *,
             generator: Optional[torch.Generator] = None
             ) -> OptimizeResult:
    """Run ALS to convergence with the reference's protocol
    (src/optimize.cpp:256-422): initial loss before the loop (:320-323); a
    check when `iter % check_every == 0` at the end of that iteration
    (:381); stop when (pre - loss) / pre < global_tol (:405); sub_tol decay
    ladder from the loss delta (:389-403); abort when the loss is not finite.

    state: initial factors (e.g. model.state.state_from_numpy); when None
    they are drawn from `generator`, or from a generator on the problem's
    device seeded with config.seed (W too, when the problem has continuous
    covariates).  The problem decides masked or dense
    (build_problem(masked=...)), as in the JAX package.  Cold CD draws one
    coordinate order per iteration (draw_perm) from a CPU generator seeded
    with config.seed.  Every setting takes any rank, on the card too.

    checkpoint_path: save the state at every check boundary (checkpoint.py,
    the JAX package's format, with the decay ladder and the loss delta in
    `extra` and the cold-CD order stream beside the factors); with resume
    and no `state`, an existing checkpoint restarts the run at the
    iteration after its own, with its decay ladder, so the resumed run
    continues the uninterrupted one (insider_tpu/train/als.py:941-960).
    profile_dir: trace the second step chunk (the iterations up to the
    first boundary after the first one and that boundary's eval, as the
    JAX package traces its second chunk, insider_tpu/train/als.py:
    1094-1095; on the card the graph's replays) with torch.profiler and
    write it there as a Chrome trace, trace_iter_<first>_<last>.json; the
    fit computes the same bits with and without it.  Like debug_checks,
    it runs one boundary a dispatch.
    The positional parameters are the JAX package's, in its order;
    generator is keyword-only.

    A sharded problem (build_problem(sharding=...)) is fitted by every rank
    of its process group together: each rank draws (or is given) the same
    whole initial state and keeps the F columns of its block, runs the
    iterations on its block with the collectives of sharding/comm.py, and
    decides each boundary from the same all-reduced sums, so history,
    n_iter and the losses are equal on every rank; at the end F is
    gathered, so column_factor and state hold the whole (K, M) F on every
    rank.  Rank 0 alone logs and writes log_jsonl; each rank writes its
    own profile, trace_iter_<first>_<last>_rank<rank>.json.  Every rank
    passes the same checkpoint_path: at each boundary every rank gathers
    F and rank 0 alone writes the whole state, in the one-process format,
    and no rank goes on before the file is written (_save_boundary); to
    resume, every rank reads it and keeps its columns, so a checkpoint of
    either fit resumes the other.  On several hosts the path must lie on
    a file system they share (a checkpoint some ranks find and others do
    not raises ValueError on every rank).  debug_checks raise the same
    NonFiniteError on every rank (_check_finite).
    """
    mesh = problem.mesh
    disable_tf32()
    lead = mesh is None or mesh.rank == 0
    cold_cd = (config.col_solver == "cd" and not config.cd_warm_start
               and config.alpha != 0.0)
    perm_gen = torch.Generator().manual_seed(config.seed) if cold_cd else None
    start_iter, resume_decay = 0, 1.0
    if (resume and checkpoint_path and state is None
            and _found(checkpoint_path, mesh, problem.device)):
        state, meta = load_checkpoint(checkpoint_path, device=problem.device,
                                      generator=perm_gen)
        start_iter = meta["iter"] + 1
        resume_decay = float(meta.get("extra", {}).get("decay", 1.0))
        if verbose:
            logger.info("resumed from %s at iter %d (decay=%g)",
                        checkpoint_path, meta["iter"], resume_decay)
    if state is None:
        M = problem.shape[1]
        if generator is None:
            generator = torch.Generator(device=problem.device)
            generator.manual_seed(config.seed)
        n_ctns = 0 if problem.ctns is None else problem.ctns.shape[1]
        state = init_state(generator, problem.n_levels, M,
                           config.latent_dim, n_ctns=n_ctns,
                           init_std=config.init_std)
    state = _stage_state(problem, state)

    def finalize(vec):
        return losses.finalize_metrics_vec(vec, config.lambda1,
                                           config.lambda2, config.alpha,
                                           masked=problem.masked)

    history: List[dict] = []
    jl = open(log_jsonl, "a") if log_jsonl and lead else None

    def emit(rec):
        history.append(rec)
        if jl:
            jl.write(json.dumps(rec) + "\n")
            jl.flush()
        if verbose and lead:
            logger.info(
                "iter %d: loss=%.12g train_rmse=%.12g test_rmse=%.12g "
                "delta=%.6g decay=%g", rec["iter"], rec["loss"],
                rec["train_rmse"], rec["test_rmse"],
                rec.get("delta_loss", float("nan")), rec.get("decay", 1.0))
        if progress_callback:
            progress_callback(rec)

    graphed = graph_route(problem, config)
    steps = (_GraphSteps(problem, config, state) if graphed
             else _EagerSteps(problem, config, state))
    # boundaries a dispatch: full check_every-sized ones back to back; the
    # first 1-iteration chunk, a max_iter tail, debug_checks and the
    # profiled chunk take one (insider_tpu/train/als.py:1036-1049)
    chain_ok = (config.boundaries_per_dispatch > 1
                and not config.debug_checks and profile_dir is None)
    ce = config.check_every
    wasted = 0
    try:
        t0 = time.time()
        m = finalize(_evaluate(problem, state))
        loss = m["loss"]
        emit({"iter": -1, **m, "elapsed_s": time.time() - t0})
        diverged = not np.isfinite(loss)
        if diverged:
            logger.warning("infinite or missing values in loss at init; "
                           "aborting")

        decay = resume_decay
        it = start_iter
        converged = False
        while (not diverged) and it <= config.max_iter:
            # advance to the end of the next check boundary (iters it..b)
            boundary = it if it % ce == 0 else ((it // ce + 1) * ce)
            boundary = min(boundary, config.max_iter)
            n = boundary - it + 1
            n_full = (config.max_iter - (it - 1)) // ce if n == ce else 0
            n_chunks = (min(config.boundaries_per_dispatch, n_full)
                        if chain_ok and n_full >= 1 else 1)
            profile = contextlib.nullcontext()
            if profile_dir and len(history) == 2:
                name = f"trace_iter_{it}_{boundary}" + (
                    "" if mesh is None else f"_rank{mesh.rank}")
                profile = _profiled(problem.device,
                                    os.path.join(profile_dir, name + ".json"))
            with profile:
                rows, waste = _run_boundary_chain(
                    problem, config, steps, n, n_chunks, decay, loss,
                    perm_gen)
            wasted += waste
            # every boundary decided again on the host, in f64
            for row in rows:
                boundary = it + n - 1
                it = boundary + 1
                pre_loss = loss
                m = finalize(row[:7])
                loss = m["loss"]
                delta_loss = pre_loss - loss
                decay = decay_from_delta_loss(delta_loss)
                emit({"iter": boundary, **m, "delta_loss": delta_loss,
                      "decay": decay, "elapsed_s": time.time() - t0})
                diverged = not np.isfinite(loss)
                converged = (not diverged
                             and delta_loss / pre_loss < config.global_tol)
                if (row[7] != decay
                        or bool(row[8]) != (diverged or converged)):
                    raise RuntimeError(
                        f"the device decided iteration {boundary} otherwise "
                        "than the host's float64 decision")
            if diverged:
                logger.warning("infinite or missing values in loss at iter "
                               "%d; aborting", boundary)
                break
            if checkpoint_path:
                _save_boundary(problem, checkpoint_path, steps.state,
                               boundary, loss, {"decay": decay,
                                                "delta_loss": delta_loss},
                               perm_gen)
            if converged or boundary >= config.max_iter:
                break
    finally:
        if jl:
            jl.close()
    state = steps.state

    if mesh is not None:
        state = InsiderState(state.cfd_factors, state.ctns_factor,
                             comm.gather_cols(state.column_factor, mesh,
                                              problem.shape[1]))
    return OptimizeResult(
        row_matrices=[f.cpu().numpy() for f in state.cfd_factors],
        ctns_factor=(None if state.ctns_factor is None
                     else state.ctns_factor.cpu().numpy()),
        column_factor=state.column_factor.cpu().numpy(),
        train_rmse=m["train_rmse"],
        test_rmse=m["test_rmse"],
        loss=loss,
        n_iter=it - 1,
        history=history,
        state=state,
        diverged=diverged,
        converged=converged,
        graphed=graphed,
        capture_s=steps.capture_s,
        wasted_iters=wasted,
    )
