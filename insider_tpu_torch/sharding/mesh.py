"""The rows x cols layout of a sharded fit on a torch.distributed group.

Counterpart of insider_tpu/sharding/mesh.py.  Rank r * cols + c of a
group of rows * cols ranks holds row block r and column block c of the
data and the masks (sharding/distributed.block_bounds), the codes (and
the row factor R) of its rows, and the F columns of its block; the
confounder factors V_v are replicated on every rank.  The column update
is local to a column block; the row side's level sums cross the column
blocks, and with rows > 1 the column grams cross the row blocks
(sharding/comm.py holds every collective).

A block may not be empty: make_mesh, given the matrix's shape, raises
ValueError when some rank's row or column block would hold nothing (M <
cols, or a ceil-sized split that leaves the last ranks no rows or
columns), on every rank alike and before any collective, so no kernel
ever sees a zero-width block.

The JAX package's apply_constraints (mesh.py:70) has no counterpart:
there is no GSPMD to keep layouts for, and each rank's tensors are its
blocks by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from insider_tpu_torch.config import ShardingConfig
from insider_tpu_torch.sharding.distributed import (block_bounds, group_rank,
                                                    group_size, local_rank,
                                                    process_block)

# The layout of an (N, M) matrix: rows over 'rows', columns over 'cols'.
MAT = ("rows", "cols")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a rows x cols layout: its rank, its row block
    r and column block c (rank = r * cols + c), its device, and the process
    groups of its collectives: 'world' (every rank), 'rows' (the ranks of
    column block c, which share their columns) and 'cols' (the ranks of row
    block r, which share their rows); a group of one rank is None."""

    cfg: ShardingConfig
    rank: int
    device: torch.device
    groups: Dict[str, Optional[object]]

    @property
    def r(self) -> int:
        return self.rank // self.cfg.cols

    @property
    def c(self) -> int:
        return self.rank % self.cfg.cols

    @property
    def shape(self) -> Dict[str, int]:
        return {"rows": self.cfg.rows, "cols": self.cfg.cols}

    @property
    def coords(self) -> Dict[str, int]:
        return {"rows": self.r, "cols": self.c}

    def block(self, global_shape) -> Tuple[Tuple[int, int], Tuple[int, int]]:
        """[start, stop) of this rank's rows and columns of an (N, M)
        matrix."""
        return process_block(self, MAT, tuple(global_shape))


# (rows, cols) -> (the process group they were made in, the groups of
# each column block, the groups of each row block)
_GROUPS: dict = {}


def _groups(cfg: ShardingConfig, rank: int) -> Dict[str, Optional[object]]:
    """This rank's process groups.  dist.new_group is called by every rank
    for every group, in one order (torch.distributed requires it), once a
    layout and process group: the groups are cached until the process
    group is replaced."""
    world = group_size()
    if world == 1:
        return dict(world=None, rows=None, cols=None)
    key = (cfg.rows, cfg.cols)
    if key not in _GROUPS or _GROUPS[key][0] is not dist.group.WORLD:
        def group(ranks: List[int]):
            if len(ranks) == 1:
                return None
            if len(ranks) == world:
                return dist.group.WORLD
            return dist.new_group(ranks)

        R, C = cfg.rows, cfg.cols
        _GROUPS[key] = (
            dist.group.WORLD,
            [group([r * C + c for r in range(R)]) for c in range(C)],
            [group([r * C + c for c in range(C)]) for r in range(R)])
    _, by_col, by_row = _GROUPS[key]
    r, c = divmod(rank, cfg.cols)
    return dict(world=dist.group.WORLD, rows=by_col[c], cols=by_row[r])


def _rank_device(cfg: ShardingConfig, rank: int, device) -> torch.device:
    if cfg.devices is not None:
        if len(cfg.devices) != cfg.n_devices:
            raise ValueError(f"ShardingConfig.devices names "
                             f"{len(cfg.devices)} devices for "
                             f"{cfg.n_devices} ranks")
        return torch.device(cfg.devices[rank])
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    lr = local_rank()
    return torch.device("cuda", torch.cuda.current_device() if lr is None
                        else lr)


def make_mesh(cfg: ShardingConfig, device="cuda",
              global_shape=None) -> Mesh:
    """This rank's Mesh for `cfg`.  The process group must have
    cfg.n_devices ranks (a 1 x 1 layout also runs with no group).  The
    rank's device: cfg.devices[rank] when given, else `device` ("cpu",
    or "cuda", which becomes cuda:LOCAL_RANK, or the current card without
    LOCAL_RANK).  global_shape (N, M): also check that no rank's block is
    empty (ValueError)."""
    if not isinstance(cfg, ShardingConfig):
        raise TypeError(f"sharding must be a ShardingConfig, got {cfg!r}")
    if cfg.rows < 1 or cfg.cols < 1:
        raise ValueError(f"mesh {cfg.rows}x{cfg.cols}: both must be >= 1")
    if global_shape is not None:
        for n, parts, axis in zip(global_shape, (cfg.rows, cfg.cols),
                                  ("row", "column")):
            empty = [i for i in range(parts)
                     if len(range(*block_bounds(n, parts, i))) == 0]
            if empty:
                raise ValueError(
                    f"mesh {cfg.rows}x{cfg.cols} on a {global_shape[0]} x "
                    f"{global_shape[1]} matrix leaves {axis} blocks {empty} "
                    f"empty: use fewer ranks on that axis")
    world = group_size()
    if world != cfg.n_devices:
        raise ValueError(f"ShardingConfig wants {cfg.n_devices} ranks, the "
                         f"process group has {world} (initialize_"
                         "distributed)")
    rank = group_rank()
    return Mesh(cfg, rank, _rank_device(cfg, rank, device),
                _groups(cfg, rank))


def shard_problem_arrays(mesh: Optional[Mesh], data, train_mask, test_mask,
                         codes, ctns, mask_dtype=torch.float32, *,
                         device=None):
    """The problem's arrays on the device: with a mesh, this rank's blocks
    of the global host arrays (data and masks (N, M), codes (N,), ctns
    (N, P)); without one, the whole arrays on `device`.  Data and ctns
    become f32, the masks `mask_dtype` (f32 or uint8), the codes int32."""
    if mesh is not None:
        (r0, r1), (c0, c1) = mesh.block(np.shape(data))
        rows, block = slice(r0, r1), (slice(r0, r1), slice(c0, c1))
        device = mesh.device
    else:
        rows, block = slice(None), (slice(None), slice(None))

    def put(x, np_dtype):
        return torch.as_tensor(
            np.ascontiguousarray(np.asarray(x)[block], np_dtype),
            device=device)

    np_mask = np.uint8 if mask_dtype is torch.uint8 else np.float32
    codes_t = [torch.as_tensor(np.asarray(c)[rows], device=device)
               for c in codes]
    ctns_t = None
    if ctns is not None:
        ctns = np.asarray(ctns)
        ctns_t = torch.as_tensor(np.ascontiguousarray(
            (ctns[:, None] if ctns.ndim == 1 else ctns)[rows], np.float32),
            device=device)
    return (put(data, np.float32), put(train_mask, np_mask),
            put(test_mask, np_mask), codes_t, ctns_t)
