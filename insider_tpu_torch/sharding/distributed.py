"""Multi-process bring-up and the block layout of a sharded fit.

Counterpart of insider_tpu/sharding/distributed.py.  The JAX package runs
one SPMD program over a device mesh, and jax.distributed joins the hosts;
the port runs one process per device, joined by a torch.distributed
process group, and each process holds one contiguous block of the matrix
(sharding/mesh.py).  Bring-up, before anything touches the card:

    from insider_tpu_torch.sharding import initialize_distributed, pod_sharding
    initialize_distributed()            # torchrun's environment, SLURM, or
                                        # explicit arguments; a no-op alone
    cfg = pod_sharding(rows=..., cols=...)
    problem = als.build_problem(..., sharding=cfg)

or, with no process ever holding the whole matrix,
als.build_problem_distributed fed by `host_row_block` / `host_col_block`
blocks or by callbacks (data/native.file_ingest_callbacks).

Block bounds are the JAX package's: an axis of n elements split over t
ranks gives block i the range [i b, min((i + 1) b, n)), b = ceil(n / t),
which is what its NamedSharding assigns on the axis padded to a multiple
of t (insider_tpu/sharding/distributed.py:126-157).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from insider_tpu_torch.config import ShardingConfig

# Every process group of the port waits at most this long in a
# collective, so a rank that died leaves the others an error, not a hang.
TIMEOUT_S = 120


def group_size() -> int:
    """The number of ranks of the process group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def group_rank() -> int:
    """This process's rank in the process group; 0 without one."""
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank() -> Optional[int]:
    """The index of this process among those of its host, from torchrun
    (LOCAL_RANK) or SLURM (SLURM_LOCALID); None when neither sets it."""
    for name in ("LOCAL_RANK", "SLURM_LOCALID"):
        if os.environ.get(name, "") != "":
            return int(os.environ[name])
    return None


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           backend: Optional[str] = None,
                           device="cuda") -> bool:
    """Join the torch.distributed process group if this is one process of
    several; otherwise do nothing.  Returns True iff the group has more
    than one rank after the call.

    Where the group comes from, in order:
      1. explicit arguments: coordinator_address ("host:port" or
         "tcp://host:port"), num_processes and process_id, all three;
      2. torchrun's environment: RANK, WORLD_SIZE, MASTER_ADDR,
         MASTER_PORT;
      3. a SLURM allocation of more than one task: SLURM_PROCID and
         SLURM_NTASKS, with the address in MASTER_ADDR and MASTER_PORT.
    With none of them (one process), nothing happens and False returns;
    a group that already exists is kept.  Explicit arguments with
    num_processes=1 make a group of one rank.

    device: "cuda" (the default) selects the card LOCAL_RANK (or
    SLURM_LOCALID) names, before the group exists; "cpu" for a group of
    CPU processes.  backend: NCCL for CUDA, gloo for the CPU, by default.
    An explicit backend exists only so that two ranks can share one card
    over gloo (NCCL refuses two ranks on one device); a fit on several
    cards takes the default.  Every collective waits at most
    TIMEOUT_S.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    explicit = (coordinator_address, num_processes, process_id)
    if any(x is not None for x in explicit):
        if any(x is None for x in explicit):
            raise ValueError("initialize_distributed: give coordinator_"
                             "address, num_processes and process_id "
                             "together")
        address = coordinator_address
        if not address.startswith("tcp://"):
            address = "tcp://" + address
        world, rank = int(num_processes), int(process_id)
    elif "RANK" in env and "WORLD_SIZE" in env:
        address, world, rank = "env://", int(env["WORLD_SIZE"]), int(
            env["RANK"])
    elif env.get("SLURM_NTASKS", "1") not in ("", "1"):
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError("initialize_distributed: under SLURM set "
                             "MASTER_ADDR and MASTER_PORT to the first "
                             "task's host and a free port")
        address = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        world, rank = int(env["SLURM_NTASKS"]), int(env["SLURM_PROCID"])
    else:
        return False
    device = torch.device(device)
    if device.type == "cuda" and local_rank() is not None:
        torch.cuda.set_device(local_rank())
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=address, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return world > 1


def pod_sharding(rows: int = 0, cols: int = 0) -> ShardingConfig:
    """A ShardingConfig over every rank of the process group (one device
    each).  With rows and cols both 0, every rank goes on the gene axis
    (cols), the direction whose column update needs no collective; a
    single 0 is inferred; rows * cols must equal the number of ranks."""
    n = group_size()
    if rows == 0 and cols == 0:
        rows, cols = 1, n
    elif rows == 0:
        if n % cols:
            raise ValueError(f"{n} ranks not divisible by cols={cols}")
        rows = n // cols
    elif cols == 0:
        if n % rows:
            raise ValueError(f"{n} ranks not divisible by rows={rows}")
        cols = n // rows
    if rows * cols != n:
        raise ValueError(f"mesh {rows}x{cols} != {n} ranks")
    return ShardingConfig(rows=rows, cols=cols)


def block_bounds(n: int, parts: int, index: int) -> Tuple[int, int]:
    """[start, stop) of block `index` of an axis of n elements split into
    `parts` ceil-sized blocks, the last ones clamped to n."""
    b = -(-n // parts)
    return min(index * b, n), min((index + 1) * b, n)


def _rank_coords(cfg: ShardingConfig):
    """(r, c) of this process's rank on cfg's mesh."""
    rank = group_rank()
    if not 0 <= rank < cfg.n_devices:
        raise ValueError(f"rank {rank} outside the {cfg.rows}x{cfg.cols} "
                         "mesh")
    return divmod(rank, cfg.cols)


def host_row_block(n_rows: int, cfg: ShardingConfig) -> Tuple[int, int]:
    """[start, stop) of the global row axis this process loads for an
    (N, M) matrix on cfg's mesh."""
    r, _ = _rank_coords(cfg)
    return block_bounds(n_rows, cfg.rows, r)


def host_col_block(n_cols: int, cfg: ShardingConfig) -> Tuple[int, int]:
    """[start, stop) of the global gene axis this process loads."""
    _, c = _rank_coords(cfg)
    return block_bounds(n_cols, cfg.cols, c)


def process_block(mesh, spec, global_shape) -> Tuple[Tuple[int, int], ...]:
    """[start, stop) per axis of the region this rank holds of an array of
    `global_shape` laid out by `spec`: one entry per axis, the mesh axis
    that splits it ("rows" or "cols") or None for a whole axis, as the
    JAX package's PartitionSpec (sharding/mesh.MAT is ("rows", "cols"))."""
    spec = tuple(spec) + (None,) * (len(global_shape) - len(spec))
    return tuple((0, n) if name is None else
                 block_bounds(n, mesh.shape[name], mesh.coords[name])
                 for name, n in zip(spec, global_shape))


def _to_device(block: np.ndarray, mesh) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(block), device=mesh.device)


def make_global_array(local_block, mesh, spec, global_shape=None):
    """This rank's block as a tensor on its device.  local_block covers
    exactly process_block(mesh, spec, global_shape) (ValueError
    otherwise); with global_shape None, the one-process convenience of
    the JAX package, local_block is the whole array and the rank's block
    is cut from it."""
    block = np.asarray(local_block)
    if global_shape is None:
        bounds = process_block(mesh, spec, block.shape)
        block = block[tuple(slice(a, b) for a, b in bounds)]
    else:
        bounds = process_block(mesh, spec, tuple(global_shape))
        want = tuple(b - a for a, b in bounds)
        if block.shape != want:
            raise ValueError(f"make_global_array: rank {mesh.rank}'s block "
                             f"is {block.shape}, its share of "
                             f"{tuple(global_shape)} is {want} (rows "
                             f"and cols {bounds})")
    return _to_device(block, mesh)


def make_global_array_from_callback(global_shape, mesh, spec, cb,
                                    np_dtype=None):
    """This rank's block as a tensor on its device, from cb(index): index
    is the tuple of slices of the block, and cb is called once, for this
    rank's block only, so no process holds more than its own block."""
    bounds = process_block(mesh, spec, tuple(global_shape))
    block = np.asarray(cb(tuple(slice(a, b) for a, b in bounds)))
    if np_dtype is not None:
        block = np.asarray(block, np_dtype)
    want = tuple(b - a for a, b in bounds)
    if block.shape != want:
        raise ValueError(f"make_global_array_from_callback: the callback "
                         f"gave {block.shape} for the block {bounds}")
    return _to_device(block, mesh)
