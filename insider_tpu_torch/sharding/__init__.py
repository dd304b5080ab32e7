"""Sharded fits on a torch.distributed process group: one process per
device, rows x cols blocks of the matrix (mesh.py), the bring-up and the
block layout (distributed.py), and the fit's collectives (comm.py)."""

from insider_tpu_torch.sharding.distributed import (
    host_col_block, host_row_block, initialize_distributed, make_global_array,
    make_global_array_from_callback, pod_sharding, process_block)
from insider_tpu_torch.sharding.mesh import Mesh, make_mesh

__all__ = [
    "initialize_distributed",
    "pod_sharding",
    "process_block",
    "host_row_block",
    "host_col_block",
    "make_global_array",
    "make_global_array_from_callback",
    "Mesh",
    "make_mesh",
]
