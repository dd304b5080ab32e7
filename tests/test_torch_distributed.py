"""The port's multi-process layout (insider_tpu_torch/sharding/distributed.py,
mesh.py) against the JAX package's (insider_tpu/sharding/).

One process here, with no process group: initialize_distributed must do
nothing, pod_sharding must lay out a given number of ranks as the JAX
package lays out its devices (tests/test_distributed.py), and each rank's
block must be the one the JAX package's NamedSharding gives the device at
the same place of its 8-device virtual CPU mesh.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from insider_tpu.config import ShardingConfig as JaxSharding
from insider_tpu.sharding.mesh import make_mesh as jax_make_mesh
from insider_tpu_torch.config import ShardingConfig
from insider_tpu_torch.sharding import (host_col_block, host_row_block,
                                        initialize_distributed,
                                        make_global_array,
                                        make_global_array_from_callback,
                                        make_mesh, pod_sharding)
from insider_tpu_torch.sharding import distributed
from insider_tpu_torch.sharding.distributed import block_bounds

REPO = Path(__file__).resolve().parent.parent


def test_initialize_noop_single_process(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "SLURM_NTASKS", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert initialize_distributed() is False
    assert not torch.distributed.is_initialized()


def test_initialize_takes_all_explicit_arguments():
    with pytest.raises(ValueError, match="together"):
        initialize_distributed("127.0.0.1:1", num_processes=2)


def test_pod_sharding_layouts(monkeypatch):
    """tests/test_distributed.py:31, in a group of 8 ranks."""
    n = 8
    monkeypatch.setattr(distributed, "group_size", lambda: n)
    assert pod_sharding() == ShardingConfig(rows=1, cols=n)
    assert pod_sharding(rows=2) == ShardingConfig(2, n // 2)
    assert pod_sharding(cols=2) == ShardingConfig(n // 2, 2)
    with pytest.raises(ValueError):
        pod_sharding(rows=3)                  # 8 not divisible
    with pytest.raises(ValueError):
        pod_sharding(rows=n, cols=n)


def test_pod_sharding_without_a_group_is_one_rank():
    assert pod_sharding() == ShardingConfig(1, 1)
    assert ShardingConfig(2, 4).n_devices == 8


@pytest.mark.parametrize("shape", [(16, 24), (13, 30)])
@pytest.mark.parametrize("layout", [(1, 8), (2, 4), (8, 1)])
def test_host_blocks_match_jax_device_map(monkeypatch, layout, shape):
    """Rank r * cols + c loads what the JAX package's NamedSharding places
    on the device at mesh position (r, c); an uneven shape against the
    axis padded to a multiple of its ranks and clamped, as the JAX
    package's process_block derives it."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    rows, cols = layout
    mesh = jax_make_mesh(JaxSharding(rows=rows, cols=cols))
    padded = tuple(-(-n // t) * t for n, t in zip(shape, layout))
    idx = NamedSharding(mesh, P("rows", "cols")).devices_indices_map(padded)
    cfg = ShardingConfig(rows, cols)
    for r in range(rows):
        for c in range(cols):
            want = [(min(s.start or 0, n), min(s.stop or n, n))
                    for s, n in zip(idx[mesh.devices[r, c]], shape)]
            monkeypatch.setattr(distributed, "group_rank",
                                lambda: r * cols + c)
            assert host_row_block(shape[0], cfg) == tuple(want[0])
            assert host_col_block(shape[1], cfg) == tuple(want[1])


@pytest.mark.parametrize("n,parts", [(16, 4), (13, 4), (5, 5), (44477, 2),
                                     (377, 3)])
def test_blocks_tile_the_axis(n, parts):
    bounds = [block_bounds(n, parts, i) for i in range(parts)]
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert {b - a for a, b in bounds[:-1]} == {-(-n // parts)}


def test_make_mesh_refuses_empty_blocks():
    """A layout that leaves a rank no columns (or rows) is refused before
    any collective: 3 columns over 4 ranks, 9 rows over 4 (blocks of 3,
    the last empty)."""
    with pytest.raises(ValueError, match="column blocks"):
        make_mesh(ShardingConfig(1, 4), "cpu", (10, 3))
    with pytest.raises(ValueError, match=r"row blocks \[3\]"):
        make_mesh(ShardingConfig(4, 1), "cpu", (9, 10))
    with pytest.raises(ValueError, match="ranks"):
        make_mesh(ShardingConfig(2, 2), "cpu", (10, 10))


def test_make_global_array_checks_the_block():
    mesh = make_mesh(ShardingConfig(1, 1), "cpu")
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    got = make_global_array(x, mesh, ("rows", "cols"), global_shape=(3, 4))
    assert np.array_equal(got.numpy(), x)
    assert np.array_equal(make_global_array(x, mesh, ("rows", "cols"))
                          .numpy(), x)
    with pytest.raises(ValueError, match="block"):
        make_global_array(x[:2], mesh, ("rows", "cols"), global_shape=(3, 4))
    calls = []

    def cb(index):
        calls.append(index)
        return x[index]

    got = make_global_array_from_callback((3, 4), mesh, ("rows", "cols"), cb,
                                          np_dtype=np.float64)
    assert calls == [(slice(0, 3), slice(0, 4))]
    assert got.dtype == torch.float64


def test_sharding_modules_import_no_jax():
    """The collectives and the layout load neither JAX nor the JAX
    package (in a fresh interpreter, as tests/test_torch_package.py
    checks the package)."""
    code = ("import sys; before = set(sys.modules); "
            "import insider_tpu_torch.sharding.comm, "
            "insider_tpu_torch.sharding.distributed; "
            "print(sorted(m for m in set(sys.modules) - before "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'insider_tpu')))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH", "")) if p))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
