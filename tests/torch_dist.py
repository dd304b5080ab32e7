"""Run a job on every rank of a gloo process group of CPU processes.

    results = spawn(world, "module:function", inputs, tmp_path)

starts `world` Python processes running this file, each joining one gloo
group on 127.0.0.1 at a port found by binding port 0 (never a fixed one:
the test workers run side by side); each calls function(inputs, rank) from
the named module of tests/ and pickles what it returns.  The whole group
runs under a hard wall-clock limit: past it every process is killed and
spawn raises, so a rank that hangs in a collective fails its test instead
of stalling the run.  A nonzero exit of any rank raises with its output.

The processes run this file as a script, with the repository on
PYTHONPATH and no tests/conftest.py, so no JAX is imported there: a job
module imports the port and numpy only.
"""

from __future__ import annotations

import importlib
import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
# A group's processes take ~3 s each to import torch, all at once; the
# jobs of the tests take a few seconds more.  Past this the group is
# killed.
WALL_S = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(world: int, job: str, inputs, tmp_path, wall_s: float = WALL_S):
    """Run job ("module:function") on `world` gloo ranks; returns the
    list of what each rank's call returned, in rank order."""
    tmp_path = Path(tmp_path)
    with open(tmp_path / "inputs.pkl", "wb") as fh:
        pickle.dump(inputs, fh)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), str(REPO / "tests"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    address = f"127.0.0.1:{free_port()}"
    logs = [open(tmp_path / f"rank{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, job, str(r), str(world), address,
         str(tmp_path)], env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    deadline = time.monotonic() + wall_s
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{job}: the group of {world} ranks ran past "
                             f"{wall_s} s and was killed")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        if p.returncode != 0:
            failed.append(f"rank {r} exit {p.returncode}:\n{log.read()}")
        log.close()
    if failed:
        raise AssertionError(f"{job}: " + "\n".join(failed))
    out = []
    for r in range(world):
        with open(tmp_path / f"result{r}.pkl", "rb") as fh:
            out.append(pickle.load(fh))
    return out


def _main(job, rank, world, address, tmp):
    import torch

    from insider_tpu_torch.sharding import initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed(address, world, rank, device="cpu")
    module, function = job.split(":")
    with open(Path(tmp) / "inputs.pkl", "rb") as fh:
        inputs = pickle.load(fh)
    result = getattr(importlib.import_module(module), function)(inputs, rank)
    with open(Path(tmp) / f"result{rank}.pkl", "wb") as fh:
        pickle.dump(result, fh)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
          sys.argv[5])
