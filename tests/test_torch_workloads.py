"""The port's workload modules (insider_tpu_torch/workloads/) against the
JAX package's scripts (workloads/*.py) and the port's in-process Insider.

Each module runs at --device cpu --synthetic-cols 200 --max-iter 5 through
runpy, as `python -m` runs it, and writes its npz and JSON; losses finite
and, for these FSS fits, non-increasing (x(1 + 1e-6)).  The ageing module's
saved factors equal an in-process fit of its configuration bit for bit;
gtex's repeat loop fits each repeat from its own seed.  The configuration
of each (the fit's arguments, the synthetic shape, the Insider settings) is
the JAX script's letter for letter, and load_or_simulate returns what the
JAX workloads/common.py's returns, exactly.
"""

import importlib.util
import json
import os
import re
import runpy
import subprocess
import sys
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest

import insider_tpu_torch as itt
from insider_tpu_torch.workloads import common
from jax_native_private import jax_native  # noqa: F401 (fixture)

ROOT = Path(__file__).resolve().parent.parent
NAMES = ["ageing", "gtex", "simulation", "prediXcan", "brainspan",
         "psyencode"]
SMALL = ["--device", "cpu", "--synthetic-cols", "200", "--max-iter", "5"]


def _run(name, out, monkeypatch, extra=()):
    monkeypatch.setattr(sys, "argv", [name, *SMALL, "--out", out, *extra])
    return runpy.run_module(f"insider_tpu_torch.workloads.{name}",
                            run_name="__main__")["obj"]


@pytest.mark.parametrize("name", NAMES)
def test_workload_runs_and_saves(tmp_path, monkeypatch, name, capsys):
    out = str(tmp_path / f"{name}.npz")
    obj = _run(name, out, monkeypatch)
    z = np.load(out)
    assert sorted(z.files) == sorted(
        [f"factor{i}" for i in range(len(obj.cfd_matrices))]
        + ["column_factor"])
    assert z["column_factor"].shape[1] == 200
    with open(out + ".json") as fh:
        meta = json.load(fh)
    assert sorted(meta) == ["loss", "n_iter", "test_rmse"]
    assert meta["loss"] == obj.fit_result.loss and meta["n_iter"] == 5
    losses = [h["loss"] for h in obj.fit_result.history]
    assert np.all(np.isfinite(losses))
    assert all(b <= a * (1 + 1e-6) for a, b in zip(losses, losses[1:]))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == meta


def test_ageing_equals_in_process_fit(tmp_path, monkeypatch):
    out = str(tmp_path / "ageing.npz")
    _run("ageing", out, monkeypatch)
    sim = itt.simulate_scale(377, 200, 24, level_counts=(2, 8, 107), seed=0)
    obj = itt.Insider(sim.data.astype(np.float64), sim.confounder,
                      interaction_idx=[0, 1], global_tol=1e-10, sub_tol=1e-5,
                      tuning_iter=30, max_iter=5, device="cpu")
    obj.fit(24, 11, 0.4, partition=1, verbose=False)
    z = np.load(out)
    for i, f in enumerate(obj.cfd_matrices):
        np.testing.assert_array_equal(z[f"factor{i}"], f)
    np.testing.assert_array_equal(z["column_factor"], obj.column_factor)


def test_gtex_repeats_start_from_their_own_seed(tmp_path, monkeypatch,
                                                capsys):
    """GTEX_REPEATS=2: the saved object is repeat 1's fit, which starts
    from seed 1 (Insider.fit reads obj.seed), not from repeat 0's."""
    monkeypatch.setenv("GTEX_REPEATS", "2")
    out = str(tmp_path / "gtex.npz")
    _run("gtex", out, monkeypatch)
    printed = [line for line in capsys.readouterr().out.splitlines()
               if line.startswith("repeat ")]
    assert [p.split(":")[0] for p in printed] == ["repeat 0", "repeat 1"]
    sim = itt.simulate_scale(600, 200, 12, level_counts=(2, 13), seed=0)
    fits = []
    for seed in (0, 1):
        obj = itt.Insider(sim.data.astype(np.float64), sim.confounder,
                          interaction_idx=[0, 1], global_tol=1e-10,
                          max_iter=5, seed=seed, device="cpu")
        fits.append(obj.fit(12, 60, 0.5, partition=1,
                            verbose=False).column_factor)
    z = np.load(out)
    np.testing.assert_array_equal(z["column_factor"], fits[1])
    assert not np.array_equal(fits[0], fits[1])


def _flat(path):
    return re.sub(r"\s+", " ", Path(path).read_text())


def _calls(text, fn):
    return [re.sub(r"\s", "", m) for m in
            re.findall(re.escape(fn) + r"\(([^()]*(?:\([^()]*\)[^()]*)*)\)",
                       text)]


@pytest.mark.parametrize("name", NAMES)
def test_configuration_is_the_jax_scripts(name):
    """The fit's arguments, the synthetic shape and the Insider settings
    read the same as in workloads/<name>.py (the port adds device=)."""
    jax_text = _flat(ROOT / "workloads" / f"{name}.py")
    port_text = _flat(ROOT / "insider_tpu_torch" / "workloads" / f"{name}.py")
    for fn in ("obj.fit", "load_or_simulate", "simulate_insider_data",
               "save_fitted"):
        assert _calls(port_text, fn) == _calls(jax_text, fn), fn
    (jax_ins,) = _calls(jax_text, "it.Insider")
    (port_ins,) = _calls(port_text, "itt.Insider")
    assert port_ins == jax_ins + ",device=args.device"


def _jax_common():
    spec = importlib.util.spec_from_file_location(
        "jax_workloads_common", ROOT / "workloads" / "common.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("log2", [True, False])
def test_load_or_simulate_matches_jax(jax_native, tmp_path, log2):
    """The synthetic fallback and the --data route (through each package's
    cli._load_table) give the JAX workloads' arrays exactly."""
    jcommon = _jax_common()
    args = Namespace(data=None, confounder_cols=None, synthetic_cols=50)
    for a, b in zip(common.load_or_simulate(args, 30, (3, 4), 5, log2=log2),
                    jcommon.load_or_simulate(args, 30, (3, 4), 5,
                                             log2=log2)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(6)
    table = np.column_stack([rng.integers(1, 4, (30, 2)),
                             rng.random((30, 40)) * 100])
    path = tmp_path / "t.csv"
    with open(path, "w") as fh:
        for row in table:
            fh.write(",".join("%.9g" % v for v in row) + "\n")
    args = Namespace(data=str(path), confounder_cols=None, synthetic_cols=50)
    for a, b in zip(common.load_or_simulate(args, 30, (3, 4), 5, log2=log2),
                    jcommon.load_or_simulate(args, 30, (3, 4), 5,
                                             log2=log2)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_parse_args_adds_device():
    args = common.parse_args("ageing", [])
    assert args.device == "cuda" and args.synthetic_cols == 2000
    assert args.max_iter is None and args.data is None
    assert common.parse_args("x", ["--device", "cpu"]).device == "cpu"


def test_python_m_workload(tmp_path):
    """python -m insider_tpu_torch.workloads.simulation in a process of its
    own, from another directory, writes its files and its R^2."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH", "")) if p))
    proc = subprocess.run(
        [sys.executable, "-m", "insider_tpu_torch.workloads.simulation",
         *SMALL, "--out", "sim.npz"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "planted-signal R^2:" in proc.stdout
    assert (tmp_path / "sim.npz").exists()
    assert (tmp_path / "sim.npz.json").exists()
