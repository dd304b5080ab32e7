"""Package-level checks of the PyTorch port (insider_tpu_torch): it imports
no JAX, its copied numpy modules match the JAX package's, the JAX factors
carry across, the ported settings build and unsupported ones raise, and
chip_smoke.py refuses to run without a GPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import insider_tpu as it
import insider_tpu_torch as itt
from insider_tpu.model.state import init_state as jax_init_state
from insider_tpu_torch.config import FitConfig, decay_from_delta_loss
from insider_tpu_torch.kernels import eval as ev
from insider_tpu_torch.kernels import cd, ctns, fss, gram, row
from insider_tpu_torch.model.state import init_state, state_from_numpy
from insider_tpu_torch.ops import col_update
from insider_tpu_torch.train import als

ROOT = Path(__file__).resolve().parent.parent


def _run(args, cwd, timeout=120):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH", "")) if p)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_import_loads_no_jax():
    """Neither the package nor its command line, native IO binding or
    workload modules load jax, jaxlib or any insider_tpu module."""
    modules = ["insider_tpu_torch", "insider_tpu_torch.cli",
               "insider_tpu_torch.data.native", "insider_tpu_torch.utils",
               "insider_tpu_torch.workloads.common"] + [
        f"insider_tpu_torch.workloads.{w}" for w in
        ("ageing", "gtex", "simulation", "prediXcan", "brainspan",
         "psyencode")]
    code = ("import importlib, sys; before = set(sys.modules); "
            f"[importlib.import_module(m) for m in {modules!r}]; "
            "new = set(sys.modules) - before; "
            "print(sorted(m for m in new if m.split('.')[0] in "
            "('jax', 'jaxlib', 'insider_tpu')))")
    proc = _run(["-c", code], cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


@pytest.mark.parametrize("ratio,rm_na_col", [(0.1, True), (0.25, False)])
def test_copied_splitter_matches(ratio, rm_na_col):
    rng = np.random.default_rng(0)
    data = rng.standard_normal((30, 40))
    data[rng.random(data.shape) < 0.05] = np.nan
    data[:, 3] = np.nan
    a = it.ratio_splitter(data, ratio=ratio, rm_na_col=rm_na_col, seed=7)
    b = itt.ratio_splitter(data, ratio=ratio, rm_na_col=rm_na_col, seed=7)
    for f in ("trainset", "testset", "train_indicator", "test_indicator",
              "na_indicator", "kept_cols"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_copied_simulator_matches():
    a = it.simulate_scale(20, 50, 4, level_counts=(3, 5), seed=3)
    b = itt.simulate_scale(20, 50, 4, level_counts=(3, 5), seed=3)
    np.testing.assert_array_equal(a.data, b.data)
    np.testing.assert_array_equal(a.confounder, b.confounder)
    c = it.simulate_insider_data(6, 3, 30, 4, seed=1)
    d = itt.simulate_insider_data(6, 3, 30, 4, seed=1)
    np.testing.assert_array_equal(c.data, d.data)
    np.testing.assert_array_equal(c.confounder, d.confounder)


def test_state_from_numpy_round_trips_jax_init():
    st = jax_init_state(jax.random.PRNGKey(3), (2, 5), 17, 4)
    cfd = [np.asarray(f) for f in st.cfd_factors]
    F = np.asarray(st.column_factor)
    ts = state_from_numpy(cfd, None, F, "cpu")
    assert ts.latent_dim == 4 and ts.ctns_factor is None
    for a, b in zip(cfd + [F], ts.cfd_factors + [ts.column_factor]):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), a)


def test_init_state_draws_from_generator():
    g = torch.Generator().manual_seed(0)
    st = init_state(g, (3, 40), 500, 6, init_std=1e-3)
    assert [tuple(f.shape) for f in st.cfd_factors] == [(3, 6), (40, 6)]
    assert tuple(st.column_factor.shape) == (6, 500)
    assert abs(float(st.column_factor.std()) - 1e-3) < 1e-4
    again = init_state(torch.Generator().manual_seed(0), (3, 40), 500, 6)
    assert torch.equal(st.column_factor, again.column_factor)


def test_decay_ladder_matches_jax():
    from insider_tpu.config import decay_from_delta_loss as jax_decay

    for d in (5e-4, 5e-3, 0.05, 0.5, 5.0, 50.0, 500.0, -1.0, 1e4):
        assert decay_from_delta_loss(d) == jax_decay(d)


@pytest.mark.parametrize("kw", [dict(boundaries_per_dispatch=5),
                                dict(masked=False, col_solver="cd",
                                     cd_warm_start=False,
                                     boundaries_per_dispatch=2)])
def test_unsupported_config_raises(kw):
    """Every boundaries_per_dispatch constructs, as the reference's does (5
    its default, <= 1 unchained, train/als._run_boundary_chain above);
    what the port has no counterpart of, use_pallas, raises."""
    for bpd in (0, 1, 2, 5):
        assert FitConfig(**dict(kw, boundaries_per_dispatch=bpd)
                         ).boundaries_per_dispatch == bpd
    assert FitConfig().boundaries_per_dispatch == 5
    for value in (True, False):
        with pytest.raises(ValueError, match="use_pallas"):
            FitConfig(**kw, use_pallas=value)


def test_col_solver_accepts_only_the_ported_solver():
    """The ported solvers are the JAX package's three names
    (insider_tpu/train/als.py:122-126); anything else raises ValueError."""
    assert FitConfig().col_solver == "auto"
    cfg = FitConfig(col_solver="cd")
    assert cfg.cd_warm_start and cfg.max_cd_sweeps == 200
    for s in ("auto", "fss", "cd"):
        assert FitConfig(col_solver=s, cd_warm_start=False).col_solver == s
    for s in ("CD", "ista", ""):
        with pytest.raises(ValueError):
            FitConfig(col_solver=s)


@pytest.mark.parametrize("call", ["masked problem", "dense problem",
                                  "dense fit", "masked cold-CD fit"])
def test_covariate_problem_and_fit_run(call):
    """Continuous covariates are ported: the calls that raised before build
    their problem and fit, with W as the last of cfd_matrices."""
    rng = np.random.default_rng(1)
    data = rng.standard_normal((12, 20))
    conf = rng.integers(1, 3, (12, 2))
    ind = np.ones((12, 20), np.uint8)
    ctns = rng.standard_normal((12, 1))
    if call.endswith("problem"):
        masked = call == "masked problem"
        prob = als.build_problem(data, conf, ind, 0 * ind,
                                 ctns_confounder=ctns, masked=masked,
                                 device="cpu")
        assert tuple(prob.ctns.shape) == (12, 1)
        const = prob.ctns_q if masked else prob.ctns_dc
        assert tuple(const.shape) == (1, 20)
        return
    obj = itt.Insider(data, conf, ctns_confounder=ctns, device="cpu")
    if call == "dense fit":
        obj.fit(3, 1.0, 0.5, partition=0, verbose=False, max_iter=3)
    else:
        obj.fit(3, 1.0, 0.5, partition=1, col_solver="cd",
                cd_warm_start=False, verbose=False, max_iter=3)
    assert obj.cfd_matrices[-1].shape == (1, 3)
    assert np.isfinite(obj.fit_result.loss)


def test_dense_problem_and_ridge_update_build():
    """partition=0 and alpha == 0, which raised before they were ported."""
    assert not FitConfig(masked=False).masked
    rng = np.random.default_rng(1)
    data = rng.standard_normal((12, 20))
    conf = rng.integers(1, 3, (12, 2))
    ind = np.ones((12, 20), np.uint8)
    prob = als.build_problem(data, conf, ind, 0 * ind, masked=False,
                             device="cpu")
    assert not prob.masked and prob.mw_cat is None
    assert [c.tolist() for c in prob.counts] == [
        np.bincount(np.unique(conf[:, v], return_inverse=True)[1]).tolist()
        for v in range(2)]
    R = torch.from_numpy(rng.standard_normal((12, 3)).astype(np.float32))
    X = torch.from_numpy(data.astype(np.float32))
    F = col_update.update_columns_masked(X, torch.ones((12, 20)), R,
                                         torch.zeros((3, 20)), 1.0, 0.0, 1e-5)
    Rd, Xd = R.double().numpy(), X.double().numpy()
    want = np.linalg.solve(Rd.T @ Rd + np.eye(3), Rd.T @ Xd)
    np.testing.assert_allclose(F.numpy(), want, rtol=1e-4, atol=1e-6)


def test_non_cpu_operands_never_take_the_plain_path():
    """Only CPU operands reach a plain version; anything else raises (on a
    machine without CUDA, meta tensors stand in for device tensors)."""
    meta = lambda *s, **kw: torch.empty(*s, device="meta", **kw)
    with pytest.raises(ValueError):
        row.level_gram(meta(3, 10), meta(4, 10))
    with pytest.raises(ValueError):
        row.row_xty(meta(5, dtype=torch.int32), meta(5, 4), meta(5, 10),
                    meta(3, 10), meta(4, 10))
    with pytest.raises(ValueError):
        fss.feature_sign_fused(meta(5, 10), meta(5, 10), meta(5, 4),
                               meta(4, 10), 1.0, 0.5)
    with pytest.raises(ValueError):
        ev.masked_eval(meta(5, 10), meta(5, 10), meta(5, 10), meta(5, 4),
                       meta(4, 10))
    with pytest.raises(ValueError):
        gram.col_gram_xty(meta(5, 10), meta(5, 10), meta(5, 4))
    with pytest.raises(ValueError):
        fss.feature_sign(meta(4, 4, 10), meta(4, 10), meta(4, 10), 1.0, 0.5)
    with pytest.raises(ValueError):
        fss.feature_sign_shared(meta(4, 4), meta(4, 10), meta(4, 10), 1.0,
                                0.5)
    with pytest.raises(ValueError):
        cd.cd_fused(meta(5, 10), meta(5, 10), meta(5, 4), meta(4, 10), 1.0,
                    0.5, 1e-5)
    with pytest.raises(ValueError):
        cd.cd_streamed(meta(4, 4, 10), meta(4, 10), meta(4, 10), 1.0, 0.5,
                       1e-5)
    with pytest.raises(ValueError):
        cd.cd_shared(meta(4, 4), meta(4, 10), meta(4, 10), 1.0, 0.5, 1e-5)
    with pytest.raises(ValueError):
        ctns.ctns_cd(meta(4, 4), meta(4), meta(4), 1.0, 0.1)


def test_chip_smoke_fails_without_gpu():
    proc = _run(["chip_smoke.py"], cwd=ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
