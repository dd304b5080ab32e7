"""The port's continuous covariates (the C W term) against the JAX package
and the f64 oracles.

The six updates of ops/continuous.py and the plain version of the ctns_cd
kernel get the same numpy inputs as the JAX functions and agree at rtol
1e-5 / atol 1e-6 (f32 both sides, sums in other orders); against the numpy
oracle tests/oracles.ctns_update_masked at tests/test_continuous.py's
tolerances (5e-3 masked, 2e-3 dense closed form).  Whole fits with P = 2
covariates start from the JAX init_state(n_ctns=2) carried across with
state_from_numpy; the JAX side runs its kernel path (Pallas in interpret
mode) with one host decision per boundary, as the port does: per-boundary
losses at rtol 1e-5.  The cold-CD covariate fit is held to the f64 oracle
reference_optimize at rtol 2e-5 (tests/test_driver_oracle.py:83-94).
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import insider_tpu as it
import insider_tpu.api as jax_api
import insider_tpu.kernels.eval_pallas as ep
import insider_tpu.kernels.fss_pallas as fsp
import insider_tpu.kernels.row_pallas as rp
import insider_tpu_torch as itt
from insider_tpu.config import FitConfig as JaxFitConfig
from insider_tpu.model.state import init_state as jax_init_state
from insider_tpu.ops import continuous as jcont
from insider_tpu.train import als as jax_als
from insider_tpu_torch.config import FitConfig
from insider_tpu_torch.kernels import ctns
from insider_tpu_torch.model.state import state_from_numpy
from insider_tpu_torch.ops import continuous
from insider_tpu_torch.train import als

import oracles

# each package's attribute `tune` is the function, not the module
jax_grid = importlib.import_module("insider_tpu.tune.grid")
grid = importlib.import_module("insider_tpu_torch.tune.grid")

N, M, K, P = 40, 300, 6, 2
LAM, ALPHA = 2.0, 0.4
MAX_ITER = 20


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture()
def interpret_kernels(monkeypatch):
    """The JAX package's Pallas kernels in interpret mode on the CPU, and
    its Insider.fit and tune deciding every boundary on the host."""
    for mod, name in ((rp, "row_xty_pallas"), (rp, "row_xty_chunked_pallas"),
                      (rp, "level_gram_pallas"),
                      (fsp, "feature_sign_fused_pallas"),
                      (fsp, "feature_sign_shared_pallas"),
                      (ep, "masked_eval_pallas")):
        def interp(*args, _orig=getattr(mod, name), **kw):
            kw["interpret"] = True
            return _orig(*args, **kw)

        monkeypatch.setattr(mod, name, interp)
    monkeypatch.setattr(jax_api, "FitConfig",
                        functools.partial(JaxFitConfig,
                                          boundaries_per_dispatch=1))
    monkeypatch.setattr(jax_grid, "FitConfig",
                        functools.partial(JaxFitConfig, use_pallas=True,
                                          boundaries_per_dispatch=1))
    yield


# --- the six updates and the CD --------------------------------------------

def _inputs(seed=0, n=N, m=60, k=5):
    """tests/test_continuous.py's problem, and R_minus / data for the fast
    forms (resid_plus = data - R_minus F)."""
    rng = np.random.default_rng(seed)
    mask = (rng.random((n, m)) < 0.8).astype(np.float32)
    F = rng.standard_normal((k, m)).astype(np.float32)
    c = rng.standard_normal(n).astype(np.float32)
    w0 = (rng.standard_normal(k) * 0.01).astype(np.float32)
    R_minus = (0.3 * rng.standard_normal((n, k))).astype(np.float32)
    data = (R_minus @ F + rng.standard_normal((n, m))).astype(np.float32)
    resid_plus = (data.astype(np.float64)
                  - R_minus.astype(np.float64) @ F).astype(np.float32)
    return dict(mask=mask, F=F, c=c, w0=w0, R_minus=R_minus, data=data,
                resid_plus=resid_plus)


def _both(x, *names):
    return ([jnp.asarray(x[n]) for n in names],
            [torch.from_numpy(x[n]) for n in names])


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def _oracle(x, lam, tol=1e-1):
    return oracles.ctns_update_masked(
        x["resid_plus"].astype(np.float64), x["mask"].astype(np.float64),
        x["F"].astype(np.float64), x["c"].astype(np.float64),
        x["w0"].astype(np.float64), lam, tol=tol)


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_update_matches_jax_and_oracle(seed):
    x, lam = _inputs(seed), 0.9
    j, t = _both(x, "resid_plus", "mask", "F", "c", "w0")
    got = continuous.update_ctns_row_masked(*t, lam)
    _close(got, jcont.update_ctns_row_masked(*j, lam))
    np.testing.assert_allclose(got.numpy(), _oracle(x, lam), rtol=5e-3,
                               atol=5e-3)


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_fast_update_matches_jax_and_oracle(seed):
    x, lam = _inputs(seed), 0.9
    x["q"] = (x["c"] ** 2) @ x["mask"]
    x["bc"] = x["c"] @ (x["mask"] * x["data"])
    j, t = _both(x, "q", "bc", "mask", "R_minus", "F", "c", "w0")
    got = continuous.update_ctns_row_masked_fast(*t, lam)
    _close(got, jcont.update_ctns_row_masked_fast(*j, lam))
    np.testing.assert_allclose(got.numpy(), _oracle(x, lam), rtol=5e-3,
                               atol=5e-3)


def test_masked_v1_update_matches_jax_and_oracle():
    """v1 stops on the sweep's loss decrease < 1e-3, the oracle (v2) on
    sum |delta w|; run the oracle to a tight tol, near the exact ridge
    solution, which both stop rules approach."""
    x, lam = _inputs(2), 0.9
    j, t = _both(x, "resid_plus", "mask", "F", "c", "w0")
    got = continuous.update_ctns_row_masked_v1(*t, lam)
    _close(got, jcont.update_ctns_row_masked_v1(*j, lam))
    np.testing.assert_allclose(got.numpy(), _oracle(x, lam, tol=1e-9),
                               rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("fast", [False, True])
def test_dense_update_matches_jax_and_closed_form(fast):
    x, lam = _inputs(3), 1.1
    F64, c64 = x["F"].astype(np.float64), x["c"].astype(np.float64)
    x["gram"] = x["F"] @ x["F"].T
    want = np.linalg.solve(
        (c64 @ c64) * (F64 @ F64.T) + lam * np.eye(F64.shape[0]),
        F64 @ (x["resid_plus"].astype(np.float64).T @ c64))
    if fast:
        x["dc"] = x["c"] @ x["data"]
        x["cc"] = np.asarray(x["c"] @ x["c"], np.float32)
        j, t = _both(x, "dc", "cc", "R_minus", "F", "gram", "c")
        got = continuous.update_ctns_row_dense_fast(*t, lam)
        _close(got, jcont.update_ctns_row_dense_fast(*j, lam))
    else:
        j, t = _both(x, "resid_plus", "F", "gram", "c")
        got = continuous.update_ctns_row_dense(*t, lam)
        _close(got, jcont.update_ctns_row_dense(*j, lam))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("loss_criterion,tol", [(False, 1e-1), (True, 1e-3),
                                                (False, 1e-6)])
@pytest.mark.parametrize("k", [1, 5, 8, 136])
def test_plain_ctns_cd_matches_jax(loss_criterion, tol, k):
    rng = np.random.default_rng(10 + k)
    A = rng.standard_normal((3 * k, k)).astype(np.float32)
    XtX = (A.T @ A).astype(np.float32)
    b = rng.standard_normal(k).astype(np.float32)
    w0 = (0.1 * rng.standard_normal(k)).astype(np.float32)
    w, sweeps = ctns.ctns_cd_plain(torch.from_numpy(XtX), torch.from_numpy(b),
                                   torch.from_numpy(w0), 0.7, tol, 100,
                                   loss_criterion)
    want = jcont._ctns_cd(jnp.asarray(XtX), jnp.asarray(b), jnp.asarray(w0),
                          0.7, tol, 100, loss_criterion=loss_criterion)
    _close(w, want)
    assert 1 <= int(sweeps) <= 100
    # the wrapper on CPU tensors is the plain version, and launches nothing
    n0 = ctns.ctns_cd.launches
    again = ctns.ctns_cd(torch.from_numpy(XtX), torch.from_numpy(b),
                         torch.from_numpy(w0), 0.7, tol, 100, loss_criterion)
    assert torch.equal(again, w) and ctns.ctns_cd.launches == n0


def test_ctns_cd_stops_at_the_cap_and_runs_one_sweep():
    XtX = torch.tensor([[2.0, 1.9], [1.9, 2.0]])
    b = torch.tensor([1.0, -1.0])
    w, sweeps = ctns.ctns_cd(XtX, b, torch.zeros(2), 1e-3, 1e-12, 3,
                             with_sweeps=True)
    assert int(sweeps) == 3
    w, sweeps = ctns.ctns_cd(XtX, b, torch.zeros(2), 1e-3, 1e9, 100,
                             with_sweeps=True)
    assert int(sweeps) == 1
    with pytest.raises(ValueError):
        ctns.ctns_cd(XtX, b, torch.zeros(2), 1e-3, 1e-1, 0)


# --- whole fits -------------------------------------------------------------

def _raw_problem(seed=1):
    """3 confounders + their first two's interaction, ~1% NaNs, and P
    continuous covariates of which the data carries C W_true F."""
    sim = it.simulate_scale(N, M, K, level_counts=(2, 4, 7), noise_std=0.5,
                            seed=seed)
    rng = np.random.default_rng(7)
    c = rng.standard_normal((N, P))
    w_true = rng.standard_normal((P, K))
    data = (sim.data + (c @ w_true) @ sim.gene_factor).astype(np.float64)
    data[np.random.default_rng(5).random(data.shape) < 0.01] = np.nan
    return data, sim.confounder, c


def _jax_state(n_levels, n_cols, k=K, seed=0, n_ctns=P):
    st = jax_init_state(jax.random.PRNGKey(seed), tuple(n_levels), n_cols, k,
                        n_ctns=n_ctns)
    return ([np.asarray(f) for f in st.cfd_factors],
            None if st.ctns_factor is None else np.asarray(st.ctns_factor),
            np.asarray(st.column_factor))


def _fit_both(partition, **fit_kw):
    data, confounder, c = _raw_problem()
    jobj = it.Insider(data, confounder, c, interaction_idx=[0, 1],
                      max_iter=MAX_ITER)
    jobj.fit(K, LAM, ALPHA, partition=partition, verbose=False,
             use_pallas=True, **fit_kw)
    tobj = itt.Insider(data, confounder, c, interaction_idx=[0, 1],
                       max_iter=MAX_ITER, device="cpu")
    n_levels = [np.unique(v).size for v in tobj.confounder.T]
    cfd0, W0, F0 = _jax_state(n_levels, tobj.data.shape[1], seed=tobj.seed)
    tobj.fit(K, LAM, ALPHA, partition=partition, verbose=False,
             state=state_from_numpy(cfd0, W0, F0, "cpu"), **fit_kw)
    return tobj, jobj


def _assert_fits_match(tobj, jobj):
    h_port, h_jax = tobj.fit_result.history, jobj.fit_result.history
    assert [h["iter"] for h in h_port] == [h["iter"] for h in h_jax]
    for fld in ("loss", "train_rmse"):
        np.testing.assert_allclose([h[fld] for h in h_port],
                                   [h[fld] for h in h_jax], rtol=1e-5)
    assert len(tobj.cfd_matrices) == len(jobj.cfd_matrices)
    for g, w in zip(tobj.cfd_matrices + [tobj.column_factor],
                    jobj.cfd_matrices + [jobj.column_factor]):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=0,
                                   atol=1e-3 * float(np.abs(w).max()))


@pytest.mark.parametrize("partition", [1, 0])
def test_covariate_fit_matches_jax(interpret_kernels, partition):
    n0 = ctns.ctns_cd.launches
    tobj, jobj = _fit_both(partition)
    assert ctns.ctns_cd.launches == n0           # CPU: the plain version
    _assert_fits_match(tobj, jobj)
    assert [h["iter"] for h in tobj.fit_result.history] == [-1, 0, 10, 20]
    assert tobj.cfd_matrices[-1].shape == (P, K)
    np.testing.assert_array_equal(tobj.cfd_matrices[-1],
                                  tobj.fit_result.ctns_factor)
    losses = [h["loss"] for h in tobj.fit_result.history]
    assert losses[-1] < losses[0]


def test_covariate_fit_is_run_through_ctns_cd(monkeypatch):
    """A masked covariate fit calls the K-space CD once per covariate and
    iteration, a dense one never (its update is the closed form)."""
    calls = []
    orig = continuous.ctns_cd

    def spy(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)

    monkeypatch.setattr(continuous, "ctns_cd", spy)
    data, confounder, c = _raw_problem()
    obj = itt.Insider(data, confounder, c, interaction_idx=[0, 1],
                      device="cpu")
    obj.fit(K, LAM, ALPHA, partition=1, verbose=False, max_iter=4)
    assert len(calls) == P * 5
    obj.fit(K, LAM, ALPHA, partition=0, verbose=False, max_iter=4)
    assert len(calls) == P * 5


def test_cold_cd_covariate_fit_matches_f64_oracle():
    """tests/test_driver_oracle.py:83-94 in the port: cold strong-rule CD
    with two covariates, against the f64 oracle.  The oracle sweeps a fresh
    random order per column and sweep; the port, like the JAX package's
    kernel path, one order per column update (train/als.draw_perm), and its
    tolerance-stopped sub-solves then end lower early on: at iteration 10
    the port's loss is 4.4e-5 to 7.8e-5 below the oracle's over draw_perm
    seeds 0-4, and the JAX kernel path's (Pallas in interpret mode) 4.5e-5
    to 5.2e-5 below it over two keys; the 2e-5 pin of the JAX package's
    test holds for its per-sweep-order path.  So: never worse than the
    oracle (x(1 + 2e-5)) at any boundary, and within 2e-5 from iteration
    40 on."""
    sim = it.simulate_insider_data(v1_num=8, v2_num=3, gene_num=40,
                                   latent_dim=3, seed=7,
                                   with_interaction=True)
    c = np.random.default_rng(8).normal(size=(sim.data.shape[0], 2))
    obj = itt.Insider(sim.data, sim.confounder, ctns_confounder=c,
                      interaction_idx=(0, 1), split_ratio=0.1, device="cpu")
    prob = obj.tuning_problem()
    cfg = FitConfig(latent_dim=3, lambda1=2.0, lambda2=2.0, alpha=0.4,
                    max_iter=50, global_tol=0.0, col_solver="cd",
                    cd_warm_start=False)
    cfd0, W0, F0 = _jax_state(prob.n_levels, prob.shape[1], k=3, n_ctns=2)
    oracle = oracles.reference_optimize(
        prob.data.numpy(), prob.train_mask.numpy(), prob.test_mask.numpy(),
        [v.numpy() for v in prob.codes], list(prob.n_levels), F0, cfd0,
        cfg.lambda1, cfg.lambda2, cfg.alpha, max_iter=cfg.max_iter,
        global_tol=cfg.global_tol, sub_tol=cfg.sub_tol,
        ctns=prob.ctns.numpy(), W0=W0)
    res = als.optimize(prob, cfg, state=state_from_numpy(cfd0, W0, F0,
                                                         "cpu"),
                       verbose=False)
    o_by_iter = {h["iter"]: h for h in oracle["history"]}
    tail = 0
    for h in res.history:
        o = o_by_iter.get(h["iter"])
        if o is None:
            continue
        assert h["loss"] <= o["loss"] * (1.0 + 2e-5), h["iter"]
        if h["iter"] >= 40:
            for fld in ("loss", "train_rmse", "test_rmse"):
                assert h[fld] == pytest.approx(o[fld], rel=2e-5), (
                    h["iter"], fld)
            tail += 1
    assert tail == 2 and res.history[-1]["iter"] == 50
    assert res.ctns_factor.shape == (2, 3)


# --- the entry points -------------------------------------------------------

def test_one_dimensional_covariate_is_one_column():
    data, confounder, c = _raw_problem()
    obj = itt.Insider(data, confounder, c[:, 0], device="cpu")
    assert obj.ctns_confounder.shape == (N, 1)
    obj.fit(3, LAM, ALPHA, partition=1, verbose=False, max_iter=2)
    assert obj.cfd_matrices[-1].shape == (1, 3)
    assert len(obj.cfd_matrices) == obj.confounder.shape[1] + 1
    prob = als.build_problem(obj.data, obj.confounder, obj.train_indicator,
                             obj.test_indicator, c[:, 0], device="cpu")
    assert tuple(prob.ctns.shape) == (N, 1)
    assert tuple(prob.ctns_q.shape) == tuple(prob.ctns_bc.shape) == (1, M)


def test_problem_constants_match_jax():
    data, confounder, c = _raw_problem()
    obj = itt.Insider(data, confounder, c, device="cpu")
    for masked in (True, False):
        args = (obj.data, obj.confounder, obj.train_indicator,
                obj.test_indicator, c)
        tp = als.build_problem(*args, masked=masked, device="cpu")
        jp = jax_als.build_problem(*args, masked=masked)
        pre = jp.arrays.pre
        pairs = ([("ctns_q", pre.ctns_q), ("ctns_bc", pre.ctns_bc)] if masked
                 else [("ctns_dc", pre.ctns_dc), ("ctns_cc", pre.ctns_cc)])
        for name, want in pairs:
            np.testing.assert_allclose(getattr(tp, name).numpy(),
                                       np.asarray(want), rtol=1e-5, atol=1e-5)


def test_tune_with_covariates_matches_jax(interpret_kernels, monkeypatch,
                                          tmp_path):
    def jax_draw(problem, rank, seed, init_std):
        cfd, W, F = _jax_state(problem.n_levels, problem.shape[1], k=rank,
                               seed=seed, n_ctns=problem.ctns.shape[1])
        return state_from_numpy(cfd, W, F, problem.device)

    monkeypatch.setattr(grid, "draw_state", jax_draw)
    data, confounder, c = _raw_problem(seed=3)
    data = data[:, :120]
    kw = dict(interaction_idx=[0, 1], tuning_iter=5)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    jres = jax_grid.tune(it.Insider(data, confounder, c, **kw), [2, 3],
                         [1.0, 2.0], 0.4, out_dir=str(jdir),
                         batch_grid=False)
    tres = itt.Insider(data, confounder, c, device="cpu", **kw).tune(
        [2, 3], [1.0, 2.0], 0.4, out_dir=str(tdir))
    assert tres["latent_rank"] == jres["latent_rank"]
    for key in ("rank_tuning", "reg_tuning"):
        np.testing.assert_allclose(tres[key], jres[key], rtol=1e-5)


def test_draw_state_draws_w():
    data, confounder, c = _raw_problem()
    prob = itt.Insider(data, confounder, c, device="cpu").tuning_problem()
    st = grid.draw_state(prob, 4, 0, 1e-3)
    assert tuple(st.ctns_factor.shape) == (P, 4)
    assert st.ctns_factor.abs().max() > 0
