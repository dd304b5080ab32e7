"""Whole fits of the port with col_solver="cd": cold strong-rule CD
(cd_warm_start=False) and the FSS-warm-started default, against the
independent f64 numpy oracle tests/oracles.reference_optimize, at the
settings and tolerances of the JAX package's oracle pins
(tests/test_driver_oracle.py:83-94, :130-152, :171-194), without continuous
covariates (not ported yet).  The oracle sweeps a fresh random order per
column and sweep, the port one order per column update (train/als.draw_perm),
so the agreement rests on tight sub-solves, as for the JAX optimize().
"""

import jax
import numpy as np
import pytest
import torch

import insider_tpu as it
import insider_tpu_torch as itt
from insider_tpu.model.state import init_state as jax_init_state
from insider_tpu_torch.config import FitConfig
from insider_tpu_torch.model.state import state_from_numpy
from insider_tpu_torch.ops import col_update
from insider_tpu_torch.train import als

import oracles


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _obj(seed=7):
    sim = it.simulate_insider_data(v1_num=8, v2_num=3, gene_num=40,
                                   latent_dim=3, seed=seed,
                                   with_interaction=True)
    return itt.Insider(sim.data, sim.confounder, interaction_idx=(0, 1),
                       split_ratio=0.1, device="cpu")


def _fit_and_oracle(prob, cfg):
    """The port's fit and the oracle's from the JAX init_state."""
    st = jax_init_state(jax.random.PRNGKey(cfg.seed), prob.n_levels,
                        prob.shape[1], cfg.latent_dim)
    cfd0 = [np.asarray(f) for f in st.cfd_factors]
    F0 = np.asarray(st.column_factor)
    oracle = oracles.reference_optimize(
        prob.data.numpy(), prob.train_mask.numpy(), prob.test_mask.numpy(),
        [c.numpy() for c in prob.codes], list(prob.n_levels), F0, cfd0,
        cfg.lambda1, cfg.lambda2, cfg.alpha, max_iter=cfg.max_iter,
        global_tol=cfg.global_tol, sub_tol=cfg.sub_tol, masked=cfg.masked)
    res = als.optimize(prob, cfg, state=state_from_numpy(cfd0, None, F0,
                                                         "cpu"),
                       verbose=False)
    return res.history, oracle["history"]


def _compare(history, oracle_history, rtol):
    """tests/test_driver_oracle.py:65-80."""
    o_by_iter = {h["iter"]: h for h in oracle_history}
    checked = 0
    for h in history:
        o = o_by_iter.get(h["iter"])
        if o is None:
            continue
        for fld in ("loss", "train_rmse", "test_rmse"):
            a, b = h[fld], o[fld]
            if np.isnan(b):
                assert np.isnan(a)
                continue
            assert a == pytest.approx(b, rel=rtol), (h["iter"], fld, a, b)
        checked += 1
    assert checked >= 5, f"only {checked} boundaries compared"


def _cfg(**kw):
    return FitConfig(latent_dim=3, lambda1=2.0, lambda2=2.0, alpha=0.4,
                     global_tol=0.0, col_solver="cd", **kw)


def test_masked_cold_cd_fit_matches_f64_oracle():
    obj = _obj()
    prob = als.build_problem(obj.data, obj.confounder, obj.train_indicator,
                             obj.test_indicator, device="cpu")
    hist, ohist = _fit_and_oracle(prob, _cfg(max_iter=50,
                                             cd_warm_start=False))
    _compare(hist, ohist, rtol=2e-5)


def test_dense_cold_cd_fit_matches_f64_oracle():
    """Tolerance-stopped CD with different coordinate orders: the JAX pin
    is 5e-5 overall and 1.5e-5 at the final boundary
    (tests/test_driver_oracle.py:144-152)."""
    obj = _obj()
    indicator = obj.train_indicator + obj.test_indicator
    prob = als.build_problem(obj.data, obj.confounder, indicator,
                             obj.na_indicator, masked=False, device="cpu")
    hist, ohist = _fit_and_oracle(prob, _cfg(max_iter=40, masked=False,
                                             cd_warm_start=False))
    _compare(hist, ohist, rtol=5e-5)
    assert hist[-1]["iter"] == ohist[-1]["iter"] == 40
    assert hist[-1]["loss"] == pytest.approx(ohist[-1]["loss"], rel=1.5e-5)


def test_masked_warm_cd_fit_not_worse_than_oracle():
    """col_solver="cd" with the FSS warm start solves each subproblem at
    least as tightly as the oracle's cold CD: its losses are never worse
    (x(1 + 2e-5), tests/test_driver_oracle.py:171-194)."""
    obj = _obj()
    prob = als.build_problem(obj.data, obj.confounder, obj.train_indicator,
                             obj.test_indicator, device="cpu")
    hist, ohist = _fit_and_oracle(prob, _cfg(max_iter=50))
    o_by_iter = {h["iter"]: h for h in ohist}
    checked = 0
    for h in hist:
        o = o_by_iter.get(h["iter"])
        if o is None or h["iter"] < 0:
            continue
        assert h["loss"] <= o["loss"] * (1 + 2e-5), h["iter"]
        checked += 1
    assert checked >= 4


def test_fss_solver_equals_auto():
    obj = _obj()
    prob = als.build_problem(obj.data, obj.confounder, obj.train_indicator,
                             obj.test_indicator, device="cpu")
    runs = [als.optimize(prob, FitConfig(latent_dim=3, lambda1=2.0,
                                         lambda2=2.0, alpha=0.4, max_iter=20,
                                         col_solver=s), verbose=False)
            for s in ("auto", "fss")]
    assert runs[0].history == [
        dict(h, elapsed_s=runs[0].history[i]["elapsed_s"])
        for i, h in enumerate(runs[1].history)]
    np.testing.assert_array_equal(runs[0].column_factor,
                                  runs[1].column_factor)


@pytest.mark.parametrize("partition", [0, 1])
def test_insider_fit_runs_cold_cd(monkeypatch, partition):
    """Insider.fit(col_solver="cd", cd_warm_start=False) runs cold CD: one
    coordinate order per iteration from draw_perm, one cold-CD column
    update per iteration, lasso zeros in the column factor."""
    perms, updates = [], []
    orig_draw = als.draw_perm

    def draw(gen, K):
        perms.append(orig_draw(gen, K))
        return perms[-1]

    name = "cd_fused" if partition else "cd_shared"
    orig_cd = getattr(col_update, name)

    def spy(*args, **kw):
        updates.append(1)
        return orig_cd(*args, **kw)

    monkeypatch.setattr(als, "draw_perm", draw)
    monkeypatch.setattr(col_update, name, spy)
    obj = _obj()
    obj.fit(3, 2.0, 0.4, partition=partition, verbose=False,
            col_solver="cd", cd_warm_start=False, max_iter=10)
    assert len(perms) == len(updates) == 11
    assert all(sorted(p.tolist()) == [0, 1, 2] for p in perms)
    # the orders come from a CPU generator seeded with the fit's seed
    gen = torch.Generator().manual_seed(obj.seed)
    assert all(torch.equal(p, torch.randperm(3, generator=gen))
               for p in perms)
    losses = [h["loss"] for h in obj.fit_result.history]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert int((obj.column_factor == 0).sum()) > 0
