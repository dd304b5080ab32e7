"""The port's dense fit (partition=0), its alpha == 0 ridge fits and its
K > 32 masked fit, against the JAX package and the f64 oracle.

Both packages get the same numpy problem and the same initial factors (the
JAX init_state, carried across with state_from_numpy).  The JAX side runs
its kernel path (use_pallas=True, the Pallas entries in interpret mode) and
decides every boundary on the host (boundaries_per_dispatch=1), as the port
does.  Tolerances as tests/test_torch_slice.py: per-boundary losses rtol
1e-5, factors atol 1e-3 of their largest magnitude.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import insider_tpu as it
import insider_tpu.api as jax_api
import insider_tpu.kernels.eval_pallas as ep
import insider_tpu.kernels.fss_pallas as fsp
import insider_tpu.kernels.gram_pallas as gp
import insider_tpu.kernels.row_pallas as rp
import insider_tpu_torch as itt
from insider_tpu.config import FitConfig as JaxFitConfig
from insider_tpu.model.state import init_state as jax_init_state
from insider_tpu_torch.config import FitConfig
from insider_tpu_torch.kernels import fss, gram
from insider_tpu_torch.model.state import state_from_numpy
from insider_tpu_torch.train import als

N, M, K = 40, 300, 6
LAM = 2.0
MAX_ITER = 20


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture()
def interpret_kernels(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode on the CPU,
    and let its Insider.fit decide every boundary on the host."""
    for mod, name in ((rp, "row_xty_pallas"), (rp, "row_xty_chunked_pallas"),
                      (rp, "level_gram_pallas"),
                      (fsp, "feature_sign_fused_pallas"),
                      (fsp, "feature_sign_pallas"),
                      (fsp, "feature_sign_shared_pallas"),
                      (gp, "col_gram_xty_pallas"),
                      (ep, "masked_eval_pallas")):
        def interp(*args, _orig=getattr(mod, name), **kw):
            kw["interpret"] = True
            return _orig(*args, **kw)

        monkeypatch.setattr(mod, name, interp)
    monkeypatch.setattr(jax_api, "FitConfig",
                        functools.partial(JaxFitConfig,
                                          boundaries_per_dispatch=1))
    yield


def _raw_problem():
    """3 confounders + their first two's interaction, ~1% NaNs."""
    sim = it.simulate_scale(N, M, K, level_counts=(2, 4, 7), noise_std=0.5,
                            seed=1)
    data = sim.data.astype(np.float64)
    data[np.random.default_rng(5).random(data.shape) < 0.01] = np.nan
    return data, sim.confounder


def _assert_fits_match(tobj, jobj):
    h_port, h_jax = tobj.fit_result.history, jobj.fit_result.history
    assert [h["iter"] for h in h_port] == [h["iter"] for h in h_jax]
    for fld in ("loss", "train_rmse"):
        np.testing.assert_allclose([h[fld] for h in h_port],
                                   [h[fld] for h in h_jax], rtol=1e-5)
    for g, w in zip(tobj.cfd_matrices + [tobj.column_factor],
                    jobj.cfd_matrices + [jobj.column_factor]):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=0,
                                   atol=1e-3 * float(np.abs(w).max()))


def _fit_both(partition, alpha):
    data, confounder = _raw_problem()
    jobj = it.Insider(data, confounder, interaction_idx=[0, 1],
                      max_iter=MAX_ITER)
    jobj.fit(K, LAM, alpha, partition=partition, verbose=False,
             use_pallas=True)
    tobj = itt.Insider(data, confounder, interaction_idx=[0, 1],
                       max_iter=MAX_ITER, device="cpu")
    n_levels = [np.unique(c).size for c in tobj.confounder.T]
    st = jax_init_state(jax.random.PRNGKey(tobj.seed), tuple(n_levels),
                        tobj.data.shape[1], K)
    tobj.fit(K, LAM, alpha, partition=partition, verbose=False,
             state=state_from_numpy([np.asarray(f) for f in st.cfd_factors],
                                    None, np.asarray(st.column_factor),
                                    "cpu"))
    return tobj, jobj


def test_dense_fit_matches_jax(interpret_kernels):
    n0 = fss.feature_sign_shared.launches
    tobj, jobj = _fit_both(partition=0, alpha=0.4)
    assert fss.feature_sign_shared.launches == n0    # CPU: plain version
    _assert_fits_match(tobj, jobj)
    assert [h["iter"] for h in tobj.fit_result.history] == [-1, 0, 10, 20]
    assert np.isnan(tobj.test_rmse) and np.isnan(jobj.test_rmse)
    assert int((tobj.column_factor == 0).sum()) > 0


@pytest.mark.parametrize("partition", [0, 1])
def test_ridge_fit_matches_jax(interpret_kernels, partition):
    tobj, jobj = _fit_both(partition=partition, alpha=0.0)
    _assert_fits_match(tobj, jobj)
    if partition:
        assert tobj.test_rmse == pytest.approx(jobj.test_rmse, rel=1e-5)


def test_masked_k40_fit_matches_f64_oracle(monkeypatch):
    """A K=40 masked fit, which takes the streamed route (col_gram_xty, then
    feature_sign), against the independent f64 numpy oracle
    (tests/oracles.reference_optimize), with the pin of
    tests/test_torch_slice.py:136-178: the port's loss is never worse than
    the oracle's (x(1+1e-6)), and the two agree to 3e-5 from iter 40 on."""
    import oracles

    calls = []
    orig = gram.col_gram_xty

    def spy(*args):
        calls.append(1)
        return orig(*args)

    monkeypatch.setattr("insider_tpu_torch.ops.col_update.col_gram_xty", spy)
    k = 40
    sim = it.simulate_insider_data(v1_num=8, v2_num=3, gene_num=40,
                                   latent_dim=3, seed=7,
                                   with_interaction=True)
    obj = itt.Insider(sim.data, sim.confounder, interaction_idx=(0, 1),
                      split_ratio=0.1, device="cpu")
    prob = als.build_problem(obj.data, obj.confounder, obj.train_indicator,
                             obj.test_indicator, device="cpu")
    cfg = FitConfig(latent_dim=k, lambda1=8.0, lambda2=8.0, alpha=0.4,
                    max_iter=50, global_tol=0.0)
    st = jax_init_state(jax.random.PRNGKey(0), prob.n_levels,
                        prob.shape[1], k)
    cfd0 = [np.asarray(f) for f in st.cfd_factors]
    F0 = np.asarray(st.column_factor)
    oracle = oracles.reference_optimize(
        prob.data.numpy(), prob.train_mask.numpy(), prob.test_mask.numpy(),
        [c.numpy() for c in prob.codes], list(prob.n_levels), F0, cfd0,
        cfg.lambda1, cfg.lambda2, cfg.alpha, max_iter=cfg.max_iter,
        global_tol=cfg.global_tol, sub_tol=cfg.sub_tol, masked=True)
    res = als.optimize(prob, cfg, state=state_from_numpy(cfd0, None, F0,
                                                         "cpu"),
                       verbose=False)
    assert len(calls) == 51                      # one per iteration
    assert res.history[-1]["loss"] < 0.5 * res.history[0]["loss"]
    o_by_iter = {h["iter"]: h for h in oracle["history"]}
    tail = 0
    for h in res.history:
        o = o_by_iter.get(h["iter"])
        if o is None:
            continue
        assert h["loss"] <= o["loss"] * (1.0 + 1e-6), h["iter"]
        if h["iter"] >= 40:
            for fld in ("loss", "train_rmse", "test_rmse"):
                assert h[fld] == pytest.approx(o[fld], rel=3e-5), (
                    h["iter"], fld)
            tail += 1
    assert tail >= 2
