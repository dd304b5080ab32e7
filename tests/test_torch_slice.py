"""The port's masked fit against the JAX package's, end to end.

Both packages get the same numpy problem and the same initial factors (the
JAX init_state, carried across with state_from_numpy).  The JAX side runs
its kernel path (use_pallas=True, the Pallas entries in interpret mode) and
decides every boundary on the host (boundaries_per_dispatch=1), which is
what the port does.  Tolerances: per-boundary losses rtol 1e-5 (both sides
sum the loss in f64 from f32 factors that differ by summation order only);
factors atol 1e-3 of their largest magnitude (a few ALS iterations amplify
f32 rounding differences in the iterates more than in the loss).  The fit
is also held against the independent f64 numpy oracle.
"""

import jax
import numpy as np
import pytest
import torch

import insider_tpu as it
import insider_tpu.kernels.eval_pallas as ep
import insider_tpu.kernels.fss_pallas as fsp
import insider_tpu.kernels.row_pallas as rp
import insider_tpu_torch as itt
from insider_tpu.config import FitConfig as JaxFitConfig
from insider_tpu.model.state import init_state as jax_init_state
from insider_tpu.train import als as jax_als
from insider_tpu_torch.config import FitConfig
from insider_tpu_torch.model.state import state_from_numpy
from insider_tpu_torch.train import als

N, M, K = 40, 300, 6
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
    """Run the JAX package's Pallas kernels in interpret mode on the CPU."""
    for mod, name in ((rp, "row_xty_pallas"), (rp, "row_xty_chunked_pallas"),
                      (rp, "level_gram_pallas"),
                      (fsp, "feature_sign_fused_pallas"),
                      (ep, "masked_eval_pallas")):
        def interp(*args, _orig=getattr(mod, name), **kw):
            kw["interpret"] = True
            return _orig(*args, **kw)

        monkeypatch.setattr(mod, name, interp)
    yield


def _raw_problem():
    """3 confounders + their first two's interaction, ~1% NaNs."""
    sim = it.simulate_scale(N, M, K, level_counts=(2, 4, 7), noise_std=0.5,
                            seed=1)
    data = sim.data.astype(np.float64)
    data[np.random.default_rng(5).random(data.shape) < 0.01] = np.nan
    return data, sim.confounder


def _jax_state(n_levels, seed=0):
    st = jax_init_state(jax.random.PRNGKey(seed), tuple(n_levels), M, K)
    return ([np.asarray(f) for f in st.cfd_factors],
            np.asarray(st.column_factor))


def _assert_histories_match(h_port, h_jax):
    assert [h["iter"] for h in h_port] == [h["iter"] for h in h_jax]
    np.testing.assert_allclose([h["loss"] for h in h_port],
                               [h["loss"] for h in h_jax], rtol=1e-5)
    np.testing.assert_allclose([h["train_rmse"] for h in h_port],
                               [h["train_rmse"] for h in h_jax], rtol=1e-5)


def _assert_factors_close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=0,
                                   atol=1e-3 * float(np.abs(w).max()))


def test_optimize_matches_jax_kernel_path(interpret_kernels):
    data, confounder = _raw_problem()
    obj = it.Insider(data, confounder, interaction_idx=[0, 1])
    train, test = obj.train_indicator, obj.test_indicator
    jprob = jax_als.build_problem(obj.data, obj.confounder, train, test)
    cfd0, F0 = _jax_state(jprob.n_levels)
    jcfg = JaxFitConfig(latent_dim=K, lambda1=LAM, lambda2=LAM, alpha=ALPHA,
                        max_iter=MAX_ITER, boundaries_per_dispatch=1,
                        use_pallas=True, global_tol=1e-12)
    jst = jax_init_state(jax.random.PRNGKey(0), jprob.n_levels, M, K)
    jres = jax_als.optimize(jprob, jcfg, state=jst, verbose=False)

    prob = als.build_problem(obj.data, obj.confounder, train, test,
                             device="cpu")
    assert prob.n_levels == tuple(jprob.n_levels)
    cfg = FitConfig(latent_dim=K, lambda1=LAM, lambda2=LAM, alpha=ALPHA,
                    max_iter=MAX_ITER, global_tol=1e-12)
    res = als.optimize(prob, cfg, state=state_from_numpy(cfd0, None, F0,
                                                         "cpu"),
                       verbose=False)

    assert [h["iter"] for h in res.history] == [-1, 0, 10, 20]
    _assert_histories_match(res.history, jres.history)
    assert res.n_iter == jres.n_iter and not res.diverged
    _assert_factors_close(res.row_matrices + [res.column_factor],
                          jres.row_matrices + [jres.column_factor])


def test_insider_fit_matches_jax(interpret_kernels):
    data, confounder = _raw_problem()
    jobj = it.Insider(data, confounder, interaction_idx=[0, 1],
                      max_iter=MAX_ITER)
    jobj.fit(K, LAM, ALPHA, partition=1, verbose=False, use_pallas=True)

    tobj = itt.Insider(data, confounder, interaction_idx=[0, 1],
                       max_iter=MAX_ITER, device="cpu")
    np.testing.assert_array_equal(tobj.confounder, jobj.confounder)
    n_levels = [np.unique(c).size for c in tobj.confounder.T]
    cfd0, F0 = _jax_state(n_levels, seed=tobj.seed)
    tobj.fit(K, LAM, ALPHA, partition=1, verbose=False,
             state=state_from_numpy(cfd0, None, F0, "cpu"))

    _assert_histories_match(tobj.fit_result.history, jobj.fit_result.history)
    assert tobj.test_rmse == pytest.approx(jobj.test_rmse, rel=1e-5)
    _assert_factors_close(tobj.cfd_matrices + [tobj.column_factor],
                          jobj.cfd_matrices + [jobj.column_factor])


def test_optimize_matches_f64_oracle():
    """The port's fit against the independent f64 numpy oracle
    (tests/oracles.reference_optimize), with the pin the JAX package's FSS
    fit test uses (tests/test_driver_oracle.py:97-127): FSS solves each
    column exactly while the oracle's CD stops at its sub_tol, so the port's
    loss is never worse than the oracle's (x(1+1e-6)), and the two agree to
    3e-5 once the decay ladder has tightened the oracle (iter >= 40)."""
    import oracles

    sim = it.simulate_insider_data(v1_num=8, v2_num=3, gene_num=40,
                                   latent_dim=3, seed=7,
                                   with_interaction=True)
    obj = itt.Insider(sim.data, sim.confounder, interaction_idx=(0, 1),
                      split_ratio=0.1, device="cpu")
    prob = als.build_problem(obj.data, obj.confounder, obj.train_indicator,
                             obj.test_indicator, device="cpu")
    cfg = FitConfig(latent_dim=3, lambda1=2.0, lambda2=2.0, alpha=0.4,
                    max_iter=50, global_tol=0.0)
    st = jax_init_state(jax.random.PRNGKey(0), prob.n_levels,
                        prob.shape[1], 3)
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
