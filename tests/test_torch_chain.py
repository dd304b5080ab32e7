"""The port's chained check boundaries (FitConfig.boundaries_per_dispatch
> 1, train/als._run_boundary_chain) on the CPU.

The problem is the JAX package's chain test's (tests/test_als.py:126-159:
8 x 3 levels, 60 genes, K=3, lambda 2, alpha 0.4, 70 iterations).  A
chained fit decides each boundary on the device with the host's own f64
formulas, so it must equal the boundaries_per_dispatch=1 fit bit for bit:
every history record's numbers, the factors, n_iter, converged and
diverged.  Against the JAX package's fits (whose chain decides in f32
double-single pairs) the port's chained fit holds the port's rtol 1e-5.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import insider_tpu as it
from insider_tpu.config import FitConfig as JaxFitConfig
from insider_tpu.model.state import init_state as jax_init_state
from insider_tpu.train import als as jals
from insider_tpu_torch.checkpoint import load_checkpoint
from insider_tpu_torch.config import FitConfig
from insider_tpu_torch.model.state import InsiderState, state_from_numpy
from insider_tpu_torch.train import als

K = 3
BASE = dict(latent_dim=K, lambda1=2.0, lambda2=2.0, alpha=0.4, max_iter=70,
            global_tol=1e-9, seed=0)
COLD = dict(col_solver="cd", cd_warm_start=False)


@pytest.fixture(scope="module")
def data():
    sim = it.simulate_insider_data(v1_num=8, v2_num=3, gene_num=60,
                                   latent_dim=K, seed=3)
    split = it.ratio_splitter(sim.data.astype(np.float64), ratio=0.1)
    ctns = np.random.default_rng(4).standard_normal(
        (split.data.shape[0], 2)).astype(np.float32)
    return dict(data=split.data, confounder=sim.confounder,
                train=split.train_indicator, test=split.test_indicator,
                ctns=ctns)


def _problem(d, masked=True, ctns=False):
    return als.build_problem(d["data"], d["confounder"], d["train"],
                             d["test"], d["ctns"] if ctns else None,
                             masked=masked, device="cpu")


def _fit(problem, **kw):
    return als.optimize(problem, FitConfig(**dict(BASE, **kw)),
                        verbose=False)


def _records(res):
    """Every history record's numbers, NaN-safe (a dense fit has no test
    RMSE), without the wall clock."""
    return [[np.float64(v).tobytes() for k, v in sorted(h.items())
             if k != "elapsed_s"] for h in res.history]


def _assert_same_fit(a, b):
    assert [h["iter"] for h in a.history] == [h["iter"] for h in b.history]
    assert _records(a) == _records(b)
    assert (a.n_iter, a.converged, a.diverged) == (b.n_iter, b.converged,
                                                   b.diverged)
    for x, y in zip(a.row_matrices + [a.column_factor],
                    b.row_matrices + [b.column_factor]):
        assert np.array_equal(x, y)
    if a.ctns_factor is not None:
        assert np.array_equal(a.ctns_factor, b.ctns_factor)


@pytest.mark.parametrize("kind", ["masked", "dense", "cold_cd",
                                  "cold_cd_dense", "covariates"])
def test_chained_fit_is_bit_for_bit_the_unchained(data, kind):
    problem = _problem(data, masked="dense" not in kind,
                       ctns=kind == "covariates")
    kw = COLD if kind.startswith("cold") else {}
    one, five = (_fit(problem, boundaries_per_dispatch=b, **kw)
                 for b in (1, 5))
    assert FitConfig().boundaries_per_dispatch == 5
    _assert_same_fit(one, five)
    assert [h["iter"] for h in five.history] == [-1, 0] + list(
        range(10, 71, 10))
    assert not five.graphed and five.wasted_iters == 0


def _jax_state(problem):
    st = jax_init_state(jax.random.PRNGKey(0), tuple(problem.n_levels),
                        problem.shape[1], K)
    return st, state_from_numpy([np.asarray(f) for f in st.cfd_factors],
                                None, np.asarray(st.column_factor), "cpu")


def test_chained_fit_matches_jax(data):
    """The port's chained fit against the JAX package's chained and
    unchained fits from one initial state, per-boundary losses and RMSEs
    at rtol 1e-5.  The JAX package's two runs must first have made the same
    ladder decisions on this problem (its f32 double-single chain can flip
    a rung edge that its host's f64 does not)."""
    problem = _problem(data)
    jproblem = jals.build_problem(data["data"], data["confounder"],
                                  data["train"], data["test"], masked=True)
    # (a fresh initial state each: the JAX fit donates its buffers)
    jres = {b: jals.optimize(jproblem, JaxFitConfig(
        **dict(BASE, boundaries_per_dispatch=b)),
        state=_jax_state(problem)[0], verbose=False) for b in (1, 5)}
    st = _jax_state(problem)[1]
    decisions = [[(h["iter"], h.get("decay")) for h in jres[b].history]
                 for b in (1, 5)]
    assert decisions[0] == decisions[1]
    assert jres[1].n_iter == jres[5].n_iter
    res = als.optimize(problem, FitConfig(**BASE), state=st, verbose=False)
    for ref in jres.values():
        assert [h["iter"] for h in res.history] == [h["iter"]
                                                    for h in ref.history]
        assert [h.get("decay") for h in res.history] == [
            h.get("decay") for h in ref.history]
        for f in ("loss", "train_rmse", "test_rmse"):
            np.testing.assert_allclose([h[f] for h in res.history],
                                       [h[f] for h in ref.history],
                                       rtol=1e-5)
        assert res.n_iter == ref.n_iter and res.converged == ref.converged


# global_tol 1e-5 stops this fit at iteration 230 (FSS) and 220 (cold CD):
# the third and the second boundary of the dispatch of iterations 201-250
@pytest.mark.parametrize("kw,stop", [({}, 230), (COLD, 220)])
def test_convergence_mid_dispatch(data, kw, stop):
    problem = _problem(data)
    one, five = (_fit(problem, boundaries_per_dispatch=b, max_iter=400,
                      global_tol=1e-5, **kw) for b in (1, 5))
    _assert_same_fit(one, five)
    assert five.converged and five.n_iter == stop
    # at most one boundary past the stop runs, its state discarded
    assert five.wasted_iters == 10


def _poison(state):
    F = state.column_factor.clone()
    F[0, 0] = float("nan")
    return InsiderState(list(state.cfd_factors), state.ctns_factor, F)


def test_chain_aborts_within_one_boundary(data, monkeypatch):
    """tests/test_divergence.py:55-80 for the port: factors poisoned at the
    first chained dispatch are caught at its first boundary; the chain
    stops there and no second dispatch runs."""
    problem = _problem(data)
    calls = {"n": 0}
    orig = als._run_boundary_chain

    def sabotage(problem, config, steps, *args):
        calls["n"] += 1
        if calls["n"] == 1:
            steps.state = _poison(steps.state)
        return orig(problem, config, steps, *args)

    monkeypatch.setattr(als, "_run_boundary_chain", sabotage)
    res = _fit(problem, max_iter=500)
    assert res.diverged and not res.converged
    assert res.n_iter <= 2 * 10
    assert calls["n"] == 1
    assert not np.isfinite(res.history[-1]["loss"])
    assert res.wasted_iters <= 10


@pytest.mark.parametrize("wrong", ["decay", "stop"])
def test_host_decides_every_boundary_again(data, monkeypatch, wrong):
    """The host decides each boundary again from the copied sums in f64
    and raises where the device decided its decay or its stop
    otherwise."""
    problem = _problem(data)
    if wrong == "decay":        # never leaves the first rung
        monkeypatch.setattr(als, "_device_decay",
                            lambda delta: torch.ones_like(delta))
    else:                       # a loss that stops the first boundary
        monkeypatch.setattr(als, "_device_loss",
                            lambda vec, config: vec[0] * float("nan"))
    with pytest.raises(RuntimeError, match="otherwise than the host"):
        _fit(problem)


def test_chained_resume_equals_uninterrupted(data, tmp_path):
    """A cold-CD chained fit stopped at a checkpoint (max_iter=30) and
    resumed to 70 equals the uninterrupted chained fit bit for bit, its
    order generator included; the dispatches fall otherwise in the two
    runs (1-50, 51-70 against 1-30, 31-70)."""
    problem = _problem(data)
    full = _fit(problem, **COLD)
    path = str(tmp_path / "ck.npz")
    als.optimize(problem, FitConfig(**dict(BASE, max_iter=30, **COLD)),
                 verbose=False, checkpoint_path=path)
    resumed = als.optimize(problem, FitConfig(**dict(BASE, **COLD)),
                           verbose=False, checkpoint_path=path, resume=True)
    assert resumed.history[1]["iter"] == 40
    assert _records(resumed)[1:] == _records(full)[5:]
    assert resumed.n_iter == full.n_iter
    for x, y in zip(resumed.row_matrices + [resumed.column_factor],
                    full.row_matrices + [full.column_factor]):
        assert np.array_equal(x, y)


def test_checkpoint_at_a_mid_dispatch_stop(data, tmp_path):
    """A chained cold-CD fit that converges mid-dispatch saves what the
    unchained fit saves at its stop: the iteration, the decay, the factors
    and the order generator after the live boundaries' draws (not after
    the draws of the boundary run past the stop)."""
    problem = _problem(data)
    saved = {}
    for b in (1, 5):
        path = str(tmp_path / f"ck{b}.npz")
        als.optimize(problem, FitConfig(**dict(
            BASE, boundaries_per_dispatch=b, max_iter=400, global_tol=1e-5,
            **COLD)), verbose=False, checkpoint_path=path)
        gen = torch.Generator()
        st, meta = load_checkpoint(path, device="cpu", generator=gen)
        saved[b] = (st, meta, gen.get_state())
    (s1, m1, g1), (s5, m5, g5) = saved[1], saved[5]
    assert m1["iter"] == m5["iter"] == 220
    assert m1["extra"] == m5["extra"]
    assert torch.equal(g1, g5)
    for x, y in zip(s1.cfd_factors + [s1.column_factor],
                    s5.cfd_factors + [s5.column_factor]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("bpd", [0, 1, 2, 5, 8])
def test_any_boundaries_per_dispatch_is_the_same_fit(data, bpd):
    """Any value is accepted, as the reference's (<= 1 is unchained), and
    gives the same fit."""
    problem = _problem(data)
    _assert_same_fit(_fit(problem, boundaries_per_dispatch=1),
                     _fit(problem, boundaries_per_dispatch=bpd))


def test_fit_config_binds_positionally_as_the_reference():
    """Every field at the reference's position, with its default."""
    ref = [(f.name, f.default) for f in dataclasses.fields(JaxFitConfig)]
    port = [(f.name, f.default) for f in dataclasses.fields(FitConfig)]
    assert port == ref
    with pytest.raises(ValueError, match="use_pallas"):
        FitConfig(use_pallas=True)


def test_column_wrappers_take_tol_as_a_tensor():
    """Every column kernel's wrapper takes its tolerance as a float or as
    a 0-d f32 tensor (a chained boundary's, decided on the device); on
    the CPU its plain version reads the tensor's value: the same bits."""
    from insider_tpu_torch.kernels import cd, fss

    rng = np.random.default_rng(9)
    N, Kc, M = 30, 4, 50
    R = torch.from_numpy(rng.standard_normal((N, Kc)).astype(np.float32))
    mask = torch.from_numpy((rng.random((N, M)) > 0.2).astype(np.float32))
    data = torch.from_numpy(rng.standard_normal((N, M)).astype(np.float32))
    beta0 = torch.from_numpy(
        rng.standard_normal((Kc, M)).astype(np.float32))
    G = torch.einsum("nk,nl,nm->klm", R, R, mask).contiguous()
    b = R.T @ (mask * data)
    XtX = (R.T @ R).contiguous()
    calls = [
        lambda t: fss.feature_sign_fused(mask, data, R, beta0, 3.0, 0.4,
                                         max_outer=2, polish_sweeps=8,
                                         tol=t),
        lambda t: fss.feature_sign(G, b, beta0, 3.0, 0.4, max_outer=2,
                                   polish_sweeps=8, tol=t),
        lambda t: fss.feature_sign_shared(XtX, b, beta0, 3.0, 0.4,
                                          max_outer=2, polish_sweeps=8,
                                          tol=t),
        lambda t: cd.cd_fused(mask, data, R, beta0, 3.0, 0.4, t, 10),
        lambda t: cd.cd_streamed(G, b, beta0, 3.0, 0.4, t, 10),
        lambda t: cd.cd_shared(XtX, b, beta0, 3.0, 0.4, t, 10),
    ]
    for rung in (1e-5, 1e-8):
        t = (torch.tensor(rung, dtype=torch.float64) * 1.0).to(torch.float32)
        for call in calls:
            assert torch.equal(call(rung), call(t))
