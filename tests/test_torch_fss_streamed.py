"""The port's FSS kernels on precomputed grams (insider_tpu_torch/kernels/
fss.py: feature_sign on streamed (K, K, M) grams, feature_sign_shared on one
(K, K) gram) against the JAX package's Pallas kernels, the masked column
update's dispatch by K, the column updates at K = 72 > 64 (which raised
before the kernels held four coordinates per lane), and at K = 136 > 128 on
the CPU, where the plain versions take any K (the CUDA kernels stop at 128,
and a fit on the card says so before its first iteration).

On CPU tensors the wrappers run their plain version (ops/fss.py, which
follows the TPU kernel's iteration); the Pallas kernels run in interpret
mode.  Tolerance: rtol 2e-5, atol 1e-5 on beta, as the JAX package's
fused-vs-streamed and shared-vs-streamed kernel tests
(tests/test_fss.py:293-317, :353-379).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insider_tpu.kernels.fss_pallas import (feature_sign_pallas,
                                            feature_sign_shared_pallas)
from insider_tpu.ops import col_update as jax_col_update
from insider_tpu_torch.kernels.fss import feature_sign, feature_sign_shared
from insider_tpu_torch.kernels.gram import col_gram_xty
from insider_tpu_torch.ops import col_update

KW = dict(max_outer=48, polish_sweeps=16, tol=1e-8)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _masked_problem(N, K, M, seed):
    """f32 per-gene masked grams (K, K, M), Xty and a warm start, summed in
    f64 from a random row factor, mask and data."""
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((N, K))
    mask = (rng.random((N, M)) > 0.1).astype(np.float64)
    data = rng.standard_normal((N, M))
    G = np.einsum("ij,ik,il->klj", mask, R, R).astype(np.float32)
    xty = (R.T @ (mask * data)).astype(np.float32)
    beta0 = (0.01 * rng.standard_normal((K, M))).astype(np.float32)
    return G, xty, beta0


def _dense_problem(N, K, M, seed):
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((N, K))
    data = rng.standard_normal((N, M))
    beta0 = (0.01 * rng.standard_normal((K, M))).astype(np.float32)
    return ((R.T @ R).astype(np.float32), (R.T @ data).astype(np.float32),
            beta0)


def _jax_kw(lam, alpha):
    return dict(lam=lam, alpha=alpha, max_outer=KW["max_outer"],
                polish_sweeps=KW["polish_sweeps"],
                tol=jnp.float32(KW["tol"]), interpret=True, block=512)


@pytest.mark.parametrize("K,lam,alpha", [(6, 2.0, 0.5), (40, 11.0, 0.4)])
def test_feature_sign_matches_pallas_kernel(K, lam, alpha):
    G, xty, beta0 = _masked_problem(60, K, 150, seed=K)
    want = feature_sign_pallas(jnp.asarray(G), jnp.asarray(xty),
                               jnp.asarray(beta0), **_jax_kw(lam, alpha))
    got = feature_sign(torch.from_numpy(G), torch.from_numpy(xty),
                       torch.from_numpy(beta0), lam, alpha, **KW)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=1e-5)
    assert int((got == 0).sum()) > 0     # lasso zeros are exact


@pytest.mark.parametrize("K,lam,alpha", [(6, 2.0, 0.5), (12, 11.0, 0.4)])
def test_feature_sign_shared_matches_pallas_kernel(K, lam, alpha):
    XtX, xty, beta0 = _dense_problem(60, K, 150, seed=10 + K)
    want = feature_sign_shared_pallas(jnp.asarray(XtX), jnp.asarray(xty),
                                      jnp.asarray(beta0),
                                      **_jax_kw(lam, alpha))
    got = feature_sign_shared(torch.from_numpy(XtX), torch.from_numpy(xty),
                              torch.from_numpy(beta0), lam, alpha, **KW)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=1e-5)
    assert int((got == 0).sum()) > 0


def test_shared_matches_streamed_on_broadcast_grams():
    """Dense path: the shared-gram FSS matches the streamed FSS fed the
    broadcast (K, K, M) gram (the port's form of
    tests/test_fss.py:353-379)."""
    K, M = 6, 300
    XtX, xty, beta0 = _dense_problem(60, K, M, seed=12)
    XtX, xty, beta0 = (torch.from_numpy(x) for x in (XtX, xty, beta0))
    a = feature_sign(XtX[:, :, None].expand(K, K, M).contiguous(), xty,
                     beta0, 2.0, 0.5, **KW)
    b = feature_sign_shared(XtX, xty, beta0, 2.0, 0.5, **KW)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5, atol=1e-5)


def _spy(monkeypatch, name, calls):
    orig = getattr(col_update, name)

    def spy(*args, **kw):
        calls.append(name)
        return orig(*args, **kw)

    monkeypatch.setattr(col_update, name, spy)


@pytest.mark.parametrize("K,alpha,route", [
    (24, 0.4, ["feature_sign_fused"]),
    (32, 0.4, ["feature_sign_fused"]),
    (40, 0.4, ["col_gram_xty", "feature_sign"]),
    (40, 0.0, ["col_gram_xty"]),
])
def test_masked_column_update_dispatch_by_k(monkeypatch, K, alpha, route):
    """K <= 32 takes the fused kernel; 32 < K <= 64 the streamed route;
    alpha == 0 the ridge solve on col_gram_xty's grams."""
    calls = []
    for name in ("feature_sign_fused", "col_gram_xty", "feature_sign",
                 "feature_sign_shared"):
        _spy(monkeypatch, name, calls)
    rng = np.random.default_rng(K)
    N, M = 50, 40
    R = torch.from_numpy(rng.standard_normal((N, K)).astype(np.float32))
    mask = torch.from_numpy((rng.random((N, M)) > 0.1).astype(np.float32))
    data = torch.from_numpy(rng.standard_normal((N, M)).astype(np.float32))
    F0 = torch.zeros((K, M))
    F = col_update.update_columns_masked(data, mask, R, F0, 5.0, alpha, 1e-6)
    assert calls == route
    assert F.shape == (K, M) and F.is_contiguous()
    assert bool(torch.isfinite(F).all())


def test_dense_column_update_dispatch(monkeypatch):
    calls = []
    _spy(monkeypatch, "feature_sign_shared", calls)
    rng = np.random.default_rng(3)
    R = torch.from_numpy(rng.standard_normal((50, 40)).astype(np.float32))
    data = torch.from_numpy(rng.standard_normal((50, 30)).astype(np.float32))
    F0 = torch.zeros((40, 30))
    col_update.update_columns_dense(data, R, F0, 5.0, 0.4, 1e-6)
    assert calls == ["feature_sign_shared"]
    F = col_update.update_columns_dense(data, R, F0, 5.0, 0.0, 1e-6)
    assert calls == ["feature_sign_shared"]          # ridge: no kernel
    Rd, Xd = R.double().numpy(), data.double().numpy()
    np.testing.assert_allclose(
        F.numpy(), np.linalg.solve(Rd.T @ Rd + 5.0 * np.eye(40), Rd.T @ Xd),
        rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("update", ["masked", "dense"])
def test_column_update_rejects_k_over_64(update):
    """The CUDA column kernels hold at most four coordinates per lane: on
    the card K = 129 raises (check_rank, which both updates call first);
    on the CPU the plain versions take it, as the JAX package's CPU path
    does.  The test keeps its name from when the limit was 64, on every
    device."""
    K, N, M = 129, 140, 10
    R, mask, data, F0 = (T(x) for x in _inputs(N, K, M, seed=129))
    with pytest.raises(ValueError, match="128"):
        col_update.check_rank(K, "cuda")
    col_update.check_rank(128, "cuda")
    col_update.check_rank(K, "cpu")
    if update == "masked":
        F = col_update.update_columns_masked(data, mask, R, F0, 30.0, 0.5,
                                             1e-5)
    else:
        F = col_update.update_columns_dense(data, R, F0, 30.0, 0.5, 1e-5)
    assert F.shape == (K, M) and bool(torch.isfinite(F).all())


def _inputs(N, K, M, seed):
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((N, K)).astype(np.float32)
    mask = (rng.random((N, M)) > 0.1).astype(np.float32)
    data = rng.standard_normal((N, M)).astype(np.float32)
    beta0 = (0.01 * rng.standard_normal((K, M))).astype(np.float32)
    return R, mask, data, beta0


T = torch.from_numpy
LAM, ALPHA, TOL = 11.0, 0.4, dict(rtol=2e-5, atol=1e-5)


def test_masked_update_k72_matches_pallas_kernel():
    """K = 72 > 64: the streamed route (col_gram_xty, then feature_sign)
    against the JAX streamed FSS kernel on the same grams."""
    K, N, M = 72, 90, 40
    R, mask, data, F0 = _inputs(N, K, M, seed=72)
    got = col_update.update_columns_masked(T(data), T(mask), T(R), T(F0),
                                           LAM, ALPHA, 1e-8,
                                           max_fss_polish_sweeps=16)
    G, xty = col_gram_xty(T(mask), T(data), T(R))
    want = feature_sign_pallas(jnp.asarray(G.numpy()),
                               jnp.asarray(xty.numpy()), jnp.asarray(F0),
                               LAM, ALPHA, 48, polish_sweeps=16,
                               tol=jnp.float32(1e-8), interpret=True,
                               block=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert int((got == 0).sum()) > 0


def test_dense_update_k72_matches_jax():
    """K = 72 > 64, dense: the port's update against the JAX package's jnp
    update_columns_dense (FSS, then a randomly permuted plain-CD polish),
    both polished to a tight tolerance, so they agree at the optimum."""
    K, N, M = 72, 90, 40
    R, _, data, F0 = _inputs(N, K, M, seed=73)
    lam, alpha, tol = 30.0, 0.4, 1e-10
    got = col_update.update_columns_dense(T(data), T(R), T(F0), lam, alpha,
                                          tol, max_fss_polish_sweeps=200)
    want, _, _ = jax_col_update.update_columns_dense(
        jnp.asarray(data), jnp.asarray(R), jnp.asarray(F0), lam, alpha,
        jnp.float32(tol), jax.random.PRNGKey(0), use_pallas=False,
        solver="fss", max_fss_polish_sweeps=200)
    want = np.asarray(want)
    Rd, Xd = R.astype(np.float64), data.astype(np.float64)
    G, b = Rd.T @ Rd, Rd.T @ Xd

    def objective(B):
        B = B.astype(np.float64)
        return (0.5 * np.einsum("km,kl,lm->m", B, G, B) - (b * B).sum(0)
                + lam * (1 - alpha) / 2 * (B * B).sum(0)
                + lam * alpha * np.abs(B).sum(0))

    np.testing.assert_allclose(objective(got.numpy()), objective(want),
                               rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert int((got == 0).sum()) > 0


def _objective_np(B, G, b, lam, alpha):
    """Every column's elastic-net objective in f64; G (K, K) shared or
    (M, K, K) per column, b (K, M)."""
    B = B.astype(np.float64)
    GB = (np.einsum("kl,lm->km", G, B) if G.ndim == 2
          else np.einsum("mkl,lm->km", G, B))
    return (0.5 * (B * GB).sum(0) - (b * B).sum(0)
            + lam * (1 - alpha) / 2 * (B * B).sum(0)
            + lam * alpha * np.abs(B).sum(0))


@pytest.mark.parametrize("update", ["masked", "dense"])
def test_column_update_k136_on_cpu_matches_jax(update):
    """K = 136 > 128 on the CPU: the port's masked and dense column updates
    (plain versions) against the JAX package's update_columns_masked /
    update_columns_dense on its CPU path (use_pallas=False: FSS, then a
    randomly permuted plain-CD polish), both polished to a tight tolerance.
    The two solve the same strictly convex problem by different iterations,
    so they are held to each column's objective, within 1e-6 relative."""
    K, N, M = 136, 120, 40
    R, mask, data, F0 = _inputs(N, K, M, seed=136)
    lam, alpha, tol = 30.0, 0.4, 1e-10
    kw = dict(use_pallas=False, solver="fss", max_fss_polish_sweeps=400)
    Rd = R.astype(np.float64)
    if update == "masked":
        got = col_update.update_columns_masked(
            T(data), T(mask), T(R), T(F0), lam, alpha, tol,
            max_fss_polish_sweeps=400)
        want = jax_col_update.update_columns_masked(
            jnp.asarray(data), jnp.asarray(mask), jnp.asarray(R),
            jnp.asarray(F0), lam, alpha, jnp.float32(tol),
            jax.random.PRNGKey(0), **kw)[0]
        G = np.einsum("im,ik,il->mkl", mask.astype(np.float64), Rd, Rd)
        b = Rd.T @ (mask * data).astype(np.float64)
    else:
        got = col_update.update_columns_dense(T(data), T(R), T(F0), lam,
                                              alpha, tol,
                                              max_fss_polish_sweeps=400)
        want = jax_col_update.update_columns_dense(
            jnp.asarray(data), jnp.asarray(R), jnp.asarray(F0), lam, alpha,
            jnp.float32(tol), jax.random.PRNGKey(0), **kw)[0]
        G, b = Rd.T @ Rd, Rd.T @ data.astype(np.float64)
    assert got.shape == (K, M)
    np.testing.assert_allclose(_objective_np(got.numpy(), G, b, lam, alpha),
                               _objective_np(np.asarray(want), G, b, lam,
                                             alpha), rtol=1e-6)
    assert int((got == 0).sum()) > 0


def test_fit_on_the_card_checks_the_rank_before_its_first_iteration(
        monkeypatch):
    """optimize() on a problem that lies on a CUDA device raises ValueError
    for K = 129 before it evaluates, draws or iterates anything.  Runs
    without a card: the problem (on the CPU) reports a CUDA device, and
    every step a fit would take first is replaced by one that fails."""
    from insider_tpu_torch.config import FitConfig
    from insider_tpu_torch.train import als

    rng = np.random.default_rng(0)
    N, M = 30, 12
    problem = als.build_problem(
        rng.standard_normal((N, M)), rng.integers(0, 3, (N, 2)),
        np.ones((N, M)), np.zeros((N, M)), masked=True, device="cpu")

    def ran(*args, **kw):
        raise AssertionError("the fit ran before checking the rank")

    monkeypatch.setattr(als.Problem, "device",
                        property(lambda self: torch.device("cuda")))
    for name in ("init_state", "_evaluate", "_als_iteration"):
        monkeypatch.setattr(als, name, ran)
    for K in (129, 200):
        with pytest.raises(ValueError, match="128"):
            als.optimize(problem, FitConfig(latent_dim=K, lambda1=1.0,
                                            lambda2=1.0, alpha=0.5),
                         verbose=False)
    with pytest.raises(AssertionError, match="before checking"):
        als.optimize(problem, FitConfig(latent_dim=128, lambda1=1.0,
                                        lambda2=1.0, alpha=0.5),
                     generator=torch.Generator(), verbose=False)
