"""The port's FSS kernels on precomputed grams (insider_tpu_torch/kernels/
fss.py: feature_sign on streamed (K, K, M) grams, feature_sign_shared on one
(K, K) gram) against the JAX package's Pallas kernels, and the masked
column update's dispatch by K.

On CPU tensors the wrappers run their plain version (ops/fss.py, which
follows the TPU kernel's iteration); the Pallas kernels run in interpret
mode.  Tolerance: rtol 2e-5, atol 1e-5 on beta, as the JAX package's
fused-vs-streamed and shared-vs-streamed kernel tests
(tests/test_fss.py:293-317, :353-379).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insider_tpu.kernels.fss_pallas import (feature_sign_pallas,
                                            feature_sign_shared_pallas)
from insider_tpu_torch.kernels.fss import feature_sign, feature_sign_shared
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
    K, N, M = 65, 70, 10
    R, data = torch.zeros((N, K)), torch.zeros((N, M))
    F0 = torch.zeros((K, M))
    with pytest.raises(ValueError, match="64"):
        if update == "masked":
            col_update.update_columns_masked(data, torch.ones((N, M)), R, F0,
                                             1.0, 0.5, 1e-5)
        else:
            col_update.update_columns_dense(data, R, F0, 1.0, 0.5, 1e-5)
