"""The port's cold strong-rule coordinate descent (CD) against the JAX
package's CD kernels, and its cold-CD column updates (given a coordinate
order) against the JAX ones with solver="cd", cd_warm_start=False.

On CPU tensors the wrappers of insider_tpu_torch/kernels/cd.py run their
plain version (ops/fss.elastic_net_cd, which follows the TPU kernel's
iteration); the Pallas kernels run in interpret mode on the same inputs,
pre-permuted where the JAX dispatch permutes them.  Tolerance: rtol 2e-5,
atol 1e-5 on beta, as the JAX package's CD kernel tests
(tests/test_cd_pallas.py:174-175, :210-211).  Sweep caps are short: the
comparison is of one iteration, not of a converged optimum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import insider_tpu.kernels.cd_packed as cdpk
import insider_tpu.kernels.cd_pallas as cdp
import insider_tpu.kernels.gram_pallas as gp
from insider_tpu.ops import col_update as jax_col_update
from insider_tpu_torch.config import FitConfig
from insider_tpu_torch.kernels import cd
from insider_tpu_torch.ops import col_update
from insider_tpu_torch.train import als

TOL = dict(rtol=2e-5, atol=1e-5)
LAM, ALPHA, CD_TOL, SWEEPS = 11.0, 0.4, 1e-8, 40


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(N, K, M, seed):
    """R, mask, data and a warm start near zero, f32."""
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((N, K)).astype(np.float32)
    mask = (rng.random((N, M)) > 0.1).astype(np.float32)
    data = rng.standard_normal((N, M)).astype(np.float32)
    beta0 = (0.01 * rng.standard_normal((K, M))).astype(np.float32)
    return R, mask, data, beta0


def _grams(R, mask, data):
    """f32 per-gene grams (K, K, M) and Xty, summed in f64."""
    R, mask, data = (x.astype(np.float64) for x in (R, mask, data))
    G = np.einsum("ij,ik,il->klj", mask, R, R).astype(np.float32)
    return G, (R.T @ (mask * data)).astype(np.float32)


def _jax_kw():
    return dict(max_sweeps=SWEEPS, interpret=True)


T = torch.from_numpy


def _fused_pallas(packed, R, mask, data, beta0, lam, alpha, tol):
    fn = (cdpk.elastic_net_cd_fused_packed_pallas if packed
          else cdp.elastic_net_cd_fused_pallas)
    return np.asarray(fn(jnp.asarray(mask), jnp.asarray(mask * data),
                         jnp.asarray(R), jnp.asarray(beta0), lam, alpha,
                         jnp.float32(tol), **_jax_kw()))


# K = 1, 8, 17, 24, 32: every width of the card kernel's coordinates a lane
# (tests/test_torch_cuda.py: test_cd_fused)
@pytest.mark.parametrize("K", [1, 8, 17, 24, 32])
@pytest.mark.parametrize("packed", [True, False])
def test_cd_fused_matches_pallas_kernel(K, packed):
    R, mask, data, beta0 = _inputs(80, K, 300, seed=K)
    want = _fused_pallas(packed, R, mask, data, beta0, LAM, ALPHA, CD_TOL)
    n0 = cd.cd_fused.launches
    got = cd.cd_fused(T(mask), T(data), T(R), T(beta0), LAM, ALPHA, CD_TOL,
                      SWEEPS)
    assert cd.cd_fused.launches == n0          # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert int((got == 0).sum()) > 0           # lasso zeros are exact


def _staggered_masked(N, K, M, seed):
    """R, mask, data and a warm start in which neighbouring columns stop at
    very different sweeps: every even column has data = 0 (Xty = 0, every
    coordinate screened: it converges after one sweep), every odd one
    correlated coordinates, on which CD at tol 0 is still moving at the
    cap.  The card kernel hands a converged group the next column in
    mid-flight (refill): this is the case it schedules.  The plain
    version's matmuls round by M in the last bits, which a nearly singular
    gram would amplify past the tolerance over the sweeps; the coordinates'
    own parts (0.5) keep the grams far from singular."""
    rng = np.random.default_rng(seed)
    R = (rng.standard_normal((N, 1))
         + 0.5 * rng.standard_normal((N, K))).astype(np.float32)
    mask = (rng.random((N, M)) > 0.1).astype(np.float32)
    data = rng.standard_normal((N, M)).astype(np.float32)
    data[:, ::2] = 0.0
    beta0 = (0.01 * rng.standard_normal((K, M))).astype(np.float32)
    return R, mask, data, beta0


@pytest.mark.parametrize("K", [5, 24])
def test_cd_fused_columns_are_independent(K):
    """Each column of a batch comes out as it does solved alone, at the JAX
    tolerance (the card kernel runs several columns on one warp and refills
    converged groups, and is held to the same bits on the card,
    tests/test_torch_cuda.py), and the batch agrees with the JAX fused
    kernel."""
    M, lam, alpha, tol = 9, 0.05, 0.5, 0.0
    R, mask, data, beta0 = _staggered_masked(3 * K + 20, K, M, seed=40 + K)
    got = cd.cd_fused(T(mask), T(data), T(R), T(beta0), lam, alpha, tol,
                      SWEEPS)
    fewer = cd.cd_fused(T(mask), T(data), T(R), T(beta0), lam, alpha, tol,
                        SWEEPS - 1)
    assert float(got[:, ::2].abs().max()) == 0.0
    assert not any(torch.equal(got[:, j], fewer[:, j])
                   for j in range(1, M, 2))          # at the cap
    for j in range(M):
        alone = cd.cd_fused(T(mask[:, j:j + 1].copy()),
                            T(data[:, j:j + 1].copy()), T(R),
                            T(beta0[:, j:j + 1].copy()), lam, alpha, tol,
                            SWEEPS)
        np.testing.assert_allclose(alone[:, 0].numpy(), got[:, j].numpy(),
                                   **TOL, err_msg=str(j))
    want = _fused_pallas(False, R, mask, data, beta0, lam, alpha, tol)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("K", [6, 40])
@pytest.mark.parametrize("packed", [True, False])
def test_cd_streamed_matches_pallas_kernel(K, packed):
    R, mask, data, beta0 = _inputs(60, K, 150, seed=K)
    G, xty = _grams(R, mask, data)
    fn = (cdpk.elastic_net_cd_packed_pallas if packed
          else cdp.elastic_net_cd_pallas)
    want = fn(jnp.asarray(G), jnp.asarray(xty), jnp.asarray(beta0), LAM,
              ALPHA, jnp.float32(CD_TOL), **_jax_kw())
    got = cd.cd_streamed(T(G), T(xty), T(beta0), LAM, ALPHA, CD_TOL, SWEEPS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert int((got == 0).sum()) > 0


def _staggered(K, M, seed):
    """Per-gene grams (f32, summed in f64), Xty and a warm start in which
    neighbouring columns stop at very different sweeps: every even column
    has Xty = 0 (every coordinate screened: it converges after one sweep),
    every odd one strongly correlated coordinates, on which CD at tol 0 is
    still moving at the cap."""
    rng = np.random.default_rng(seed)
    N = 3 * K
    R = rng.standard_normal((N, 1)) + 0.1 * rng.standard_normal((N, K))
    mask = rng.random((N, M)) > 0.1
    G = np.einsum("ij,ik,il->klj", mask, R, R).astype(np.float32)
    xty = (R.T @ (mask * rng.standard_normal((N, M)))).astype(np.float32)
    xty[:, ::2] = 0.0
    beta0 = (0.01 * rng.standard_normal((K, M))).astype(np.float32)
    return G, xty, beta0


@pytest.mark.parametrize("K", [6, 40])
def test_cd_streamed_columns_are_independent(K):
    """Each column of a batch comes out as it does solved alone, at the JAX
    tolerance (the card kernel runs several columns on one warp in lockstep
    and is held to the same bits; tests/test_torch_cuda.py; the plain
    version's first s = G beta sums in an order torch picks by M, so its
    bits may differ), and the batch agrees with the JAX kernel."""
    M, lam, alpha, tol = 9, 0.05, 0.5, 0.0
    G, xty, beta0 = _staggered(K, M, seed=30 + K)
    got = cd.cd_streamed(T(G), T(xty), T(beta0), lam, alpha, tol, SWEEPS)
    fewer = cd.cd_streamed(T(G), T(xty), T(beta0), lam, alpha, tol,
                           SWEEPS - 1)
    assert float(got[:, ::2].abs().max()) == 0.0
    assert not any(torch.equal(got[:, j], fewer[:, j])
                   for j in range(1, M, 2))          # at the cap
    for j in range(M):
        alone = cd.cd_streamed(T(G[:, :, j:j + 1].copy()),
                               T(xty[:, j:j + 1].copy()),
                               T(beta0[:, j:j + 1].copy()), lam, alpha, tol,
                               SWEEPS)
        np.testing.assert_allclose(alone[:, 0].numpy(), got[:, j].numpy(),
                                   **TOL, err_msg=str(j))
    want = cdp.elastic_net_cd_pallas(jnp.asarray(G), jnp.asarray(xty),
                                     jnp.asarray(beta0), lam, alpha,
                                     jnp.float32(tol), **_jax_kw())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cd_shared_matches_pallas_kernel():
    rng = np.random.default_rng(3)
    N, K, M = 60, 8, 200
    R = rng.standard_normal((N, K))
    data = rng.standard_normal((N, M))
    XtX = (R.T @ R).astype(np.float32)
    xty = (R.T @ data).astype(np.float32)
    beta0 = (0.01 * rng.standard_normal((K, M))).astype(np.float32)
    want = cdp.elastic_net_cd_shared_pallas(
        jnp.asarray(XtX), jnp.asarray(xty), jnp.asarray(beta0), 30.0, ALPHA,
        jnp.float32(CD_TOL), **_jax_kw())
    got = cd.cd_shared(T(XtX), T(xty), T(beta0), 30.0, ALPHA, CD_TOL, SWEEPS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert int((got == 0).sum()) > 0


@pytest.fixture()
def interpret_cd(monkeypatch):
    """The JAX package's CD and gram kernels in interpret mode."""
    for mod, name in ((cdpk, "elastic_net_cd_fused_packed_pallas"),
                      (cdpk, "elastic_net_cd_packed_pallas"),
                      (cdp, "elastic_net_cd_fused_pallas"),
                      (cdp, "elastic_net_cd_pallas"),
                      (cdp, "elastic_net_cd_shared_pallas"),
                      (gp, "col_gram_xty_pallas")):
        def interp(*args, _orig=getattr(mod, name), **kw):
            kw["interpret"] = True
            return _orig(*args, **kw)

        monkeypatch.setattr(mod, name, interp)
    yield


def _jax_perm(key, K):
    """The order the JAX dispatch draws (insider_tpu/ops/col_update.py:
    439-443, :545-546)."""
    _, sub = jax.random.split(key)
    return torch.from_numpy(np.array(jax.random.permutation(sub, K)))


@pytest.mark.parametrize("K", [6, 40])
def test_masked_cold_cd_update_matches_jax(interpret_cd, K):
    N, M = 60, 120
    R, mask, data, F0 = _inputs(N, K, M, seed=10 + K)
    key = jax.random.PRNGKey(K)
    want, _, _ = jax_col_update.update_columns_masked(
        jnp.asarray(data), jnp.asarray(mask), jnp.asarray(R), jnp.asarray(F0),
        LAM, ALPHA, jnp.float32(CD_TOL), key, max_sweeps=SWEEPS,
        use_pallas=True, solver="cd", cd_warm_start=False)
    got = col_update.update_columns_masked(
        T(data), T(mask), T(R), T(F0), LAM, ALPHA, CD_TOL,
        perm=_jax_perm(key, K), max_cd_sweeps=SWEEPS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dense_cold_cd_update_matches_jax(interpret_cd):
    N, K, M = 60, 8, 150
    R, _, data, F0 = _inputs(N, K, M, seed=20)
    key = jax.random.PRNGKey(3)
    want, _, _ = jax_col_update.update_columns_dense(
        jnp.asarray(data), jnp.asarray(R), jnp.asarray(F0), 30.0, ALPHA,
        jnp.float32(CD_TOL), key, max_sweeps=SWEEPS, use_pallas=True,
        solver="cd", cd_warm_start=False)
    got = col_update.update_columns_dense(
        T(data), T(R), T(F0), 30.0, ALPHA, CD_TOL,
        perm=_jax_perm(key, K), max_cd_sweeps=SWEEPS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _spy(monkeypatch, calls):
    for name in ("feature_sign_fused", "feature_sign", "feature_sign_shared",
                 "col_gram_xty", "cd_fused", "cd_streamed", "cd_shared"):
        def spy(*args, _name=name, _orig=getattr(col_update, name), **kw):
            calls.append(_name)
            return _orig(*args, **kw)

        monkeypatch.setattr(col_update, name, spy)


@pytest.mark.parametrize("K,alpha,warm,route", [
    (24, 0.4, False, ["cd_fused"]),
    (40, 0.4, False, ["col_gram_xty", "cd_streamed"]),
    (72, 0.4, False, ["col_gram_xty", "cd_streamed"]),
    (24, 0.4, True, ["feature_sign_fused"]),
    (24, 0.0, False, ["col_gram_xty"]),
])
def test_masked_cd_dispatch(monkeypatch, K, alpha, warm, route):
    """Cold CD takes the fused CD kernel for K <= 32 and the streamed route
    above; warm CD is FSS with its polish; alpha == 0 the ridge solve."""
    calls = []
    _spy(monkeypatch, calls)
    R, mask, data, F0 = _inputs(50, K, 40, seed=K)
    cfg = FitConfig(latent_dim=K, col_solver="cd", cd_warm_start=warm,
                    max_cd_sweeps=20)
    F = col_update.update_columns_masked(
        T(data), T(mask), T(R), T(F0), 5.0, alpha, 1e-6,
        **als._col_kw(cfg, torch.randperm(K)))
    assert calls == route
    assert F.shape == (K, 40) and F.is_contiguous()
    assert bool(torch.isfinite(F).all())


def test_dense_cd_dispatch(monkeypatch):
    calls = []
    _spy(monkeypatch, calls)
    R, _, data, F0 = _inputs(50, 12, 30, seed=4)
    for warm in (False, True):
        cfg = FitConfig(latent_dim=12, col_solver="cd", cd_warm_start=warm,
                        max_cd_sweeps=20)
        col_update.update_columns_dense(
            T(data), T(R), T(F0), 5.0, 0.4, 1e-6,
            **als._col_kw(cfg, torch.randperm(12)))
    assert calls == ["cd_shared", "feature_sign_shared"]


def test_warm_cd_is_fss_with_a_long_polish():
    """col_solver="cd" with cd_warm_start is FSS plus a polish of up to
    max_cd_sweeps sweeps (insider_tpu/ops/col_update.py:402-416), whatever
    fss_polish says."""
    R, mask, data, F0 = _inputs(50, 6, 80, seed=5)
    args = (T(data), T(mask), T(R), T(F0), 5.0, 0.4, 1e-9)
    cfg = FitConfig(latent_dim=6, col_solver="cd", max_cd_sweeps=77,
                    fss_polish=False)
    a = col_update.update_columns_masked(*args, **als._col_kw(cfg, None))
    b = col_update.update_columns_masked(*args, fss_polish=True,
                                         max_fss_polish_sweeps=77)
    assert torch.equal(a, b)


def test_cold_cd_needs_an_order():
    """Cold CD runs in the order it is given: the kernel sweeps the
    permuted problem in fixed order and the update un-permutes it."""
    R, mask, data, F0 = _inputs(20, 4, 10, seed=6)
    cfg = FitConfig(latent_dim=4, col_solver="cd", cd_warm_start=False,
                    max_cd_sweeps=20)
    perm = torch.tensor([2, 0, 3, 1])
    kw = als._col_kw(cfg, perm)
    assert kw == dict(perm=perm, max_cd_sweeps=20)
    got = col_update.update_columns_masked(T(data), T(mask), T(R), T(F0),
                                           5.0, 0.4, 1e-6, **kw)
    want = cd.cd_fused(T(mask), T(data), T(R)[:, perm].contiguous(),
                       T(F0)[perm].contiguous(), 5.0, 0.4, 1e-6, 20)
    assert torch.equal(got, want[torch.argsort(perm)])

