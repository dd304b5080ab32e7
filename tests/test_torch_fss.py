"""The port's fused FSS column kernel (insider_tpu_torch/kernels/fss.py) and
its plain FSS (ops/fss.py) against the JAX package, on the same numpy
inputs.  On CPU tensors the wrapper runs its plain version.

The port follows the TPU kernel's iteration (fss_pallas.py:_fss_compute),
so the kernel comparison is on beta itself, at the tolerance of the JAX
package's fused-vs-streamed kernel test (tests/test_fss.py:293-317): rtol
2e-5, atol 1e-5.  The JAX jnp FSS (ops/fss.feature_sign_batched) computes
its gradient and picks its violator in another form, so against it the
comparison is on the per-column objective.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insider_tpu.kernels.fss_pallas import feature_sign_fused_pallas
from insider_tpu.ops.col_update import col_gram_masked as jax_col_gram
from insider_tpu.ops.fss import feature_sign_batched
from insider_tpu_torch.kernels.fss import feature_sign_fused
from insider_tpu_torch.ops.col_update import col_gram_masked
from insider_tpu_torch.ops.fss import feature_sign_search

HI = jax.lax.Precision.HIGHEST


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(N, K, M, seed):
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((N, K)).astype(np.float32)
    mask = (rng.random((N, M)) > 0.1).astype(np.float32)
    data = rng.standard_normal((N, M)).astype(np.float32)
    beta0 = (0.01 * rng.standard_normal((K, M))).astype(np.float32)
    return R, mask, data, beta0


def _objective(B, G, b, lam, alpha):
    """Per-column elastic-net objective in f64.  G (M, K, K), b (K, M)."""
    B = np.asarray(B, np.float64)
    G = np.asarray(G, np.float64)
    b = np.asarray(b, np.float64)
    q = 0.5 * np.einsum("km,mkl,lm->m", B, G, B) - np.einsum("km,km->m", b, B)
    return (q + lam * (1 - alpha) / 2 * np.sum(B * B, 0)
            + lam * alpha * np.sum(np.abs(B), 0))


@pytest.mark.parametrize("K,lam,alpha", [(6, 2.0, 0.5), (13, 11.0, 0.4)])
def test_fused_matches_pallas_kernel(K, lam, alpha):
    N, M = 45, 700
    R, mask, data, beta0 = _inputs(N, K, M, seed=7 + K)
    want = feature_sign_fused_pallas(
        jnp.asarray(mask), jnp.asarray(mask * data), jnp.asarray(R),
        jnp.asarray(beta0), lam, alpha, 32, polish_sweeps=16,
        tol=jnp.float32(1e-9), interpret=True, block=512)
    got = feature_sign_fused(torch.from_numpy(mask), torch.from_numpy(data),
                             torch.from_numpy(R), torch.from_numpy(beta0),
                             lam, alpha, max_outer=32, polish_sweeps=16,
                             tol=1e-9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=1e-5)
    assert int((got == 0).sum()) > 0     # lasso zeros are exact


@pytest.mark.parametrize("lam,alpha", [(3.0, 0.6), (1.0, 0.3)])
def test_plain_fss_matches_jnp_fss_objective(lam, alpha):
    """Without the polish, both FSS forms reach the same per-column optimum
    (up to the f32 KKT slack): objectives agree to 1e-5 relative."""
    N, K, M = 50, 8, 400
    R, mask, data, beta0 = _inputs(N, K, M, seed=3)
    xty = (R.T.astype(np.float64) @ (mask * data)).astype(np.float32)
    G_j = jax_col_gram(jnp.asarray(R), jnp.asarray(mask))
    bj, _ = feature_sign_batched(G_j, jnp.asarray(xty), jnp.asarray(beta0),
                                 lam, alpha, max_outer=48)
    G_t = col_gram_masked(torch.from_numpy(R), torch.from_numpy(mask))
    bt = feature_sign_search(G_t.permute(1, 2, 0), torch.from_numpy(xty),
                             torch.from_numpy(beta0), lam, alpha,
                             max_outer=48)
    G = G_t.numpy()
    oj = _objective(bj, G, xty, lam, alpha)
    ot = _objective(bt.numpy(), G, xty, lam, alpha)
    np.testing.assert_allclose(ot, oj, rtol=1e-5,
                               atol=1e-5 * float(np.abs(oj).max()))


def test_col_gram_matches_jax():
    R, mask, _, _ = _inputs(30, 5, 90, seed=5)
    want = jax_col_gram(jnp.asarray(R), jnp.asarray(mask))
    got = col_gram_masked(torch.from_numpy(R), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)
