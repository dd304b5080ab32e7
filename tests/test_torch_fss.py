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
from insider_tpu_torch.ops.fss import _active_solve, feature_sign_search

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


def _compact_solve(G, act, rhs, l2):
    """The CUDA kernels' active solve (csrc/fss_core.cuh: active_solve_regs,
    active_solve_shared) emulated in torch, one column at a time: the
    forward elimination and back substitution of _active_solve over the
    active coordinates only, in ascending order, with the same operations
    (x - colk * y) in the same order.  Inactive coordinates solve to 0."""
    K, M = rhs.shape
    out = torch.zeros_like(rhs)
    for j in range(M):
        A = torch.nonzero(act[:, j] > 0.5).flatten()
        a = A.numel()
        U = G[:, :, j][A][:, A].clone()
        ii = torch.arange(a)
        U[ii, ii] = U[ii, ii] + l2
        x = rhs[A, j].clone()
        for p in range(a):
            inv = 1.0 / U[p, p]
            rowp = U[p] * inv
            xp = x[p] * inv
            U[p] = rowp
            x[p] = xp
            colk = U[p + 1:, p].clone()
            U[p + 1:] = U[p + 1:] - colk[:, None] * rowp[None, :]
            x[p + 1:] = x[p + 1:] - colk * xp
        for k in range(a - 1, 0, -1):
            x[:k] = x[:k] - U[:k, k] * x[k]
        out[A, j] = x
    return out


# random SPD grams; per column an active set that is empty, one coordinate,
# all of them, or scattered; K up to 70 (the kernels' shared-memory path
# takes active sets above 32)
@pytest.mark.parametrize("K,M,l2", [(1, 4, 0.5), (6, 40, 0.0), (24, 60, 6.6),
                                    (50, 24, 0.5), (70, 12, 1.0)])
def test_compacted_elimination_is_bit_for_bit(K, M, l2):
    """Skipping the inactive pivots and rows, as the kernels do, computes
    the full-width elimination's values bit for bit: an inactive pivot or
    row only ever subtracts exact zeros."""
    rng = np.random.default_rng(K * 100 + M)
    X = rng.standard_normal((3 * K + 5, K, M)).astype(np.float32)
    G = torch.from_numpy(np.einsum("nkm,nlm->klm", X, X))
    act = (rng.random((K, M)) < rng.random(M)).astype(np.float32)
    act[:, 0] = 0.0
    act[:, 1 % M] = 1.0
    act[:, 2 % M] = 0.0
    act[rng.integers(K), 2 % M] = 1.0
    act = torch.from_numpy(act)
    rhs = torch.from_numpy(rng.standard_normal((K, M)).astype(np.float32))
    want = _active_solve(G, act, rhs, l2)
    got = _compact_solve(G, act, rhs, l2)
    assert torch.equal(got[act > 0.5], want[act > 0.5])
    assert not bool(want[act < 0.5].any())
    assert bool(torch.isfinite(got).all())
