"""The port's glm_interaction against the JAX package and a f64 OLS oracle,
and its regularized incomplete beta against scipy.

Coefficients rtol 1e-4 / atol 1e-6 (f32 closed form both sides, sums in
other orders); p-values at tests/test_glm.py's rtol 5e-3 / atol 2e-4 (the
JAX package evaluates the Student-t tail in f32, the port in f64).  The
copied betainc is held to scipy.special.betainc at rtol 1e-10 over the
Student-t's b = 1/2, for a = dof / 2 from 0.5 to 5e6: at the flagship shape
dof reaches ~10^6.
"""

import numpy as np
import pytest
import scipy.special
from scipy import stats

import insider_tpu_torch as itt
from insider_tpu.analysis.glm import glm_interaction as jax_glm
from insider_tpu_torch.analysis.glm import betainc, glm_interaction


def _oracle(residual, codes, F):
    """tests/test_glm.py's oracle: the stacked per-level design in f64."""
    K, M = F.shape
    levels = np.unique(codes)
    coeffs = np.zeros((levels.size, K))
    pvals = np.zeros((levels.size, K))
    for li, lv in enumerate(levels):
        ids = np.flatnonzero(codes == lv)
        X = np.tile(F.T, (ids.size, 1))
        y = residual[ids].reshape(-1)
        beta, *_ = np.linalg.lstsq(X, y, rcond=None)
        resid = y - X @ beta
        dof = y.size - K
        sigma2 = resid @ resid / dof
        se = np.sqrt(sigma2 * np.diag(np.linalg.inv(X.T @ X)))
        pvals[li] = 2 * stats.t.sf(np.abs(beta / se), dof)
        coeffs[li] = beta
    return coeffs, pvals


def _inputs(seed, N, M, K, L, signal=0.0):
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((K, M))
    codes = rng.integers(1, L + 1, N)
    codes[:L] = np.arange(1, L + 1)
    beta = signal * rng.standard_normal((L, K))
    residual = beta[codes - 1] @ F + rng.standard_normal((N, M))
    return residual, codes, F


CASES = [(0, 24, 40, 3, 4, 0.0), (1, 60, 200, 6, 5, 0.05),
         (2, 120, 300, 8, 16, 0.02)]


@pytest.mark.parametrize("case", CASES[:2])
def test_glm_matches_jax(case):
    residual, codes, F = _inputs(*case)
    coef, pval = glm_interaction(residual, None, codes, F, device="cpu")
    jcoef, jpval = jax_glm(residual, None, codes, F)
    np.testing.assert_allclose(coef, np.asarray(jcoef), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(pval, np.asarray(jpval), rtol=5e-3, atol=2e-4)


def test_glm_at_larger_dof_matches_jax_coefficients():
    """At dof ~ 2000 (7 rows of 300 genes a level) the JAX package's f32
    argument x = dof / (dof + t^2) no longer resolves small t (f32 spacing
    6e-8 below 1): its p-values stray from the f64 oracle by up to 1.9e-3,
    past test_glm.py's atol 2e-4, while the port's, in f64 from the same f32
    t, stay within 1e-6 of it.  So the coefficients are held to the JAX
    package, the p-values to the oracle."""
    residual, codes, F = _inputs(*CASES[2])
    coef, pval = glm_interaction(residual, None, codes, F, device="cpu")
    jcoef, jpval = jax_glm(residual, None, codes, F)
    np.testing.assert_allclose(coef, np.asarray(jcoef), rtol=1e-4, atol=1e-6)
    _, pval_o = _oracle(residual, codes, F)
    np.testing.assert_allclose(pval, pval_o, rtol=0, atol=1e-6)
    assert np.abs(np.asarray(jpval) - pval_o).max() > 2e-4


@pytest.mark.parametrize("case", CASES)
def test_glm_matches_ols_oracle(case):
    residual, codes, F = _inputs(*case)
    coef, pval = glm_interaction(residual, None, codes, F, device="cpu")
    coef_o, pval_o = _oracle(residual, codes, F)
    np.testing.assert_allclose(coef, coef_o, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(pval, pval_o, rtol=5e-3, atol=2e-4)
    assert np.all((pval >= 0) & (pval <= 1))


def test_glm_exported_shapes_and_determinism():
    residual, codes, F = _inputs(3, 12, 15, 2, 3)
    a = itt.glm_interaction(residual, None, codes, F, device="cpu")
    b = itt.glm_interaction(residual, None, codes, F, 1e-10, 10,
                            device="cpu")
    assert a[0].shape == (3, 2) and a[1].shape == (3, 2)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("a", [0.5, 1.0, 2.5, 9.5, 14.9, 15.0, 60.0, 1e3,
                               4.7e4, 5e5, 2e6, 5e6])
def test_betainc_matches_scipy(a):
    """At x = dof / (dof + t^2) over |t| from 0 to 60: the p-values'
    arguments, out to where they underflow."""
    t = np.concatenate([[0.0], np.geomspace(1e-3, 60.0, 80)])
    x = 2 * a / (2 * a + t * t)
    got = betainc(a, 0.5, x)
    want = scipy.special.betainc(a, 0.5, x)
    keep = want > 1e-290
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-10, atol=0)


def test_betainc_other_arguments():
    rng = np.random.default_rng(0)
    a = 10 ** rng.uniform(-0.3, 6.7, 2000)
    b = rng.choice([0.5, 1.0, 3.0], 2000)
    x = rng.random(2000)
    got, want = betainc(a, b, x), scipy.special.betainc(a, b, x)
    keep = want > 1e-290
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-10, atol=0)
    edge = betainc([2.0, 2.0, -1.0, 2.0], 0.5, [0.0, 1.0, 0.5, 1.5])
    np.testing.assert_array_equal(edge[:2], [0.0, 1.0])
    assert np.isnan(edge[2:]).all()
