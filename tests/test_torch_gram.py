"""The port's streamed column-gram builder (insider_tpu_torch/kernels/gram.py)
and the plain form of its kernel's arithmetic (ops/planes.planes_col_gram_xty)
against the JAX package's Pallas kernel, on the same numpy inputs.

On CPU tensors the wrapper runs its plain version; the Pallas kernel runs in
interpret mode.  Ragged N (neither the Pallas kernel's row chunk nor the
CUDA kernel's k-step of 16 divides it) and uint8 masks, at the tolerance of
tests/test_gram_pallas.py: atol 3e-5 of each output's largest magnitude.
The planes form and the plain version are also held to the f64 sums: max
error <= 1e-6 of the largest magnitude, and every entry's error <= 1e-6 of
its own sum of |terms| (COL_GRAM_RTOL, the gates chip_smoke.py holds the
kernel to), bounds that one bf16 plane of the table does not meet; their
grams are symmetric bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insider_tpu.kernels.gram_pallas import col_gram_xty_pallas
from insider_tpu_torch.kernels.gram import col_gram_xty, col_gram_xty_plain
from insider_tpu_torch.ops.planes import bf16_planes, planes_col_gram_xty

COL_GRAM_RTOL = 1e-6    # of the f64 sums' max magnitude, and of each entry's
                        # sum of |terms|


def _inputs(K, mask_dtype, N=45, M=150):
    rng = np.random.default_rng(K)
    R = (0.4 * rng.standard_normal((N, K))).astype(np.float32)
    mask = (rng.random((N, M)) < 0.9).astype(mask_dtype)
    data = rng.standard_normal((N, M)).astype(np.float32)
    return R, mask, data


def _assert_matches_pallas(got, R, mask, data):
    want = col_gram_xty_pallas(jnp.asarray(mask), jnp.asarray(data),
                               jnp.asarray(R), interpret=True)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=3e-5 * float(np.abs(w).max()))


@pytest.mark.parametrize("K", [6, 40])
@pytest.mark.parametrize("mask_dtype", [np.float32, np.uint8])
def test_col_gram_xty_matches_pallas_kernel(K, mask_dtype):
    R, mask, data = _inputs(K, mask_dtype)
    got = col_gram_xty(torch.from_numpy(mask), torch.from_numpy(data),
                       torch.from_numpy(R))
    assert got[0].shape == (K, K, 150) and got[1].shape == (K, 150)
    _assert_matches_pallas(got, R, mask, data)


@pytest.mark.parametrize("K", [6, 33, 50])
@pytest.mark.parametrize("mask_dtype", [np.float32, np.uint8])
def test_planes_col_gram_xty_matches_pallas_kernel(K, mask_dtype):
    R, mask, data = _inputs(K, mask_dtype)
    got = planes_col_gram_xty(torch.from_numpy(mask), torch.from_numpy(data),
                              torch.from_numpy(R))
    _assert_matches_pallas(got, R, mask, data)


@pytest.mark.parametrize("form", ["planes", "plain"])
@pytest.mark.parametrize("K", [6, 33, 50])
@pytest.mark.parametrize("mask_dtype", [np.float32, np.uint8])
def test_col_gram_xty_f64_gate(K, mask_dtype, form):
    """Grams and Xty of the planes form and of the plain version within
    COL_GRAM_RTOL of the f64 sums' largest magnitude; the one-plane control
    (the sums over the table's hi plane alone) exceeds it; the grams are
    symmetric bit for bit."""
    R, mask, data = (torch.from_numpy(x) for x in _inputs(K, mask_dtype))
    fn = planes_col_gram_xty if form == "planes" else col_gram_xty_plain
    gram, xty = fn(mask, data, R)
    exact = col_gram_xty_plain(mask.double(), data.double(), R.double())
    for got, ref in zip((gram, xty), exact):
        err = float((got.double() - ref).abs().max())
        assert err <= COL_GRAM_RTOL * float(ref.abs().max())
    k1, k2 = torch.triu_indices(K, K)
    hi = bf16_planes((R[:, k1] * R[:, k2]).T.contiguous())[0].double()
    control = hi @ mask.double()
    err = float((control - exact[0][k1, k2]).abs().max())
    assert err > COL_GRAM_RTOL * float(exact[0].abs().max())
    assert torch.equal(gram, gram.transpose(0, 1))


def _entry_errors(got, mask, data, R):
    """Each entry's error against the f64 sum, as a fraction of its own sum
    of |terms| (sum_i mask_ij |R_ik R_il|, sum_i |R_ik mask_ij data_ij|):
    the largest, for the grams and for Xty."""
    m, d, r = mask.double(), data.double(), R.double()
    exact = col_gram_xty_plain(m, d, r)
    scale = (torch.einsum("im,ik,il->klm", m, r.abs(), r.abs()),
             r.abs().T @ (m * d).abs())
    return [float(((g.double() - e).abs() / s.clamp(min=1e-300)).max())
            for g, e, s in zip(got, exact, scale)]


@pytest.mark.parametrize("N", [1, 16, 45])
@pytest.mark.parametrize("form", ["planes", "plain"])
def test_col_gram_xty_entry_gate(N, form):
    """Every entry of the planes form and of the plain version within
    COL_GRAM_RTOL of its own sum of |terms|, with entries of many
    magnitudes (R's columns scaled by 10^-3 .. 10^3, so a pair's terms and
    sums span many binades); the one-plane control exceeds it."""
    rng = np.random.default_rng(N)
    K, M = 9, 120
    R = (rng.standard_normal((N, K))
         * 10.0 ** rng.integers(-3, 4, (1, K))).astype(np.float32)
    mask = (rng.random((N, M)) < 0.9).astype(np.float32)
    data = rng.standard_normal((N, M)).astype(np.float32)
    R, mask, data = (torch.from_numpy(x) for x in (R, mask, data))
    fn = planes_col_gram_xty if form == "planes" else col_gram_xty_plain
    gram, xty = fn(mask, data, R)
    assert max(_entry_errors((gram, xty), mask, data, R)) <= COL_GRAM_RTOL
    k1, k2 = torch.triu_indices(K, K)
    hi = bf16_planes((R[:, k1] * R[:, k2]).T.contiguous())[0].double()
    control = torch.empty((K, K, M), dtype=torch.float64)
    control[k1, k2] = control[k2, k1] = hi @ mask.double()
    assert _entry_errors((control, xty), mask, data, R)[0] > COL_GRAM_RTOL
