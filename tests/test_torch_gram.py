"""The port's streamed column-gram builder (insider_tpu_torch/kernels/gram.py)
against the JAX package's Pallas kernel, on the same numpy inputs.

On CPU tensors the wrapper runs its plain version; the Pallas kernel runs in
interpret mode.  Ragged N (the Pallas kernel's row chunk does not divide
it) and uint8 masks, at the tolerance of tests/test_gram_pallas.py: atol
3e-5 of each output's largest magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insider_tpu.kernels.gram_pallas import col_gram_xty_pallas
from insider_tpu_torch.kernels.gram import col_gram_xty


@pytest.mark.parametrize("K", [6, 40])
@pytest.mark.parametrize("mask_dtype", [np.float32, np.uint8])
def test_col_gram_xty_matches_pallas_kernel(K, mask_dtype):
    N, M = 45, 150
    rng = np.random.default_rng(K)
    R = (0.4 * rng.standard_normal((N, K))).astype(np.float32)
    mask = (rng.random((N, M)) < 0.9).astype(mask_dtype)
    data = rng.standard_normal((N, M)).astype(np.float32)

    g_want, x_want = col_gram_xty_pallas(jnp.asarray(mask), jnp.asarray(data),
                                         jnp.asarray(R), interpret=True)
    g_got, x_got = col_gram_xty(torch.from_numpy(mask),
                                torch.from_numpy(data), torch.from_numpy(R))
    assert g_got.shape == (K, K, M) and x_got.shape == (K, M)
    for got, want in ((g_got, g_want), (x_got, x_want)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=3e-5 * float(np.abs(want).max()))
