"""The port's row kernels (insider_tpu_torch/kernels/row.py) against the JAX
package's Pallas kernels in interpret mode, on the same numpy inputs.

On CPU tensors the port's wrappers run their plain versions.  Tolerance:
rtol 2e-5 (level_gram) and 3e-5 (row_xty) with an absolute floor of the same
fraction of the output's largest magnitude -- the tolerances of the JAX
package's own kernel tests (tests/test_row_pallas*.py): both sides sum in
f32, in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insider_tpu.kernels.row_pallas import (level_gram_pallas,
                                            row_xty_chunked_pallas,
                                            row_xty_pallas)
from insider_tpu_torch.kernels import row

HI = jax.lax.Precision.HIGHEST


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _row_inputs(N, L, K, M, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, L, N).astype(np.int32)
    R = rng.standard_normal((N, K)).astype(np.float32)
    mask = (rng.random((N, M)) > 0.1).astype(np.float32)
    data = rng.standard_normal((N, M)).astype(np.float32)
    F = rng.standard_normal((K, M)).astype(np.float32)
    E = np.eye(L, dtype=np.float32)[codes]
    D = (E.T.astype(np.float64) @ (mask * data)).astype(np.float32)
    return codes, E, R, mask, D, F


# L < 8 and L >= 8 (the JAX kernel's exact01 branch); M ragged against
# every block size
@pytest.mark.parametrize("N,L,K,M", [(37, 5, 6, 300), (64, 13, 8, 1031)])
def test_row_xty_matches_pallas(N, L, K, M):
    codes, E, R, mask, D, F = _row_inputs(N, L, K, M, seed=0)
    want = row_xty_pallas(jnp.asarray(E), jnp.asarray(R), jnp.asarray(mask),
                          jnp.asarray(D), jnp.asarray(F), block=512,
                          interpret=True)
    got = row.row_xty(torch.from_numpy(codes), torch.from_numpy(R),
                      torch.from_numpy(mask), torch.from_numpy(D),
                      torch.from_numpy(F))
    _close(got, want, 3e-5)


@pytest.mark.parametrize("N,L,K,M", [(45, 6, 5, 333), (70, 11, 4, 260)])
def test_row_xty_matches_chunked_pallas(N, L, K, M):
    codes, E, R, mask, D, F = _row_inputs(N, L, K, M, seed=1)
    want = row_xty_chunked_pallas(jnp.asarray(E), jnp.asarray(R),
                                  jnp.asarray(mask), jnp.asarray(D),
                                  jnp.asarray(F), interpret=True)
    got = row.row_xty(torch.from_numpy(codes), torch.from_numpy(R),
                      torch.from_numpy(mask), torch.from_numpy(D),
                      torch.from_numpy(F))
    _close(got, want, 3e-5)


@pytest.mark.parametrize("L,K,M", [(7, 6, 300), (29, 8, 1100)])
def test_level_gram_matches_pallas(L, K, M):
    rng = np.random.default_rng(2)
    Mw = rng.integers(0, 200, (L, M)).astype(np.float32)
    F = rng.standard_normal((K, M)).astype(np.float32)
    want = level_gram_pallas(jnp.asarray(Mw), jnp.asarray(F), block=512,
                             interpret=True)
    got = row.level_gram(torch.from_numpy(Mw), torch.from_numpy(F))
    assert got.shape == (L, K, K)
    _close(got, want, 2e-5)


# L = 1600 levels at K = 4, above the ~1,580 levels that the first CUDA
# row_xty kernel's shared-memory plan held at that rank (the redesigned
# kernel takes any L); most levels have no row
def test_row_xty_many_levels_matches_chunked_pallas():
    codes, E, R, mask, D, F = _row_inputs(96, 1600, 4, 130, seed=6)
    want = row_xty_chunked_pallas(jnp.asarray(E), jnp.asarray(R),
                                  jnp.asarray(mask), jnp.asarray(D),
                                  jnp.asarray(F), interpret=True)
    t = torch.from_numpy
    got = row.row_xty(t(codes), t(R), t(mask), t(D), t(F))
    assert got.shape == (1600, 4)
    _close(got, want, 3e-5)
    levels = row.level_order(t(codes), 1600)
    assert torch.equal(row.row_xty(t(codes), t(R), t(mask), t(D), t(F),
                                   levels), got)


@pytest.mark.parametrize("N,L", [(1, 1), (37, 1), (50, 7), (200, 40),
                                 (9, 30)])
def test_level_order_matches_numpy(N, L):
    """The rows sorted by level (a stable sort), each level's first
    position and each level's last position, against numpy; levels without
    rows have equal offsets."""
    codes = np.random.default_rng(N + L).integers(0, L, N).astype(np.int32)
    order, offsets, ends = row.level_order(torch.from_numpy(codes), L)
    assert order.dtype == offsets.dtype == ends.dtype == torch.int32
    want_order = np.argsort(codes, kind="stable")
    np.testing.assert_array_equal(order.numpy(), want_order)
    np.testing.assert_array_equal(
        offsets.numpy(), np.searchsorted(codes[want_order], np.arange(L + 1)))
    counts = np.bincount(codes, minlength=L)
    np.testing.assert_array_equal(np.diff(offsets.numpy()), counts)
    want_ends = np.full(N, -1)
    for lv in range(L):
        rows = order.numpy()[offsets[lv]:offsets[lv + 1]]
        np.testing.assert_array_equal(rows, np.flatnonzero(codes == lv))
        if rows.size:
            want_ends[offsets[lv + 1] - 1] = lv
    np.testing.assert_array_equal(ends.numpy(), want_ends)


def test_level_order_leaves_out_codes_outside_the_levels():
    codes = torch.tensor([2, -1, 0, 3, 0, 5, 2], dtype=torch.int32)
    order, offsets, ends = row.level_order(codes, 4)
    assert offsets.tolist() == [1, 3, 3, 5, 6]
    assert order[offsets[0]:offsets[4]].tolist() == [2, 4, 0, 6, 3]
    assert ends.tolist() == [-1, -1, 0, -1, 2, 3, -1]


def test_cpu_wrappers_do_not_count_launches():
    """On CPU tensors the plain version runs and no kernel launch is
    counted."""
    before = (row.level_gram.launches, row.row_xty.launches)
    codes, E, R, mask, D, F = _row_inputs(20, 3, 4, 50, seed=3)
    row.level_gram(torch.from_numpy(mask[:3]), torch.from_numpy(F))
    row.row_xty(torch.from_numpy(codes), torch.from_numpy(R),
                torch.from_numpy(mask), torch.from_numpy(D),
                torch.from_numpy(F))
    assert (row.level_gram.launches, row.row_xty.launches) == before


def test_update_row_factor_matches_jax():
    """The fit's row update (level_gram, row_xty, batched SPD solve)
    against the JAX package's update_row_factor_masked_fast, at the
    tolerance of its kernel-path test (tests/test_row_pallas_driver.py:
    61-62)."""
    from insider_tpu.ops import row_update as jax_row_update
    from insider_tpu_torch.train import als

    codes, E, R, mask, D, F = _row_inputs(48, 6, 4, 512, seed=5)
    Mw = (E.T @ mask).astype(np.float32)
    want = jax_row_update.update_row_factor_masked_fast(
        *(jnp.asarray(x) for x in (E, Mw, D, mask, R, F)), jnp.float32(2.0))
    t = torch.from_numpy
    got = als.update_row_factor(row.level_gram(t(Mw), t(F)), t(codes), t(R),
                                t(mask), t(D), t(F), 2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5,
                               atol=1e-5)
