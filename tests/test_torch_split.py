"""The exact bf16 splits of the port's tensor-core gram builds
(insider_tpu_torch/ops/planes.py, which documents what csrc/level_gram.cu
and csrc/fss.cu compute) against the JAX package, and the port's default
device.

The three-plane split must equal fss_pallas._bf16_planes plane for plane
and sum back to its input exactly; the three-plane count split must be
exact for every count below 2**24, f32's exact integer range (so a level
may hold any number of rows).  Summed in f32, the plane products must agree
with the f32 plain versions at the kernels' tolerances (level_gram 2e-5,
the column grams 3e-5 of the output's largest magnitude) and with the JAX
kernels' own arithmetic.  The entry points run on the card unless the
caller asks for the CPU: without a card they raise.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import insider_tpu_torch as itt
from insider_tpu.kernels import fss_pallas
from insider_tpu.kernels.row_pallas import level_gram_pallas
from insider_tpu_torch.kernels import row
from insider_tpu_torch.ops import planes
from insider_tpu_torch.ops.col_update import col_gram_masked
from insider_tpu_torch.train import als


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


# normal magnitudes, tiny and huge ones, and everything between; above
# 2**-103 every plane is a normal number (the JAX package's CPU backend
# flushes subnormals to zero, torch does not)
@pytest.mark.parametrize("lo_exp,hi_exp", [(-3, 3), (-30, -25), (25, 30),
                                           (-30, 30)])
def test_bf16_planes_match_jax(lo_exp, hi_exp):
    rng = np.random.default_rng(lo_exp + 100)
    x = (rng.choice([-1.0, 1.0], 20000)
         * 10.0 ** rng.uniform(lo_exp, hi_exp, 20000)).astype(np.float32)
    assert np.abs(x).min() >= 2.0 ** -103
    got = planes.bf16_planes(torch.from_numpy(x))
    want = fss_pallas._bf16_planes(jnp.asarray(x))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w.astype(jnp.float32)))
    hi, mid, lo = (p.float() for p in got)
    assert torch.equal(hi + mid + lo, torch.from_numpy(x))
    assert torch.equal(hi + (mid + lo), torch.from_numpy(x))


def test_count_planes_exact_below_65536():
    c = torch.arange(1 << 16, dtype=torch.float32)
    hi, mid, lo = planes.count_planes(c)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert not bool(hi.float().any())
    assert torch.equal(mid.float() + lo.float(), c)
    assert torch.equal(mid.float(), torch.floor(c / 256) * 256)
    assert float(lo.float().max()) == 255.0
    # the two planes the kernel takes below 65536
    two = planes.count_planes(c, 2)
    assert len(two) == 2
    assert torch.equal(two[0], mid) and torch.equal(two[1], lo)


def test_count_planes_exact_below_2_24():
    """Every integer below 2**24 splits exactly: the edges of each plane
    and random counts spread over the whole range; a two-plane split
    (256 floor(c / 256) and the rest) is not exact there."""
    rng = np.random.default_rng(24)
    edges = [(1 << e) + d for e in (8, 16, 23) for d in (-1, 0, 1)]
    c = torch.from_numpy(np.concatenate([
        edges, [0, 65535, 65536, 70000, (1 << 24) - 1],
        rng.integers(0, 1 << 24, 50000)]).astype(np.float32))
    assert float(c.max()) == float((1 << 24) - 1)
    hi, mid, lo = (p.float() for p in planes.count_planes(c))
    assert torch.equal(hi + mid + lo, c)
    assert torch.equal(hi, torch.floor(c / 65536) * 65536)
    assert float(mid.max()) <= 255 * 256 and float(lo.max()) <= 255
    two_hi = torch.floor(c / 256) * 256
    assert not torch.equal(two_hi.to(torch.bfloat16).float()
                           + (c - two_hi).to(torch.bfloat16).float(), c)


# counts up to 1000, above 256 where one bf16 plane stops being exact
@pytest.mark.parametrize("L,K,M,cmax", [(9, 5, 300, 200), (37, 12, 500, 1000)])
def test_planes_level_gram(L, K, M, cmax):
    rng = np.random.default_rng(K)
    mw = rng.integers(0, cmax + 1, (L, M)).astype(np.float32)
    F = rng.standard_normal((K, M)).astype(np.float32)
    got = planes.planes_level_gram(torch.from_numpy(mw), torch.from_numpy(F))
    assert got.shape == (L, K, K)
    _close(got, row.level_gram_plain(torch.from_numpy(mw),
                                     torch.from_numpy(F)), 2e-5)
    _close(got, level_gram_pallas(jnp.asarray(mw), jnp.asarray(F),
                                  interpret=True), 2e-5)


# counts of levels above 2**16 rows, where the old two count planes fail
@pytest.mark.parametrize("L,K,M,cmin,cmax", [(4, 6, 300, 60000, 70000),
                                             (9, 13, 200, 0, 1 << 20)])
def test_planes_level_gram_large_counts(L, K, M, cmin, cmax):
    rng = np.random.default_rng(L + K)
    mw = rng.integers(cmin, cmax + 1, (L, M)).astype(np.float32)
    F = rng.standard_normal((K, M)).astype(np.float32)
    got = planes.planes_level_gram(torch.from_numpy(mw), torch.from_numpy(F))
    exact = row.level_gram_plain(torch.from_numpy(mw).double(),
                                 torch.from_numpy(F).double())
    _close(got, exact, 2e-5)
    _close(got, level_gram_pallas(jnp.asarray(mw), jnp.asarray(F),
                                  interpret=True), 2e-5)


def test_masked_problem_records_its_largest_level_count():
    """build_problem keeps the largest per-level count, which sets
    level_gram's count planes: a level of 70000 rows needs the third."""
    n = 70000
    data = np.zeros((n, 2), np.float32)
    conf = np.zeros((n, 1), np.int64)
    train = np.ones_like(data)
    train[:5, 1] = 0.0
    problem = als.build_problem(data, conf, train, np.zeros_like(data),
                                device="cpu")
    assert problem.max_level_count == float(n)
    assert torch.equal(problem.mw_cat, torch.tensor([[n, n - 5]],
                                                    dtype=torch.float32))


@pytest.mark.parametrize("N,K,M", [(45, 5, 130), (100, 24, 70)])
def test_planes_masked_gram(N, K, M):
    rng = np.random.default_rng(N)
    R = rng.standard_normal((N, K)).astype(np.float32)
    mask = (rng.random((N, M)) > 0.1).astype(np.float32)
    got = planes.planes_masked_gram(torch.from_numpy(R),
                                    torch.from_numpy(mask))
    assert got.shape == (M, K, K)
    _close(got, col_gram_masked(torch.from_numpy(R), torch.from_numpy(mask)),
           3e-5)
    # the TPU kernel's table planes against the bf16 mask (_planes_dot)
    table = jnp.asarray(R.T[:, None, :] * R.T[None, :, :]).reshape(K * K, N)
    want = fss_pallas._planes_dot(*fss_pallas._bf16_planes(table),
                                  jnp.asarray(mask))              # (K^2, M)
    _close(got, np.asarray(want).T.reshape(M, K, K), 3e-5)


def test_default_device_is_cuda():
    assert (inspect.signature(itt.Insider).parameters["device"].default
            == "cuda")
    assert (inspect.signature(als.build_problem).parameters["device"].default
            == "cuda")


def _tiny_problem():
    rng = np.random.default_rng(0)
    data = rng.standard_normal((12, 20))
    conf = np.stack([rng.integers(0, 2, 12), rng.integers(0, 3, 12)], 1)
    return data, conf, np.ones_like(data), np.zeros_like(data)


def test_build_problem_default_device():
    """Without a device, build_problem stages on the card; without a card
    it raises and names device="cpu" -- decided here, not at import."""
    data, conf, train, test = _tiny_problem()
    if torch.cuda.is_available():
        assert als.build_problem(data, conf, train, test).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            als.build_problem(data, conf, train, test)
    assert als.build_problem(data, conf, train, test,
                             device="cpu").device.type == "cpu"


def test_insider_default_device():
    data, conf, _, _ = _tiny_problem()
    if torch.cuda.is_available():
        assert itt.Insider(data, conf).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            itt.Insider(data, conf)
    assert itt.Insider(data, conf, device="cpu").device.type == "cpu"
