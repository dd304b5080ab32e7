"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and the CUDA toolkit; elsewhere every test skips.  Run
on a GPU machine (this file imports no JAX, and the repository's conftest
imports JAX, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Small, ragged shapes: every kernel is checked where its blocks do not divide
the problem.  Tolerances as in chip_smoke.py: level_gram 2e-5 and row_xty
3e-5 of the output's max magnitude; masked_eval SSEs 1e-5 relative, counts
exact; feature_sign_fused per-column objective excess <= 1e-6 relative.
"""

import numpy as np
import pytest
import torch

from insider_tpu_torch.kernels import eval as ev
from insider_tpu_torch.kernels import fss, row
from insider_tpu_torch.ops.col_update import col_gram_masked

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from insider_tpu_torch.train.als import disable_tf32

    disable_tf32()
    return torch.device("cuda")


def _t(x, dev):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def _max_err_ok(got, ref, rtol):
    return float((got - ref).abs().max()) <= rtol * float(ref.abs().max())


@pytest.mark.parametrize("L,K,M", [(9, 5, 1031), (133, 24, 3001)])
def test_level_gram(cuda, L, K, M):
    rng = np.random.default_rng(0)
    mw = _t(rng.integers(0, 200, (L, M)).astype(np.float32), cuda)
    F = _t(rng.standard_normal((K, M)).astype(np.float32), cuda)
    n0 = row.level_gram.launches
    got = row.level_gram(mw, F)
    assert row.level_gram.launches == n0 + 1
    assert _max_err_ok(got, row.level_gram_plain(mw, F), 2e-5)
    assert torch.equal(got, row.level_gram(mw, F))        # bit for bit


@pytest.mark.parametrize("N,L,K,M", [(37, 3, 6, 1031), (150, 107, 24, 2000)])
def test_row_xty(cuda, N, L, K, M):
    rng = np.random.default_rng(1)
    codes = _t(rng.integers(0, L, N).astype(np.int32), cuda)
    R = _t(rng.standard_normal((N, K)).astype(np.float32), cuda)
    mask = _t((rng.random((N, M)) > 0.1).astype(np.float32), cuda)
    data = _t(rng.standard_normal((N, M)).astype(np.float32), cuda)
    F = _t(rng.standard_normal((K, M)).astype(np.float32), cuda)
    E = torch.nn.functional.one_hot(codes.long(), L).float()
    D = (E.T @ (mask * data)).contiguous()
    n0 = row.row_xty.launches
    got = row.row_xty(codes, R, mask, D, F)
    assert row.row_xty.launches == n0 + 1
    assert _max_err_ok(got, row.row_xty_plain(codes, R, mask, D, F), 3e-5)
    assert torch.equal(got, row.row_xty(codes, R, mask, D, F))


@pytest.mark.parametrize("N,M,K", [(64, 256, 8), (377, 1111, 24)])
def test_masked_eval(cuda, N, M, K):
    rng = np.random.default_rng(2)
    data = _t(rng.standard_normal((N, M)).astype(np.float32), cuda)
    train_np = (rng.random((N, M)) < 0.85).astype(np.float32)
    train = _t(train_np, cuda)
    test = _t(((rng.random((N, M)) < 0.5) * (1 - train_np)
               ).astype(np.float32), cuda)
    R = _t((0.3 * rng.standard_normal((N, K))).astype(np.float32), cuda)
    F = _t((0.3 * rng.standard_normal((K, M))).astype(np.float32), cuda)
    got = [float(x) for x in ev.masked_eval(data, train, test, R, F)]
    ref = [float(x) for x in ev.masked_eval_plain(data, train, test, R, F)]
    for q in (0, 1):
        assert abs(got[q] - ref[q]) <= 1e-5 * abs(ref[q])
    assert got[2:] == ref[2:]
    again = [float(x) for x in ev.masked_eval(data, train, test, R, F)]
    assert again == got


@pytest.mark.parametrize("N,K,M", [(45, 5, 333), (100, 13, 700),
                                   (377, 24, 1000), (60, 32, 257)])
def test_feature_sign_fused(cuda, N, K, M):
    rng = np.random.default_rng(3 + K)
    R = _t(rng.standard_normal((N, K)).astype(np.float32), cuda)
    mask = _t((rng.random((N, M)) > 0.1).astype(np.float32), cuda)
    data = _t(rng.standard_normal((N, M)).astype(np.float32), cuda)
    beta0 = _t((0.01 * rng.standard_normal((K, M))).astype(np.float32), cuda)
    lam, alpha = 11.0, 0.4
    kw = dict(max_outer=48, polish_sweeps=16, tol=1e-9)
    n0 = fss.feature_sign_fused.launches
    got = fss.feature_sign_fused(mask, data, R, beta0, lam, alpha, **kw)
    assert fss.feature_sign_fused.launches == n0 + 1
    ref = fss.feature_sign_fused_plain(mask, data, R, beta0, lam, alpha, **kw)
    G = col_gram_masked(R, mask).double()
    b = (R.T @ (mask * data)).double()

    def objective(B):
        B = B.double()
        q = 0.5 * torch.einsum("km,mkl,lm->m", B, G, B) - (b * B).sum(0)
        return (q + lam * (1 - alpha) / 2 * (B * B).sum(0)
                + lam * alpha * B.abs().sum(0))

    fk, fp = objective(got), objective(ref)
    assert float(((fk - fp) / fp.abs().clamp(min=1.0)).max()) <= 1e-6
    match = torch.isclose(got, ref, rtol=2e-5, atol=1e-5).all(0)
    assert float(match.double().mean()) >= 0.99
    assert int((got == 0).sum()) > 0
    assert torch.equal(got, fss.feature_sign_fused(mask, data, R, beta0, lam,
                                                   alpha, **kw))


def test_mixed_devices_raise(cuda):
    F = torch.zeros((4, 10), device=cuda)
    with pytest.raises(ValueError):
        row.level_gram(torch.zeros((3, 10)), F)
