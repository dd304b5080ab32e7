"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and the CUDA toolkit; elsewhere every test skips.  Run
on a GPU machine (this file imports no JAX, and the repository's conftest
imports JAX, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Small, ragged shapes: every kernel is checked where its blocks do not divide
the problem.  Tolerances as in chip_smoke.py: level_gram 2e-5 of the f32
plain version's max magnitude (and 1e-6 of the f64 sum's, below), row_xty
and col_gram_xty 3e-5 of the output's max magnitude (col_gram_xty also
within 2e-6 of ops/planes.planes_col_gram_xty, the plain form of its
arithmetic, and within 1e-6 of the f64 sums', below); masked_eval SSEs 1e-5
relative, counts exact; the FSS kernels' per-column objective excess <= 1e-6
relative.  The CD kernels run the plain version's iteration, compared at a
short sweep cap (20): every column's objective excess <= 1e-6 relative and
at least 99% of the columns match at rtol 2e-5 / atol 1e-5.  row_xty is
also held to the f64 result: max error <= 1e-4 of its largest magnitude
(ROW_XTY_RTOL), a bound that the cancellation-prone f32 form D F^T - T F^T
does not meet where D and T nearly cancel.  The fused
kernels (feature_sign_fused, cd_fused) and col_gram_xty sum the same exact
bf16 planes of the f32 table on the tensor cores, but Xty in other orders
(row by row; each k-step from zero), so the streamed route on
col_gram_xty's output is held to them by the route check (_check_routes),
not bit for bit; the FSS routes also agree element-wise (rtol 2e-5 / atol
1e-5).  level_gram and col_gram_xty are held to the f64 sums: max error <=
1e-6 of the largest magnitude (LEVEL_GRAM_RTOL, COL_GRAM_RTOL; for
col_gram_xty also every entry's error <= 1e-6 of its own sum of |terms|), a
bound that one bf16 plane of the table would not meet; col_gram_xty's grams
are symmetric bit for bit.  Every kernel is run twice
and must agree with itself bit for bit.
"""

import numpy as np
import pytest
import torch

from insider_tpu_torch.kernels import eval as ev
from insider_tpu_torch.kernels import cd, ctns, fss, gram, row
from insider_tpu_torch.ops.col_update import col_gram_masked
from insider_tpu_torch.ops.planes import bf16_planes, planes_col_gram_xty
from insider_tpu_torch.ops.row_update import factor_outer_table

pytestmark = pytest.mark.cuda

LEVEL_GRAM_RTOL = 1e-6          # of the f64 sum's max magnitude
COL_GRAM_RTOL = 1e-6            # of the f64 sums' max magnitude, and of
                                # each entry's sum of |terms|


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


# counts up to 1000, above 256, where one bf16 plane no longer holds them,
# and below 256 (zero high count planes, as at the flagship shape); ragged
# level counts (L = 150 spans two level tiles of the kernel); counts up to
# 70000 and 2**24 - 1, levels of more than 65536 rows, where all three
# count planes are nonzero
@pytest.mark.parametrize("L,K,M,cmax", [(9, 5, 1031, 1000),
                                        (133, 24, 3001, 1000),
                                        (133, 24, 3001, 255),
                                        (37, 50, 2000, 1000),
                                        (150, 24, 777, 1000),
                                        (6, 24, 1031, 70000),
                                        (4, 13, 300, (1 << 24) - 1)])
def test_level_gram(cuda, L, K, M, cmax):
    rng = np.random.default_rng(0)
    mw = _t(rng.integers(0, cmax + 1, (L, M)).astype(np.float32), cuda)
    F = _t(rng.standard_normal((K, M)).astype(np.float32), cuda)
    n0 = row.level_gram.launches
    got = row.level_gram(mw, F)
    assert row.level_gram.launches == n0 + 1
    assert _max_err_ok(got, row.level_gram_plain(mw, F), 2e-5)
    # against the f64 sum; the gate rejects one bf16 plane of the table
    exact = row.level_gram_plain(mw.double(), F.double())
    assert _max_err_ok(got.double(), exact, LEVEL_GRAM_RTOL)
    hi = bf16_planes(factor_outer_table(F))[0].double()
    one_plane = (mw.double() @ hi.T).reshape(exact.shape)
    assert not _max_err_ok(one_plane, exact, LEVEL_GRAM_RTOL)
    assert torch.equal(got, row.level_gram(mw, F))        # bit for bit
    # the largest count given, as a fit gives it: the same planes
    assert torch.equal(got, row.level_gram(mw, F, float(mw.max())))


def test_level_gram_rejects_counts_past_2_24(cuda):
    mw = torch.ones((3, 40), device=cuda)
    F = torch.ones((4, 40), device=cuda)
    for bad in (-1.0, float(1 << 24)):
        with pytest.raises(ValueError, match="counts"):
            row.level_gram(mw, F, bad)


ROW_XTY_RTOL = 1e-4             # of the f64 result's max magnitude


def _row_xty_case(N, L, K, M, layout, seed):
    """Level codes, R_minus, mask, D and F for row_xty, as numpy.  layout:
    "random" codes; "empty": level 1 has no row; "big": all rows but 40 in
    level 0, more than a level group's 64 rows; "cancel": data = R_minus F +
    0.005 noise, so D and T nearly cancel, as near a fit's end."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, L, N).astype(np.int32)
    if layout == "empty":
        codes[codes == 1] = 0
    if layout == "big":
        codes = np.where(np.arange(N) < N - 40, 0, L - 1).astype(np.int32)
    R = (0.5 * rng.standard_normal((N, K))).astype(np.float32)
    mask = (rng.random((N, M)) > 0.1).astype(np.float32)
    F = (0.3 * rng.standard_normal((K, M))).astype(np.float32)
    data = rng.standard_normal((N, M))
    if layout == "cancel":
        data = R.astype(np.float64) @ F + 0.005 * data
    E = np.eye(L)[codes]
    D = (E.T @ (mask * data)).astype(np.float32)
    return codes, R, mask, D, F


def _row_xty_errors(codes, R, mask, D, F, got):
    """Max errors of `got` and of the cancellation-prone f32 form D F^T -
    T F^T against the f64 result, as fractions of its max magnitude."""
    L = D.shape[0]
    exact = row.row_xty_plain(codes, R.double(), mask.double(), D.double(),
                              F.double())
    E_t = torch.nn.functional.one_hot(codes.long(), L).float().T
    control = D @ F.T - (E_t @ (mask * (R @ F))) @ F.T
    scale = float(exact.abs().max())
    return [float((x.double() - exact).abs().max()) / scale
            for x in (got, control)]


# L = 1; a level with no row; L = 2000 (above the first kernel's ~1,500
# at K = 24); one level larger than a level group; K = 8, 24, 50, 96, 128
# and odd ranks; M ragged and not a multiple of 4; N = 1; D and T nearly
# cancelling, where the f64 gate must reject the f32 form D F^T - T F^T;
# N = 65535
@pytest.mark.parametrize("N,L,K,M,layout", [
    (37, 3, 6, 1031, "random"), (150, 107, 24, 2000, "empty"),
    (40, 1, 8, 257, "random"), (300, 2000, 24, 513, "random"),
    (300, 2, 24, 1031, "big"), (200, 12, 50, 777, "empty"),
    (120, 25, 96, 301, "random"), (90, 9, 128, 130, "empty"),
    (70, 5, 13, 99, "big"), (1, 1, 24, 333, "random"),
    (1, 4, 8, 65, "random"), (65535, 3, 8, 37, "random"),
    (200, 8, 24, 8191, "cancel")])
def test_row_xty(cuda, N, L, K, M, layout):
    codes, R, mask, D, F = (_t(x, cuda) for x in _row_xty_case(
        N, L, K, M, layout, seed=N + L + K))
    levels = row.level_order(codes, L)
    n0 = row.row_xty.launches
    got = row.row_xty(codes, R, mask, D, F, levels)
    assert row.row_xty.launches == n0 + 1
    if layout != "cancel":
        assert _max_err_ok(got, row.row_xty_plain(codes, R, mask, D, F), 3e-5)
    # the same without the row order (derived), bit for bit
    assert torch.equal(got, row.row_xty(codes, R, mask, D, F))
    err, control = _row_xty_errors(codes, R, mask, D, F, got)
    assert err <= ROW_XTY_RTOL
    if layout == "cancel":
        assert control > ROW_XTY_RTOL


@pytest.mark.parametrize("N,M,K,no_test", [
    (64, 256, 8, False), (377, 1111, 24, False), (300, 777, 50, False),
    (120, 301, 96, True), (90, 130, 128, False), (1, 33, 24, True)])
def test_masked_eval(cuda, N, M, K, no_test):
    rng = np.random.default_rng(2)
    data = _t(rng.standard_normal((N, M)).astype(np.float32), cuda)
    train_np = (rng.random((N, M)) < 0.85).astype(np.float32)
    train = _t(train_np, cuda)
    test = _t(((rng.random((N, M)) < 0.5) * (1 - train_np) * (not no_test)
               ).astype(np.float32), cuda)
    R = _t((0.3 * rng.standard_normal((N, K))).astype(np.float32), cuda)
    F = _t((0.3 * rng.standard_normal((K, M))).astype(np.float32), cuda)
    n0 = ev.masked_eval.launches
    got = [float(x) for x in ev.masked_eval(data, train, test, R, F)]
    assert ev.masked_eval.launches == n0 + 1
    ref = [float(x) for x in ev.masked_eval_plain(data, train, test, R, F)]
    for q in (0, 1):
        assert abs(got[q] - ref[q]) <= 1e-5 * abs(ref[q])
    assert got[2:] == ref[2:]
    if no_test:
        assert got[1] == 0.0 and got[3] == 0.0
    again = [float(x) for x in ev.masked_eval(data, train, test, R, F)]
    assert again == got


# Warm starts of the FSS kernels: every coordinate zero (the active sets
# grow one coordinate a step), every coordinate nonzero and near the
# solution, and every coordinate nonzero and far from it with max_outer = 2,
# where the columns stop at the cap.
WARM_STARTS = ("zero", "nonzero", "cap")


def _warm(rng, K, M, warm):
    """A warm start (K, M) and the FSS keywords for it."""
    scale = {"zero": 0.0, "nonzero": 0.01, "cap": 1.0}[warm]
    beta0 = (scale * rng.standard_normal((K, M))).astype(np.float32)
    return beta0, dict(max_outer=2 if warm == "cap" else 48,
                       polish_sweeps=16, tol=1e-9)


# every KMAX instance of the kernel (8, 16, 24, 32) at ragged N and M, K = 1
@pytest.mark.parametrize("warm", WARM_STARTS)
@pytest.mark.parametrize("N,K,M", [(40, 1, 129), (45, 5, 333), (77, 8, 301),
                                   (100, 13, 700), (129, 16, 515),
                                   (377, 24, 1000), (60, 32, 257)])
def test_feature_sign_fused(cuda, N, K, M, warm):
    rng = np.random.default_rng(3 + K)
    R = _t(rng.standard_normal((N, K)).astype(np.float32), cuda)
    mask = _t((rng.random((N, M)) > 0.1).astype(np.float32), cuda)
    data = _t(rng.standard_normal((N, M)).astype(np.float32), cuda)
    beta0, kw = _warm(rng, K, M, warm)
    beta0 = _t(beta0, cuda)
    lam, alpha = 11.0, 0.4
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


def _masked_inputs(N, K, M, seed):
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((N, K)).astype(np.float32)
    mask = (rng.random((N, M)) > 0.1).astype(np.float32)
    data = rng.standard_normal((N, M)).astype(np.float32)
    beta0 = (0.01 * rng.standard_normal((K, M))).astype(np.float32)
    return R, mask, data, beta0


def _objective(G, b, lam, alpha):
    """Every column's elastic-net objective in f64.  G (K, K, M), b (K, M)."""
    G, b = G.double(), b.double()

    def objective(B):
        B = B.double()
        q = 0.5 * torch.einsum("km,klm,lm->m", B, G, B) - (b * B).sum(0)
        return (q + lam * (1 - alpha) / 2 * (B * B).sum(0)
                + lam * alpha * B.abs().sum(0))

    return objective


def _check_fss(got, ref, G, b, lam, alpha):
    """Per-column objective excess of the kernel over the plain version
    <= 1e-6 relative; >= 99% of the columns match; exact zeros exist.
    G (K, K, M) and b (K, M), as the kernels take them."""
    objective = _objective(G, b, lam, alpha)
    assert bool(torch.isfinite(got).all())
    fk, fp = objective(got), objective(ref)
    assert float(((fk - fp) / fp.abs().clamp(min=1.0)).max()) <= 1e-6
    match = torch.isclose(got, ref, rtol=2e-5, atol=1e-5).all(0)
    assert float(match.double().mean()) >= 0.99
    assert int((got == 0).sum()) > 0


def _check_routes(fused, streamed, G, b, lam, alpha):
    """A fused kernel against the streamed route on col_gram_xty's output:
    the two round the grams and Xty differently, so an f32 rounding
    difference may move a column.
    Every column's objective agrees within 1e-6 relative, and >= 99% of
    the columns match at rtol 2e-5 / atol 1e-5."""
    objective = _objective(G, b, lam, alpha)
    ff, fs = objective(fused), objective(streamed)
    assert float(((ff - fs).abs() / fs.abs().clamp(min=1.0)).max()) <= 1e-6
    match = torch.isclose(fused, streamed, rtol=2e-5, atol=1e-5).all(0)
    assert float(match.double().mean()) >= 0.99


# ragged N and odd M (uint8 rows then start at every byte of a word, and the
# array's last word is partial); N = 70001, past 65536 rows, where the f32
# sums run over 4376 k-steps and are held to the f64 sums at LONG_SUM_RTOL
LONG_SUM_RTOL = 1e-5


@pytest.mark.parametrize("N,K,M,u8", [(45, 6, 333, False), (100, 24, 700, True),
                                      (300, 50, 1031, False),
                                      (77, 50, 1001, True),
                                      (70, 64, 257, True),
                                      (150, 96, 300, False),
                                      (140, 128, 257, True),
                                      (70001, 8, 37, False)])
def test_col_gram_xty(cuda, N, K, M, u8):
    R, mask, data, _ = _masked_inputs(N, K, M, seed=20 + K)
    R, data = _t(R, cuda), _t(data, cuda)
    mask = _t(mask.astype(np.uint8) if u8 else mask, cuda)
    n0 = gram.col_gram_xty.launches
    got = gram.col_gram_xty(mask, data, R)
    assert gram.col_gram_xty.launches == n0 + 1
    ref = gram.col_gram_xty_plain(mask, data, R)
    for g, r in zip(got, ref):
        assert _max_err_ok(g, r, 3e-5)
    # against the f64 sums and the planes form of the kernel's arithmetic
    rtol = COL_GRAM_RTOL if N < 65536 else LONG_SUM_RTOL
    m64, d64, r64 = mask.double(), data.double(), R.double()
    exact = gram.col_gram_xty_plain(m64, d64, r64)
    planes = planes_col_gram_xty(mask, data, R)
    for g, e, p in zip(got, exact, planes):
        assert _max_err_ok(g.double(), e, rtol)
        assert _max_err_ok(g, p, 2 * rtol)
    # every entry within rtol of its own sum of |terms|; the gate rejects
    # one bf16 plane of the table (whose relative error falls as
    # 1 / sqrt(N): not at N = 70001)
    if N < 65536:
        scale = (torch.einsum("im,ik,il->klm", m64, r64.abs(), r64.abs()),
                 r64.abs().T @ (m64 * d64).abs())
        for g, e, sc in zip(got, exact, scale):
            assert float(((g.double() - e).abs() / sc.clamp(min=1e-300))
                         .max()) <= rtol
        k1, k2 = torch.triu_indices(K, K, device=cuda)
        hi = bf16_planes((R[:, k1] * R[:, k2]).T.contiguous())[0].double()
        assert not _max_err_ok(hi @ m64, exact[0][k1, k2], rtol)
    assert torch.equal(got[0], got[0].transpose(0, 1))
    again = gram.col_gram_xty(mask, data, R)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("u8", [False, True])
def test_col_gram_xty_views_off_a_chunk(cuda, u8):
    """Mask and data views that start off a 16-byte chunk (copied by the
    wrapper) give the grams of the same inputs in their own allocations."""
    R, mask, data, _ = _masked_inputs(51, 40, 333, seed=5)
    R = _t(R, cuda)
    big_mask = _t(np.concatenate([np.ones((1, 333)), mask]).astype(
        np.uint8 if u8 else np.float32), cuda)
    big_data = _t(np.concatenate([np.ones((1, 333)), data]).astype(
        np.float32), cuda)
    views = big_mask[1:], big_data[1:]
    assert all(v.data_ptr() % 16 and v.is_contiguous() for v in views)
    got = gram.col_gram_xty(*views, R)
    want = gram.col_gram_xty(*(v.clone() for v in views), R)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# one, two, three and four coordinates a lane; active sets above 32 (the
# kernels' shared-memory solve) from K = 33
@pytest.mark.parametrize("warm", WARM_STARTS)
@pytest.mark.parametrize("N,K,M", [(45, 5, 333), (377, 24, 1000),
                                   (100, 33, 300), (300, 50, 700),
                                   (120, 64, 257), (130, 65, 200),
                                   (150, 96, 130), (200, 128, 70)])
def test_feature_sign(cuda, N, K, M, warm):
    R, mask, data, _ = _masked_inputs(N, K, M, seed=30 + K)
    beta0, kw = _warm(np.random.default_rng(K), K, M, warm)
    R, mask, data, beta0 = (_t(x, cuda) for x in (R, mask, data, beta0))
    lam, alpha = 11.0, 0.4
    G, b = gram.col_gram_xty_plain(mask, data, R)
    n0 = fss.feature_sign.launches
    got = fss.feature_sign(G, b, beta0, lam, alpha, **kw)
    assert fss.feature_sign.launches == n0 + 1
    _check_fss(got, fss.feature_sign_plain(G, b, beta0, lam, alpha, **kw), G,
               b, lam, alpha)
    assert torch.equal(got, fss.feature_sign(G, b, beta0, lam, alpha, **kw))
    if K <= fss.FUSED_MAX_K and warm == "nonzero":
        # the streamed route against the fused kernel on the same problem
        fused = fss.feature_sign_fused(mask, data, R, beta0, lam, alpha, **kw)
        Gk, bk = gram.col_gram_xty(mask, data, R)
        streamed = fss.feature_sign(Gk, bk, beta0, lam, alpha, **kw)
        assert torch.allclose(streamed, fused, rtol=2e-5, atol=1e-5)
        _check_routes(fused, streamed, G, b, lam, alpha)


@pytest.mark.parametrize("N,K,M", [(45, 3, 333), (45, 5, 333),
                                   (377, 24, 1000), (377, 25, 1000),
                                   (300, 50, 700), (300, 96, 130),
                                   (300, 128, 70)])
def test_feature_sign_shared(cuda, N, K, M):
    R, _, data, beta0 = _masked_inputs(N, K, M, seed=40 + K)
    R, data, beta0 = (_t(x, cuda) for x in (R, data, beta0))
    lam, alpha = 30.0, 0.4
    kw = dict(max_outer=48, polish_sweeps=16, tol=1e-9)
    XtX, b = (R.T @ R).contiguous(), (R.T @ data).contiguous()
    n0 = fss.feature_sign_shared.launches
    got = fss.feature_sign_shared(XtX, b, beta0, lam, alpha, **kw)
    assert fss.feature_sign_shared.launches == n0 + 1
    ref = fss.feature_sign_shared_plain(XtX, b, beta0, lam, alpha, **kw)
    _check_fss(got, ref, XtX[:, :, None].expand(K, K, M), b, lam, alpha)
    assert torch.equal(got, fss.feature_sign_shared(XtX, b, beta0, lam,
                                                    alpha, **kw))
    # every width the build has gives the same bits; a width it lacks
    # raises
    for lanes, _ in fss.feature_sign_shared_widths(K):
        assert torch.equal(got, fss.feature_sign_shared(
            XtX, b, beta0, lam, alpha, **kw, lanes=lanes)), lanes
    with pytest.raises(RuntimeError):
        fss.feature_sign_shared(XtX, b, beta0, lam, alpha, **kw, lanes=2)


@pytest.mark.parametrize("K", [3, 5, 17, 24, 32, 50])
def test_fss_shared_columns_are_independent(cuda, K):
    """Each column of one batched feature_sign_shared call equals, bit for
    bit, the kernel's output on that column alone (M = 1), at every width
    the build has, where the columns of a block stop at very different
    steps and groups take new columns in mid-flight: every even column has
    data = 0 and a zero warm start (it converges at its first outer step
    and its first polish sweep), every odd one correlated coordinates, a
    small lambda and tol 0 (it runs to max_outer steps, most of them, and
    to the polish cap).  M = 150 spans several blocks, the last ragged."""
    N, M = 3 * K + 20, 150
    rng = np.random.default_rng(110 + K)
    R = (rng.standard_normal((N, 1))
         + 0.5 * rng.standard_normal((N, K))).astype(np.float32)
    data = rng.standard_normal((N, M)).astype(np.float32)
    data[:, ::2] = 0.0
    beta0 = (0.01 * rng.standard_normal((K, M))).astype(np.float32)
    beta0[:, ::2] = 0.0
    R, data, beta0 = (_t(x, cuda) for x in (R, data, beta0))
    XtX, b = (R.T @ R).contiguous(), (R.T @ data).contiguous()
    kw = dict(lam=0.05, alpha=0.5, max_outer=4, polish_sweeps=8, tol=0.0)
    got = fss.feature_sign_shared(XtX, b, beta0, **kw)
    fewer = fss.feature_sign_shared(XtX, b, beta0, **dict(kw, max_outer=3))
    assert float(got[:, ::2].abs().max()) == 0.0
    assert not all(torch.equal(got[:, j], fewer[:, j])
                   for j in range(1, M, 2))          # some at the cap
    for lanes, _ in fss.feature_sign_shared_widths(K):
        assert torch.equal(got, fss.feature_sign_shared(XtX, b, beta0, **kw,
                                                        lanes=lanes)), lanes
        for j in range(M):
            alone = fss.feature_sign_shared(
                XtX, b[:, j:j + 1].contiguous(),
                beta0[:, j:j + 1].contiguous(), **kw, lanes=lanes)
            assert torch.equal(alone[:, 0], got[:, j]), (lanes, j)


CD_KW = dict(lam=11.0, alpha=0.4, tol=1e-9, max_sweeps=20)


def _check_cd(got, ref, G, b, lam):
    """The checks of _check_fss (every column's objective excess <= 1e-6
    relative, >= 99% of the columns match, finite, exact zeros) at
    CD_KW's alpha."""
    _check_fss(got, ref, G, b, lam, CD_KW["alpha"])


@pytest.mark.parametrize("N,K,M", [(45, 5, 333), (77, 8, 301),
                                   (129, 16, 515), (377, 24, 1000),
                                   (60, 32, 257)])
def test_cd_fused(cuda, N, K, M):
    R, mask, data, beta0 = _masked_inputs(N, K, M, seed=50 + K)
    R, mask, data, beta0 = (_t(x, cuda) for x in (R, mask, data, beta0))
    n0 = cd.cd_fused.launches
    got = cd.cd_fused(mask, data, R, beta0, **CD_KW)
    assert cd.cd_fused.launches == n0 + 1
    G, b = gram.col_gram_xty_plain(mask, data, R)
    _check_cd(got, cd.cd_fused_plain(mask, data, R, beta0, **CD_KW), G, b,
              CD_KW["lam"])
    assert torch.equal(got, cd.cd_fused(mask, data, R, beta0, **CD_KW))
    # every group width gives the same bits; a width with no instance
    # raises
    widths = dict(cd.cd_fused_widths(K))
    assert sorted(widths) == [8, 16, 32]
    for lanes, columns in widths.items():
        assert columns >= 8 * 32 // lanes
        assert torch.equal(got, cd.cd_fused(mask, data, R, beta0, **CD_KW,
                                            lanes=lanes)), lanes
    with pytest.raises(RuntimeError):
        cd.cd_fused(mask, data, R, beta0, **CD_KW, lanes=4)
    # the streamed route on col_gram_xty's grams: the same sums in another
    # order, the same CD loop
    Gk, bk = gram.col_gram_xty(mask, data, R)
    _check_routes(got, cd.cd_streamed(Gk, bk, beta0, **CD_KW), G, b,
                  CD_KW["lam"], CD_KW["alpha"])


def _staggered_masked(N, K, M, seed, dev):
    """R, mask, data and a warm start in which the columns stop at very
    different sweeps: every even column has data = 0 (Xty = 0, every
    coordinate screened: it converges after one sweep), every odd one
    correlated coordinates, on which CD at tol 0 (and lam 0.05) is still
    moving at the cap.  As tests/test_torch_cd.py:_staggered_masked."""
    rng = np.random.default_rng(seed)
    R = (rng.standard_normal((N, 1))
         + 0.5 * rng.standard_normal((N, K))).astype(np.float32)
    mask = (rng.random((N, M)) > 0.1).astype(np.float32)
    data = rng.standard_normal((N, M)).astype(np.float32)
    data[:, ::2] = 0.0
    beta0 = (0.01 * rng.standard_normal((K, M))).astype(np.float32)
    return tuple(_t(x, dev) for x in (R, mask, data, beta0))


@pytest.mark.parametrize("K", [5, 17, 24, 32])
def test_cd_fused_columns_are_independent(cuda, K):
    """Each column of one batched call equals, bit for bit, the kernel's
    output on that column alone (M = 1), at every group width, where the
    columns of a block stop at very different sweeps and converged groups
    take new columns in mid-flight: a refilled group keeps nothing of its
    last column.  M = 150 spans three blocks of 64 columns, the last
    ragged."""
    N, M = 3 * K + 20, 150
    R, mask, data, beta0 = _staggered_masked(N, K, M, 90 + K, cuda)
    kw = dict(lam=0.05, alpha=0.5, tol=0.0, max_sweeps=40)
    got = cd.cd_fused(mask, data, R, beta0, **kw)
    fewer = cd.cd_fused(mask, data, R, beta0, **dict(kw, max_sweeps=39))
    assert float(got[:, ::2].abs().max()) == 0.0
    assert not any(torch.equal(got[:, j], fewer[:, j])
                   for j in range(1, M, 2))          # at the cap
    for lanes, _ in cd.cd_fused_widths(K):
        assert torch.equal(got, cd.cd_fused(mask, data, R, beta0, **kw,
                                            lanes=lanes)), lanes
        for j in range(M):
            alone = cd.cd_fused(mask[:, j:j + 1].contiguous(),
                                data[:, j:j + 1].contiguous(), R,
                                beta0[:, j:j + 1].contiguous(), **kw,
                                lanes=lanes)
            assert torch.equal(alone[:, 0], got[:, j]), (lanes, j)


# each group boundary of the instances (L = 16: C steps at 16, 32, ...;
# L = 32: at 32, 64, 96), M odd, down to one column
@pytest.mark.parametrize("N,K,M", [(45, 5, 333), (40, 8, 3), (60, 16, 333),
                                   (60, 17, 1), (80, 33, 333),
                                   (300, 50, 700), (100, 64, 257),
                                   (100, 65, 333), (150, 96, 130),
                                   (150, 97, 3), (200, 128, 70)])
def test_cd_streamed(cuda, N, K, M):
    R, mask, data, beta0 = _masked_inputs(N, K, M, seed=60 + K)
    R, mask, data, beta0 = (_t(x, cuda) for x in (R, mask, data, beta0))
    G, b = gram.col_gram_xty_plain(mask, data, R)
    n0 = cd.cd_streamed.launches
    got = cd.cd_streamed(G, b, beta0, **CD_KW)
    assert cd.cd_streamed.launches == n0 + 1
    _check_cd(got, cd.cd_streamed_plain(G, b, beta0, **CD_KW), G, b,
              CD_KW["lam"])
    assert torch.equal(got, cd.cd_streamed(G, b, beta0, **CD_KW))
    # every group width gives the same bits; a width with no instance at
    # this K raises.  The kernel runs two columns a warp.
    widths = dict(cd.cd_streamed_widths(K))
    assert next(iter(widths)) == 16
    for lanes in (8, 16, 32):
        if lanes in widths:
            assert widths[lanes] >= 32 // lanes
            assert torch.equal(got, cd.cd_streamed(G, b, beta0, **CD_KW,
                                                   lanes=lanes)), lanes
        else:
            with pytest.raises(RuntimeError):
                cd.cd_streamed(G, b, beta0, **CD_KW, lanes=lanes)


def _staggered(K, M, seed, dev):
    """Per-gene grams, Xty and a warm start in which neighbouring columns
    stop at very different sweeps: every even column has Xty = 0 (every
    coordinate screened: it converges after one sweep), every odd one
    strongly correlated coordinates, on which CD at tol 0 (and lam 0.05) is
    still moving at the cap.  As tests/test_torch_cd.py:_staggered."""
    rng = np.random.default_rng(seed)
    N = 3 * K
    R = rng.standard_normal((N, 1)) + 0.1 * rng.standard_normal((N, K))
    mask = rng.random((N, M)) > 0.1
    G = np.einsum("ij,ik,il->klj", mask, R, R).astype(np.float32)
    xty = (R.T @ (mask * rng.standard_normal((N, M)))).astype(np.float32)
    xty[:, ::2] = 0.0
    beta0 = (0.01 * rng.standard_normal((K, M))).astype(np.float32)
    return _t(G, dev), _t(xty, dev), _t(beta0, dev)


@pytest.mark.parametrize("K", [17, 33, 50, 64, 96, 128])
def test_cd_streamed_columns_are_independent(cuda, K):
    """Each column of one batched call equals, bit for bit, the kernel's
    output on that column alone (M = 1), at every group width, where
    neighbouring columns of a warp stop at very different sweeps: no
    cross-talk between the groups of a warp.  M = 37 leaves the last warp
    with one column."""
    M = 37
    G, b, beta0 = _staggered(K, M, K, cuda)
    kw = dict(lam=0.05, alpha=0.5, tol=0.0, max_sweeps=40)
    got = cd.cd_streamed(G, b, beta0, **kw)
    fewer = cd.cd_streamed(G, b, beta0, **dict(kw, max_sweeps=39))
    assert float(got[:, ::2].abs().max()) == 0.0
    assert not any(torch.equal(got[:, j], fewer[:, j])
                   for j in range(1, M, 2))          # at the cap
    for lanes, _ in cd.cd_streamed_widths(K):
        assert torch.equal(got, cd.cd_streamed(G, b, beta0, **kw,
                                               lanes=lanes)), lanes
        for j in range(M):
            alone = cd.cd_streamed(G[:, :, j:j + 1].contiguous(),
                                   b[:, j:j + 1].contiguous(),
                                   beta0[:, j:j + 1].contiguous(), **kw,
                                   lanes=lanes)
            assert torch.equal(alone[:, 0], got[:, j]), (lanes, j)


@pytest.mark.parametrize("N,K,M", [(45, 5, 333), (100, 17, 301),
                                   (377, 24, 1000), (120, 32, 257),
                                   (300, 50, 700), (300, 128, 130)])
def test_cd_shared(cuda, N, K, M):
    R, _, data, beta0 = _masked_inputs(N, K, M, seed=70 + K)
    R, data, beta0 = (_t(x, cuda) for x in (R, data, beta0))
    kw = dict(CD_KW, lam=30.0)
    XtX, b = (R.T @ R).contiguous(), (R.T @ data).contiguous()
    n0 = cd.cd_shared.launches
    got = cd.cd_shared(XtX, b, beta0, **kw)
    assert cd.cd_shared.launches == n0 + 1
    _check_cd(got, cd.cd_shared_plain(XtX, b, beta0, **kw),
              XtX[:, :, None].expand(K, K, M), b, kw["lam"])
    assert torch.equal(got, cd.cd_shared(XtX, b, beta0, **kw))


def test_masked_problem_past_65536_rows(cuda):
    """A masked problem whose one level holds 70000 rows builds on the card,
    its level grams (three count planes) hold to the f64 sum, and a short
    fit runs with finite, non-increasing losses."""
    from insider_tpu_torch.config import FitConfig
    from insider_tpu_torch.train import als

    rng = np.random.default_rng(70)
    n, m, k = 70000, 6, 3
    data = rng.standard_normal((n, m))
    conf = np.stack([np.zeros(n, np.int64), rng.integers(0, 3, n)], 1)
    train = (rng.random((n, m)) > 0.05).astype(np.float64)
    problem = als.build_problem(data, conf, train, np.zeros_like(data),
                                device="cuda")
    assert problem.max_level_count >= 65536
    F = _t(rng.standard_normal((k, m)).astype(np.float32), cuda)
    got = row.level_gram(problem.mw_cat, F, problem.max_level_count)
    exact = row.level_gram_plain(problem.mw_cat.double(), F.double())
    assert _max_err_ok(got.double(), exact, LEVEL_GRAM_RTOL)
    res = als.optimize(problem, FitConfig(latent_dim=k, lambda1=1.0,
                                          lambda2=1.0, alpha=0.5, max_iter=3),
                       verbose=False)
    losses = [h["loss"] for h in res.history]
    assert np.all(np.isfinite(losses))
    assert all(b <= a * (1 + 1e-6) for a, b in zip(losses, losses[1:]))


def test_masked_k50_fit(cuda):
    """The prediXcan shape (K=50, levels 12 and 25, partition=1) on fewer
    genes: the fit runs on the card through the streamed route and never
    launches the fused kernel, whose one coordinate per lane stops at 32."""
    import insider_tpu_torch as itt

    sim = itt.simulate_scale(300, 3000, 50, level_counts=(12, 25),
                             noise_std=1.0, seed=0)
    obj = itt.Insider(sim.data, sim.confounder, device="cuda")
    wrappers = (fss.feature_sign_fused, fss.feature_sign, gram.col_gram_xty)
    before = [w.launches for w in wrappers]
    obj.fit(50, lambda_=1.0, alpha=0.5, partition=1, max_iter=20,
            verbose=False)
    fused, streamed, grams = (w.launches - b for w, b in zip(wrappers, before))
    assert fused == 0 and streamed == 21 and grams == 21
    losses = [h["loss"] for h in obj.fit_result.history]
    assert np.all(np.isfinite(losses))
    assert all(b <= a * (1 + 1e-6) for a, b in zip(losses, losses[1:]))
    assert obj.column_factor.shape == (50, 3000)


# K = 109 is the largest whose padded XtX fits 48 KB of shared memory, 110
# the first past it; 33 and 128 fill a lane's second and fourth slot
@pytest.mark.parametrize("K", [1, 5, 24, 33, 64, 109, 110, 128])
@pytest.mark.parametrize("loss_criterion,tol", [(False, 1e-1), (True, 1e-3),
                                                (False, 1e-7)])
def test_ctns_cd(cuda, K, loss_criterion, tol):
    """The covariate CD kernel follows its plain version bit for bit, sweep
    counts included: every operation rounded on its own, in the same
    order (the plain version on the card, from the same inputs)."""
    rng = np.random.default_rng(K)
    A = rng.standard_normal((2 * K + 3, K)).astype(np.float32)
    XtX = _t(A.T @ A, cuda)
    b = _t(rng.standard_normal(K).astype(np.float32), cuda)
    w0 = _t((0.1 * rng.standard_normal(K)).astype(np.float32), cuda)
    args = (XtX, b, w0, 0.7, tol, 100, loss_criterion)
    n0 = ctns.ctns_cd.launches
    w, sweeps = ctns.ctns_cd(*args, with_sweeps=True)
    assert ctns.ctns_cd.launches == n0 + 1
    w_ref, sweeps_ref = ctns.ctns_cd_plain(*args)
    assert int(sweeps) == int(sweeps_ref) and 1 <= int(sweeps) <= 100
    assert torch.equal(w, w_ref)
    assert torch.equal(w, ctns.ctns_cd(*args))


def test_ctns_cd_sweep_cap(cuda):
    XtX = torch.tensor([[2.0, 1.9], [1.9, 2.0]], device=cuda)
    b = torch.tensor([1.0, -1.0], device=cuda)
    w, sweeps = ctns.ctns_cd(XtX, b, torch.zeros(2, device=cuda), 1e-3,
                             1e-12, 3, with_sweeps=True)
    assert int(sweeps) == 3
    with pytest.raises(ValueError):
        ctns.ctns_cd(torch.zeros((129, 129), device=cuda),
                     torch.zeros(129, device=cuda),
                     torch.zeros(129, device=cuda), 1.0, 0.1)


@pytest.mark.parametrize("partition", [1, 0])
def test_covariate_fit_card_against_cpu(cuda, partition):
    """A fit with two continuous covariates, on the card and on the CPU
    from one initial state: per-boundary losses agree to rtol 1e-5; the
    masked fit launches ctns_cd twice an iteration, the dense fit never
    (its covariate update is the closed form)."""
    import insider_tpu_torch as itt
    from insider_tpu_torch.model.state import state_from_numpy

    sim = itt.simulate_scale(120, 2000, 8, level_counts=(2, 4, 9),
                             noise_std=0.5, seed=2)
    rng = np.random.default_rng(7)
    c = rng.standard_normal((120, 2))
    data = sim.data + (c @ rng.standard_normal((2, 8))) @ sim.gene_factor
    histories, launched = {}, {}
    for dev in ("cuda", "cpu"):
        obj = itt.Insider(data, sim.confounder, c, interaction_idx=[0, 1],
                          max_iter=20, device=dev)
        init = np.random.default_rng(4)
        counts = [np.unique(v).size for v in obj.confounder.T]
        state = state_from_numpy(
            [1e-3 * init.standard_normal((L, 8)) for L in counts],
            1e-3 * init.standard_normal((2, 8)),
            1e-3 * init.standard_normal((8, obj.data.shape[1])), dev)
        n0 = ctns.ctns_cd.launches
        obj.fit(8, 5.0, 0.4, partition=partition, verbose=False, state=state)
        launched[dev] = ctns.ctns_cd.launches - n0
        histories[dev] = [h["loss"] for h in obj.fit_result.history]
    assert launched == {"cuda": 2 * 21 if partition else 0, "cpu": 0}
    np.testing.assert_allclose(histories["cuda"], histories["cpu"],
                               rtol=1e-5, atol=0)


def test_covariate_update_has_no_host_sync(cuda):
    """One masked covariate update (the constants, the (M, N) @ (N, K)
    correction and the ctns_cd launch) runs with the sync debug mode set
    to raise on any host sync."""
    from insider_tpu_torch.ops import continuous

    rng = np.random.default_rng(3)
    n, m, k = 60, 500, 8
    t = lambda x: _t(np.asarray(x, np.float32), cuda)
    mask, data = t(rng.random((n, m)) > 0.1), t(rng.standard_normal((n, m)))
    c, F = t(rng.standard_normal(n)), t(rng.standard_normal((k, m)))
    R_minus, w0 = t(rng.standard_normal((n, k))), t(np.zeros(k))
    q, bc = (c * c) @ mask, c @ (mask * data)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        w = continuous.update_ctns_row_masked_fast(q, bc, mask, R_minus, F,
                                                   c, w0, 1.0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(w).all()


def test_mixed_devices_raise(cuda):
    F = torch.zeros((4, 10), device=cuda)
    with pytest.raises(ValueError):
        row.level_gram(torch.zeros((3, 10)), F)


# uint8 masks: each kernel that reads the mask computes with it what it
# computes with the same mask as f32, bit for bit (the widening is exact and
# the sums keep their order).  M odd, so the uint8 rows start at any byte
# (the fused kernels stage them as the 16-byte chunks that cover them);
# N past one staging step; K = 8, 24, 32 and, where the kernel takes it,
# 50 and 128; a mask view that starts off a 16-byte chunk.
def _u8_case(rng, N, K, M, dev, offset=0):
    """A 0/1 mask (N, M) as uint8, `offset` bytes into its allocation, and
    the same mask as f32."""
    flat = _t((rng.random(N * M + offset) > 0.15).astype(np.uint8), dev)
    mask_u8 = flat[offset:].view(N, M)
    return mask_u8, mask_u8.float().contiguous()


@pytest.mark.parametrize("N,K,M", [(37, 8, 1031), (377, 24, 2001),
                                   (130, 50, 777), (90, 128, 131)])
def test_row_xty_uint8_mask(cuda, N, K, M):
    rng = np.random.default_rng(N + K)
    L = 7
    codes = _t(rng.integers(0, L, N).astype(np.int32), cuda)
    R = _t((0.3 * rng.standard_normal((N, K))).astype(np.float32), cuda)
    F = _t((0.3 * rng.standard_normal((K, M))).astype(np.float32), cuda)
    D = _t(rng.standard_normal((L, M)).astype(np.float32), cuda)
    u8, f32 = _u8_case(rng, N, K, M, cuda)
    got = row.row_xty(codes, R, u8, D, F)
    assert torch.equal(got, row.row_xty(codes, R, f32, D, F))
    assert _max_err_ok(got, row.row_xty_plain(codes, R, u8, D, F), 3e-5)


@pytest.mark.parametrize("N,M,K", [(64, 257, 8), (377, 2001, 24),
                                   (300, 777, 50), (90, 131, 128)])
def test_masked_eval_uint8_masks(cuda, N, M, K):
    rng = np.random.default_rng(N + M)
    data = _t(rng.standard_normal((N, M)).astype(np.float32), cuda)
    train_u8, train = _u8_case(rng, N, K, M, cuda)
    test = (1 - train) * _t((rng.random((N, M)) < 0.5).astype(np.float32),
                            cuda)
    test_u8 = test.to(torch.uint8)
    R = _t((0.3 * rng.standard_normal((N, K))).astype(np.float32), cuda)
    F = _t((0.3 * rng.standard_normal((K, M))).astype(np.float32), cuda)
    got = [float(x) for x in ev.masked_eval(data, train_u8, test_u8, R, F)]
    assert got == [float(x) for x in ev.masked_eval(data, train, test, R, F)]
    ref = [float(x) for x in ev.masked_eval_plain(data, train_u8, test_u8,
                                                  R, F)]
    for q in (0, 1):
        assert abs(got[q] - ref[q]) <= 1e-5 * abs(ref[q])
    assert got[2:] == ref[2:]
    with pytest.raises(TypeError):
        ev.masked_eval(data, train_u8, test, R, F)


@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("N,K,M", [(45, 5, 333), (377, 24, 2001),
                                   (130, 32, 515)])
def test_fused_kernels_uint8_mask(cuda, N, K, M, offset):
    rng = np.random.default_rng(N + K + offset)
    R = _t(rng.standard_normal((N, K)).astype(np.float32), cuda)
    data = _t(rng.standard_normal((N, M)).astype(np.float32), cuda)
    beta0 = _t((0.01 * rng.standard_normal((K, M))).astype(np.float32), cuda)
    u8, f32 = _u8_case(rng, N, K, M, cuda, offset)
    assert (u8.data_ptr() % 16 != 0) == bool(offset)
    lam, alpha = 11.0, 0.4
    kw = dict(max_outer=48, polish_sweeps=16, tol=1e-9)
    G = col_gram_masked(R, f32).permute(1, 2, 0)
    b = R.T @ (f32 * data)
    got = fss.feature_sign_fused(u8, data, R, beta0, lam, alpha, **kw)
    assert torch.equal(got, fss.feature_sign_fused(f32, data, R, beta0, lam,
                                                   alpha, **kw))
    _check_fss(got, fss.feature_sign_fused_plain(u8, data, R, beta0, lam,
                                                 alpha, **kw),
               G, b, lam, alpha)
    got = cd.cd_fused(u8, data, R, beta0, lam, alpha, 1e-9, 20)
    assert torch.equal(got, cd.cd_fused(f32, data, R, beta0, lam, alpha, 1e-9,
                                        20))
    _check_fss(got, cd.cd_fused_plain(u8, data, R, beta0, lam, alpha, 1e-9,
                                      20), G, b, lam, alpha)


@pytest.mark.parametrize("N,L,M", [(300, 7, 1031), (2000, 1700, 257)])
def test_segment_sum_equals_the_cpu_bit_for_bit(cuda, N, L, M):
    """The segment-sum row update's level sums (ops/row_update.segment_sum)
    on the card: each level's rows added in row order, as on the CPU, so
    the two agree bit for bit and a second run repeats them; with L=1700
    over 2000 rows some levels have no rows (sums 0)."""
    from insider_tpu_torch.ops.row_update import segment_sum

    rng = np.random.default_rng(N + L)
    x = rng.standard_normal((N, M)).astype(np.float32)
    codes = rng.integers(0, L, N).astype(np.int32)
    want = segment_sum(torch.from_numpy(x), torch.from_numpy(codes), L)
    xd, cd_ = _t(x, cuda), _t(codes, cuda)
    got = segment_sum(xd, cd_, L)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(segment_sum(xd, cd_, L), got)
