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
and must agree with itself bit for bit.  Past K = 128 (WIDE_RANKS: 129,
160, 256 and 300, where the wide FSS and cold-CD solves read their gram
from device memory) the widened kernels are held to the same gates, with
both mask dtypes where the kernel takes both, and the gram builds also
past the shared-memory ceilings of their narrow tiling (col_gram_xty at K
= 700, level_gram at K = 520 with three count planes); ctns_cd is its plain
version bit for bit, sweep counts included, at every K.  The FSS and
cold-CD kernels past 128 also run at K = 320 and 321 (the grouped solves'
last K and the first where the block solve runs alone), and every width
of feature_sign_widths, feature_sign_shared_widths, cd_streamed_widths
and cd_shared_widths gives the block solve's bits (lanes=128) there, on
grams that are symmetric bit for bit, with each column's bits independent
of the columns beside it.
"""

import functools

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
WIDE_RANKS = (129, 160, 256, 300)   # past the narrow kernels' 128
# the edges of the row kernels' k-chunks of 16 past 128
ROW_EDGE_RANKS = (161, 191, 192, 193, 320, 321)


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
                                        (4, 13, 300, (1 << 24) - 1),
                                        (37, 129, 517, 1000),
                                        (37, 160, 517, 70000),
                                        (9, 256, 301, 1000),
                                        (9, 300, 301, 1000),
                                        (37, 520, 256, 70000)])
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


@pytest.mark.parametrize("K", [24, 160])
def test_level_gram_view_off_a_chunk(cuda, K):
    """An F view that starts off a 16-byte chunk (copied by the wrapper)
    gives the grams of the same F in its own allocation."""
    rng = np.random.default_rng(K)
    mw = _t(rng.integers(0, 1000, (9, 333)).astype(np.float32), cuda)
    big = _t(rng.standard_normal((K + 1, 333)).astype(np.float32), cuda)
    F = big[1:]
    assert F.data_ptr() % 16 and F.is_contiguous()
    assert torch.equal(row.level_gram(mw, F), row.level_gram(mw, F.clone()))


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
# N = 65535.  Past 128, at the wide tile's edges (csrc/predict_tile.cuh:
# 16 x 32 tiles, 64 x 128 where those give every SM a block, N x M from
# 300 x 3457): K at the k-chunks' edges; M ragged and below one column
# tile; N below one row tile; a level longer than a row group ("big") and
# empty levels, on both tiles; near-cancelling inputs on the 64 x 128
# tile at K = 161 and 300, where one f32 chain over K for each prediction
# left the error at 0.95 and 2.2 times the f64 gate's limit.
@pytest.mark.parametrize("N,L,K,M,layout", [
    (37, 3, 6, 1031, "random"), (150, 107, 24, 2000, "empty"),
    (40, 1, 8, 257, "random"), (300, 2000, 24, 513, "random"),
    (300, 2, 24, 1031, "big"), (200, 12, 50, 777, "empty"),
    (120, 25, 96, 301, "random"), (90, 9, 128, 130, "empty"),
    (70, 5, 13, 99, "big"), (1, 1, 24, 333, "random"),
    (1, 4, 8, 65, "random"), (65535, 3, 8, 37, "random"),
    (200, 8, 24, 8191, "cancel"), (150, 12, 129, 301, "empty"),
    (200, 8, 160, 8191, "cancel"), (120, 25, 256, 301, "random"),
    (90, 9, 300, 130, "big")]
    + [(150, 12, k, 301, "empty") for k in ROW_EDGE_RANKS]
    + [(37, 3, 161, 31, "random"), (300, 25, 193, 29, "big"),
       (11, 4, 191, 333, "random"), (1, 1, 321, 45, "random"),
       (300, 107, 161, 3457, "empty"), (300, 2, 193, 3501, "big"),
       (377, 16, 320, 3459, "random"), (300, 8, 161, 8191, "cancel"),
       (377, 8, 300, 8191, "cancel")])
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
    # a uint8 mask gives the f32 mask's bits
    assert torch.equal(got, row.row_xty(codes, R, mask.to(torch.uint8), D, F,
                                        levels))
    err, control = _row_xty_errors(codes, R, mask, D, F, got)
    assert err <= ROW_XTY_RTOL
    if layout == "cancel":
        assert control > ROW_XTY_RTOL


# past 128 also the wide tile's edges, as test_row_xty's: K at the
# k-chunks' edges, M and N below one tile, and the 64 x 128 tile
@pytest.mark.parametrize("N,M,K,no_test", [
    (64, 256, 8, False), (377, 1111, 24, False), (300, 777, 50, False),
    (120, 301, 96, True), (90, 130, 128, False), (1, 33, 24, True),
    (150, 301, 129, False), (120, 130, 160, True), (90, 131, 256, False),
    (65, 67, 300, False)]
    + [(150, 301, k, False) for k in ROW_EDGE_RANKS]
    + [(37, 31, 161, False), (11, 333, 191, True), (1, 45, 321, False),
       (300, 3457, 161, False), (377, 3459, 320, True),
       (301, 3501, 193, False)])
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
    # uint8 masks give the f32 masks' bits
    assert [float(x) for x in ev.masked_eval(
        data, train.to(torch.uint8), test.to(torch.uint8), R, F)] == got


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
                                      (70001, 8, 37, False)]
                         + [(70, k, 131, u8) for k in WIDE_RANKS
                            for u8 in (False, True)]
                         + [(300, 700, 64, u8) for u8 in (False, True)])
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
# kernels' shared-memory solve) from K = 33; the wide solve past K = 128,
# its gram in device memory at K = 256 and 300, with N about 2 K as at K =
# 128 (at N = 300, K = 256 the warm start far from the solution and
# max_outer = 2 leave the columns unconverged on an ill-conditioned gram,
# where the kernel and the plain version, both f32, lie 1-2e-5 apart and
# each as far from the f64 plain version)
@pytest.mark.parametrize("warm", WARM_STARTS)
@pytest.mark.parametrize("N,K,M", [(45, 5, 333), (377, 24, 1000),
                                   (100, 33, 300), (300, 50, 700),
                                   (120, 64, 257), (130, 65, 200),
                                   (150, 96, 130), (200, 128, 70),
                                   (260, 129, 64), (320, 160, 64),
                                   (500, 256, 40), (600, 300, 40),
                                   (640, 320, 40), (642, 321, 40)])
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
    assert torch.equal(G, G.transpose(0, 1))             # symmetric
    _check_fss_widths("feature_sign", got, (G, b, beta0, lam, alpha), kw, K)
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
                                   (300, 128, 70), (300, 129, 64),
                                   (300, 160, 64), (300, 256, 40),
                                   (350, 300, 40), (370, 320, 40),
                                   (371, 321, 40)])
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
    assert torch.equal(XtX, XtX.T)                       # symmetric
    _check_fss_widths("feature_sign_shared", got,
                      (XtX, b, beta0, lam, alpha), kw, K)


# The grouped solves' last K (320) and the next, where the block solve
# takes over
GROUP_MAX_K = 320


def _check_fss_widths(name, got, args, kw, K):
    """Past K = 128 the widths of feature_sign_widths /
    feature_sign_shared_widths: the grouped solve's to K = 320 (named by
    its polish's group width, 32), listed before the block solve (128),
    and past 320 the block solve alone; each gives the block solve's bits
    (lanes=128), and a width with no instance at this K raises."""
    if K <= 128:
        return
    fn = getattr(fss, name)
    widths = dict(getattr(fss, name + "_widths")(K))
    grouped = [] if K > GROUP_MAX_K else [32]
    assert sorted(widths) == sorted(grouped + [128])
    assert next(iter(widths)) != 128 or not grouped          # listed first
    block = fn(*args, **kw, lanes=128)
    assert torch.equal(got, block)
    for lanes in (8, 16, 32):
        if lanes in widths:
            assert widths[lanes] >= 1
            assert torch.equal(fn(*args, **kw, lanes=lanes), block), lanes
        else:
            with pytest.raises(RuntimeError):
                fn(*args, **kw, lanes=lanes)


@pytest.mark.parametrize("K", [129, 160, 256, 300, 320, 321])
@pytest.mark.parametrize("name", ["feature_sign", "feature_sign_shared"])
def test_fss_wide_columns_are_independent(cuda, name, K):
    """Past K = 128, at every width (the grouped solve's and the block
    solve): each column of one batched call equals, bit for bit, the
    kernel's output on that column alone, where neighbouring columns stop
    at very different steps and sweeps (every even column has Xty = 0 and
    a zero warm start: it converges at its first step and its first polish
    sweep; the odd ones run to the step and polish caps), and every width
    gives the same bits.  M = 37."""
    M = 37
    G, b, beta0 = _staggered(K, M, 200 + K, cuda)
    beta0[:, ::2] = 0.0
    if name == "feature_sign_shared":
        G = G[:, :, 0].contiguous()
    kw = dict(lam=0.05, alpha=0.5, max_outer=4, polish_sweeps=8, tol=0.0)
    fn = getattr(fss, name)
    got = fn(G, b, beta0, **kw)
    fewer = fn(G, b, beta0, **dict(kw, max_outer=3))
    assert float(got[:, ::2].abs().max()) == 0.0
    assert not all(torch.equal(got[:, j], fewer[:, j])
                   for j in range(1, M, 2))          # some at the cap
    for lanes, _ in getattr(fss, name + "_widths")(K):
        assert torch.equal(got, fn(G, b, beta0, **kw, lanes=lanes)), lanes
        for j in range(M):
            Gj = (G if name == "feature_sign_shared"
                  else G[:, :, j:j + 1].contiguous())
            alone = fn(Gj, b[:, j:j + 1].contiguous(),
                       beta0[:, j:j + 1].contiguous(), **kw, lanes=lanes)
            assert torch.equal(alone[:, 0], got[:, j]), (lanes, j)


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
    # one instance at K <= 128 (L = 8, 16 or 32 by K); every other width
    # raises
    widths = dict(cd.cd_shared_widths(K))
    assert list(widths) == [8 if K <= 32 else 16 if K <= 64 else 32]
    for lanes in (8, 16, 32, 128):
        if lanes in widths:
            assert widths[lanes] >= 32 // lanes
            assert torch.equal(got, cd.cd_shared(XtX, b, beta0, **kw,
                                                 lanes=lanes)), lanes
        else:
            with pytest.raises(RuntimeError):
                cd.cd_shared(XtX, b, beta0, **kw, lanes=lanes)


CD_WIDE_RANKS = WIDE_RANKS + (GROUP_MAX_K, GROUP_MAX_K + 1)


# past the narrow kernels' 128 (CD_WIDE_RANKS): the grouped loop's
# instances to K = 320 (L = 32 on a gram in shared memory; cd_streamed past
# K = 192 also L = 16 on grams read through L2), listed before the block
# solve (128), and past 320 the block solve alone; lam 11 screens nothing
# here, lam 30 screens part of every column (the skipped coordinates, the
# KKT reactivation)
@pytest.mark.parametrize("lam", [11.0, 30.0])
@pytest.mark.parametrize("K", CD_WIDE_RANKS)
@pytest.mark.parametrize("name", ["cd_streamed", "cd_shared"])
def test_cd_wide(cuda, name, K, lam):
    N, M = K + 50, 67
    R, mask, data, beta0 = _masked_inputs(N, K, M, seed=80 + K)
    R, mask, data, beta0 = (_t(x, cuda) for x in (R, mask, data, beta0))
    kw = dict(CD_KW, lam=lam)
    if name == "cd_streamed":
        G, b = gram.col_gram_xty_plain(mask, data, R)
        args, Gc = (G, b, beta0), G
        assert torch.equal(G, G.transpose(0, 1))             # symmetric
    else:
        G, b = (R.T @ R).contiguous(), (R.T @ data).contiguous()
        args, Gc = (G, b, beta0), G[:, :, None].expand(K, K, M)
        assert torch.equal(G, G.T)
    fn, plain = getattr(cd, name), getattr(cd, name + "_plain")
    n0 = fn.launches
    got = fn(*args, **kw)
    assert fn.launches == n0 + 1
    _check_cd(got, plain(*args, **kw), Gc, b, lam)
    assert torch.equal(got, fn(*args, **kw))                 # bit for bit
    thr = kw["alpha"] * (2 * lam - b.abs().max(0).values)
    assert bool((b.abs() < thr).any()) == (lam > 20)         # screened
    # every width gives the block solve's bits; a width with no instance
    # at this K raises
    widths = dict(getattr(cd, name + "_widths")(K))
    grouped = ([] if K > GROUP_MAX_K else
               [16, 32] if name == "cd_streamed" and K > 192 else [32])
    assert sorted(widths) == sorted(grouped + [128])
    assert next(iter(widths)) != 128 or not grouped          # listed first
    block = fn(*args, **kw, lanes=128)
    assert torch.equal(got, block)
    for lanes in (8, 16, 32):
        if lanes in widths:
            assert widths[lanes] >= 32 // lanes
            assert torch.equal(fn(*args, **kw, lanes=lanes), block), lanes
        else:
            with pytest.raises(RuntimeError):
                fn(*args, **kw, lanes=lanes)


@pytest.mark.parametrize("K", CD_WIDE_RANKS)
@pytest.mark.parametrize("name", ["cd_streamed", "cd_shared"])
def test_cd_wide_columns_are_independent(cuda, name, K):
    """Past K = 128, at every width (the grouped loop's instances and the
    block solve): each column of one batched call equals, bit for bit, the
    kernel's output on that column alone, where neighbouring columns stop
    at very different sweeps (every even one after a sweep, the odd ones at
    the cap), and every width gives the same bits.  M = 37."""
    M = 37
    G, b, beta0 = _staggered(K, M, K, cuda)
    if name == "cd_shared":
        G = G[:, :, 0].contiguous()
    kw = dict(lam=0.05, alpha=0.5, tol=0.0, max_sweeps=40)
    fn = getattr(cd, name)
    got = fn(G, b, beta0, **kw)
    fewer = fn(G, b, beta0, **dict(kw, max_sweeps=39))
    assert float(got[:, ::2].abs().max()) == 0.0
    assert not any(torch.equal(got[:, j], fewer[:, j])
                   for j in range(1, M, 2))          # at the cap
    for lanes, _ in getattr(cd, name + "_widths")(K):
        assert torch.equal(got, fn(G, b, beta0, **kw, lanes=lanes)), lanes
        for j in range(M):
            Gj = G if name == "cd_shared" else G[:, :, j:j + 1].contiguous()
            alone = fn(Gj, b[:, j:j + 1].contiguous(),
                       beta0[:, j:j + 1].contiguous(), **kw, lanes=lanes)
            assert torch.equal(alone[:, 0], got[:, j]), (lanes, j)


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
# the first past it; 33 and 128 fill a lane's second and fourth slot; past
# 128 (WIDE_RANKS) the block of 128 threads, XtX in shared memory at 129
# and 160, read in place at 256 and 300
@pytest.mark.parametrize("K", [1, 5, 24, 33, 64, 109, 110, 128]
                         + list(WIDE_RANKS))
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
    # past 128 too (the block of 128 threads), bit for bit its plain version
    rng = np.random.default_rng(129)
    A = rng.standard_normal((140, 129)).astype(np.float32)
    args = (_t(A.T @ A, cuda), _t(rng.standard_normal(129).astype(
        np.float32), cuda), torch.zeros(129, device=cuda), 1e-3, 1e-12, 3)
    w, sweeps = ctns.ctns_cd(*args, with_sweeps=True)
    w_ref, sweeps_ref = ctns.ctns_cd_plain(*args)
    assert int(sweeps) == int(sweeps_ref) == 3
    assert torch.equal(w, w_ref)


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
                                   (130, 50, 777), (90, 128, 131)]
                         + [(90, k, 131) for k in WIDE_RANKS]
                         + [(90, k, 131) for k in ROW_EDGE_RANKS]
                         + [(7, 161, 29), (300, 193, 3457)])
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
                                   (300, 777, 50), (90, 131, 128)]
                         + [(90, 131, k) for k in WIDE_RANKS]
                         + [(90, 131, k) for k in ROW_EDGE_RANKS]
                         + [(7, 29, 161), (300, 3457, 193)])
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


def _csv_table(path, n=120, m=500, seed=2):
    """An expression table as the command line reads it: a header, 3
    confounder columns (levels 2, 4, 9), then non-negative values with 1%
    NA, written with %.9g."""
    import insider_tpu_torch as itt

    sim = itt.simulate_scale(n, m, 8, level_counts=(2, 4, 9), seed=seed)
    rng = np.random.default_rng(seed)
    data = np.abs(sim.data).astype(np.float32)
    data[rng.random(data.shape) < 0.01] = np.nan
    table = np.column_stack([sim.confounder, data])
    with open(path, "w") as fh:
        fh.write(",".join(f"c{i}" for i in range(table.shape[1])) + "\n")
        for r in table:
            fh.write(",".join("NA" if np.isnan(v) else "%.9g" % v
                              for v in r) + "\n")


@pytest.mark.parametrize("partition", [1, 0])
def test_cli_fit_equals_in_process_card_fit(cuda, tmp_path, partition):
    """`fit` through the command line, on the card by default, saves the
    in-process card fit's factors and loss bit for bit."""
    import json

    import insider_tpu_torch as itt
    from insider_tpu_torch import cli

    path, out = str(tmp_path / "t.csv"), str(tmp_path / "f.npz")
    _csv_table(path)
    cli.main(["fit", "--data", path, "--confounder-cols", "3",
              "--interaction", "0,1", "--log2", "--rank", "8", "--lam", "2",
              "--alpha", "0.4", "--partition", str(partition), "--max-iter",
              "30", "--out", out])
    data, conf = cli._load_table(path, 3, True, 0)
    obj = itt.Insider(data, conf, interaction_idx=[0, 1], max_iter=30)
    assert obj.device.type == "cuda"
    obj.fit(8, 2.0, 0.4, partition=partition, verbose=False)
    z = np.load(out)
    for i, f in enumerate(obj.cfd_matrices):
        np.testing.assert_array_equal(z[f"factor{i}"], f)
    np.testing.assert_array_equal(z["column_factor"], obj.column_factor)
    with open(out + ".json") as fh:
        assert json.load(fh)["loss"] == obj.fit_result.loss


@pytest.mark.parametrize("masked", [True, False])
def test_debug_checks_keep_the_card_trajectory(cuda, masked):
    """FitConfig.debug_checks on the card: the same fit bit for bit (the
    checks only read); a NaN in a train-masked cell is pinned to the first
    row update."""
    import insider_tpu_torch as itt
    from insider_tpu_torch.config import FitConfig
    from insider_tpu_torch.model.state import init_state
    from insider_tpu_torch.train import als

    sim = itt.simulate_scale(120, 700, 8, level_counts=(2, 4, 9), seed=3)
    split = itt.ratio_splitter(sim.data, ratio=0.1, seed=3)
    problem = als.build_problem(split.data, sim.confounder,
                                split.train_indicator, split.test_indicator,
                                masked=masked, device="cuda")
    runs = []
    for checks in (False, True):
        cfg = FitConfig(latent_dim=8, lambda1=2.0, lambda2=2.0, alpha=0.4,
                        masked=masked, max_iter=20, global_tol=0.0,
                        debug_checks=checks)
        runs.append(als.optimize(problem, cfg, verbose=False))
    off, on = runs
    assert [h["loss"] for h in on.history] == [h["loss"]
                                               for h in off.history]
    for a, b in zip(on.row_matrices + [on.column_factor],
                    off.row_matrices + [off.column_factor]):
        np.testing.assert_array_equal(a, b)
    d = np.asarray(split.data).copy()
    ti = np.asarray(split.train_indicator).copy()
    d[1, 3], ti[1, 3] = np.nan, 1
    poisoned = als.build_problem(d, sim.confounder, ti, split.test_indicator,
                                 masked=masked, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    state = init_state(g, poisoned.n_levels, poisoned.shape[1], 8)
    with pytest.raises(als.NonFiniteError, match=r"row update V\[0\] "
                                                 r"\(optimize_row\)"):
        als._als_iteration(poisoned, cfg, state, 1e-5)


# --- the column kernels' tolerance on the device, the graph and the chain --

# two rungs of the sub_tol decay ladder, f32(1e-5 * decay)
RUNGS = (float(np.float32(1e-5 * 1.0)), float(np.float32(1e-5 * 1e-3)))


def _tol_cases(dev):
    """{kernel: (launch(tol), plain(tol), check(got, ref))} at shapes that
    take each kernel's route; the FSS kernels from far warm starts at a
    2-step cap, so that the polish, which tol stops, does the work."""
    R, mask, data, beta0 = (_t(x, dev) for x in _masked_inputs(77, 8, 301,
                                                                seed=5))
    Rw, maskw, dataw, beta0w = (_t(x, dev) for x in _masked_inputs(
        120, 40, 257, seed=6))
    far, farw = 100 * beta0, 100 * beta0w
    G, b = gram.col_gram_xty_plain(mask, data, R)
    Gw, bw = gram.col_gram_xty_plain(maskw, dataw, Rw)
    XtX, bd = (R.T @ R).contiguous(), (R.T @ data).contiguous()
    Gd = XtX[:, :, None].expand(*XtX.shape, bd.shape[1])
    lam, alpha = 11.0, 0.4
    fkw = dict(max_outer=2, polish_sweeps=16)
    ckw = dict(max_sweeps=20)

    def fss_check(G, b):
        return lambda got, ref: _check_fss(got, ref, G, b, lam, alpha)

    return {
        "feature_sign_fused": (
            lambda t: fss.feature_sign_fused(mask, data, R, far, lam, alpha,
                                             tol=t, **fkw),
            lambda t: fss.feature_sign_fused_plain(mask, data, R, far, lam,
                                                   alpha, tol=t, **fkw),
            fss_check(G, b)),
        "feature_sign": (
            lambda t: fss.feature_sign(Gw, bw, farw, lam, alpha, tol=t,
                                       **fkw),
            lambda t: fss.feature_sign_plain(Gw, bw, farw, lam, alpha, tol=t,
                                             **fkw),
            fss_check(Gw, bw)),
        "feature_sign_shared": (
            lambda t: fss.feature_sign_shared(XtX, bd, far, 30.0, alpha,
                                              tol=t, **fkw),
            lambda t: fss.feature_sign_shared_plain(XtX, bd, far, 30.0,
                                                    alpha, tol=t, **fkw),
            lambda got, ref: _check_fss(got, ref, Gd, bd, 30.0, alpha)),
        "cd_fused": (
            lambda t: cd.cd_fused(mask, data, R, beta0, lam, alpha, t, **ckw),
            lambda t: cd.cd_fused_plain(mask, data, R, beta0, lam, alpha, t,
                                        **ckw),
            fss_check(G, b)),
        "cd_streamed": (
            lambda t: cd.cd_streamed(Gw, bw, beta0w, lam, alpha, t, **ckw),
            lambda t: cd.cd_streamed_plain(Gw, bw, beta0w, lam, alpha, t,
                                           **ckw),
            fss_check(Gw, bw)),
        "cd_shared": (
            lambda t: cd.cd_shared(XtX, bd, beta0, 30.0, alpha, t, **ckw),
            lambda t: cd.cd_shared_plain(XtX, bd, beta0, 30.0, alpha, t,
                                         **ckw),
            lambda got, ref: _check_fss(got, ref, Gd, bd, 30.0, alpha)),
    }


@pytest.mark.parametrize("kernel", ["feature_sign_fused", "feature_sign",
                                    "feature_sign_shared", "cd_fused",
                                    "cd_streamed", "cd_shared"])
def test_tol_by_pointer_at_two_rungs(cuda, kernel):
    """One launch site, captured in a CUDA graph, reading its tolerance
    from one f32 on the card: replayed at two rungs of the decay ladder it
    gives what a launch with the tolerance as a float gives, bit for bit,
    and passes the kernel's checks against its plain version at each."""
    launch, plain, check = _tol_cases(cuda)[kernel]
    tol = torch.full((), RUNGS[0], dtype=torch.float32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch(tol)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = launch(tol)
    outs = []
    for rung in RUNGS:
        tol.fill_(rung)
        g.replay()
        torch.cuda.synchronize()
        got = out.clone()
        assert torch.equal(got, launch(rung)), rung
        check(got, plain(rung))
        outs.append(got)
    assert not torch.equal(*outs)        # the kernel read the new rung


def _graph_problem(kind, dev, sharding=None):
    import insider_tpu_torch as itt
    from insider_tpu_torch.train import als

    k = 160 if "K160" in kind else 40 if "K40" in kind else 8
    sim = itt.simulate_scale(120, 700, k, level_counts=(2, 4, 9), seed=3)
    split = itt.ratio_splitter(sim.data, ratio=0.1, seed=3)
    ctns = (np.random.default_rng(2).standard_normal((120, 2))
            .astype(np.float32) if "covariates" in kind else None)
    problem = als.build_problem(split.data, sim.confounder,
                                split.train_indicator, split.test_indicator,
                                ctns, masked="dense" not in kind,
                                sharding=sharding,
                                precompute="segment" not in kind,
                                device=dev)
    kw = dict(latent_dim=k, lambda1=2.0, lambda2=2.0, alpha=0.4,
              max_iter=60, global_tol=1e-9)
    if "cold" in kind:
        kw.update(col_solver="cd", cd_warm_start=False)
    if "converging" in kind:
        kw.update(max_iter=200, global_tol=_mid_dispatch_tol(problem, kw))
    return problem, kw


def _mid_dispatch_tol(problem, kw):
    """A global_tol that stops this fit at the 2nd, 3rd or 4th boundary of
    a dispatch of five (a later one is enqueued): between the relative
    loss decrease there and the least one before it, read from the fit
    run to 200 iterations with no stop."""
    from insider_tpu_torch.config import FitConfig
    from insider_tpu_torch.train import als

    res = als.optimize(problem, FitConfig(**dict(kw, max_iter=200,
                                                 global_tol=0.0)),
                       verbose=False)
    loss = {h["iter"]: h["loss"] for h in res.history}
    rel = {b: (loss[b - 10] - loss[b]) / loss[b - 10]
           for b in range(10, 201, 10)}
    for b in range(20, 201, 10):
        least = min(rel[c] for c in range(10, b, 10))
        if (b // 10) % 5 in (2, 3, 4) and 0 < rel[b] < least:
            return float(np.sqrt(rel[b] * least))
    pytest.fail(f"no boundary inside a dispatch to stop at: {rel}")


GRAPH_KINDS = ["masked", "dense", "cold masked", "cold dense", "masked K40",
               "covariates masked", "covariates dense", "segment masked",
               "segment dense", "converging masked", "masked K160",
               "dense K160", "cold masked K160"]


@pytest.mark.parametrize("kind", GRAPH_KINDS)
def test_graph_fit_equals_eager_fit(cuda, monkeypatch, kind):
    """The fit as replays of one captured iteration, unchained and chained
    (boundaries_per_dispatch 1 and 5), equals the eager fit (every kernel
    launched from the host, one boundary a dispatch) bit for bit;
    each replay counts the kernels of the captured iteration."""
    from insider_tpu_torch.config import FitConfig
    from insider_tpu_torch.train import als, graph

    problem, kw = _graph_problem(kind, cuda)
    wrappers = graph.kernel_wrappers()
    runs, counts = {}, {}
    for mode in ("eager", "graph 1", "graph 5"):
        with monkeypatch.context() as m:
            if mode == "eager":     # the fit as it runs off the card
                m.setattr(als, "graph_route", lambda *a, **k: False)
            for w in wrappers.values():
                w.launches = 0
            runs[mode] = als.optimize(problem, FitConfig(
                **kw, boundaries_per_dispatch=int(mode[-1]) if mode !=
                "eager" else 1), verbose=False)
            counts[mode] = {n: w.launches for n, w in wrappers.items()}
    ref = runs["eager"]
    assert not ref.graphed
    for mode in ("graph 1", "graph 5"):
        got = runs[mode]
        assert got.graphed and got.capture_s > 0
        assert [h["loss"] for h in got.history] == [h["loss"]
                                                    for h in ref.history]
        assert [h["decay"] for h in got.history[1:]] == [
            h["decay"] for h in ref.history[1:]]
        assert (got.n_iter, got.converged) == (ref.n_iter, ref.converged)
        for a, b in zip(got.row_matrices + [got.column_factor],
                        ref.row_matrices + [ref.column_factor]):
            np.testing.assert_array_equal(a, b)
    # the graph fits launch each kernel as often as the eager fit (the
    # first iteration eagerly, the others as replays), plus the iterations
    # (and their boundary's eval) a chained dispatch ran past its stop
    for mode in ("graph 1", "graph 5"):
        wasted = runs[mode].wasted_iters
        per_iter = {n: c / (ref.n_iter + 1) for n, c in counts["eager"].items()
                    if n != "masked_eval"}
        for n, c in per_iter.items():
            assert counts[mode][n] == c * (ref.n_iter + 1 + wasted), (mode, n)
        assert counts[mode]["masked_eval"] == (
            counts["eager"]["masked_eval"]
            + (wasted // 10 if problem.masked else 0))
    if "converging" in kind:
        assert ref.converged and ref.n_iter % 50 in (20, 30, 40)
        assert runs["graph 5"].wasted_iters == 10


@pytest.mark.parametrize("kind", ["covariates masked", "covariates dense",
                                  "segment masked", "segment dense"])
def test_one_by_one_sharded_card_fit_equals_the_eager_fit(
        cuda, monkeypatch, tmp_path, kind):
    """On the card, ShardingConfig(1, 1) with no process group runs the
    settings ported to the sharded fit (covariates, the segment-sum rows
    of precompute=False), checkpointed at boundary 30 and resumed, and
    under debug_checks: each bit for bit the eager unsharded fit (a
    sharded fit runs eagerly)."""
    from insider_tpu_torch.config import FitConfig, ShardingConfig
    from insider_tpu_torch.train import als

    problem, kw = _graph_problem(kind, cuda)
    sharded, _ = _graph_problem(kind, cuda, ShardingConfig(1, 1))
    monkeypatch.setattr(als, "graph_route", lambda *a, **k: False)
    ref = als.optimize(problem, FitConfig(**kw), verbose=False)
    path = str(tmp_path / "ckpt.npz")
    als.optimize(sharded, FitConfig(**dict(kw, max_iter=30)), verbose=False,
                 checkpoint_path=path)
    resumed = als.optimize(sharded, FitConfig(**kw), verbose=False,
                           checkpoint_path=path, resume=True)
    checked = als.optimize(sharded, FitConfig(**kw, debug_checks=True),
                           verbose=False)
    by_iter = {h["iter"]: h["loss"] for h in ref.history}
    assert [h["loss"] for h in checked.history] == [h["loss"]
                                                    for h in ref.history]
    assert resumed.history[0]["loss"] == by_iter[30]
    assert [(h["iter"], h["loss"]) for h in resumed.history[1:]] == [
        (h["iter"], h["loss"]) for h in ref.history if h["iter"] > 30]
    for got in (resumed, checked):
        assert not got.graphed
        for a, b in zip(got.row_matrices + [got.column_factor],
                        ref.row_matrices + [ref.column_factor]):
            np.testing.assert_array_equal(a, b)
        if ref.ctns_factor is not None:
            np.testing.assert_array_equal(got.ctns_factor, ref.ctns_factor)


# every column kernel, and the K it runs at: the fused ones up to 32, the
# others also past it (K=50: two coordinates a lane; K=160: the wide FSS
# and cold-CD solves and col_gram_xty's second Xty block)
NONFINITE_CASES = [(name, k) for k in (6, 24, 50)
                   for name in ("col_gram_xty", "feature_sign",
                                "feature_sign_shared", "cd_streamed",
                                "cd_shared")
                   + (("feature_sign_fused", "cd_fused") if k <= 32 else ())
                   ] + [(name, 160) for name in ("col_gram_xty", "feature_sign",
                                                 "feature_sign_shared",
                                                 "cd_streamed", "cd_shared")
                        ] + [(name, k) for k in (300, 321)
                             for name in ("feature_sign",
                                          "feature_sign_shared",
                                          "cd_streamed", "cd_shared")]


@pytest.mark.parametrize("name,K", NONFINITE_CASES)
def test_nonfinite_inputs_give_the_plain_versions_columns(cuda, name, K):
    """Column 1's data a NaN at a train element, column 2's an Inf, column
    3's warm start a NaN: the kernel gives non-finite the columns its plain
    version gives non-finite (an FSS kernel all NaN), a poisoned column it
    keeps finite as the plain version does (a CD kernel's NaN in Xty: zero),
    and every other column as on the clean input, bit for bit
    (tests/test_torch_nonfinite.py holds the plain versions to the TPU
    kernels there)."""
    rng = np.random.default_rng(K)
    N, M = 300, 1031
    R = _t(rng.standard_normal((N, K)).astype(np.float32), cuda)
    mask = _t((rng.random((N, M)) > 0.1).astype(np.float32), cuda)
    clean = _t(rng.standard_normal((N, M)).astype(np.float32), cuda)
    beta_clean = _t((0.01 * rng.standard_normal((K, M))).astype(np.float32),
                    cuda)
    data, beta0 = clean.clone(), beta_clean.clone()
    for j, v in ((1, float("nan")), (2, float("inf"))):
        data[int(torch.nonzero(mask[:, j])[0]), j] = v
    beta0[0, 3] = float("nan")
    kw = dict(max_outer=48, polish_sweeps=16, tol=1e-6)

    def run(fn, data, beta0):
        G = col_gram_masked(R, mask).permute(1, 2, 0).contiguous()
        b = R.T @ (mask * data)
        Gs, bs = (R.T @ R).contiguous(), (R.T @ data).contiguous()
        if name == "col_gram_xty":
            return fn(mask, data, R)[1]
        if name in ("feature_sign_fused", "cd_fused"):
            args = (mask, data, R, beta0, 2.0, 0.5)
        elif name in ("feature_sign", "cd_streamed"):
            args = (G, b, beta0, 2.0, 0.5)
        else:
            args = (Gs, bs, beta0, 2.0, 0.5)
        if name.startswith("cd"):
            return fn(*args, 1e-6, 200)
        return fn(*args, **kw)

    module = {"col_gram_xty": gram, "feature_sign": fss,
              "feature_sign_fused": fss, "feature_sign_shared": fss,
              "cd_fused": cd, "cd_streamed": cd, "cd_shared": cd}[name]
    kernel, plain = getattr(module, name), getattr(module, name + "_plain")
    got, ref = run(kernel, data, beta0), run(plain, data, beta0)
    base = run(kernel, clean, beta_clean)
    bad = ~torch.isfinite(got).all(0)
    assert torch.equal(bad, ~torch.isfinite(ref).all(0))
    assert bad[1:4].any()
    poisoned = torch.zeros_like(bad)             # its inputs' columns
    poisoned[1:3 if name == "col_gram_xty" else 4] = True
    assert torch.equal(got[:, ~poisoned], base[:, ~poisoned])
    # a poisoned column that stays finite (CD's NaN in Xty: screened out)
    # is the plain version's, zero
    kept = poisoned & ~bad
    assert torch.equal(got[:, kept], ref[:, kept])
    assert not got[:, kept].any()
    if name != "col_gram_xty":
        assert torch.isnan(got[:, bad]).all()
    if name not in ("col_gram_xty", "feature_sign_fused", "cd_fused") \
            and K > 128:
        # every width past 128 (the grouped solves' instances and the block
        # solve) gives these bits, NaNs in the same places
        for lanes, _ in getattr(module, name + "_widths")(K):
            other = run(functools.partial(kernel, lanes=lanes), data, beta0)
            assert torch.equal(torch.nan_to_num(other, 7.0),
                               torch.nan_to_num(got, 7.0)), lanes
            assert torch.equal(torch.isnan(other), torch.isnan(got)), lanes
