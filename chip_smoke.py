#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (insider_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: CUDA present; print the card's name and power limit
     (nvidia-smi); TF32 off for every f32 contraction;
  2. build: compile the CUDA kernels from insider_tpu_torch/csrc/;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the flagship shapes (377 x 44477, K=24, levels 2/16/8/107), with max
     error and median times (CUDA events);
  4. kernels of the dense and K > 32 paths, at full width (M=44477):
     col_gram_xty at K=24 (N=377) and K=50 (N=300); feature_sign at K=50
     on those grams; at K=24 feature_sign on col_gram_xty grams against
     feature_sign_fused, bit for bit; feature_sign_shared at K=24 on R^T R,
     R^T data;
  5. the cold-CD kernels at full width (M=44477): cd_fused at K=24
     (N=377), cd_streamed at K=50 on col_gram_xty grams (N=300) and at
     K=24 against cd_fused (bit for bit), cd_shared at K=24; each against
     its plain version at a short sweep cap and at the 200-sweep cap
     (every column's objective, and element-wise at the short cap);
  6. K = 96 and K = 128 at M=2048 (N=300): col_gram_xty, feature_sign,
     feature_sign_shared, cd_streamed and cd_shared against their plain
     versions;
  7. small fits: the same fit on the card (kernels) and on the CPU (plain
     versions) from one numpy initial state, per-boundary losses agree:
     masked K=8, dense K=8, masked K=40, masked alpha=0 (FSS); masked K=8,
     dense K=8, masked K=40 (cold CD); masked K=96 (FSS);
  8. flagship fit: Insider(...).fit(24, 11, 0.4, partition=1) at
     377 x 44477 on the card, then the same with partition=0;
  9. K=50 masked fit: the prediXcan shape, 300 x 44477, levels (12, 25),
     fit(50, 1.0, 0.5, partition=1), 20 iterations;
 10. cold-CD fits (col_solver="cd", cd_warm_start=False) of the problems
     of phases 8-9: flagship masked and dense, K=50 masked; the final loss
     is set against the FSS fit's.
A fit phase sets every launch count to 0 just before the fit and reads
them just after: each kernel of its path must have launched, and the
kernels of the other solver or route never; losses finite, and
non-increasing for the FSS fits (a cold-CD fit screens its warm start, so
its losses need not be monotone; whether they were is printed); ms per
iteration from the fit's own boundary clock (each boundary copies its
metrics to the host, so the clock reads a synchronized device).
Then one JSON line with the kernels' numbers, and as the last line
{"ok": true, "device": {...}}.  Without CUDA the script exits non-zero and
prints no result.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np

N, M, K = 377, 44477, 24
LEVELS = (2, 16, 8, 107)          # after the interaction is inserted
LAM, ALPHA, SUB_TOL = 11.0, 0.4, 1e-5


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def timed_ms(torch, fn, reps):
    """Median of `reps` CUDA-event timings of fn(), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_kernels(torch, row, fss, ev):
    """Kernels against plain versions at the flagship shapes.  Returns
    ({name: record} with max_abs_err, ms and plain_ms; FSS statistics)."""
    from insider_tpu_torch.ops.col_update import col_gram_masked

    dev = "cuda"
    rng = np.random.default_rng(0)
    R_true = rng.standard_normal((N, K)).astype(np.float32)
    F_true = rng.standard_normal((K, M)).astype(np.float32)
    F_true[:, rng.choice(M, int(0.3 * M), replace=False)] = 0.0
    data = (R_true @ F_true + rng.standard_normal((N, M))).astype(np.float32)
    train = (rng.random((N, M)) > 0.1).astype(np.float32)
    test = ((1.0 - train) * (rng.random((N, M)) > 0.5)).astype(np.float32)
    codes = [rng.integers(0, L, N).astype(np.int32) for L in LEVELS]
    F = (0.3 * rng.standard_normal((K, M))).astype(np.float32)
    R_minus = [(0.5 * rng.standard_normal((N, K))).astype(np.float32)
               for _ in LEVELS]
    beta0 = (F_true + 0.01 * rng.standard_normal((K, M))).astype(np.float32)

    t = lambda x: torch.from_numpy(x).to(dev)
    data_t, train_t, test_t, F_t = t(data), t(train), t(test), t(F)
    R_t, beta0_t = t(R_true), t(beta0)
    codes_t = [t(c) for c in codes]
    Rm_t = [t(r) for r in R_minus]
    E_t = [torch.nn.functional.one_hot(c.long(), L).float().T.contiguous()
           for c, L in zip(codes_t, LEVELS)]
    mw_cat = torch.cat([E @ train_t for E in E_t]).contiguous()
    D_t = [(E @ (train_t * data_t)).contiguous() for E in E_t]
    out = {}

    # level_gram: rtol 2e-5 of the output's max magnitude
    got = row.level_gram(mw_cat, F_t)
    ref = row.level_gram_plain(mw_cat, F_t)
    err = float((got - ref).abs().max())
    if not err <= 2e-5 * float(ref.abs().max()):
        fail(f"level_gram max err {err:.3e} vs max |ref| "
             f"{float(ref.abs().max()):.3e}")
    out["level_gram"] = dict(
        max_abs_err=err,
        ms=timed_ms(torch, lambda: row.level_gram(mw_cat, F_t), 20),
        plain_ms=timed_ms(torch, lambda: row.level_gram_plain(mw_cat, F_t),
                          20))

    # row_xty, every confounder's level count: rtol 3e-5 of max magnitude
    errs = []
    for v, L in enumerate(LEVELS):
        args = (codes_t[v], Rm_t[v], train_t, D_t[v], F_t)
        got, ref = row.row_xty(*args), row.row_xty_plain(*args)
        err = float((got - ref).abs().max())
        if not err <= 3e-5 * float(ref.abs().max()):
            fail(f"row_xty (L={L}) max err {err:.3e} vs max |ref| "
                 f"{float(ref.abs().max()):.3e}")
        errs.append(err)
    all_xty = lambda fn: [fn(codes_t[v], Rm_t[v], train_t, D_t[v], F_t)
                          for v in range(len(LEVELS))]
    out["row_xty"] = dict(
        max_abs_err=max(errs),
        ms=timed_ms(torch, lambda: all_xty(row.row_xty), 20),
        plain_ms=timed_ms(torch, lambda: all_xty(row.row_xty_plain), 20))

    # masked_eval: SSE rel err <= 1e-5, counts exact
    got = ev.masked_eval(data_t, train_t, test_t, R_t, F_t)
    ref = ev.masked_eval_plain(data_t, train_t, test_t, R_t, F_t)
    g, r = [float(x) for x in got], [float(x) for x in ref]
    for q in (0, 1):
        if not abs(g[q] - r[q]) <= 1e-5 * abs(r[q]):
            fail(f"masked_eval sse[{q}] {g[q]!r} vs {r[q]!r}")
    if g[2:] != r[2:]:
        fail(f"masked_eval counts {g[2:]} vs {r[2:]}")
    out["masked_eval"] = dict(
        max_abs_err=max(abs(a - b) for a, b in zip(g, r)),
        ms=timed_ms(torch, lambda: ev.masked_eval(
            data_t, train_t, test_t, R_t, F_t), 20),
        plain_ms=timed_ms(torch, lambda: ev.masked_eval_plain(
            data_t, train_t, test_t, R_t, F_t), 20))

    # feature_sign_fused: per-column objective of the kernel may exceed the
    # plain version's by at most 1e-6 relative (an f32 rounding difference
    # may flip one edge coordinate); report the share of matching columns
    kw = dict(max_outer=48, polish_sweeps=32, tol=SUB_TOL)
    args = (train_t, data_t, R_t, beta0_t, LAM, ALPHA)
    got = fss.feature_sign_fused(*args, **kw)
    ref = fss.feature_sign_fused_plain(*args, **kw)
    G = col_gram_masked(R_t, train_t).double()                   # (M, K, K)
    b = (R_t.T @ (train_t * data_t)).double()                    # (K, M)
    l1, l2 = LAM * ALPHA, LAM * (1 - ALPHA)

    def objective(B):
        B = B.double()
        q = 0.5 * torch.einsum("km,mkl,lm->m", B, G, B) - (b * B).sum(0)
        return q + l2 / 2 * (B * B).sum(0) + l1 * B.abs().sum(0)

    fk, fp = objective(got), objective(ref)
    excess = (fk - fp) / fp.abs().clamp(min=1.0)
    if not bool(torch.isfinite(got).all()):
        fail("feature_sign_fused returned non-finite values")
    if not float(excess.max()) <= 1e-6:
        fail(f"feature_sign_fused objective excess {float(excess.max()):.3e}")
    match = torch.isclose(got, ref, rtol=2e-5, atol=1e-5).all(0)
    stats = {"match_share": float(match.double().mean()),
             "max_objective_excess": float(excess.max())}
    out["feature_sign_fused"] = dict(
        max_abs_err=float((got - ref).abs().max()),
        ms=timed_ms(torch, lambda: fss.feature_sign_fused(*args, **kw), 10),
        plain_ms=timed_ms(torch, lambda: fss.feature_sign_fused_plain(
            *args, **kw), 3))
    return out, stats


def problem(torch, n, k, m, seed):
    """A masked column problem on the card: R (n, k), mask and data (n, m),
    and a warm start near the true column factor."""
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((n, k)).astype(np.float32)
    F_true = rng.standard_normal((k, m)).astype(np.float32)
    F_true[:, rng.choice(m, int(0.3 * m), replace=False)] = 0.0
    data = (R @ F_true + rng.standard_normal((n, m))).astype(np.float32)
    mask = (rng.random((n, m)) > 0.1).astype(np.float32)
    beta0 = (F_true + 0.01 * rng.standard_normal((k, m))).astype(np.float32)
    return [torch.from_numpy(x).to("cuda") for x in (R, mask, data, beta0)]


def objectives(torch, B, G, b, lam, alpha):
    """Per-column elastic-net objective in f64.  G (K, K, M), b (K, M)."""
    l1, l2 = lam * alpha, lam * (1 - alpha)
    B, G, b = B.double(), G.double(), b.double()
    q = 0.5 * (B * (G * B[None]).sum(1)).sum(0) - (b * B).sum(0)
    return q + l2 / 2 * (B * B).sum(0) + l1 * B.abs().sum(0)


def fss_checks(torch, name, got, ref, G, b, lam, alpha):
    """The FSS kernels' checks against their plain version: finite, and the
    per-column objective of the kernel exceeds the plain version's by at
    most 1e-6 relative (an f32 rounding difference may flip one edge
    coordinate).  G (K, K, M) and b (K, M) as the kernels take them.
    Returns the share of columns matching at rtol 2e-5 / atol 1e-5 and the
    largest objective excess."""
    if not bool(torch.isfinite(got).all()):
        fail(f"{name} returned non-finite values")
    fk = objectives(torch, got, G, b, lam, alpha)
    fp = objectives(torch, ref, G, b, lam, alpha)
    excess = float(((fk - fp) / fp.abs().clamp(min=1.0)).max())
    if not excess <= 1e-6:
        fail(f"{name} objective excess {excess:.3e}")
    match = torch.isclose(got, ref, rtol=2e-5, atol=1e-5).all(0)
    return float(match.double().mean()), excess


def phase_kernels_slice2(torch, gram, fss):
    """col_gram_xty, feature_sign and feature_sign_shared against their
    plain versions at full width.  Returns ({name: record}, statistics)."""
    out, stats = {}, {}
    kw = dict(max_outer=48, polish_sweeps=32, tol=SUB_TOL)
    grams = {}
    for n, k, seed in ((N, K, 5), (300, 50, 6)):
        R, mask, data, beta0 = problem(torch, n, k, M, seed)
        got = gram.col_gram_xty(mask, data, R)
        ref = gram.col_gram_xty_plain(mask, data, R)
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        for g, r, what in zip(got, ref, ("gram", "xty")):
            e = float((g - r).abs().max())
            if not e <= 3e-5 * float(r.abs().max()):
                fail(f"col_gram_xty K={k} {what} max err {e:.3e} vs max "
                     f"|ref| {float(r.abs().max()):.3e}")
        rec = dict(
            max_abs_err=err,
            ms=timed_ms(torch, lambda: gram.col_gram_xty(mask, data, R), 10),
            plain_ms=timed_ms(torch, lambda: gram.col_gram_xty_plain(
                mask, data, R), 5))
        print(f"col_gram_xty K={k} N={n}: max_abs_err {err:.3e} kernel "
              f"{rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms")
        grams[k] = (R, mask, data, beta0, got)
        out["col_gram_xty"] = rec                  # the K=50 record is kept

    # feature_sign at K=50 on the kernel's grams
    R, mask, data, beta0, (G, b) = grams[50]
    lam, alpha = 1.0, 0.5
    got = fss.feature_sign(G, b, beta0, lam, alpha, **kw)
    ref = fss.feature_sign_plain(G, b, beta0, lam, alpha, **kw)
    share, excess = fss_checks(torch, "feature_sign", got, ref, G, b, lam,
                               alpha)
    stats["feature_sign"] = dict(match_share=share, max_objective_excess=excess)
    out["feature_sign"] = dict(
        max_abs_err=float((got - ref).abs().max()),
        ms=timed_ms(torch, lambda: fss.feature_sign(G, b, beta0, lam, alpha,
                                                    **kw), 5),
        plain_ms=timed_ms(torch, lambda: fss.feature_sign_plain(
            G, b, beta0, lam, alpha, **kw), 2))

    # K=24: the streamed route against the fused kernel, as
    # tests/test_fss.py:293-317 holds the two TPU kernels; the same gram
    # sums in the same order and the same FSS core: bit for bit
    R, mask, data, beta0, (G, b) = grams[K]
    streamed = fss.feature_sign(G, b, beta0, LAM, ALPHA, **kw)
    fused = fss.feature_sign_fused(mask, data, R, beta0, LAM, ALPHA, **kw)
    if not torch.equal(streamed, fused):
        fail(f"feature_sign vs feature_sign_fused at K={K}: max diff "
             f"{float((streamed - fused).abs().max()):.3e}")
    stats["streamed_vs_fused"] = float((streamed - fused).abs().max())

    # feature_sign_shared at K=24 on R^T R, R^T data
    XtX = (R.T @ R).contiguous()
    Xty = (R.T @ data).contiguous()
    got = fss.feature_sign_shared(XtX, Xty, beta0, LAM, ALPHA, **kw)
    ref = fss.feature_sign_shared_plain(XtX, Xty, beta0, LAM, ALPHA, **kw)
    share, excess = fss_checks(torch, "feature_sign_shared", got, ref,
                               XtX[:, :, None].expand(K, K, M), Xty, LAM,
                               ALPHA)
    stats["feature_sign_shared"] = dict(match_share=share,
                                        max_objective_excess=excess)
    out["feature_sign_shared"] = dict(
        max_abs_err=float((got - ref).abs().max()),
        ms=timed_ms(torch, lambda: fss.feature_sign_shared(
            XtX, Xty, beta0, LAM, ALPHA, **kw), 10),
        plain_ms=timed_ms(torch, lambda: fss.feature_sign_shared_plain(
            XtX, Xty, beta0, LAM, ALPHA, **kw), 3))
    return out, stats


def cd_checks(torch, name, fn, plain, args, G, b, lam, alpha, sweeps):
    """A CD kernel against its plain version on the same inputs, at a short
    sweep cap (10) and at the cap `sweeps`.  At both caps the kernel's
    output is finite and every column's objective exceeds the plain
    version's by at most 1e-6 relative, as fss_checks holds the FSS
    kernels; at the short cap >= 99% of the columns also match element-wise
    (rtol 2e-5 / atol 1e-5).  The matching share at the cap is reported.
    Returns (kernel output at the cap, statistics)."""
    seen = {}
    for cap in (10, sweeps):
        got, ref = fn(*args, cap), plain(*args, cap)
        if not bool(torch.isfinite(got).all()):
            fail(f"{name} returned non-finite values at {cap} sweeps")
        fk = objectives(torch, got, G, b, lam, alpha)
        fp = objectives(torch, ref, G, b, lam, alpha)
        excess = float(((fk - fp) / fp.abs().clamp(min=1.0)).max())
        match = float(torch.isclose(got, ref, rtol=2e-5, atol=1e-5).all(0)
                      .double().mean())
        seen[cap] = (match, excess)
        print(f"{name} at {cap} sweeps: columns matching plain {match:.6f}; "
              f"max objective excess {excess:.3e}; max abs err "
              f"{float((got - ref).abs().max()):.3e}")
        if not excess <= 1e-6:
            fail(f"{name} objective excess {excess:.3e} at {cap} sweeps")
    if not seen[10][0] >= 0.99:
        fail(f"{name}: {seen[10][0]:.6f} of the columns match plain at 10 "
             "sweeps")
    stats = dict(short_cap_match_share=seen[10][0],
                 short_cap_max_objective_excess=seen[10][1],
                 match_share=seen[sweeps][0],
                 max_objective_excess=seen[sweeps][1],
                 max_abs_err=float((got - ref).abs().max()))
    return got, stats


def phase_kernels_cd(torch, gram, cd):
    """The cold-CD kernels against their plain versions at full width.
    Returns {name: record}."""
    out, stats = {}, {}
    S = 200

    def record(name, fn, plain, args, reps):
        return dict(
            max_abs_err=stats[name]["max_abs_err"],
            ms=timed_ms(torch, lambda: fn(*args, S), reps),
            plain_ms=timed_ms(torch, lambda: plain(*args, S), 2))

    # cd_fused at the flagship shape, and cd_streamed on col_gram_xty's
    # grams of the same problem: the same sums, the same CD loop
    R, mask, data, beta0 = problem(torch, N, K, M, 7)
    G, b = gram.col_gram_xty(mask, data, R)
    args = (mask, data, R, beta0, LAM, ALPHA, SUB_TOL)
    fused, stats["cd_fused"] = cd_checks(torch, "cd_fused", cd.cd_fused,
                                         cd.cd_fused_plain, args, G, b, LAM,
                                         ALPHA, S)
    streamed = cd.cd_streamed(G, b, beta0, LAM, ALPHA, SUB_TOL, S)
    if not torch.equal(streamed, fused):
        fail(f"cd_streamed vs cd_fused at K={K}: max diff "
             f"{float((streamed - fused).abs().max()):.3e}")
    out["cd_fused"] = record("cd_fused", cd.cd_fused, cd.cd_fused_plain,
                             args, 5)

    # cd_shared at K=24 on R^T R, R^T data
    XtX, Xty = (R.T @ R).contiguous(), (R.T @ data).contiguous()
    args = (XtX, Xty, beta0, LAM, ALPHA, SUB_TOL)
    _, stats["cd_shared"] = cd_checks(
        torch, "cd_shared", cd.cd_shared, cd.cd_shared_plain, args,
        XtX[:, :, None].expand(K, K, M), Xty, LAM, ALPHA, S)
    out["cd_shared"] = record("cd_shared", cd.cd_shared, cd.cd_shared_plain,
                              args, 5)
    del G, b

    # cd_streamed at the prediXcan shape, K=50, N=300
    R, mask, data, beta0 = problem(torch, 300, 50, M, 8)
    G, b = gram.col_gram_xty(mask, data, R)
    args = (G, b, beta0, 1.0, 0.5, SUB_TOL)
    _, stats["cd_streamed"] = cd_checks(torch, "cd_streamed", cd.cd_streamed,
                                        cd.cd_streamed_plain, args, G, b, 1.0,
                                        0.5, S)
    out["cd_streamed"] = record("cd_streamed", cd.cd_streamed,
                                cd.cd_streamed_plain, args, 3)
    return out


def phase_kernels_wide(torch, gram, fss, cd):
    """K = 96 and K = 128 (three and four coordinates per lane) at
    M=2048, N=300: every gram-input kernel against its plain version.
    Returns {name: record}."""
    m, n = 2048, 300
    out = {}
    kw = dict(max_outer=48, polish_sweeps=32, tol=SUB_TOL)
    for k in (96, 128):
        R, mask, data, beta0 = problem(torch, n, k, m, k)
        G, b = gram.col_gram_xty(mask, data, R)
        ref = gram.col_gram_xty_plain(mask, data, R)
        for g, r, what in zip((G, b), ref, ("gram", "xty")):
            e = float((g - r).abs().max())
            if not e <= 3e-5 * float(r.abs().max()):
                fail(f"col_gram_xty K={k} {what} max err {e:.3e}")
        out[f"col_gram_xty K={k}"] = dict(
            max_abs_err=max(float((g - r).abs().max())
                            for g, r in zip((G, b), ref)),
            ms=timed_ms(torch, lambda: gram.col_gram_xty(mask, data, R), 5),
            plain_ms=timed_ms(torch, lambda: gram.col_gram_xty_plain(
                mask, data, R), 3))
        XtX, Xty = (R.T @ R).contiguous(), (R.T @ data).contiguous()
        Gd = XtX[:, :, None].expand(k, k, m)
        lam, alpha = 1.0, 0.5
        for name, fn, plain, args, GG, bb in (
                ("feature_sign", fss.feature_sign, fss.feature_sign_plain,
                 (G, b, beta0, lam, alpha), G, b),
                ("feature_sign_shared", fss.feature_sign_shared,
                 fss.feature_sign_shared_plain,
                 (XtX, Xty, beta0, lam, alpha), Gd, Xty)):
            got, r = fn(*args, **kw), plain(*args, **kw)
            share, excess = fss_checks(torch, f"{name} K={k}", got, r, GG,
                                       bb, lam, alpha)
            out[f"{name} K={k}"] = dict(
                max_abs_err=float((got - r).abs().max()),
                match_share=share, max_objective_excess=excess,
                ms=timed_ms(torch, lambda: fn(*args, **kw), 2),
                plain_ms=timed_ms(torch, lambda: plain(*args, **kw), 1))
        for name, fn, plain, args, GG, bb in (
                ("cd_streamed", cd.cd_streamed, cd.cd_streamed_plain,
                 (G, b, beta0, lam, alpha, SUB_TOL), G, b),
                ("cd_shared", cd.cd_shared, cd.cd_shared_plain,
                 (XtX, Xty, beta0, lam, alpha, SUB_TOL), Gd, Xty)):
            _, st = cd_checks(torch, f"{name} K={k}", fn, plain, args, GG,
                              bb, lam, alpha, 200)
            out[f"{name} K={k}"] = dict(
                st, ms=timed_ms(torch, lambda: fn(*args, 200), 2),
                plain_ms=timed_ms(torch, lambda: plain(*args, 200), 1))
    return out


def phase_small_fit(torch, itt, k=8, m=2000, partition=1, alpha=0.4,
                    max_iter=20, **solver):
    """Card (kernels) against CPU (plain versions) on one small fit."""
    from insider_tpu_torch.model.state import state_from_numpy

    n = 120
    sim = itt.simulate_scale(n, m, 8, level_counts=(2, 4, 9), noise_std=0.5,
                             seed=2)
    data = sim.data.astype(np.float64)
    data[np.random.default_rng(3).random(data.shape) < 0.01] = np.nan
    histories = {}
    for dev in ("cuda", "cpu"):
        obj = itt.Insider(data, sim.confounder, interaction_idx=[0, 1],
                          max_iter=max_iter, device=dev)
        rng = np.random.default_rng(4)
        levels = [np.unique(c).size for c in obj.confounder.T]
        cfd0 = [(1e-3 * rng.standard_normal((L, k))).astype(np.float32)
                for L in levels]
        F0 = (1e-3 * rng.standard_normal((k, obj.data.shape[1]))
              ).astype(np.float32)
        obj.fit(k, 5.0, alpha, partition=partition, verbose=False,
                state=state_from_numpy(cfd0, None, F0, dev), **solver)
        histories[dev] = obj.fit_result.history
    lc = [h["loss"] for h in histories["cuda"]]
    lp = [h["loss"] for h in histories["cpu"]]
    if len(lc) != len(lp) or not np.allclose(lc, lp, rtol=1e-5, atol=0):
        fail(f"small fit (K={k}, partition={partition}, alpha={alpha}, "
             f"{solver}) losses card {lc} vs cpu {lp}")
    return float(np.max(np.abs(np.subtract(lc, lp)) / np.abs(lp)))


def run_fit(torch, obj, wrappers, expect, name, monotone=True, **fit_kw):
    """Drive one fit through Insider.fit with every launch count set to 0
    just before it; check that the kernels in `expect` launched (and those
    mapped to 0 did not), that losses are finite and, with `monotone`,
    non-increasing; print its history and ms per iteration.  Returns the
    launch counts and the final loss."""
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    obj.fit(verbose=False, **fit_kw)
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    launches = {n: w.launches for n, w in wrappers.items()}
    print(f"{name}: launches {launches}")
    for n, want in expect.items():
        if (launches[n] < 1) if want else (launches[n] != 0):
            fail(f"{name}: {n} launched {launches[n]} times")
    hist = obj.fit_result.history
    losses = [h["loss"] for h in hist]
    if not all(np.isfinite(losses)):
        fail(f"{name}: non-finite loss: {losses}")
    rises = [(a, b) for a, b in zip(losses, losses[1:])
             if not b <= a * (1 + 1e-6)]
    print(f"{name}: losses non-increasing: {not rises}")
    if monotone and rises:
        fail(f"{name}: loss increased: {rises}")
    for h in hist:
        print(f"  iter {h['iter']}: loss {h['loss']!r} train_rmse "
              f"{h['train_rmse']!r} test_rmse {h['test_rmse']!r}")
    late = [h for h in hist if h["iter"] >= 10]
    if len(late) < 2:
        fail(f"{name}: the fit stopped before two boundaries past iter 10")
    first, last = late[0], late[-1]
    ms_fit = ((last["elapsed_s"] - first["elapsed_s"])
              / (last["iter"] - first["iter"]) * 1e3)
    print(f"{name}: {obj.fit_result.n_iter} iterations in {fit_s:.2f} s; "
          f"train_rmse {hist[-1]['train_rmse']!r} test_rmse "
          f"{obj.test_rmse!r}; {ms_fit:.3f} ms/iter over iterations "
          f"{first['iter'] + 1}-{last['iter']} (boundary evals included)")
    return launches, losses[-1]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2

    import insider_tpu_torch as itt
    from insider_tpu_torch.kernels import _lib, cd, eval as ev, fss, gram, row
    from insider_tpu_torch.train import als

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi)
    als.disable_tf32()
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("TF32 is enabled")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.time()
    _lib.lib()
    build_s = time.time() - t0
    log = (_lib.build().parent / "build.log").read_text()
    print(f"build: {build_s:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # 3. kernels against plain versions
    kern, fss_stats = phase_kernels(torch, row, fss, ev)
    for name, rec in kern.items():
        print(f"kernel {name}: max_abs_err {rec['max_abs_err']:.3e} "
              f"kernel {rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms")
    print(f"feature_sign_fused: columns matching plain (rtol 2e-5, atol "
          f"1e-5): {fss_stats['match_share']:.6f}; max objective excess "
          f"{fss_stats['max_objective_excess']:.3e}")

    # 4. kernels of the dense and K > 32 paths
    kern2, stats2 = phase_kernels_slice2(torch, gram, fss)
    kern.update(kern2)
    for name, rec in kern2.items():
        print(f"kernel {name}: max_abs_err {rec['max_abs_err']:.3e} "
              f"kernel {rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms")
    for name in ("feature_sign", "feature_sign_shared"):
        print(f"{name}: columns matching plain (rtol 2e-5, atol 1e-5): "
              f"{stats2[name]['match_share']:.6f}; max objective excess "
              f"{stats2[name]['max_objective_excess']:.3e}")
    print(f"feature_sign on col_gram_xty grams vs feature_sign_fused, K={K}: "
          f"max abs diff {stats2['streamed_vs_fused']:.3e}")

    # 5. the cold-CD kernels
    kern_cd = phase_kernels_cd(torch, gram, cd)
    kern.update(kern_cd)
    for name, rec in kern_cd.items():
        print(f"kernel {name}: max_abs_err {rec['max_abs_err']:.3e} "
              f"kernel {rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms")
    print(f"cd_streamed on col_gram_xty grams vs cd_fused, K={K}: equal bit "
          "for bit")

    # 6. K = 96 and K = 128
    for name, rec in phase_kernels_wide(torch, gram, fss, cd).items():
        print(f"kernel {name} M=2048: max_abs_err {rec['max_abs_err']:.3e} "
              f"kernel {rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms")

    # 7. small fits, card against CPU
    cold = dict(col_solver="cd", cd_warm_start=False)
    for label, kw in (("masked 120x2000 K=8", {}),
                      ("dense 120x2000 K=8", dict(partition=0)),
                      ("masked 120x500 K=40", dict(k=40, m=500)),
                      ("masked 120x2000 K=8 alpha=0", dict(alpha=0.0)),
                      ("cold CD masked 120x2000 K=8", cold),
                      ("cold CD dense 120x2000 K=8", dict(cold, partition=0)),
                      ("cold CD masked 120x500 K=40", dict(cold, k=40, m=500)),
                      ("masked 120x300 K=96, 10 iterations",
                       dict(k=96, m=300, max_iter=10))):
        rel = phase_small_fit(torch, itt, **kw)
        print(f"small fit {label}: card vs cpu max loss rel diff {rel:.3e}")

    wrappers = {"level_gram": row.level_gram, "row_xty": row.row_xty,
                "feature_sign_fused": fss.feature_sign_fused,
                "masked_eval": ev.masked_eval,
                "col_gram_xty": gram.col_gram_xty,
                "feature_sign": fss.feature_sign,
                "feature_sign_shared": fss.feature_sign_shared,
                "cd_fused": cd.cd_fused, "cd_streamed": cd.cd_streamed,
                "cd_shared": cd.cd_shared}
    no_cd = dict(cd_fused=0, cd_streamed=0, cd_shared=0)
    no_fss = dict(feature_sign_fused=0, feature_sign=0, feature_sign_shared=0)

    # 8. flagship fits through the user entry point
    sim = itt.simulate_scale(N, M, K, level_counts=(2, 8, 107),
                             noise_std=1.0, seed=0)
    data = sim.data.astype(np.float64)
    data[np.random.default_rng(0).random(data.shape) < 0.01] = np.nan
    flagship = itt.Insider(data, sim.confounder, interaction_idx=[0, 1],
                           split_ratio=0.1, device="cuda")
    masked_path = dict(level_gram=1, row_xty=1, masked_eval=1)
    flag = dict(latent_dimension=K, lambda_=LAM, alpha=ALPHA, max_iter=50)
    launches, fss_masked = run_fit(
        torch, flagship, wrappers,
        dict(masked_path, feature_sign_fused=1, **no_cd), "flagship fit",
        partition=1, **flag)
    dense, fss_dense = run_fit(
        torch, flagship, wrappers, dict(feature_sign_shared=1, **no_cd),
        "flagship dense fit", partition=0, **flag)
    launches["feature_sign_shared"] = dense["feature_sign_shared"]

    # 9. K=50 masked fit at the prediXcan shape
    sim = itt.simulate_scale(300, M, 50, level_counts=(12, 25),
                             noise_std=1.0, seed=1)
    data = sim.data.astype(np.float64)
    data[np.random.default_rng(1).random(data.shape) < 0.01] = np.nan
    predixcan = itt.Insider(data, sim.confounder, device="cuda")
    k50_fit = dict(latent_dimension=50, lambda_=1.0, alpha=0.5, partition=1,
                   max_iter=20)
    k50, fss_k50 = run_fit(
        torch, predixcan, wrappers,
        dict(masked_path, feature_sign_fused=0, col_gram_xty=1,
             feature_sign=1, **no_cd), "K=50 masked fit", **k50_fit)
    launches["col_gram_xty"] = k50["col_gram_xty"]
    launches["feature_sign"] = k50["feature_sign"]

    # 10. cold-CD fits of the same problems
    for name, obj, expect, fit_kw, fss_loss in (
            ("cold CD flagship fit", flagship,
             dict(masked_path, cd_fused=1, cd_streamed=0, cd_shared=0),
             dict(flag, partition=1), fss_masked),
            ("cold CD flagship dense fit", flagship,
             dict(cd_shared=1, cd_fused=0, cd_streamed=0),
             dict(flag, partition=0), fss_dense),
            ("cold CD K=50 masked fit", predixcan,
             dict(masked_path, col_gram_xty=1, cd_streamed=1, cd_fused=0,
                  cd_shared=0), k50_fit, fss_k50)):
        counts, loss = run_fit(torch, obj, wrappers, dict(expect, **no_fss),
                               name, monotone=False, **cold, **fit_kw)
        for n in ("cd_fused", "cd_streamed", "cd_shared"):
            if expect.get(n):
                launches[n] = counts[n]
        print(f"{name}: final loss {loss!r} vs FSS fit {fss_loss!r} "
              f"(ratio {loss / fss_loss:.6f})")
    del flagship, predixcan

    # result
    tpu = "insider_tpu/kernels/"
    # the CD kernels are the CD instances of the FSS kernels' templates
    sources = {"level_gram": ("level_gram.cu", tpu + "row_pallas.py:358"),
               "row_xty": ("row_xty.cu", tpu + "row_pallas.py:166, "
                           + tpu + "row_pallas.py:300"),
               "feature_sign_fused": ("fss.cu", tpu + "fss_pallas.py:419"),
               "masked_eval": ("masked_eval.cu",
                               tpu + "eval_pallas.py:150"),
               "col_gram_xty": ("col_gram_xty.cu",
                                tpu + "gram_pallas.py:103"),
               "feature_sign": ("fss_streamed.cu",
                                tpu + "fss_pallas.py:556"),
               "feature_sign_shared": ("fss_shared.cu",
                                       tpu + "fss_pallas.py:493"),
               "cd_fused": ("fss.cu", tpu + "cd_pallas.py:213, "
                            + tpu + "cd_packed.py:325"),
               "cd_streamed": ("fss_streamed.cu", tpu + "cd_pallas.py:358, "
                               + tpu + "cd_packed.py:256"),
               "cd_shared": ("fss_shared.cu", tpu + "cd_pallas.py:289")}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "insider_tpu_torch/csrc/" + sources[name][0],
         "replaces": sources[name][1],
         "launches": launches[name],
         "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"]} for name in wrappers]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
