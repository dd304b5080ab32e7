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
     feature_sign_fused; feature_sign_shared at K=24 on R^T R, R^T data;
  5. small fits: the same fit on the card (kernels) and on the CPU (plain
     versions) from one numpy initial state, per-boundary losses agree:
     masked K=8, dense K=8, masked K=40, masked alpha=0;
  6. flagship fit: Insider(...).fit(24, 11, 0.4, partition=1) at
     377 x 44477 on the card;
  7. flagship dense fit: the same with partition=0;
  8. K=50 masked fit: the prediXcan shape, 300 x 44477, levels (12, 25),
     fit(50, 1.0, 0.5, partition=1), 20 iterations.
A fit phase sets every launch count to 0 just before the fit and reads
them just after: each kernel of its path must have launched (and the K=50
fit never the fused kernel); losses finite and non-increasing; ms per
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


def fss_checks(torch, name, got, ref, G, b, lam, alpha):
    """The FSS kernels' checks against their plain version: finite, and the
    per-column objective of the kernel exceeds the plain version's by at
    most 1e-6 relative (an f32 rounding difference may flip one edge
    coordinate).  G (K, K, M) and b (K, M) as the kernels take them.
    Returns the share of columns matching at rtol 2e-5 / atol 1e-5 and the
    largest objective excess."""
    if not bool(torch.isfinite(got).all()):
        fail(f"{name} returned non-finite values")
    l1, l2 = lam * alpha, lam * (1 - alpha)
    G, b = G.double(), b.double()

    def objective(B):
        B = B.double()
        q = 0.5 * (B * (G * B[None]).sum(1)).sum(0) - (b * B).sum(0)
        return q + l2 / 2 * (B * B).sum(0) + l1 * B.abs().sum(0)

    fk, fp = objective(got), objective(ref)
    excess = float(((fk - fp) / fp.abs().clamp(min=1.0)).max())
    if not excess <= 1e-6:
        fail(f"{name} objective excess {excess:.3e}")
    match = torch.isclose(got, ref, rtol=2e-5, atol=1e-5).all(0)
    return float(match.double().mean()), excess


def phase_kernels_slice2(torch, gram, fss):
    """col_gram_xty, feature_sign and feature_sign_shared against their
    plain versions at full width.  Returns ({name: record}, statistics)."""
    dev = "cuda"
    out, stats = {}, {}

    def problem(n, k, seed):
        rng = np.random.default_rng(seed)
        R = rng.standard_normal((n, k)).astype(np.float32)
        F_true = rng.standard_normal((k, M)).astype(np.float32)
        F_true[:, rng.choice(M, int(0.3 * M), replace=False)] = 0.0
        data = (R @ F_true + rng.standard_normal((n, M))).astype(np.float32)
        mask = (rng.random((n, M)) > 0.1).astype(np.float32)
        beta0 = (F_true + 0.01 * rng.standard_normal((k, M))
                 ).astype(np.float32)
        return [torch.from_numpy(x).to(dev) for x in (R, mask, data, beta0)]

    kw = dict(max_outer=48, polish_sweeps=32, tol=SUB_TOL)
    grams = {}
    for n, k, seed in ((N, K, 5), (300, 50, 6)):
        R, mask, data, beta0 = problem(n, k, seed)
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
    # tests/test_fss.py:293-317 holds the two TPU kernels
    R, mask, data, beta0, (G, b) = grams[K]
    streamed = fss.feature_sign(G, b, beta0, LAM, ALPHA, **kw)
    fused = fss.feature_sign_fused(mask, data, R, beta0, LAM, ALPHA, **kw)
    if not torch.allclose(streamed, fused, rtol=2e-5, atol=1e-5):
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


def phase_small_fit(torch, itt, k=8, m=2000, partition=1, alpha=0.4):
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
                          max_iter=20, device=dev)
        rng = np.random.default_rng(4)
        levels = [np.unique(c).size for c in obj.confounder.T]
        cfd0 = [(1e-3 * rng.standard_normal((L, k))).astype(np.float32)
                for L in levels]
        F0 = (1e-3 * rng.standard_normal((k, obj.data.shape[1]))
              ).astype(np.float32)
        obj.fit(k, 5.0, alpha, partition=partition, verbose=False,
                state=state_from_numpy(cfd0, None, F0, dev))
        histories[dev] = obj.fit_result.history
    lc = [h["loss"] for h in histories["cuda"]]
    lp = [h["loss"] for h in histories["cpu"]]
    if len(lc) != len(lp) or not np.allclose(lc, lp, rtol=1e-5, atol=0):
        fail(f"small fit (K={k}, partition={partition}, alpha={alpha}) "
             f"losses card {lc} vs cpu {lp}")
    return float(np.max(np.abs(np.subtract(lc, lp)) / np.abs(lp)))


def run_fit(torch, obj, wrappers, expect, name, **fit_kw):
    """Drive one fit through Insider.fit with every launch count set to 0
    just before it; check that the kernels in `expect` launched (and those
    mapped to 0 did not), that losses are finite and non-increasing; print
    its history and ms per iteration.  Returns the launch counts."""
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
    for a, b in zip(losses, losses[1:]):
        if not b <= a * (1 + 1e-6):
            fail(f"{name}: loss increased: {a!r} -> {b!r}")
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
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2

    import insider_tpu_torch as itt
    from insider_tpu_torch.kernels import _lib, eval as ev, fss, gram, row
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

    # 5. small fits, card against CPU
    for label, kw in (("masked 120x2000 K=8", {}),
                      ("dense 120x2000 K=8", dict(partition=0)),
                      ("masked 120x500 K=40", dict(k=40, m=500)),
                      ("masked 120x2000 K=8 alpha=0", dict(alpha=0.0))):
        rel = phase_small_fit(torch, itt, **kw)
        print(f"small fit {label}: card vs cpu max loss rel diff {rel:.3e}")

    wrappers = {"level_gram": row.level_gram, "row_xty": row.row_xty,
                "feature_sign_fused": fss.feature_sign_fused,
                "masked_eval": ev.masked_eval,
                "col_gram_xty": gram.col_gram_xty,
                "feature_sign": fss.feature_sign,
                "feature_sign_shared": fss.feature_sign_shared}

    # 6. flagship fit through the user entry point
    sim = itt.simulate_scale(N, M, K, level_counts=(2, 8, 107),
                             noise_std=1.0, seed=0)
    data = sim.data.astype(np.float64)
    data[np.random.default_rng(0).random(data.shape) < 0.01] = np.nan
    obj = itt.Insider(data, sim.confounder, interaction_idx=[0, 1],
                      split_ratio=0.1, device="cuda")
    masked_path = dict(level_gram=1, row_xty=1, feature_sign_fused=1,
                       masked_eval=1)
    launches = run_fit(torch, obj, wrappers, masked_path, "flagship fit",
                       latent_dimension=K, lambda_=LAM, alpha=ALPHA,
                       partition=1, max_iter=50)

    # 7. flagship dense fit (partition=0), same object
    dense = run_fit(torch, obj, wrappers, dict(feature_sign_shared=1),
                    "flagship dense fit", latent_dimension=K, lambda_=LAM,
                    alpha=ALPHA, partition=0, max_iter=50)
    launches["feature_sign_shared"] = dense["feature_sign_shared"]
    del obj

    # 8. K=50 masked fit at the prediXcan shape
    sim = itt.simulate_scale(300, M, 50, level_counts=(12, 25),
                             noise_std=1.0, seed=1)
    data = sim.data.astype(np.float64)
    data[np.random.default_rng(1).random(data.shape) < 0.01] = np.nan
    obj = itt.Insider(data, sim.confounder, device="cuda")
    k50 = run_fit(torch, obj, wrappers,
                  dict(masked_path, feature_sign_fused=0, col_gram_xty=1,
                       feature_sign=1),
                  "K=50 masked fit", latent_dimension=50, lambda_=1.0,
                  alpha=0.5, partition=1, max_iter=20)
    launches["col_gram_xty"] = k50["col_gram_xty"]
    launches["feature_sign"] = k50["feature_sign"]

    # result
    sources = {"level_gram": ("level_gram.cu", "row_pallas.py:358"),
               "row_xty": ("row_xty.cu", "row_pallas.py:166"),
               "feature_sign_fused": ("fss.cu", "fss_pallas.py:419"),
               "masked_eval": ("masked_eval.cu", "eval_pallas.py:150"),
               "col_gram_xty": ("col_gram_xty.cu", "gram_pallas.py:103"),
               "feature_sign": ("fss_streamed.cu", "fss_pallas.py:556"),
               "feature_sign_shared": ("fss_shared.cu", "fss_pallas.py:493")}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "insider_tpu_torch/csrc/" + sources[name][0],
         "replaces": "insider_tpu/kernels/" + sources[name][1],
         "launches": launches[name],
         "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"]} for name in wrappers]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
