#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (insider_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: CUDA present; print the card's name and power limit
     (nvidia-smi); TF32 off for every f32 contraction;
  2. build: compile the CUDA kernels from insider_tpu_torch/csrc/;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the flagship shapes (377 x 44477, K=24, levels 2/16/8/107), with max
     error and median times (CUDA events), and again, bit for bit;
     level_gram against its plain version in f64 (max error <= 1e-6 of the
     largest magnitude, a gate that must reject one bf16 plane of the
     table; also with a level of 80000 rows, counts above 2**16) and beside
     one cuBLAS f32 GEMM on the prebuilt table (library_ms, a yardstick the
     port never calls); row_xty against its
     plain version in f64 on inputs where D and T nearly cancel (max error
     <= 1e-4 of the largest magnitude, a gate that must reject the
     cancellation-prone f32 form D F^T - T F^T); row_xty and masked_eval at
     the K=50 shape (300 x 44477, levels 12/25); the fused kernels' gram
     build alone (feature_sign_fused with max_outer=0, polish_sweeps=0;
     cd_fused with max_sweeps=0);
  4. kernels of the dense and K > 32 paths, at full width (M=44477):
     col_gram_xty at K=24 (N=377) and K=50 (N=300), against its plain
     version in f32 and in f64 (grams and Xty within 1e-6 of the largest
     magnitude, and every entry within 1e-6 of its own sum of |terms|, a
     gate that must reject the grams over one bf16 plane of the table; the
     grams symmetric bit for bit), beside one cuBLAS f32
     GEMM of the prebuilt (K^2, N) table against the mask (library_ms);
     feature_sign at K=50 on those grams; at K=24 feature_sign on
     col_gram_xty's output against feature_sign_fused (route check);
     feature_sign_shared on R^T R, R^T data at K=24, at K=3 (PsychENCODE's
     lambda and alpha) and at K=25 (BrainSpan's), each with its match
     share, objective excess, group width and a bound that counts its
     solves' operations (fss_flops, from the fss_counts replay of the
     input);
  5. the cold-CD kernels at full width (M=44477): cd_fused at K=24
     (N=377; its group width and the columns an SM sweeps at once printed,
     and a bit-for-bit repeat), cd_streamed at K=50 on col_gram_xty grams
     (N=300; its group width printed) and at K=24 against cd_fused (route
     check), cd_shared at K=24; each against its plain version at a short
     sweep cap and at the 200-sweep cap (every column's objective, and
     element-wise at the short cap);
  6. K = 96 and K = 128 at M=2048 (N=300): col_gram_xty (with the f64
     gate of phase 4 and its library_ms), feature_sign,
     feature_sign_shared, cd_streamed and cd_shared against their plain
     versions;
  7. small fits: the same fit on the card (kernels) and on the CPU (plain
     versions) from one numpy initial state, per-boundary losses agree to
     rtol 1e-5: masked K=8, dense K=8, masked K=40, masked alpha=0 at K=8
     and at tests/test_torch_dense.py's ridge shape (40 x 300, K=6) (FSS
     and Cholesky); masked K=8, dense K=8, masked K=40 with R of full rank
     (cold CD; beside it the CPU fit on exact column grams, printed: how
     far the fit moves with their last bit); masked K=96 (FSS);
  8. flagship fit: Insider(...).fit(24, 11, 0.4, partition=1) at
     377 x 44477 on the card, then the same with partition=0;
  9. K=50 masked fit: the prediXcan shape, 300 x 44477, levels (12, 25),
     fit(50, 1.0, 0.5, partition=1), 20 iterations;
 10. cold-CD fits (col_solver="cd", cd_warm_start=False) of the problems
     of phases 8-9: flagship masked and dense, K=50 masked; the final loss
     is set against the FSS fit's;
 11. profile: torch.profiler over 10 iterations of the flagship masked and
     dense FSS fits, of the cold-CD flagship masked and dense fits and of
     the cold-CD K=50 masked fit, each from the state its fit (phase 8 or
     10) ended in; each
     kernel's device ms per iteration and per launch, each wrapper's in-fit
     device ms per launch (its kernels together), and the device busy
     share; fails if a kernel that launched shows no device time;
 12. what the columns cost, by counting replays of the plain iterations
     (printed, not gated): the FSS columns' outer steps, active sets and
     polish sweeps at five states, at the FSS flagship dense fit's end
     state with feature_sign_shared's in-fit bound (its solves' operations,
     fss_flops) beside its in-fit time from phase 11; the cold-CD columns'
     sweeps in one
     column update at K=24 (the flagship cold-CD masked and dense fits'
     end states) and K=50 (the cold-CD K=50 fit's end state and its fifth
     update), with the bound of that launch, its sweeps counted, and the
     sweeps that columns swept in lockstep, 2 or 4 to a warp, take; at the
     cold-CD flagship masked fit's end state also a replay of cd_fused's
     refill schedule (refill_replay): the sweeps its warps take when each
     group of a warp is fed the block's next column as its last
     converges;
 13. continuous covariates, checkpoint, glm: the flagship problem with P=3
     continuous covariates planted as tools/parity_run.py:129-139 plants
     them, fit(24, 11, 0.4, partition=1) and partition=0, 50 iterations
     (ctns_cd launched exactly 3 times an iteration in the masked fit, never
     in the dense one, whose covariate update is the closed form; losses
     non-increasing; ms/iter beside phase 8's); ctns_cd against its plain
     version on the masked fit's last inputs (K=24) and at K=128, both stop
     criteria (bit for bit, equal sweep counts; kernel, plain and bound
     times); small fits with P=2 covariates, masked and dense K=8, card
     against CPU (rtol 1e-5); one covariate update under
     torch.cuda.set_sync_debug_mode("error") (no host sync); the masked fit
     stopped at iteration 20 with a checkpoint and resumed to 50 equals the
     uninterrupted fit bit for bit; glm_interaction on the fit's residual
     and the 16-level interaction codes, card against CPU (coefficients
     rtol 1e-4), timed; torch.profiler over 10 iterations of the masked
     covariate fit, and over 10 covariate updates alone (their device ms
     per iteration);
 14. the memory-lean fit: row_xty, masked_eval, feature_sign_fused and
     cd_fused with uint8 masks against the same masks as f32, bit for bit,
     at the flagship shape (each also against its plain version, timed with
     both dtypes beside the uint8 bound) and at the K=50 shape (the fused
     kernels there at K=32, and col_gram_xty at K=50); the flagship FSS and
     cold-CD fits with mask_dtype=uint8, their losses bit for bit phases 8
     and 10's; the GTEx-sized masked fit (17382 x 56200, 54 tissues x 948
     donors and their interaction, about 14.7k levels, which takes the
     segment-sum update; K=24, 20 iterations) with uint8 and with f32
     masks: the routes, the precompute's column chunks, the problem's
     bytes on the card, the build's and the fit's peaks beyond them and
     ms/iter printed, and a profile of 5 iterations of the uint8 fit;
     the uint8 fit's last in-fit call of level_gram, row_xty (tissue and
     donor), masked_eval and feature_sign_fused launched again on its
     inputs and held against its plain version (gtex_infit_checks);
     gates: losses equal bit for bit, finite and
     non-increasing, level_gram once an iteration, row_xty twice,
     feature_sign_fused once, uint8 saving at least 0.99 x 2 N M 3 bytes,
     the build's peak at most 3 GB (N is cut only where the host's memory
     would not hold the set-up, and then printed); small fits card against
     CPU at rtol 1e-5: masked K=8 uint8, masked and dense K=8
     precompute=False, masked K=8 with the 9-level confounder on segment
     sums (the fast route's budget lowered in this process), masked K=40
     uint8 (col_gram_xty); optimize(profile_dir=...) writes a trace with
     the card's kernels and fits the same bits; fit_interaction and the two
     CD solvers, card against CPU.
The route checks (phases 4, 5): the fused kernels and col_gram_xty sum the
exact bf16 planes of the f32 table on the tensor cores in the same k-steps
of 16 rows, but the fused kernels sum Xty row by row and col_gram_xty each
k-step from zero, so the streamed route on col_gram_xty's output is held
to the fused kernel by every column's objective (within 1e-6
relative) and by >= 99% of the columns matching at rtol 2e-5 / atol 1e-5;
the share of columns equal bit for bit is printed.
A fit phase sets every launch count to 0 just before the fit and reads
them just after: each kernel of its path must have launched, and the
kernels of the other solver or route never; losses finite, and
non-increasing for the FSS fits (a cold-CD fit screens its warm start, so
its losses need not be monotone; whether they were is printed); ms per
iteration from the fit's own boundary clock (each boundary copies its
metrics to the host, so the clock reads a synchronized device).
Then one JSON line with the kernels' numbers: each kernel's bound_ms is
the larger of its bytes (each input read once, each output written once)
over 3.35 TB/s and its operations over the peak of their type (989
TFLOP/s bf16 tensor, 67 TFLOP/s f32), from the shapes of the timed call;
ctns_cd's count 2 K^2 flops a sweep over the sweeps it took on the timed
input; the CD kernels' operations count the sweeps their columns take on
the timed input (2 K^2 flops a column-sweep, the sweeps from a replay of the
plain iteration, cd_counts; phase 12 prints the same bound of one
column update in the cold-CD fits); feature_sign_shared's count its
solves' operations (fss_flops: each outer step's elimination, a^3 / 3
multiply-adds over its a active coordinates, and its gradient, K^2; each
polish sweep, K^2; from fss_counts' replay of the timed input); the other
FSS kernels' leave their solves out.  The uint8 records (phase 14) count a
byte an element of the mask; their launches are the GTEx-sized uint8 fit's
(the cold-CD flagship uint8 fit's for cd_fused).  As the last line {"ok": true,
"device": {...}}.
Without CUDA the script exits non-zero and prints no result.
"""

import inspect
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

N, M, K = 377, 44477, 24
LEVELS = (2, 16, 8, 107)          # after the interaction is inserted
LAM, ALPHA, SUB_TOL = 11.0, 0.4, 1e-5


HBM_BPS = 3.35e12                 # H100 SXM: bytes/s
TENSOR_BF16_FLOPS = 989e12        # dense bf16 tensor-core FLOP/s
F32_FLOPS = 67e12                 # f32 outside the tensor cores


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bound(nbytes, bf16_flop=0.0, f32_flop=0.0):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BPS
    t_ops = bf16_flop / TENSOR_BF16_FLOPS + f32_flop / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def pairs(k):
    return k * (k + 1) // 2


def fused_bound(n, k, m, sweeps=None, mask_bytes=4):
    """The fused column kernels: mask (mask_bytes an element) and data
    read, R, beta0 read, beta written; the gram in three bf16 planes on the
    tensor cores over the K(K+1)/2 pairs, Xty in f32; for CD with
    `sweeps`, also cd_flops (the FSS solve's operations are not
    counted)."""
    return bound(mask_bytes * n * m + 4 * (n * m + n * k + 2 * k * m),
                 bf16_flop=2 * 3 * pairs(k) * n * m,
                 f32_flop=2 * k * n * m + (0.0 if sweeps is None
                                           else cd_flops(k, sweeps)))


def col_gram_bound(n, k, m):
    """col_gram_xty: mask, data and R read, the (K, K, M) grams and Xty
    written; the pair sums in three bf16 planes on the tensor cores, Xty in
    f32."""
    return bound(4 * (2 * n * m + n * k + k * k * m + k * m),
                 bf16_flop=2 * 3 * pairs(k) * n * m, f32_flop=2 * k * n * m)


def gram_input_bound(k, m, shared, sweeps=None, fss=None):
    """The FSS / CD kernels on given grams: the grams, xty and beta0 read,
    beta written; for CD with `sweeps`, also cd_flops; for FSS with `fss`
    (fss_counts' replay of the input), also fss_flops (without, the FSS
    solve's operations are not counted)."""
    return bound(4 * ((k * k if shared else k * k * m) + 3 * k * m),
                 f32_flop=(cd_flops(k, sweeps) if sweeps is not None
                           else fss_flops(k, fss) if fss is not None
                           else 0.0))


def fss_flops(k, c):
    """The f32 operations of the FSS solves that the columns took (`c`:
    fss_counts' replay of this input): each outer step's elimination over
    its a active coordinates, a^3 / 3 multiply-adds, and its gradient G
    beta, K^2; each polish sweep's K rank-1 updates of s = G beta, K^2; 2
    flops a multiply-add."""
    return (2.0 / 3.0 * float(c["cubes"].sum())
            + 2.0 * k * k * float(c["steps"].double().sum()
                                  + c["polish_sweeps"].double().sum()))


def cd_flops(k, sweeps):
    """The f32 operations of the CD sweeps that the columns took (`sweeps`,
    per column, from cd_counts' replay of this input): each sweep updates K
    coordinates, each a K-wide rank-1 update of s = G beta, 2 K flops."""
    return 2.0 * k * k * float(sweeps.double().sum())


def sweep_bound(k, sweeps):
    """(bound_ms, bound_by) of the CD sweeps alone, at the f32 peak."""
    return bound(0.0, f32_flop=cd_flops(k, sweeps))


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


def flagship_inputs(torch):
    """The phase-3 inputs at the flagship shapes, on the card."""
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

    t = lambda x: torch.from_numpy(x).to("cuda")
    x = dict(data=t(data), train=t(train), test=t(test), F=t(F),
             R=t(R_true), beta0=t(beta0), codes=[t(c) for c in codes],
             R_minus=[t(r) for r in R_minus])
    E_t = [torch.nn.functional.one_hot(c.long(), L).float().T.contiguous()
           for c, L in zip(x["codes"], LEVELS)]
    x["mw_cat"] = torch.cat([E @ x["train"] for E in E_t]).contiguous()
    x["D"] = [(E @ (x["train"] * x["data"])).contiguous() for E in E_t]
    return x


def k50_inputs(torch):
    """The row kernels' inputs at the K=50 shape (prediXcan: 300 x 44477,
    levels 12 and 25), on the card."""
    n, k, levels = 300, 50, (12, 25)
    rng = np.random.default_rng(1)
    mask = torch.from_numpy((rng.random((n, M)) > 0.1)
                            .astype(np.float32)).to("cuda")
    codes = [torch.from_numpy(rng.integers(0, L, n).astype(np.int32))
             .to("cuda") for L in levels]
    E_t = [torch.nn.functional.one_hot(c.long(), L).float().T.contiguous()
           for c, L in zip(codes, levels)]
    F = torch.from_numpy((0.3 * rng.standard_normal((k, M)))
                         .astype(np.float32)).to("cuda")
    t = lambda x: torch.from_numpy(x.astype(np.float32)).to("cuda")
    R_minus = [t(0.5 * rng.standard_normal((n, k))) for _ in levels]
    R = t(rng.standard_normal((n, k)))
    data = t(rng.standard_normal((n, M)))
    test = (1.0 - mask) * t(rng.random((n, M)) > 0.5)
    return dict(mask=mask, codes=codes, F=F, R_minus=R_minus, R=R,
                data=data, test=test.contiguous(),
                mw=torch.cat([E @ mask for E in E_t]).contiguous(),
                D=[(E @ (mask * data)).contiguous() for E in E_t])


def row_order(row, codes, L):
    """row_xty's keyword for the per-problem row order that the package's
    kernel reads, as a fit passes it (computed once per problem); none for
    a package whose row_xty takes none."""
    return ({"levels": row.level_order(codes, L)}
            if hasattr(row, "level_order") else {})


def row_xty_times(torch, row, cases, mask, F, reps=20):
    """row_xty over every (codes, R_minus, D) of `cases` in one timed call,
    kernel and plain version, beside the bound: per case the mask (f32 or
    uint8), D, F, R and the row order read once, the (L, K) output
    written; the prediction's and the contraction's FMAs in f32."""
    n = mask.shape[0]
    k, m = F.shape
    mb = mask.element_size()
    orders = [row_order(row, c, D.shape[0]) for c, _, D in cases]
    b = bound(sum(mb * n * m
                  + 4 * (L * m + k * m + n * k + 2 * n + L + 1 + L * k)
                  for L in (D.shape[0] for _, _, D in cases)),
              f32_flop=sum(2 * (n * k * m + D.shape[0] * k * m)
                           for _, _, D in cases))
    return dict(
        ms=timed_ms(torch, lambda: [row.row_xty(c, r, mask, D, F, **o)
                                    for (c, r, D), o in zip(cases, orders)],
                    reps),
        plain_ms=timed_ms(torch, lambda: [row.row_xty_plain(c, r, mask, D, F)
                                          for c, r, D in cases], reps),
        bound_ms=b[0], bound_by=b[1])


def masked_eval_times(torch, ev, data, train, test, R, F, reps=20):
    """masked_eval's kernel and plain times beside its bound: data and the
    two masks (N, M; f32 or uint8), R and F read once; the prediction's
    FMAs in f32."""
    n, k = R.shape
    m = F.shape[1]
    b = bound(4 * (n * m + n * k + k * m) + 2 * train.element_size() * n * m
              + 32, f32_flop=2 * n * k * m)
    return dict(
        ms=timed_ms(torch, lambda: ev.masked_eval(data, train, test, R, F),
                    reps),
        plain_ms=timed_ms(torch, lambda: ev.masked_eval_plain(
            data, train, test, R, F), reps),
        bound_ms=b[0], bound_by=b[1])


def masked_eval_check(torch, ev, name, data, train, test, R, F):
    """masked_eval against its plain version: SSEs within 1e-5 relative,
    counts exact, and a second run equal bit for bit.  Returns the largest
    absolute difference."""
    got = ev.masked_eval(data, train, test, R, F)
    ref = ev.masked_eval_plain(data, train, test, R, F)
    g, r = [float(x) for x in got], [float(x) for x in ref]
    for q in (0, 1):
        if not abs(g[q] - r[q]) <= 1e-5 * abs(r[q]):
            fail(f"{name} sse[{q}] {g[q]!r} vs {r[q]!r}")
    if g[2:] != r[2:]:
        fail(f"{name} counts {g[2:]} vs {r[2:]}")
    if [float(x) for x in ev.masked_eval(data, train, test, R, F)] != g:
        fail(f"{name} differs from itself")
    return max(abs(a - b) for a, b in zip(g, r))


def row_xty_check(torch, row, name, codes, R_minus, mask, D, F):
    """row_xty against its f32 plain version (max error <= 3e-5 of the
    largest magnitude), given the row order and deriving it (the two equal
    bit for bit, which also repeats the kernel).  Returns the max error."""
    args = (codes, R_minus, mask, D, F)
    got = row.row_xty(*args, **row_order(row, codes, D.shape[0]))
    ref = row.row_xty_plain(*args)
    err = float((got - ref).abs().max())
    if not err <= 3e-5 * float(ref.abs().max()):
        fail(f"{name} max err {err:.3e} vs max |ref| "
             f"{float(ref.abs().max()):.3e}")
    if not torch.equal(got, row.row_xty(*args)):
        fail(f"{name} differs from itself (with and without the row order)")
    return err


ROW_XTY_RTOL = 1e-4


def row_xty_gate(torch, row, x):
    """row_xty against its plain version in f64 on inputs near a fit's end,
    where D and T nearly cancel: per flagship confounder, data = R_minus F
    + 0.01 noise, so S = D - T is about 1e-3 of D.  Max error <=
    ROW_XTY_RTOL of the largest magnitude of the f64 result; the gate must
    reject a control, the cancellation-prone f32 form D F^T - T F^T (T =
    E^T (mask .* R_minus F) in f32), which a kernel that contracted D and T
    with F apart would give.  At phase 3's other inputs (R_minus and F
    unrelated to the data) the two forms both pass, hence these inputs."""
    rng = np.random.default_rng(11)
    mask, F = x["train"], x["F"]
    worst = {"kernel": 0.0, "plain f32": 0.0, "f32 control": 0.0}
    for codes, Rm, L in zip(x["codes"], x["R_minus"], LEVELS):
        noise = torch.from_numpy(rng.standard_normal(mask.shape)).to("cuda")
        data = Rm.double() @ F.double() + 0.01 * noise
        E_t = torch.nn.functional.one_hot(codes.long(), L).double().T
        D = (E_t @ (mask.double() * data)).float().contiguous()
        exact = row.row_xty_plain(codes, Rm.double(), mask.double(),
                                  D.double(), F.double())
        T = E_t.float() @ (mask * (Rm @ F))
        scale = float(exact.abs().max())
        for name, got in (
                ("kernel", row.row_xty(codes, Rm, mask, D, F,
                                       **row_order(row, codes, L))),
                ("plain f32", row.row_xty_plain(codes, Rm, mask, D, F)),
                ("f32 control", D @ F.T - T @ F.T)):
            worst[name] = max(worst[name],
                              float((got.double() - exact).abs().max())
                              / scale)
        del noise, data, E_t, D, exact, T
    print("row_xty max err vs the f64 sum, near-cancelling inputs, over "
          "the four confounders, as a fraction of max |ref|: " + "; ".join(
              f"{k} {v:.4e}" for k, v in worst.items())
          + f"; limit {ROW_XTY_RTOL:g}; control "
          + ("rejected" if worst["f32 control"] > ROW_XTY_RTOL
             else "NOT rejected"))
    if not worst["kernel"] <= ROW_XTY_RTOL:
        fail(f"row_xty max err {worst['kernel']:.4e} of max |ref| > "
             f"{ROW_XTY_RTOL:g}")
    if worst["f32 control"] <= ROW_XTY_RTOL:
        fail("row_xty's gate does not reject the f32 form D F^T - T F^T")
    return worst


LEVEL_GRAM_RTOL = 1e-6


def level_gram_gate(torch, row, mw, F, got):
    """level_gram's output `got` against the plain version in f64: max
    error <= LEVEL_GRAM_RTOL of the largest magnitude, f32 accuracy (the
    plain f32 version's own error is printed beside it).  The gate must
    reject a control, the same sums over one bf16 plane of the table
    (exact in f64), which is what a lost plane of the kernel would give."""
    from insider_tpu_torch.ops.planes import bf16_planes
    from insider_tpu_torch.ops.row_update import factor_outer_table

    exact = row.level_gram_plain(mw.double(), F.double())
    limit = LEVEL_GRAM_RTOL * float(exact.abs().max())
    hi = bf16_planes(factor_outer_table(F))[0].double()
    errs = {name: float((x.double() - exact).abs().max()) for name, x in (
        ("kernel", got), ("plain f32", row.level_gram_plain(mw, F)),
        ("one-plane control", (mw.double() @ hi.T).reshape(exact.shape)))}
    print("level_gram max err vs the f64 sum: " + "; ".join(
        f"{k} {v:.4e}" for k, v in errs.items())
        + f"; limit {limit:.4e} ({LEVEL_GRAM_RTOL:g} of max |ref|)")
    if not errs["kernel"] <= limit:
        fail(f"level_gram max err {errs['kernel']:.4e} > {limit:.4e}")
    if errs["one-plane control"] <= limit:
        fail("level_gram's gate does not reject one bf16 plane of the table")


def level_gram_times(torch, row, mw, F, reps=20):
    """level_gram's kernel, plain and library times on (mw, F): the library
    yardstick is one cuBLAS f32 GEMM, mw @ table^T, with the (K^2, M)
    outer-product table built before the timed region (TF32 off).  The
    kernel's bf16 products: 3 table planes x 2 count planes (3 where a
    count reaches 65536) per term of the K(K+1)/2 pairs."""
    k = F.shape[0]
    table = (F[:, None, :] * F[None, :, :]).reshape(k * k, -1).contiguous()
    L, m = mw.shape
    largest = float(mw.max())
    count_planes = 2 if largest < 65536 else 3
    b = bound(4 * (L * m + k * m + L * k * k),
              bf16_flop=2 * 3 * count_planes * L * pairs(k) * m)
    # the largest count as a fit passes it (computed once per problem), in
    # a package whose level_gram takes it
    kw = ({"max_count": largest} if "max_count" in
          inspect.signature(row.level_gram).parameters else {})
    return dict(
        ms=timed_ms(torch, lambda: row.level_gram(mw, F, **kw), reps),
        plain_ms=timed_ms(torch, lambda: row.level_gram_plain(mw, F), reps),
        library_ms=timed_ms(torch, lambda: torch.matmul(mw, table.T), reps),
        bound_ms=b[0], bound_by=b[1])


COL_GRAM_RTOL = 1e-6


def col_gram_gate(torch, gram, name, mask, data, R, got):
    """col_gram_xty's output `got` (grams, Xty) against its plain version
    in f64, two ways, each <= COL_GRAM_RTOL: the max error as a fraction of
    the largest magnitude, and every entry's error as a fraction of its own
    sum of |terms| (sum_i mask_ij |R_ik R_il|, sum_i |R_ik mask_ij data_ij|),
    which a pair's small sums cannot hide behind the large ones.  The plain
    f32 version's errors are printed beside.  The gate must reject a
    control, the grams summed over the hi bf16 plane of the table alone
    (exact in f64), both ways; the grams must be symmetric bit for bit.
    Returns the errors."""
    from insider_tpu_torch.ops.planes import bf16_planes

    k = R.shape[1]
    m64, d64, r64 = mask.double(), data.double(), R.double()
    exact = gram.col_gram_xty_plain(m64, d64, r64)
    scale = (torch.einsum("im,ik,il->klm", m64, r64.abs(), r64.abs()),
             r64.abs().T @ (m64 * d64).abs())
    plain = gram.col_gram_xty_plain(mask, data, R)
    k1, k2 = torch.triu_indices(k, k, device=R.device)
    hi = bf16_planes((R[:, k1] * R[:, k2]).T.contiguous())[0].double()
    control = torch.empty_like(exact[0])
    control[k1, k2] = control[k2, k1] = hi @ m64

    def rel(x, i):
        e = exact[i]
        return float((x.double() - e).abs().max()) / float(e.abs().max())

    def entry(x, i):
        d = (x.double() - exact[i]).abs() / scale[i].clamp(min=1e-300)
        return float(d.max())

    errs = {}
    for what, x, i in (("kernel grams", got[0], 0), ("kernel xty", got[1], 1),
                       ("plain f32 grams", plain[0], 0),
                       ("plain f32 xty", plain[1], 1),
                       ("one-plane control", control, 0)):
        errs[what] = rel(x, i)
        errs[what + " per entry"] = entry(x, i)
    symmetric = torch.equal(got[0], got[0].transpose(0, 1))
    rejected = min(errs["one-plane control"],
                   errs["one-plane control per entry"]) > COL_GRAM_RTOL
    print(f"{name} err vs the f64 sums (max as a fraction of max |ref|; per "
          "entry, the largest fraction of its own sum of |terms|): "
          + "; ".join(f"{key} {v:.4e}" for key, v in errs.items())
          + f"; limit {COL_GRAM_RTOL:g}; control "
          + ("rejected" if rejected else "NOT rejected")
          + f"; symmetric bit for bit: {symmetric}")
    for key in ("kernel grams", "kernel xty", "kernel grams per entry",
                "kernel xty per entry"):
        if not errs[key] <= COL_GRAM_RTOL:
            fail(f"{name} {key} err {errs[key]:.4e} > {COL_GRAM_RTOL:g}")
    if not rejected:
        fail(f"{name}: the gate does not reject one bf16 plane of the table")
    if not symmetric:
        fail(f"{name}: the grams are not symmetric bit for bit")
    return errs


def col_gram_library_ms(torch, R, mask, reps=10):
    """col_gram_xty's library yardstick: one cuBLAS f32 GEMM (TF32 off) of
    the prebuilt (K^2, N) outer-product table of R against the mask, the
    grams in the kernel's (K^2, M) layout (Xty left out).  The port never
    calls it."""
    n, k = R.shape
    table = (R.T[:, None, :] * R.T[None, :, :]).reshape(k * k, n).contiguous()
    return timed_ms(torch, lambda: torch.matmul(table, mask), reps)


def build_alone_ms(torch, fss, cd, x, reps=20):
    """The fused kernels with no solve: feature_sign_fused with
    max_outer=0 and polish_sweeps=0, cd_fused with max_sweeps=0 (screening
    only), at the flagship shape: the gram and Xty build, and reading and
    writing beta."""
    args = (x["train"], x["data"], x["R"], x["beta0"], LAM, ALPHA)
    return dict(
        feature_sign_fused=timed_ms(torch, lambda: fss.feature_sign_fused(
            *args, max_outer=0, polish_sweeps=0, tol=SUB_TOL), reps),
        cd_fused=timed_ms(torch, lambda: cd.cd_fused(*args, SUB_TOL, 0), reps))


def phase_kernels(torch, row, fss, cd, ev):
    """Kernels against plain versions at the flagship shapes.  Returns
    ({name: record} with max_abs_err, ms, plain_ms and the bound; FSS
    statistics; the build-alone times)."""
    from insider_tpu_torch.ops.col_update import col_gram_masked

    x = flagship_inputs(torch)
    data_t, train_t, test_t, F_t = x["data"], x["train"], x["test"], x["F"]
    R_t, beta0_t, codes_t, Rm_t = x["R"], x["beta0"], x["codes"], x["R_minus"]
    mw_cat, D_t = x["mw_cat"], x["D"]
    out = {}

    # level_gram: rtol 2e-5 of the f32 plain version's max magnitude, and
    # against the f64 sum (level_gram_gate)
    got = row.level_gram(mw_cat, F_t)
    ref = row.level_gram_plain(mw_cat, F_t)
    err = float((got - ref).abs().max())
    if not err <= 2e-5 * float(ref.abs().max()):
        fail(f"level_gram max err {err:.3e} vs max |ref| "
             f"{float(ref.abs().max()):.3e}")
    level_gram_gate(torch, row, mw_cat, F_t, got)
    if not torch.equal(got, row.level_gram(mw_cat, F_t)):
        fail("level_gram differs from itself")
    # a level of 80000 rows beside the flagship's: counts above 2**16, where
    # all three count planes are nonzero, held by the same gate
    big = torch.from_numpy(np.random.default_rng(12).binomial(
        80000, 0.9, (1, M)).astype(np.float32)).to("cuda")
    if not float(big.min()) >= 65536:
        fail("the large level's counts are not all >= 65536")
    mw_big = torch.cat([mw_cat, big]).contiguous()
    print("level_gram with a level of 80000 rows (counts "
          f"{float(big.min()):.0f}-{float(big.max()):.0f}):")
    level_gram_gate(torch, row, mw_big, F_t, row.level_gram(mw_big, F_t))
    del big, mw_big
    out["level_gram"] = dict(max_abs_err=err,
                             **level_gram_times(torch, row, mw_cat, F_t))

    # row_xty, every confounder's level count: rtol 3e-5 of max magnitude
    # against the f32 plain version, bit for bit again; the f64 gate
    cases = list(zip(codes_t, Rm_t, D_t))
    errs = [row_xty_check(torch, row, f"row_xty (L={D.shape[0]})", c, r,
                          train_t, D, F_t) for c, r, D in cases]
    gate = row_xty_gate(torch, row, x)
    out["row_xty"] = dict(max_abs_err=max(errs), f64_gate=gate,
                          **row_xty_times(torch, row, cases, train_t, F_t))

    # masked_eval: SSE rel err <= 1e-5, counts exact, bit for bit again
    out["masked_eval"] = dict(
        max_abs_err=masked_eval_check(torch, ev, "masked_eval", data_t,
                                      train_t, test_t, R_t, F_t),
        **masked_eval_times(torch, ev, data_t, train_t, test_t, R_t, F_t))

    # both at the K=50 shape (checks only; chip_ab.py times them)
    k50 = k50_inputs(torch)
    for c, r, D in zip(k50["codes"], k50["R_minus"], k50["D"]):
        row_xty_check(torch, row, f"row_xty K=50 (L={D.shape[0]})", c, r,
                      k50["mask"], D, k50["F"])
    masked_eval_check(torch, ev, "masked_eval K=50", k50["data"],
                      k50["mask"], k50["test"], k50["R"], k50["F"])
    del k50

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
    if not torch.equal(got, fss.feature_sign_fused(*args, **kw)):
        fail("feature_sign_fused differs from itself")
    match = torch.isclose(got, ref, rtol=2e-5, atol=1e-5).all(0)
    stats = {"match_share": float(match.double().mean()),
             "max_objective_excess": float(excess.max())}
    bnd = fused_bound(N, K, M)
    out["feature_sign_fused"] = dict(
        max_abs_err=float((got - ref).abs().max()),
        ms=timed_ms(torch, lambda: fss.feature_sign_fused(*args, **kw), 10),
        plain_ms=timed_ms(torch, lambda: fss.feature_sign_fused_plain(
            *args, **kw), 3),
        bound_ms=bnd[0], bound_by=bnd[1])
    return out, stats, build_alone_ms(torch, fss, cd, x)


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


# feature_sign_shared's inputs by K, R^T R and R^T data of problem(): (N,
# M, seed, lam, alpha).  K=3 at PsychENCODE's lambda and alpha
# (workloads/psyencode.py), K=25 at BrainSpan's (workloads/brainspan.py),
# K=24 at the flagship's; K = 24, 50 are phase 4's problems, K = 96, 128
# phase 6's.
SHARED_CASES = {3: (N, M, 3, 120.0, 0.9), 24: (N, M, 5, LAM, ALPHA),
                25: (N, M, 25, 6.0, 0.4), 50: (300, M, 6, 1.0, 0.5),
                96: (300, 2048, 96, 1.0, 0.5),
                128: (300, 2048, 128, 1.0, 0.5)}


def shared_inputs(torch, k):
    """(XtX, Xty, beta0, lam, alpha) of SHARED_CASES[k] on the card."""
    n, m, seed, lam, alpha = SHARED_CASES[k]
    R, _, data, beta0 = problem(torch, n, k, m, seed)
    return ((R.T @ R).contiguous(), (R.T @ data).contiguous(), beta0, lam,
            alpha)


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


def route_check(torch, name, fused, streamed, G, b, lam, alpha):
    """A fused kernel against the streamed route on col_gram_xty's output
    for the same problem.  The two round the grams and Xty differently
    (module docstring), so an f32 rounding difference may move a column:
    every column's objective agrees within 1e-6
    relative, and >= 99% of the columns match at rtol 2e-5 / atol 1e-5; the
    share of columns equal bit for bit is printed.  Returns (matching
    share, largest objective difference, share equal bit for bit)."""
    ff = objectives(torch, fused, G, b, lam, alpha)
    fs = objectives(torch, streamed, G, b, lam, alpha)
    diff = float(((ff - fs).abs() / fs.abs().clamp(min=1.0)).max())
    share = float(torch.isclose(fused, streamed, rtol=2e-5, atol=1e-5)
                  .all(0).double().mean())
    bits = float((fused == streamed).all(0).double().mean())
    print(f"{name} on col_gram_xty's output vs the fused kernel, K={K}: "
          f"columns matching {share:.6f}, equal bit for bit {bits:.6f}; "
          f"max objective difference {diff:.3e}; max abs diff "
          f"{float((fused - streamed).abs().max()):.3e}")
    if not diff <= 1e-6:
        fail(f"{name} vs the fused kernel: objective difference {diff:.3e}")
    if not share >= 0.99:
        fail(f"{name} vs the fused kernel: {share:.6f} of the columns match")
    return share, diff, bits


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
        gate = col_gram_gate(torch, gram, f"col_gram_xty K={k}", mask, data,
                             R, got)
        bnd = col_gram_bound(n, k, M)
        rec = dict(
            max_abs_err=err, f64_gate=gate,
            ms=timed_ms(torch, lambda: gram.col_gram_xty(mask, data, R), 10),
            plain_ms=timed_ms(torch, lambda: gram.col_gram_xty_plain(
                mask, data, R), 5),
            library_ms=col_gram_library_ms(torch, R, mask),
            bound_ms=bnd[0], bound_by=bnd[1])
        print(f"col_gram_xty K={k} N={n}: max_abs_err {err:.3e} kernel "
              f"{rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms library "
              f"{rec['library_ms']:.4f} ms bound {bnd[0]:.4f} ms "
              f"({bnd[1]})")
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
    bnd = gram_input_bound(50, M, shared=False)
    out["feature_sign"] = dict(
        max_abs_err=float((got - ref).abs().max()),
        ms=timed_ms(torch, lambda: fss.feature_sign(G, b, beta0, lam, alpha,
                                                    **kw), 5),
        plain_ms=timed_ms(torch, lambda: fss.feature_sign_plain(
            G, b, beta0, lam, alpha, **kw), 2),
        bound_ms=bnd[0], bound_by=bnd[1])

    # K=24: the streamed route against the fused kernel, as
    # tests/test_fss.py:293-317 holds the two TPU kernels (route_check)
    R, mask, data, beta0, (G, b) = grams[K]
    streamed = fss.feature_sign(G, b, beta0, LAM, ALPHA, **kw)
    fused = fss.feature_sign_fused(mask, data, R, beta0, LAM, ALPHA, **kw)
    stats["streamed_vs_fused"] = route_check(torch, "feature_sign", fused,
                                             streamed, G, b, LAM, ALPHA)

    # feature_sign_shared on R^T R, R^T data: K=24 (the record of the
    # kernels line), PsychENCODE's K=3 and BrainSpan's K=25 (SHARED_CASES);
    # the bound counts the solves' operations (fss_counts' replay)
    for k in (K, 3, 25):
        XtX, Xty, beta0, lam, alpha = shared_inputs(torch, k)
        name = ("feature_sign_shared" if k == K
                else f"feature_sign_shared K={k}")
        got = fss.feature_sign_shared(XtX, Xty, beta0, lam, alpha, **kw)
        ref = fss.feature_sign_shared_plain(XtX, Xty, beta0, lam, alpha,
                                            **kw)
        Gd = XtX[:, :, None].expand(k, k, M)
        share, excess = fss_checks(torch, name, got, ref, Gd, Xty, lam,
                                   alpha)
        stats[name] = dict(match_share=share, max_objective_excess=excess)
        bnd = gram_input_bound(k, M, shared=True, fss=fss_counts(
            torch, Gd, Xty, beta0, lam, alpha, **kw))
        out[name] = dict(
            max_abs_err=float((got - ref).abs().max()),
            ms=timed_ms(torch, lambda: fss.feature_sign_shared(
                XtX, Xty, beta0, lam, alpha, **kw), 10),
            plain_ms=timed_ms(torch, lambda: fss.feature_sign_shared_plain(
                XtX, Xty, beta0, lam, alpha, **kw), 3),
            bound_ms=bnd[0], bound_by=bnd[1],
            lanes=fss.feature_sign_shared_widths(k)[0][0])
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
    Returns {name: record}; each bound counts the sweeps that the plain
    replay (cd_counts) takes on the same input, at the 200 cap."""
    from insider_tpu_torch.ops.col_update import col_gram_masked

    out, stats = {}, {}
    S = 200

    def record(name, fn, plain, args, reps, bnd):
        return dict(
            max_abs_err=stats[name]["max_abs_err"],
            ms=timed_ms(torch, lambda: fn(*args, S), reps),
            plain_ms=timed_ms(torch, lambda: plain(*args, S), 2),
            bound_ms=bnd[0], bound_by=bnd[1])

    # cd_fused at the flagship shape, and cd_streamed on col_gram_xty's
    # grams of the same problem: the same sums in another order, the same
    # CD loop (route_check)
    R, mask, data, beta0 = problem(torch, N, K, M, 7)
    G, b = gram.col_gram_xty(mask, data, R)
    args = (mask, data, R, beta0, LAM, ALPHA, SUB_TOL)
    fused, stats["cd_fused"] = cd_checks(torch, "cd_fused", cd.cd_fused,
                                         cd.cd_fused_plain, args, G, b, LAM,
                                         ALPHA, S)
    if not torch.equal(fused, cd.cd_fused(*args, S)):
        fail("cd_fused differs from itself")
    streamed = cd.cd_streamed(G, b, beta0, LAM, ALPHA, SUB_TOL, S)
    route_check(torch, "cd_streamed", fused, streamed, G, b, LAM, ALPHA)
    Gp = col_gram_masked(R, mask).permute(1, 2, 0).contiguous()
    sw = cd_counts(torch, Gp, R.T @ (mask * data), beta0, LAM, ALPHA,
                   SUB_TOL, S)["sweeps"]
    del Gp
    out["cd_fused"] = record("cd_fused", cd.cd_fused, cd.cd_fused_plain,
                             args, 5, fused_bound(N, K, M, sweeps=sw))

    # cd_shared at K=24 on R^T R, R^T data
    XtX, Xty = (R.T @ R).contiguous(), (R.T @ data).contiguous()
    args = (XtX, Xty, beta0, LAM, ALPHA, SUB_TOL)
    _, stats["cd_shared"] = cd_checks(
        torch, "cd_shared", cd.cd_shared, cd.cd_shared_plain, args,
        XtX[:, :, None].expand(K, K, M), Xty, LAM, ALPHA, S)
    sw = cd_counts(torch, XtX[:, :, None].expand(K, K, M), Xty, beta0, LAM,
                   ALPHA, SUB_TOL, S)["sweeps"]
    out["cd_shared"] = record("cd_shared", cd.cd_shared, cd.cd_shared_plain,
                              args, 5,
                              gram_input_bound(K, M, shared=True, sweeps=sw))
    del G, b

    # cd_streamed at the prediXcan shape, K=50, N=300
    R, mask, data, beta0 = problem(torch, 300, 50, M, 8)
    G, b = gram.col_gram_xty(mask, data, R)
    args = (G, b, beta0, 1.0, 0.5, SUB_TOL)
    _, stats["cd_streamed"] = cd_checks(torch, "cd_streamed", cd.cd_streamed,
                                        cd.cd_streamed_plain, args, G, b, 1.0,
                                        0.5, S)
    sw = cd_counts(torch, G, b, beta0, 1.0, 0.5, SUB_TOL, S)["sweeps"]
    out["cd_streamed"] = record("cd_streamed", cd.cd_streamed,
                                cd.cd_streamed_plain, args, 3,
                                gram_input_bound(50, M, shared=False,
                                                 sweeps=sw))
    out["cd_streamed"]["lanes"], columns = cd.cd_streamed_widths(50)[0]
    lanes, fused_columns = cd.cd_fused_widths(K)[0]
    print(f"cd_fused at K={K}: group width L={lanes}, {32 // lanes} columns a "
          f"warp, {fused_columns} columns an SM sweeps at once")
    for name in ("cd_fused", "cd_shared", "cd_streamed"):
        r = out[name]
        print(f"{name}: kernel {r['ms']:.4f} ms bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}; the sweeps of the plain replay counted)")
    print(f"cd_streamed at K=50: group width L={out['cd_streamed']['lanes']}"
          f", {32 // out['cd_streamed']['lanes']} columns a warp, {columns} "
          "an SM")
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
        bnd = col_gram_bound(n, k, m)
        out[f"col_gram_xty K={k}"] = dict(
            max_abs_err=max(float((g - r).abs().max())
                            for g, r in zip((G, b), ref)),
            f64_gate=col_gram_gate(torch, gram, f"col_gram_xty K={k}", mask,
                                   data, R, (G, b)),
            ms=timed_ms(torch, lambda: gram.col_gram_xty(mask, data, R), 5),
            plain_ms=timed_ms(torch, lambda: gram.col_gram_xty_plain(
                mask, data, R), 3),
            library_ms=col_gram_library_ms(torch, R, mask),
            bound_ms=bnd[0], bound_by=bnd[1])
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
            sw = cd_counts(torch, GG, bb, beta0, lam, alpha, SUB_TOL,
                           200)["sweeps"]
            bnd = gram_input_bound(k, m, shared=name == "cd_shared",
                                   sweeps=sw)
            out[f"{name} K={k}"] = dict(
                st, ms=timed_ms(torch, lambda: fn(*args, 200), 2),
                plain_ms=timed_ms(torch, lambda: plain(*args, 200), 1),
                bound_ms=bnd[0], bound_by=bnd[1])
        out[f"cd_streamed K={k}"]["lanes"] = cd.cd_streamed_widths(k)[0][0]
    return out


def phase_small_fit(torch, itt, k=8, m=2000, partition=1, alpha=0.4,
                    max_iter=20, n=120, levels=(2, 4, 9), seeds=(2, 3),
                    lam=5.0, true_k=8, witness=False, init="small",
                    n_ctns=0, **solver):
    """Card (kernels) against CPU (plain versions) on one small fit: data
    from simulate_scale(n, m, true_k, levels, seed=seeds[0]) with 1% NaNs
    (seeds[1]); from one initial state carried to both devices: numpy
    draws of 1e-3 scale (init "small"), or the package's own draw as
    Insider.fit makes it on the CPU (init "package": model/state.init_state
    from a CPU generator seeded with the object's seed).
    With `witness`, the CPU fit is also run with the column grams and Xty
    summed in f64 and rounded once (the exact inputs in f32), and its
    distance from the CPU fit is printed: how far the fit itself moves
    with the last bit of those inputs, the scale against which the card's
    distance is read.  With n_ctns, that many continuous covariates C
    (numpy, seed 7) are planted in the data as C W_true F_true and fitted,
    W starting from the same numpy draw on both devices.  Returns the
    card's largest relative distance and None, or a failure message."""
    from insider_tpu_torch.kernels.gram import col_gram_xty_plain
    from insider_tpu_torch.model.state import init_state, state_from_numpy
    from insider_tpu_torch.ops import col_update

    sim = itt.simulate_scale(n, m, true_k, level_counts=levels, noise_std=0.5,
                             seed=seeds[0])
    data = sim.data.astype(np.float64)
    ctns = None
    if n_ctns:
        crng = np.random.default_rng(7)
        ctns = crng.standard_normal((n, n_ctns))
        data = data + (ctns @ crng.standard_normal((n_ctns, true_k))
                       ) @ sim.gene_factor
    data[np.random.default_rng(seeds[1]).random(data.shape) < 0.01] = np.nan

    def exact_col_gram_xty(mask, data, R):
        g, x = col_gram_xty_plain(mask.double(), data.double(), R.double())
        return g.float(), x.float()

    histories = {}
    for dev in ("cuda", "cpu") + (("exact",) if witness else ()):
        run_on = "cpu" if dev == "exact" else dev
        obj = itt.Insider(data, sim.confounder, ctns, interaction_idx=[0, 1],
                          max_iter=max_iter, device=run_on)
        counts = [np.unique(c).size for c in obj.confounder.T]
        W0 = None
        if init == "small":
            rng = np.random.default_rng(4)
            cfd0 = [(1e-3 * rng.standard_normal((L, k))).astype(np.float32)
                    for L in counts]
            F0 = (1e-3 * rng.standard_normal((k, obj.data.shape[1]))
                  ).astype(np.float32)
            if n_ctns:
                W0 = (1e-3 * rng.standard_normal((n_ctns, k))
                      ).astype(np.float32)
        else:
            st = init_state(torch.Generator().manual_seed(obj.seed), counts,
                            obj.data.shape[1], k)
            cfd0 = [f.numpy() for f in st.cfd_factors]
            F0 = st.column_factor.numpy()
        state = state_from_numpy(cfd0, W0, F0, run_on)
        orig = col_update.col_gram_xty
        if dev == "exact":
            col_update.col_gram_xty = exact_col_gram_xty
        try:
            obj.fit(k, lam, alpha, partition=partition, verbose=False,
                    state=state, **solver)
        finally:
            col_update.col_gram_xty = orig
        histories[dev] = obj.fit_result.history
    lc = [h["loss"] for h in histories["cuda"]]
    lp = [h["loss"] for h in histories["cpu"]]
    if witness:
        le = [h["loss"] for h in histories["exact"]]
        print(f"small fit (K={k}, {solver}): CPU with exact column grams vs "
              "CPU, max loss rel diff "
              f"{float(np.max(np.abs(np.subtract(le, lp)) / np.abs(lp))):.3e}")
    if len(lc) != len(lp) or not np.allclose(lc, lp, rtol=1e-5, atol=0):
        return None, (f"small fit (K={k}, partition={partition}, alpha="
                      f"{alpha}, P={n_ctns}, {solver}) losses card {lc} vs "
                      f"cpu {lp}")
    return float(np.max(np.abs(np.subtract(lc, lp)) / np.abs(lp))), None


def flagship_object(itt):
    """The flagship problem (phases 8, 10, 11) as an Insider on the card."""
    sim = itt.simulate_scale(N, M, K, level_counts=(2, 8, 107),
                             noise_std=1.0, seed=0)
    data = sim.data.astype(np.float64)
    data[np.random.default_rng(0).random(data.shape) < 0.01] = np.nan
    return itt.Insider(data, sim.confounder, interaction_idx=[0, 1],
                       split_ratio=0.1, device="cuda")


def covariate_object(itt):
    """The flagship problem with P=3 continuous covariates (phase 13),
    planted as tools/parity_run.py:129-139 plants them (its Protocol C
    problem): C (N, 3) and W_true (3, K) from default_rng(7), the data
    plus C W_true F_true; the 1% NaNs and the split of flagship_object."""
    sim = itt.simulate_scale(N, M, K, level_counts=(2, 8, 107),
                             noise_std=1.0, seed=0)
    rng = np.random.default_rng(7)
    ctns = rng.standard_normal((N, 3)).astype(np.float32)
    w_true = rng.standard_normal((3, K)).astype(np.float32)
    data = (sim.data + (ctns @ w_true) @ sim.gene_factor).astype(np.float64)
    data[np.random.default_rng(0).random(data.shape) < 0.01] = np.nan
    return itt.Insider(data, sim.confounder, ctns, interaction_idx=[0, 1],
                       split_ratio=0.1, device="cuda")


def predixcan_object(itt):
    """The K=50 masked problem (phases 9, 10) as an Insider on the card."""
    sim = itt.simulate_scale(300, M, 50, level_counts=(12, 25),
                             noise_std=1.0, seed=1)
    data = sim.data.astype(np.float64)
    data[np.random.default_rng(1).random(data.shape) < 0.01] = np.nan
    return itt.Insider(data, sim.confounder, device="cuda")


FLAG_FIT = dict(latent_dimension=K, lambda_=LAM, alpha=ALPHA, max_iter=50)
K50_FIT = dict(latent_dimension=50, lambda_=1.0, alpha=0.5, partition=1,
               max_iter=20)
COLD = dict(col_solver="cd", cd_warm_start=False)


def device_kernel_times(torch, prof):
    """{device kernel name: (total us, launches)} of a torch.profiler run,
    from its device-side events (kernels and copies)."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.end - e.time_range.start
            tot, n = out.get(e.name, (0.0, 0))
            out[e.name] = (tot + us, n + 1)
    return out


# the device kernels of the profiled fit's wrappers, by a part of their names
KERNEL_NAMES = {"level_gram": "level_gram", "row_xty": "row_xty",
                "feature_sign_fused": "fused_kernel<",
                "masked_eval": "masked_eval", "col_gram_xty": "col_gram_xty",
                "feature_sign": "streamed_kernel<",
                "feature_sign_shared": "shared_kernel",
                "cd_fused": "fused_kernel<", "cd_streamed": "streamed_kernel<",
                "cd_shared": "shared_kernel", "ctns_cd": "ctns_cd_kernel"}


def profile_fit(torch, obj, wrappers, state, latent_dimension, lambda_,
                alpha, iters=10, masked=True, mask_dtype=None, **solver):
    """torch.profiler over `iters` iterations of the object's masked (or,
    with masked=False, dense) fit (FSS, or the FitConfig solver settings in
    `solver`; masks stored as mask_dtype) from `state` (where
    an earlier fit ended: in-fit inputs, kernels built and warm), boundary
    evals included (three: before, after iteration 0 and after the last).
    The problem is staged before the window, which holds train/als.optimize
    alone, as Insider.fit calls it.
    Prints each device kernel's ms per iteration and per launch and the
    device busy share (device kernel time over the host's window, which
    ends in a synchronize); fails if a kernel that launched shows no
    device time.  Returns {"busy_share", "kernels": {name: record}, ...}."""
    from torch.profiler import ProfilerActivity, profile

    from insider_tpu_torch.config import FitConfig
    from insider_tpu_torch.train import als

    cfg = FitConfig(latent_dim=latent_dimension, lambda1=lambda_,
                    lambda2=lambda_, alpha=alpha, masked=masked,
                    global_tol=obj.params["global_tol"],
                    sub_tol=obj.params["sub_tol"], max_iter=iters - 1,
                    seed=obj.seed, **solver)
    problem = als.build_problem(obj.data, obj.confounder,
                                obj.train_indicator + obj.test_indicator,
                                obj.na_indicator, obj.ctns_confounder,
                                masked=masked, mask_dtype=mask_dtype,
                                device="cuda")
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        als.optimize(problem, cfg, state=state, verbose=False)
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    launches = {n: w.launches for n, w in wrappers.items()}
    times = device_kernel_times(torch, prof)
    busy = sum(us for us, _ in times.values()) / wall_us
    kernels = {}
    for name, (us, n) in sorted(times.items(), key=lambda kv: -kv[1][0]):
        kernels[name] = dict(ms_per_iter=us / 1e3 / iters,
                             ms_per_launch=us / 1e3 / n, launches=n)
        print(f"  profile: {us / 1e3 / iters:9.4f} ms/iter "
              f"{us / 1e3 / n:9.4f} ms/launch x{n:4d}  {name[:90]}")
    print(f"  profile: device busy {busy:.3f} of {wall_us / 1e3:.2f} ms "
          f"({iters} iterations, 3 boundary evals); wrapper launches "
          f"{launches}")
    in_fit = {}
    for wname, n in launches.items():
        part = KERNEL_NAMES.get(wname)
        if not (n and part):
            continue
        us = sum(t for k, (t, _) in times.items() if part in k)
        if not us:
            fail(f"profile: {wname} launched {n} times, no device time")
        in_fit[wname] = dict(ms_per_launch=us / 1e3 / n,
                             ms_per_iter=us / 1e3 / iters, launches=n)
        print(f"  in fit: {wname} {us / 1e3 / n:.4f} ms per launch "
              f"(its kernels together), {n / iters:g} launches/iter")
    return dict(busy_share=busy, wall_ms=wall_us / 1e3, kernels=kernels,
                launches=launches, in_fit=in_fit)


def fss_counts(torch, G, xty, beta0, lam, alpha, max_outer=48,
               polish_sweeps=32, tol=SUB_TOL):
    """A counting replay of the FSS kernels' iteration on one input: the
    loop of the plain version (ops/fss.feature_sign_search, then its polish,
    ops/fss.elastic_net_cd without the strong rule), step by step, with
    counters per column.  G (K, K, M), xty and beta0 (K, M).  Returns the
    solution (the plain version's) and per-column tensors: outer steps
    taken, the largest active set solved, the sum over steps of the
    active-set size cubed (the work of an elimination over the active
    coordinates only), whether the column stopped at the max_outer cap,
    polish sweeps; and the active-set size of every (column, step) solve.
    The plain functions are not changed."""
    from insider_tpu_torch.ops import fss as plain

    l1, l2 = plain.penalties(lam, alpha)
    K, M = xty.shape
    dev = xty.device
    beta = beta0.clone()
    act = (beta != 0.0).to(beta.dtype)
    theta = torch.sign(beta)
    conv = torch.zeros((1, M), dtype=torch.bool, device=dev)
    thresh = l1 + plain.KKT_RTOL * (l1 + xty.abs().max(dim=0,
                                                       keepdim=True).values)
    steps = torch.zeros(M, dtype=torch.long, device=dev)
    max_act = torch.zeros(M, dtype=torch.long, device=dev)
    cubes = torch.zeros(M, dtype=torch.float64, device=dev)
    sizes = []
    for _ in range(max_outer):
        if bool(conv.all()):
            break
        live = ~conv[0]
        a = (act > 0.5).sum(0)
        steps += live
        max_act = torch.maximum(max_act, torch.where(live, a, 0))
        cubes += torch.where(live, a.double() ** 3, 0.0)
        sizes.append(a[live])
        beta_star = plain._active_solve(G, act, xty - l1 * theta, l2)
        flip = (act > 0.5) & (torch.sign(beta_star) != theta) & (beta != 0.0)
        denom = beta - beta_star
        safe = torch.where(flip & (denom != 0.0), denom, 1.0)
        t_k = torch.where(flip, beta / safe, 1.0).clamp(0.0, 1.0)
        t = t_k.min(dim=0, keepdim=True).values
        live = ~conv
        beta = torch.where((act > 0.5) & live, beta + t * (beta_star - beta),
                           beta)
        beta = torch.where(flip & (t_k <= t) & (t < 1.0) & live, 0.0, beta)
        act = (beta != 0.0).to(beta.dtype)
        theta = torch.sign(beta)
        solved = (t >= 1.0) & live
        grad = plain._gram_times(G, beta) + l2 * beta - xty
        viol = (act < 0.5) & (grad.abs() > thresh) & solved
        pick, best = plain._first_max_pick(torch.where(viol, grad.abs(), -1.0),
                                           viol)
        act = torch.where(pick, 1.0, act)
        theta = torch.where(pick, -torch.sign(grad), theta)
        conv = conv | (solved & ~(best > 0.0))
    capped = ~conv[0]

    # the polish: plain CD sweeps, every coordinate active
    idx = torch.arange(K, device=dev)
    d = G[idx, idx]
    s = plain._gram_times(G, beta)
    den = d + l2
    den = torch.where(den > 0.0, den, 1.0)
    inv_den, half_den = 1.0 / den, 0.5 * den
    inv_l1 = float(np.float32(1.0) / np.float32(max(l1, 1e-30)))
    tol32 = float(np.float32(tol))
    pconv = torch.zeros((1, M), dtype=torch.bool, device=dev)
    sweeps = torch.zeros(M, dtype=torch.long, device=dev)
    for _ in range(polish_sweeps):
        if bool(pconv.all()):
            break
        sweeps += ~pconv[0]
        dec = torch.zeros((1, M), dtype=beta.dtype, device=dev)
        for k in range(K):
            b_k = beta[k:k + 1]
            u = xty[k:k + 1] - s[k:k + 1] + b_k * d[k:k + 1]
            w = (torch.sign(u) * torch.clamp(u.abs() - l1, min=0.0)
                 * inv_den[k:k + 1])
            w = torch.where(pconv, b_k, w)
            delta = w - b_k
            xi = torch.where(w != 0.0, torch.sign(w),
                             torch.clamp(u * inv_l1, -1.0, 1.0))
            dec = dec + (half_den[k:k + 1] * delta * delta
                         + l1 * (b_k.abs() - xi * b_k))
            s = s + G[k] * delta
            beta[k:k + 1] = w
        pconv = pconv | (dec.abs() <= tol32)
    return dict(beta=beta, steps=steps, max_active=max_act, cubes=cubes,
                capped=capped, polish_sweeps=sweeps,
                sizes=torch.cat(sizes) if sizes else steps[:0])


def count_summary(torch, name, K, c):
    """One line of fss_counts' distributions: median, p90 and max of the
    outer steps, the largest active set and the polish sweeps per column;
    the share of columns at the max_outer cap; the active-set size over all
    (column, step) solves; and the elimination work over the active
    coordinates against the K^3 per step of a full-width elimination."""
    def dist(x):
        x = x.double()
        return dict(median=float(x.median()), p90=float(x.quantile(0.9)),
                    max=float(x.max()), mean=float(x.mean()))

    out = dict(K=K, columns=int(c["steps"].numel()),
               steps=dist(c["steps"]), max_active=dist(c["max_active"]),
               polish_sweeps=dist(c["polish_sweeps"]),
               capped_share=float(c["capped"].double().mean()),
               active_per_step=(dist(c["sizes"]) if c["sizes"].numel()
                                else None),
               active_work_share=float(c["cubes"].sum())
               / max(float(c["steps"].double().sum()) * K ** 3, 1.0))
    print(f"FSS counts, {name}: " + json.dumps(out))
    return out


def cd_counts(torch, G, xty, beta0, lam, alpha, tol, max_sweeps):
    """A counting replay of the cold-CD kernels' iteration on one input: the
    loop of the plain version (ops/fss.elastic_net_cd with the strong rule),
    sweep by sweep, with a counter per column.  G (K, K, M), xty and beta0
    (K, M), coordinates in the sweep order.  Returns the solution (the plain
    version's) and per column: sweeps taken, whether the column stopped at
    the max_sweeps cap, and its active (unscreened) coordinates at the
    end.  The plain function is not changed."""
    from insider_tpu_torch.ops import fss as plain

    l1, l2 = plain.penalties(lam, alpha)
    tol = float(np.float32(tol))
    K, M = xty.shape
    dev = xty.device
    lam32, alpha32 = np.float32(lam), np.float32(alpha)
    mx = xty.abs().max(dim=0, keepdim=True).values
    thr = float(alpha32) * (float(np.float32(2.0) * lam32) - mx)
    active = xty.abs() >= thr
    beta = beta0 * active.to(beta0.dtype)
    idx = torch.arange(K, device=dev)
    d = G[idx, idx]
    s = plain._gram_times(G, beta)
    den = d + l2
    den = torch.where(den > 0.0, den, 1.0)
    inv_den, half_den = 1.0 / den, 0.5 * den
    inv_l1 = float(np.float32(1.0) / np.float32(max(l1, 1e-30)))
    conv = torch.zeros((1, M), dtype=torch.bool, device=dev)
    sweeps = torch.zeros(M, dtype=torch.long, device=dev)
    for _ in range(max_sweeps):
        if bool(conv.all()):
            break
        sweeps += ~conv[0]
        upd = active & ~conv
        dec = torch.zeros((1, M), dtype=beta.dtype, device=dev)
        for k in range(K):
            b_k = beta[k:k + 1]
            u = xty[k:k + 1] - s[k:k + 1] + b_k * d[k:k + 1]
            w = (torch.sign(u) * torch.clamp(u.abs() - l1, min=0.0)
                 * inv_den[k:k + 1])
            w = torch.where(upd[k:k + 1], w, b_k)
            delta = w - b_k
            xi = torch.where(w != 0.0, torch.sign(w),
                             torch.clamp(u * inv_l1, -1.0, 1.0))
            dec = dec + (half_den[k:k + 1] * delta * delta
                         + l1 * (b_k.abs() - xi * b_k))
            s = s + G[k] * delta
            beta[k:k + 1] = w
        cand = ~conv & (dec.abs() <= tol)
        viol = ~active & ((s - xty).abs() > l1)
        active = active | (viol & cand)
        conv = conv | (cand & ~viol.any(dim=0, keepdim=True))
    return dict(beta=beta, sweeps=sweeps, capped=~conv[0],
                active=active.sum(0))


def refill_replay(sweeps, P, CB=64, warps=8):
    """A replay of cd_fused's refill schedule (csrc/fss.cu) on the sweeps
    that each column takes (cd_counts): each block of CB consecutive
    columns is solved by `warps` warps of P groups; group g of each warp
    takes the block's columns c = g (mod P) in order, the next one as its
    last converges, so a group's columns run back to back, and a warp
    sweeps while any of its groups holds a column (the refill prologue is
    not counted).  Returns (the warps' sweeps, P at a time, over the
    columns' own: what lockstep with refill costs; the mean over blocks of
    the block's slowest warp over its mean warp: how long a block holds
    its shared memory beyond its warps' average)."""
    import heapq

    sw = [int(x) for x in sweeps.cpu().tolist()]
    warp_sweeps, tail = 0, []
    for j0 in range(0, len(sw), CB):
        cols = sw[j0:j0 + CB]
        ends = [[0] * P for _ in range(warps)]
        for g in range(P):
            free = [(0, w) for w in range(warps)]
            for s in cols[g::P]:
                t, w = heapq.heappop(free)
                ends[w][g] = t + s
                heapq.heappush(free, (t + s, w))
        per_warp = [max(e) for e in ends]
        warp_sweeps += sum(per_warp)
        mean = sum(per_warp) / warps
        tail.append(max(per_warp) / mean if mean else 1.0)
    return P * warp_sweeps / max(sum(sw), 1), sum(tail) / len(tail)


def cd_count_summary(torch, name, K, c, bnd=None, refill=False):
    """One line of cd_counts' distributions: median, p90, max and mean of
    the sweeps and of the active coordinates per column, the share of
    columns at the sweep cap, and for P = 2 and 4 the sweeps that P
    neighbouring columns swept in lockstep take (P times the most of the
    P; cd_streamed's groups, fss_streamed.cu) over the columns' own; with
    `refill`, refill_replay's two ratios for P = 1, 2 and 4 (cd_fused at L
    = 32, 16 and 8); with `bnd`, the kernel's bound on this input
    (bound_ms, bound_by), its sweeps counted."""
    def dist(x):
        x = x.double()
        return dict(median=float(x.median()), p90=float(x.quantile(0.9)),
                    max=float(x.max()), mean=float(x.mean()))

    sw = c["sweeps"].double()
    lockstep = {}
    for p in (2, 4):
        padded = torch.nn.functional.pad(sw, (0, -sw.numel() % p))
        lockstep[p] = float(p * padded.view(-1, p).max(1).values.sum()
                            / sw.sum())
    out = dict(K=K, columns=int(c["sweeps"].numel()),
               sweeps=dist(c["sweeps"]), active=dist(c["active"]),
               capped_share=float(c["capped"].double().mean()),
               lockstep_sweeps=lockstep)
    if refill:
        replay = {p: refill_replay(c["sweeps"], p) for p in (1, 2, 4)}
        out.update(refill_sweeps={p: r[0] for p, r in replay.items()},
                   refill_block_tail={p: r[1] for p, r in replay.items()})
    if bnd is not None:
        out.update(bound_ms=bnd[0], bound_by=bnd[1],
                   sweeps_bound_ms=sweep_bound(K, c["sweeps"])[0])
    print(f"CD counts, {name}: " + json.dumps(out))
    return out


def captured_calls(torch, specs, run):
    """The arguments of chosen calls while run() runs: specs maps a key to
    (module, name, at), the `at`-th call (1-based) of <module>.<name>, or
    its last call where `at` is None; returns {key: (args, kwargs)}.  The
    wrappers are restored after."""
    wanted = {}
    for key, (module, name, at) in specs.items():
        wanted.setdefault((module, name), {})[at] = key
    seen, got, origs = {}, {}, {}

    def spy_for(module, name):
        orig = origs[(module, name)] = getattr(module, name)

        def spy(*args, **kw):
            n = seen[(module, name)] = seen.get((module, name), 0) + 1
            for at in (n, None):
                if at in wanted[(module, name)]:
                    got[wanted[(module, name)][at]] = (args, kw)
            return orig(*args, **kw)
        return spy

    try:
        for module, name in wanted:
            setattr(module, name, spy_for(module, name))
        run()
    finally:
        for (module, name), orig in origs.items():
            setattr(module, name, orig)
    for key, (module, name, at) in specs.items():
        if key not in got:
            fail(f"{name} was called {seen.get((module, name), 0)} times, "
                 f"not {at}")
    return got


def captured_call(torch, name, at, run, module=None):
    """The arguments of the `at`-th call (1-based) of <module>.<name> (by
    default ops/col_update, whose column-update kernel wrappers it names)
    while run() runs, as (args, kwargs); the wrapper is restored after."""
    if module is None:
        from insider_tpu_torch.ops import col_update as module
    return captured_calls(torch, {0: (module, name, at)}, run)[0]


def phase_counts(torch, itt, gram, flagship, flag_state, dense_state,
                 dense_ms, cd_flag_state, cd_dense_state, predixcan,
                 cd_k50_state):
    """Phase 12: what the FSS columns cost, by a counting replay
    (fss_counts) at five states: phase 3's and phase 4's synthetic inputs,
    the flagship masked and dense fits' warm states (the column update of
    one iteration from the state its phase-8 fit ended in, phase 11's
    start; for the dense fit also feature_sign_shared's in-fit bound, the
    solves' operations counted, beside its in-fit time `dense_ms` from
    phase 11) and the K=50 masked fit's fifth column update from a cold
    start; and
    the cold-CD columns' sweeps (cd_counts) in the column update of one
    iteration of the cold-CD flagship masked and dense fits from the states
    their phase-10 fits ended in (K=24, cd_fused's and cd_shared's inputs)
    and in the cold-CD K=50 masked fit's column update from its phase-10
    end state and its fifth from a cold start (cd_streamed's), each with
    its kernel's in-fit bound, the sweeps counted."""
    from insider_tpu_torch.config import FitConfig
    from insider_tpu_torch.ops.col_update import col_gram_masked
    from insider_tpu_torch.train import als

    out = {}
    kw = dict(max_outer=48, polish_sweeps=32, tol=SUB_TOL)
    x = flagship_inputs(torch)
    G = col_gram_masked(x["R"], x["train"]).permute(1, 2, 0).contiguous()
    xty = x["R"].T @ (x["train"] * x["data"])
    out["phase 3 input, K=24"] = count_summary(torch, "phase 3 input", K,
                                               fss_counts(torch, G, xty,
                                                          x["beta0"], LAM,
                                                          ALPHA, **kw))
    del x, G, xty
    R, mask, data, beta0 = problem(torch, 300, 50, M, 6)
    G, b = gram.col_gram_xty(mask, data, R)
    out["phase 4 input, K=50"] = count_summary(
        torch, "phase 4 input", 50, fss_counts(torch, G, b, beta0, 1.0, 0.5,
                                               **kw))
    del G, b

    cfg = FitConfig(latent_dim=K, lambda1=LAM, lambda2=LAM, alpha=ALPHA,
                    masked=True, global_tol=flagship.params["global_tol"],
                    sub_tol=flagship.params["sub_tol"], max_iter=0,
                    seed=flagship.seed)
    prob = als.build_problem(flagship.data, flagship.confounder,
                             flagship.train_indicator
                             + flagship.test_indicator,
                             flagship.na_indicator, masked=True,
                             device="cuda")
    (mask, data, R, beta0, lam, alpha), ckw = captured_call(
        torch, "feature_sign_fused", 1,
        lambda: als.optimize(prob, cfg, state=flag_state, verbose=False))
    G = col_gram_masked(R, mask).permute(1, 2, 0).contiguous()
    out["flagship fit, warm"] = count_summary(
        torch, "flagship masked fit's warm state", K,
        fss_counts(torch, G, R.T @ (mask * data), beta0, lam, alpha, **ckw))
    del prob, G

    cfg = FitConfig(latent_dim=K, lambda1=LAM, lambda2=LAM, alpha=ALPHA,
                    masked=False, global_tol=flagship.params["global_tol"],
                    sub_tol=flagship.params["sub_tol"], max_iter=0,
                    seed=flagship.seed)
    prob = als.build_problem(flagship.data, flagship.confounder,
                             flagship.train_indicator
                             + flagship.test_indicator,
                             flagship.na_indicator, masked=False,
                             device="cuda")
    (XtX, b, beta0, lam, alpha), ckw = captured_call(
        torch, "feature_sign_shared", 1,
        lambda: als.optimize(prob, cfg, state=dense_state, verbose=False))
    m = b.shape[1]
    c = fss_counts(torch, XtX[:, :, None].expand(K, K, m), b, beta0, lam,
                   alpha, **ckw)
    bnd = gram_input_bound(K, m, shared=True, fss=c)
    out["flagship dense fit, warm"] = dict(
        count_summary(torch, "flagship dense fit's warm state", K, c),
        bound_ms=bnd[0], bound_by=bnd[1], flops=fss_flops(K, c),
        in_fit_ms=dense_ms)
    print(f"feature_sign_shared in the flagship dense fit: {dense_ms:.4f} ms "
          f"a launch (phase 11) against an in-fit bound of {bnd[0]:.4f} ms "
          f"({bnd[1]}: {fss_flops(K, c):.4g} f32 flops at 67 TFLOP/s; "
          f"elimination {2.0 / 3.0 * float(c['cubes'].sum()):.4g}, "
          f"gradients {2.0 * K * K * float(c['steps'].sum()):.4g}, polish "
          f"{2.0 * K * K * float(c['polish_sweeps'].sum()):.4g})")
    del prob

    (G, b, beta0, lam, alpha), ckw = captured_call(
        torch, "feature_sign", 5,
        lambda: predixcan.fit(verbose=False, **dict(K50_FIT, max_iter=4)))
    out["K=50 fit, 5th update"] = count_summary(
        torch, "K=50 masked fit's fifth column update", 50,
        fss_counts(torch, G, b, beta0, lam, alpha, **ckw))
    del G, b

    cfg = FitConfig(latent_dim=K, lambda1=LAM, lambda2=LAM, alpha=ALPHA,
                    masked=True, global_tol=flagship.params["global_tol"],
                    sub_tol=flagship.params["sub_tol"], max_iter=0,
                    seed=flagship.seed, **COLD)
    prob = als.build_problem(flagship.data, flagship.confounder,
                             flagship.train_indicator
                             + flagship.test_indicator,
                             flagship.na_indicator, masked=True,
                             device="cuda")
    (mask, data, R, beta0, lam, alpha, tol, sweeps), _ = captured_call(
        torch, "cd_fused", 1,
        lambda: als.optimize(prob, cfg, state=cd_flag_state, verbose=False))
    G = col_gram_masked(R, mask).permute(1, 2, 0).contiguous()
    c = cd_counts(torch, G, R.T @ (mask * data), beta0, lam, alpha, tol,
                  sweeps)
    n, m = mask.shape
    out["cold CD flagship fit, warm"] = cd_count_summary(
        torch, "cold-CD flagship masked fit's end state", K, c,
        fused_bound(n, K, m, sweeps=c["sweeps"]), refill=True)
    del prob, G

    cfg = FitConfig(latent_dim=K, lambda1=LAM, lambda2=LAM, alpha=ALPHA,
                    masked=False, global_tol=flagship.params["global_tol"],
                    sub_tol=flagship.params["sub_tol"], max_iter=0,
                    seed=flagship.seed, **COLD)
    prob = als.build_problem(flagship.data, flagship.confounder,
                             flagship.train_indicator
                             + flagship.test_indicator,
                             flagship.na_indicator, masked=False,
                             device="cuda")
    (XtX, b, beta0, lam, alpha, tol, sweeps), _ = captured_call(
        torch, "cd_shared", 1,
        lambda: als.optimize(prob, cfg, state=cd_dense_state, verbose=False))
    m = b.shape[1]
    c = cd_counts(torch, XtX[:, :, None].expand(K, K, m), b, beta0, lam,
                  alpha, tol, sweeps)
    out["cold CD flagship dense fit, warm"] = cd_count_summary(
        torch, "cold-CD flagship dense fit's end state", K, c,
        gram_input_bound(K, m, shared=True, sweeps=c["sweeps"]))
    del prob

    # the cold-CD K=50 fit's end state (phase 11's profile starts there)
    cfg = FitConfig(latent_dim=50, lambda1=K50_FIT["lambda_"],
                    lambda2=K50_FIT["lambda_"], alpha=K50_FIT["alpha"],
                    masked=True, global_tol=predixcan.params["global_tol"],
                    sub_tol=predixcan.params["sub_tol"], max_iter=0,
                    seed=predixcan.seed, **COLD)
    prob = als.build_problem(predixcan.data, predixcan.confounder,
                             predixcan.train_indicator
                             + predixcan.test_indicator,
                             predixcan.na_indicator, masked=True,
                             device="cuda")
    (G, b, beta0, lam, alpha, tol, sweeps), _ = captured_call(
        torch, "cd_streamed", 1,
        lambda: als.optimize(prob, cfg, state=cd_k50_state, verbose=False))
    c = cd_counts(torch, G, b, beta0, lam, alpha, tol, sweeps)
    out["cold CD K=50 fit, warm"] = cd_count_summary(
        torch, "cold-CD K=50 masked fit's end state", 50, c,
        gram_input_bound(50, b.shape[1], shared=False, sweeps=c["sweeps"]))
    del prob, G, b

    (G, b, beta0, lam, alpha, tol, sweeps), _ = captured_call(
        torch, "cd_streamed", 5,
        lambda: predixcan.fit(verbose=False, **dict(K50_FIT, max_iter=4),
                              **COLD))
    c = cd_counts(torch, G, b, beta0, lam, alpha, tol, sweeps)
    out["cold CD K=50 fit, 5th update"] = cd_count_summary(
        torch, "cold-CD K=50 masked fit's fifth column update", 50, c,
        gram_input_bound(50, b.shape[1], shared=False, sweeps=c["sweeps"]))
    return out


def run_fit(torch, obj, wrappers, expect, name, monotone=True, **fit_kw):
    """Drive one fit through Insider.fit with every launch count set to 0
    just before it; check that the kernels in `expect` launched (and those
    mapped to 0 did not), that losses are finite and, with `monotone`,
    non-increasing; print its history and ms per iteration.  Returns the
    launch counts, the final loss and the ms per iteration."""
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
    return launches, losses[-1], ms_fit


def ctns_cd_record(torch, ctns, name, XtX, b, w0, loss_criterion, tol,
                   reps=20, plain_reps=3):
    """ctns_cd against its plain version on the card: w bit for bit and
    the same sweep count (the kernel rounds every operation on its own, in
    the plain version's order); the kernel's and the plain version's
    median times beside the bound: XtX, b and w0 read and w written, and
    2 K^2 flops a sweep over the sweeps taken, in f32."""
    args = (XtX, b, w0, LAM, tol, 100, loss_criterion)
    w, sweeps = ctns.ctns_cd(*args, with_sweeps=True)
    w_ref, sweeps_ref = ctns.ctns_cd_plain(*args)
    n, n_ref = int(sweeps), int(sweeps_ref)
    err = float((w - w_ref).abs().max())
    k = b.shape[0]
    bnd = bound(4 * (k * k + 3 * k) + 4, f32_flop=2.0 * k * k * n)
    rec = dict(max_abs_err=err, sweeps=n,
               ms=timed_ms(torch, lambda: ctns.ctns_cd(*args), reps),
               plain_ms=timed_ms(torch, lambda: ctns.ctns_cd_plain(*args),
                                 plain_reps),
               bound_ms=bnd[0], bound_by=bnd[1], library_ms=None)
    print(f"kernel {name}: max_abs_err {err:.3e} sweeps kernel {n} plain "
          f"{n_ref}; kernel {rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} "
          f"ms bound {rec['bound_ms']:.6f} ms ({rec['bound_by']})")
    if n != n_ref or not torch.equal(w, w_ref):
        fail(f"{name}: kernel and plain version differ (sweeps {n} vs "
             f"{n_ref}, max err {err:.3e})")
    if not torch.equal(w, ctns.ctns_cd(*args)):
        fail(f"{name} differs from itself")
    return rec


def phase_covariates(torch, itt, wrappers, masked_path, flag_ms):
    """Phase 13: continuous covariates, checkpoint and glm_interaction on
    the card.  Returns ctns_cd's record for the kernels line (launches from
    the masked covariate fit)."""
    import tempfile

    from insider_tpu_torch.config import FitConfig
    from insider_tpu_torch.kernels import ctns
    from insider_tpu_torch.ops import continuous
    from insider_tpu_torch.train import als

    obj = covariate_object(itt)
    fit_kw = dict(FLAG_FIT, partition=1)
    n_iter = FLAG_FIT["max_iter"] + 1
    no_cd = dict(cd_fused=0, cd_streamed=0, cd_shared=0)
    inputs = {}

    def masked_fit():
        return run_fit(torch, obj, wrappers,
                       dict(masked_path, feature_sign_fused=1, ctns_cd=1,
                            **no_cd), "covariate flagship fit", **fit_kw)

    # the masked fit's last covariate update's inputs to ctns_cd
    args, _ = captured_call(torch, "ctns_cd", 3 * n_iter,
                            lambda: inputs.update(fit=masked_fit()),
                            module=continuous)
    launches, loss, ms = inputs["fit"]
    if launches["ctns_cd"] != 3 * n_iter:
        fail(f"covariate flagship fit: ctns_cd launched "
             f"{launches['ctns_cd']} times, not 3 x {n_iter}")
    print(f"covariate flagship fit (P=3): {ms:.3f} ms/iter against "
          f"{flag_ms['masked']:.3f} without covariates (phase 8); ctns_cd "
          f"{launches['ctns_cd']} launches in {n_iter} iterations")
    full = obj.fit_result
    state = full.state
    _, _, dense_ms = run_fit(
        torch, obj, wrappers, dict(feature_sign_shared=1, ctns_cd=0, **no_cd),
        "covariate flagship dense fit", **dict(FLAG_FIT, partition=0))
    print(f"covariate flagship dense fit (P=3): {dense_ms:.3f} ms/iter "
          f"against {flag_ms['dense']:.3f} without covariates (phase 8)")

    # ctns_cd against its plain version: the masked fit's last covariate
    # inputs (K=24), and a random SPD system at K=128
    XtX, b, w0 = args[:3]
    rec = ctns_cd_record(torch, ctns, "ctns_cd K=24 (flagship fit)", XtX,
                         b, w0, False, 1e-1)
    ctns_cd_record(torch, ctns, "ctns_cd K=24 loss criterion", XtX, b, w0,
                   True, 1e-3)
    rng = np.random.default_rng(13)
    A = torch.from_numpy(rng.standard_normal((300, 128)).astype(
        np.float32)).to("cuda")
    XtX128 = (A.T @ A).contiguous()
    b128 = torch.from_numpy(rng.standard_normal(128).astype(
        np.float32)).to("cuda")
    w128 = torch.zeros(128, device="cuda")
    for crit, tol in ((False, 1e-1), (True, 1e-3)):
        ctns_cd_record(torch, ctns, f"ctns_cd K=128 "
                       f"{'loss criterion' if crit else 'sum |dw|'}",
                       XtX128, b128, w128, crit, tol, plain_reps=1)

    # small fits with covariates, card against CPU
    for label, kw in (("masked 120x2000 K=8 P=2", dict(n_ctns=2)),
                      ("dense 120x2000 K=8 P=2", dict(n_ctns=2,
                                                      partition=0))):
        rel, failed = phase_small_fit(torch, itt, **kw)
        if failed:
            fail(failed)
        print(f"small fit {label}: card vs cpu max loss rel diff {rel:.3e}")

    # one covariate update with any host sync an error
    problem = als.build_problem(obj.data, obj.confounder,
                                obj.train_indicator + obj.test_indicator,
                                obj.na_indicator, obj.ctns_confounder,
                                device="cuda")
    cfg = FitConfig(latent_dim=K, lambda1=LAM, lambda2=LAM, alpha=ALPHA)
    R = als._row_factor(problem, state)
    F = state.column_factor
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        W = als._update_covariates(problem, cfg, state.ctns_factor, R, F,
                                   None)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not bool(torch.isfinite(W).all()):
        fail("covariate update under the sync debug mode: non-finite W")
    print("covariate update: no host sync (sync debug mode \"error\")")

    # checkpoint at iteration 20, resumed to 50: the uninterrupted fit bit
    # for bit
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        path = f"{tmp}/covariates.npz"
        obj.fit(verbose=False, checkpoint_path=path,
                **dict(fit_kw, max_iter=20))
        obj.fit(verbose=False, checkpoint_path=path, resume=True, **fit_kw)
    resumed = obj.fit_result
    by_iter = {h["iter"]: h["loss"] for h in full.history}
    tail = [(h["iter"], h["loss"], by_iter.get(h["iter"]))
            for h in resumed.history[1:]]
    same = (bool(tail) and all(a == b for _, a, b in tail)
            and resumed.history[0]["loss"] == by_iter[20]
            and all(np.array_equal(a, b) for a, b in zip(
                resumed.row_matrices + [resumed.ctns_factor,
                                        resumed.column_factor],
                full.row_matrices + [full.ctns_factor,
                                     full.column_factor])))
    print(f"checkpoint at iteration 20, resumed to 50: boundaries {tail}; "
          f"equal to the uninterrupted fit bit for bit: {same}")
    if not same:
        fail("the resumed covariate fit differs from the uninterrupted one")

    # glm_interaction on the fit's residual, card against CPU
    residual = (problem.data - als._row_factor(problem, state) @ F
                ).cpu().numpy()
    codes = obj.confounder[:, 1]
    F_h = F.cpu().numpy()
    torch.cuda.synchronize()
    t0 = time.time()
    coef, pval = itt.glm_interaction(residual, None, codes, F_h)
    glm_s = time.time() - t0
    coef_c, pval_c = itt.glm_interaction(residual, None, codes, F_h,
                                         device="cpu")
    if not (np.allclose(coef, coef_c, rtol=1e-4, atol=1e-6)
            and np.all(np.isfinite(pval)) and coef.shape == (16, K)):
        fail(f"glm_interaction card vs cpu: max coefficient diff "
             f"{np.abs(coef - coef_c).max():.3e}")
    print(f"glm_interaction ({coef.shape[0]} levels, K={K}, dof "
          f"{int(np.unique(codes, return_counts=True)[1].min()) * M - K}-"
          f"{int(np.unique(codes, return_counts=True)[1].max()) * M - K}): "
          f"{glm_s * 1e3:.1f} ms on the card (p-values on the host), "
          f"coefficients vs cpu max diff {np.abs(coef - coef_c).max():.3e}, "
          f"p-values vs cpu max diff {np.abs(pval - pval_c).max():.3e}")

    # profiles: 10 iterations of the masked covariate fit, and 10 covariate
    # updates alone
    print("profile of the covariate flagship fit (FSS, P=3), 10 iterations:")
    prof = profile_fit(torch, obj, wrappers, state, K, LAM, ALPHA)
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        t0 = time.time()
        for _ in range(10):
            als._update_covariates(problem, cfg, state.ctns_factor, R, F,
                                   None)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    upd = device_kernel_times(torch, p)
    dev_ms = sum(us for us, _ in upd.values()) / 1e3
    print(f"covariate update (P=3): {dev_ms / 10:.4f} device ms per "
          f"iteration ({sum(n for _, n in upd.values()) / 10:g} kernels), "
          f"{wall_ms / 10:.4f} ms host wall per iteration; in the fit, "
          f"busy {prof['busy_share']:.3f}")
    for kname, (us, n) in sorted(upd.items(), key=lambda kv: -kv[1][0]):
        print(f"  update: {us / 1e3 / 10:9.4f} ms/iter x{n / 10:g}  "
              f"{kname[:80]}")
    rec["launches"] = launches["ctns_cd"]
    return rec


# Phase 14, the memory-lean fit.  GTEx v8 (the GTEx Consortium's v8
# release): 17382 RNA-seq samples of 948 donors in 54 tissues, 56200
# GENCODE v26 genes; the tissue x donor interaction is inserted as one more
# confounder, whose levels are the combinations seen (R/insider.R:34-40),
# about 14.7k on random codes: past the fast route's budgets, so it takes
# the segment-sum update.
GTEX_N, GTEX_M, GTEX_LEVELS = 17382, 56200, (54, 948)
GTEX_FIT = dict(latent_dimension=K, lambda_=LAM, alpha=ALPHA, partition=1,
                max_iter=20)
GB = 1e9


def bit_equal(torch, name, a, b):
    """Fail unless the uint8-mask output a equals the f32-mask output b bit
    for bit (tensors, or tuples and lists of them)."""
    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        fail(f"{name}: uint8 masks differ from f32 masks")


def uint8_kernels(torch, row, fss, cd, ev, gram):
    """The four kernels that read the mask, with uint8 masks against the
    same masks as f32: at the flagship shape (377 x 44477, K=24; M odd, so
    the uint8 rows start at every byte) row_xty, masked_eval,
    feature_sign_fused and cd_fused, each also against its plain version
    (phase 3's and phase 5's checks) and timed with both dtypes beside the
    uint8 bound; at the K=50 shape (300 x 44477) row_xty and masked_eval,
    the fused kernels at their largest K, 32, and col_gram_xty.  Every
    uint8 output equals the f32 one bit for bit.  Returns
    {name: record} of the uint8 kernels at the flagship shape."""
    from insider_tpu_torch.ops.col_update import col_gram_masked

    out = {}
    x = flagship_inputs(torch)
    train, test, data, F = x["train"], x["test"], x["data"], x["F"]
    train8, test8 = train.to(torch.uint8), test.to(torch.uint8)
    cases = list(zip(x["codes"], x["R_minus"], x["D"]))
    for c, r, D in cases:
        o = row_order(row, c, D.shape[0])
        bit_equal(torch, f"row_xty (L={D.shape[0]})",
                  row.row_xty(c, r, train8, D, F, **o),
                  row.row_xty(c, r, train, D, F, **o))
    errs = [row_xty_check(torch, row, f"row_xty uint8 (L={D.shape[0]})", c,
                          r, train8, D, F) for c, r, D in cases]
    rec = row_xty_times(torch, row, cases, train8, F)
    out["row_xty uint8"] = dict(
        max_abs_err=max(errs), f32_ms=row_xty_times(
            torch, row, cases, train, F)["ms"], **rec)

    args = (data, train8, test8, x["R"], F)
    bit_equal(torch, "masked_eval", torch.stack(list(ev.masked_eval(*args))),
              torch.stack(list(ev.masked_eval(data, train, test, x["R"], F))))
    out["masked_eval uint8"] = dict(
        max_abs_err=masked_eval_check(torch, ev, "masked_eval uint8", *args),
        f32_ms=masked_eval_times(torch, ev, data, train, test, x["R"],
                                 F)["ms"],
        **masked_eval_times(torch, ev, *args))

    kw = dict(max_outer=48, polish_sweeps=32, tol=SUB_TOL)
    R, beta0 = x["R"], x["beta0"]
    G = col_gram_masked(R, train).permute(1, 2, 0).contiguous()
    b = R.T @ (train * data)
    got = fss.feature_sign_fused(train8, data, R, beta0, LAM, ALPHA, **kw)
    bit_equal(torch, "feature_sign_fused", got, fss.feature_sign_fused(
        train, data, R, beta0, LAM, ALPHA, **kw))
    ref = fss.feature_sign_fused_plain(train8, data, R, beta0, LAM, ALPHA,
                                       **kw)
    fss_checks(torch, "feature_sign_fused uint8", got, ref, G, b, LAM, ALPHA)
    bnd = fused_bound(N, K, M, mask_bytes=1)
    out["feature_sign_fused uint8"] = dict(
        max_abs_err=float((got - ref).abs().max()),
        ms=timed_ms(torch, lambda: fss.feature_sign_fused(
            train8, data, R, beta0, LAM, ALPHA, **kw), 10),
        f32_ms=timed_ms(torch, lambda: fss.feature_sign_fused(
            train, data, R, beta0, LAM, ALPHA, **kw), 10),
        plain_ms=timed_ms(torch, lambda: fss.feature_sign_fused_plain(
            train8, data, R, beta0, LAM, ALPHA, **kw), 3),
        bound_ms=bnd[0], bound_by=bnd[1])

    # cd_fused on phase 5's input, at its 200-sweep cap
    S = 200
    R, mask, data5, beta0 = problem(torch, N, K, M, 7)
    mask8 = mask.to(torch.uint8)
    cargs = (data5, R, beta0, LAM, ALPHA, SUB_TOL)
    got = cd.cd_fused(mask8, *cargs, S)
    bit_equal(torch, "cd_fused", got, cd.cd_fused(mask, *cargs, S))
    G, b5 = gram.col_gram_xty(mask, data5, R)
    _, st = cd_checks(torch, "cd_fused uint8", cd.cd_fused,
                      cd.cd_fused_plain, (mask8,) + cargs, G, b5, LAM,
                      ALPHA, S)
    Gp = col_gram_masked(R, mask).permute(1, 2, 0).contiguous()
    sw = cd_counts(torch, Gp, R.T @ (mask * data5), beta0, LAM, ALPHA,
                   SUB_TOL, S)["sweeps"]
    del Gp, G
    bnd = fused_bound(N, K, M, sweeps=sw, mask_bytes=1)
    out["cd_fused uint8"] = dict(
        max_abs_err=st["max_abs_err"],
        ms=timed_ms(torch, lambda: cd.cd_fused(mask8, *cargs, S), 5),
        f32_ms=timed_ms(torch, lambda: cd.cd_fused(mask, *cargs, S), 5),
        plain_ms=timed_ms(torch, lambda: cd.cd_fused_plain(mask8, *cargs, S),
                          2),
        bound_ms=bnd[0], bound_by=bnd[1])

    # the K=50 shape
    k50 = k50_inputs(torch)
    mask8, test8 = k50["mask"].to(torch.uint8), k50["test"].to(torch.uint8)
    for c, r, D in zip(k50["codes"], k50["R_minus"], k50["D"]):
        bit_equal(torch, f"row_xty K=50 (L={D.shape[0]})",
                  row.row_xty(c, r, mask8, D, k50["F"]),
                  row.row_xty(c, r, k50["mask"], D, k50["F"]))
        row_xty_check(torch, row, f"row_xty uint8 K=50 (L={D.shape[0]})", c,
                      r, mask8, D, k50["F"])
    args = (k50["data"], mask8, test8, k50["R"], k50["F"])
    bit_equal(torch, "masked_eval K=50",
              torch.stack(list(ev.masked_eval(*args))),
              torch.stack(list(ev.masked_eval(
                  k50["data"], k50["mask"], k50["test"], k50["R"],
                  k50["F"]))))
    masked_eval_check(torch, ev, "masked_eval uint8 K=50", *args)
    bit_equal(torch, "col_gram_xty K=50",
              gram.col_gram_xty(mask8, k50["data"], k50["R"]),
              gram.col_gram_xty(k50["mask"], k50["data"], k50["R"]))
    R32 = k50["R"][:, :32].contiguous()
    beta32 = torch.zeros((32, M), device="cuda")
    bit_equal(torch, "feature_sign_fused 300 x 44477 K=32",
              fss.feature_sign_fused(mask8, k50["data"], R32, beta32, 1.0,
                                     0.5, **kw),
              fss.feature_sign_fused(k50["mask"], k50["data"], R32, beta32,
                                     1.0, 0.5, **kw))
    bit_equal(torch, "cd_fused 300 x 44477 K=32",
              cd.cd_fused(mask8, k50["data"], R32, beta32, 1.0, 0.5, SUB_TOL,
                          S),
              cd.cd_fused(k50["mask"], k50["data"], R32, beta32, 1.0, 0.5,
                          SUB_TOL, S))
    print("uint8 masks at the K=50 shape (300 x 44477): row_xty, "
          "masked_eval, col_gram_xty (K=50), feature_sign_fused and cd_fused "
          "(K=32) equal the f32 masks' outputs bit for bit")
    return out


def gtex_object(itt, n):
    """The GTEx-sized problem (n x 56200; 54 tissues, 948 donors, their
    interaction) as an Insider on the card: simulate_scale's data with 1%
    NaNs, made a block of rows at a time."""
    sim = itt.simulate_scale(n, GTEX_M, K, level_counts=GTEX_LEVELS,
                             noise_std=1.0, seed=0)
    conf = sim.confounder
    data = sim.data.astype(np.float64)
    del sim
    rng = np.random.default_rng(0)
    for i0 in range(0, n, 1024):
        blk = data[i0:i0 + 1024]
        blk[rng.random(blk.shape) < 0.01] = np.nan
    return itt.Insider(data, conf, interaction_idx=[0, 1], split_ratio=0.1,
                       device="cuda")


def measured_fit(torch, als, obj, wrappers, expect, name, **fit_kw):
    """run_fit with the device memory read around the fit's build_problem:
    the bytes it leaves allocated (the problem), its peak beyond them, and
    the fit's peak beyond what the build left.  Returns (launch counts,
    losses, ms per iteration, memory figures, the problem's fast
    confounders)."""
    mem, orig = {}, als.build_problem

    def build(*args, **kw):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        prob = orig(*args, **kw)
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        mem.update(persistent=after - before,
                   build_peak=torch.cuda.max_memory_allocated() - after,
                   after=after, fast=prob.fast())
        torch.cuda.reset_peak_memory_stats()
        return prob

    als.build_problem = build
    try:
        launches, _, ms = run_fit(torch, obj, wrappers, expect, name,
                                  **fit_kw)
    finally:
        als.build_problem = orig
    mem["fit_peak"] = torch.cuda.max_memory_allocated() - mem["after"]
    losses = [h["loss"] for h in obj.fit_result.history]
    print(f"{name}: problem {mem['persistent'] / GB:.3f} GB on the card; "
          f"build peak beyond it {mem['build_peak'] / GB:.3f} GB; fit peak "
          f"beyond it {mem['fit_peak'] / GB:.3f} GB; {ms:.3f} ms/iter")
    return launches, losses, ms, mem


def gtex_infit_checks(torch, als, iters, run):
    """Each kernel of the GTEx-sized fit held against its plain version on
    the inputs the fit gave it: the last iteration's calls of level_gram,
    row_xty (tissue, L=54, and donor, L=948), masked_eval and
    feature_sign_fused, captured while run() drives the fit, and launched
    again after it beside the plain versions.  Tolerances: level_gram
    within LEVEL_GRAM_RTOL of max |ref| of the f64 sums (level_gram_gate);
    row_xty within ROW_XTY_RTOL of max |ref| of the f64 plain version (the
    fit's inputs nearly cancel, as row_xty_gate's do); masked_eval's SSEs
    within 1e-5 relative, counts exact (masked_eval_check);
    feature_sign_fused's per-column objective at most 1e-6 relative above
    the plain version's (fss_checks).  Returns what run() returns."""
    from insider_tpu_torch.kernels import eval as ev, fss, row
    from insider_tpu_torch.ops import col_update
    from insider_tpu_torch.ops.col_update import col_gram_masked

    out = {}
    calls = captured_calls(torch, {
        "level_gram": (als, "level_gram", None),
        "row_xty tissue": (als, "row_xty", 2 * iters - 1),
        "row_xty donor": (als, "row_xty", 2 * iters),
        "masked_eval": (als, "masked_eval", None),
        "feature_sign_fused": (col_update, "feature_sign_fused", None)},
        lambda: out.update(result=run()))

    (mw, F, max_count), _ = calls.pop("level_gram")
    level_gram_gate(torch, row, mw, F, row.level_gram(mw, F, max_count))
    for key in ("row_xty tissue", "row_xty donor"):
        args, _ = calls.pop(key)
        codes, Rm, mask, D, F = args[:5]
        got = row.row_xty(*args)
        exact = row.row_xty_plain(codes, Rm.double(), mask, D.double(),
                                  F.double())
        scale = float(exact.abs().max())
        err = float((got.double() - exact).abs().max()) / scale
        f32 = float((row.row_xty_plain(codes, Rm, mask, D, F).double()
                     - exact).abs().max()) / scale
        print(f"GTEx-sized fit, in-fit {key} (L={D.shape[0]}, mask "
              f"{mask.dtype}): max err vs the f64 plain version {err:.4e} "
              f"of max |ref| (plain f32 {f32:.4e}); limit {ROW_XTY_RTOL:g}")
        if not err <= ROW_XTY_RTOL:
            fail(f"GTEx-sized fit: in-fit {key} max err {err:.4e}")
        del exact
    args, _ = calls.pop("masked_eval")
    err = masked_eval_check(torch, ev, "GTEx-sized fit, in-fit masked_eval",
                            *args)
    print(f"GTEx-sized fit, in-fit masked_eval: max abs diff {err:.4e} "
          "from the plain version")
    args, kw = calls.pop("feature_sign_fused")
    mask, data, R, beta0, lam, alpha = args
    got = fss.feature_sign_fused(*args, **kw)
    ref = fss.feature_sign_fused_plain(*args, **kw)
    G = col_gram_masked(R, mask.to(R.dtype)).permute(1, 2, 0).contiguous()
    b = R.T @ (mask * data)
    share, excess = fss_checks(torch, "GTEx-sized fit, in-fit "
                               "feature_sign_fused", got, ref, G, b, lam,
                               alpha)
    print(f"GTEx-sized fit, in-fit feature_sign_fused (mask {mask.dtype}, "
          f"{tuple(mask.shape)}): columns matching the plain version "
          f"{share:.6f}, max objective excess {excess:.3e} (limit 1e-6), "
          f"max abs diff {float((got - ref).abs().max()):.3e}")
    return out["result"]


def gtex_fits(torch, itt, als, wrappers, host_gb):
    """The GTEx-sized masked fit, 20 iterations, with uint8 masks and with
    the default f32 masks: each kernel of the uint8 fit against its plain
    version on its in-fit inputs (gtex_infit_checks); equal losses bit for
    bit, finite and non-increasing; level_gram once an iteration, row_xty exactly twice
    (tissue and donor, never the interaction), feature_sign_fused once;
    the uint8 problem at least 0.99 x 2 N M 3 bytes below the f32 one; the
    build's peak beyond the problem at most 3 GB.  N is cut only where the
    host's memory would not hold the host-side set-up, which keeps several
    f64 copies of the matrix at once (55 bytes an element allowed)."""
    n = GTEX_N
    if host_gb < 55 * GTEX_N * GTEX_M / GB:
        n = int(host_gb * GB / 55 / GTEX_M) // 1024 * 1024
        print(f"GTEx-sized fit: N cut from {GTEX_N} to {n} by the host's "
              f"{host_gb:.0f} GB")
    t0 = time.time()
    obj = gtex_object(itt, n)
    n, m = obj.data.shape
    levels = [int(np.unique(c).size) for c in obj.confounder.T]
    chunk = als.precompute_chunk(n, m)
    print(f"GTEx-sized fit: {n} x {m}, host set-up {time.time() - t0:.1f} s; "
          f"levels (tissue, tissue x donor, donor) {levels}; precompute in "
          f"{-(-m // chunk)} column chunks of {chunk}")
    iters = GTEX_FIT["max_iter"] + 1
    expect = dict(level_gram=1, row_xty=1, feature_sign_fused=1,
                  masked_eval=1, col_gram_xty=0, cd_fused=0)
    res = {}
    for label, mdt in (("uint8", torch.uint8), ("f32", None)):
        def run():
            return measured_fit(torch, als, obj, wrappers, expect,
                                f"GTEx-sized fit, {label} masks",
                                mask_dtype=mdt, **GTEX_FIT)
        launches, losses, ms, mem = (
            gtex_infit_checks(torch, als, iters, run) if mdt is not None
            else run())
        res[label] = dict(launches=launches, losses=losses, ms=ms, **mem)
        if mdt is not None:
            print("profile of the GTEx-sized fit, uint8 masks, 5 iterations "
                  "from its end state:")
            profile_fit(torch, obj, wrappers, obj.fit_result.state, K, LAM,
                        ALPHA, iters=5, mask_dtype=mdt)
        routes = ["fast" if v in mem["fast"] else "segment sums"
                  for v in range(len(levels))]
        print(f"GTEx-sized fit, {label} masks: routes (tissue, interaction, "
              f"donor) {routes}")
        if routes != ["fast", "segment sums", "fast"]:
            fail(f"GTEx-sized fit: routes {routes}")
        want = dict(level_gram=iters, row_xty=2 * iters,
                    feature_sign_fused=iters)
        for k, v in want.items():
            if launches[k] != v:
                fail(f"GTEx-sized fit, {label}: {k} launched "
                     f"{launches[k]} times, not {v}")
        if not mem["build_peak"] <= 3 * GB:
            fail(f"GTEx-sized fit, {label}: build peak "
                 f"{mem['build_peak'] / GB:.3f} GB beyond the problem")
    if res["uint8"]["losses"] != res["f32"]["losses"]:
        fail(f"GTEx-sized fit: uint8 losses {res['uint8']['losses']} vs f32 "
             f"{res['f32']['losses']}")
    saved = res["f32"]["persistent"] - res["uint8"]["persistent"]
    print(f"GTEx-sized fit: uint8 and f32 losses equal bit for bit; uint8 "
          f"masks save {saved / GB:.3f} GB of the problem (2 N M 3 = "
          f"{6 * n * m / GB:.3f} GB)")
    if not saved >= 0.99 * 6 * n * m:
        fail(f"GTEx-sized fit: uint8 saves {saved} bytes, under 0.99 x "
             f"{6 * n * m}")
    return res["uint8"]["launches"]


def profile_and_solvers(torch, itt, als):
    """optimize(profile_dir=...) on the card writes a Chrome trace with the
    card's kernels in it, and computes the fit without it bit for bit;
    fit_interaction and the two CD solvers, card against CPU."""
    import tempfile

    from insider_tpu_torch.config import FitConfig

    sim = itt.simulate_scale(120, 2000, 8, level_counts=(2, 4, 9),
                             noise_std=0.5, seed=2)
    obj = itt.Insider(sim.data, sim.confounder, interaction_idx=[0, 1],
                      device="cuda")
    prob = als.build_problem(obj.data, obj.confounder, obj.train_indicator,
                             obj.test_indicator, device="cuda")
    cfg = FitConfig(latent_dim=8, lambda1=5.0, lambda2=5.0, alpha=0.4,
                    max_iter=20)
    ref = als.optimize(prob, cfg, verbose=False)
    with tempfile.TemporaryDirectory() as tmp:
        got = als.optimize(prob, cfg, verbose=False, profile_dir=tmp)
        names = os.listdir(tmp)
        with open(os.path.join(tmp, names[0])) as fh:
            events = json.load(fh)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    print(f"profile_dir: {names}, {len(events)} events, {len(kernels)} "
          "kernel launches on the card")
    if [h["loss"] for h in got.history] != [h["loss"] for h in ref.history]:
        fail("profile_dir changed the fit's losses")
    if not kernels:
        fail("profile_dir: the trace holds no kernel of the card")

    rng = np.random.default_rng(5)
    n, m, k, L = 2000, 500, 8, 50
    res = rng.standard_normal((n, m)).astype(np.float32)
    mask = (rng.random((n, m)) > 0.2).astype(np.float32)
    F = rng.standard_normal((k, m)).astype(np.float32)
    codes = rng.integers(0, L, n)
    for masked in (True, False):
        outs = [itt.fit_interaction(
            *(torch.from_numpy(a).to(dev) for a in (res, mask)), codes,
            torch.from_numpy(F).to(dev), masked=masked).cpu().numpy()
            for dev in ("cuda", "cpu")]
        err = float(np.abs(outs[0] - outs[1]).max())
        print(f"fit_interaction masked={masked}: card vs cpu max abs diff "
              f"{err:.3e} (max |V| {float(np.abs(outs[1]).max()):.3e})")
        if not err <= 1e-4 * float(np.abs(outs[1]).max()):
            fail(f"fit_interaction masked={masked}: card vs cpu {err:.3e}")
    X = rng.standard_normal((50, 7))
    y = 2 * rng.standard_normal(50)
    for fn in (itt.coordinate_descent, itt.strong_coordinate_descent):
        outs = [fn(X, y, np.zeros(7), 1.0, 0.6, tol=1e-10, device=dev)
                for dev in ("cuda", "cpu")]
        err = float(np.abs(outs[0] - outs[1]).max())
        print(f"{fn.__name__}: card vs cpu max abs diff {err:.3e}")
        if not err <= 1e-5:
            fail(f"{fn.__name__}: card vs cpu {err:.3e}")


def phase_memory_lean(torch, itt, als, kernels, wrappers, hist):
    """Phase 14.  kernels: the modules (row, fss, cd, ev, gram); hist: the
    f32-mask flagship fits' losses (phases 8 and 10), which the uint8-mask
    fits must equal bit for bit.  Returns the uint8 kernels' records with
    the launches of their fits."""
    row, fss, cd, ev, gram = kernels
    recs = uint8_kernels(torch, row, fss, cd, ev, gram)
    for name, rec in recs.items():
        print(f"kernel {name}: max_abs_err {rec['max_abs_err']:.3e} kernel "
              f"{rec['ms']:.4f} ms (f32 masks {rec['f32_ms']:.4f} ms) plain "
              f"{rec['plain_ms']:.4f} ms bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']})")

    # the flagship FSS and cold-CD fits of phases 8 and 10 with uint8 masks
    flagship = flagship_object(itt)
    u8 = dict(mask_dtype=torch.uint8)
    masked_path = dict(level_gram=1, row_xty=1, masked_eval=1)
    launches, _, _ = run_fit(
        torch, flagship, wrappers, dict(masked_path, feature_sign_fused=1,
                                        cd_fused=0),
        "flagship fit, uint8 masks", partition=1, **FLAG_FIT, **u8)
    got = [h["loss"] for h in flagship.fit_result.history]
    if got != hist["flagship fit"]:
        fail(f"flagship fit: uint8 losses {got} vs f32 "
             f"{hist['flagship fit']}")
    cold, _, _ = run_fit(
        torch, flagship, wrappers, dict(masked_path, cd_fused=1,
                                        feature_sign_fused=0),
        "cold CD flagship fit, uint8 masks", monotone=False, partition=1,
        **COLD, **FLAG_FIT, **u8)
    got = [h["loss"] for h in flagship.fit_result.history]
    if got != hist["cold CD flagship fit"]:
        fail(f"cold CD flagship fit: uint8 losses {got} vs f32 "
             f"{hist['cold CD flagship fit']}")
    print("flagship FSS and cold-CD fits: uint8 losses equal phases 8 and "
          "10's f32 losses bit for bit")
    del flagship

    host_gb = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") / GB
    gtex = gtex_fits(torch, itt, als, wrappers, host_gb)
    for name in ("row_xty", "masked_eval", "feature_sign_fused"):
        recs[f"{name} uint8"]["launches"] = gtex[name]
    recs["cd_fused uint8"]["launches"] = cold["cd_fused"]

    # small fits, card against CPU (rtol 1e-5)
    failures = []
    fast_e = als._FAST_E_BYTES
    for label, kw, budget in (
            ("masked 120x2000 K=8 uint8", dict(mask_dtype=torch.uint8), None),
            ("masked 120x2000 K=8 precompute=False",
             dict(precompute=False), None),
            ("dense 120x2000 K=8 precompute=False",
             dict(partition=0, precompute=False), None),
            # E of the 9-level confounder, 120 x 9 x 4 bytes, over budget
            ("masked 120x2000 K=8, the 9-level confounder on segment sums",
             {}, 120 * 8 * 4),
            ("masked 120x500 K=40 uint8",
             dict(k=40, m=500, mask_dtype=torch.uint8), None)):
        if budget is not None:
            als._FAST_E_BYTES = budget
        try:
            rel, failed = phase_small_fit(torch, itt, **kw)
        finally:
            als._FAST_E_BYTES = fast_e
        if failed:
            failures.append(failed)
            print(f"small fit {label}: FAILED")
        else:
            print(f"small fit {label}: card vs cpu max loss rel diff "
                  f"{rel:.3e}")
    if failures:
        fail("; ".join(failures))

    profile_and_solvers(torch, itt, als)
    return recs


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2

    import insider_tpu_torch as itt
    from insider_tpu_torch.kernels import (_lib, cd, ctns, eval as ev, fss,
                                           gram, row)
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
    kern, fss_stats, alone = phase_kernels(torch, row, fss, cd, ev)
    for name, rec in kern.items():
        print(f"kernel {name}: max_abs_err {rec['max_abs_err']:.3e} "
              f"kernel {rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms "
              f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    print(f"level_gram: library (cuBLAS f32 GEMM on the prebuilt table) "
          f"{kern['level_gram']['library_ms']:.4f} ms")
    print(f"feature_sign_fused: columns matching plain (rtol 2e-5, atol "
          f"1e-5): {fss_stats['match_share']:.6f}; max objective excess "
          f"{fss_stats['max_objective_excess']:.3e}")
    print(f"fused gram build alone (no solve): feature_sign_fused "
          f"{alone['feature_sign_fused']:.4f} ms, cd_fused "
          f"{alone['cd_fused']:.4f} ms")

    # 4. kernels of the dense and K > 32 paths
    kern2, stats2 = phase_kernels_slice2(torch, gram, fss)
    kern.update(kern2)
    for name, rec in kern2.items():
        print(f"kernel {name}: max_abs_err {rec['max_abs_err']:.3e} "
              f"kernel {rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms")
    for name in ("feature_sign", "feature_sign_shared",
                 "feature_sign_shared K=3", "feature_sign_shared K=25"):
        print(f"{name}: columns matching plain (rtol 2e-5, atol 1e-5): "
              f"{stats2[name]['match_share']:.6f}; max objective excess "
              f"{stats2[name]['max_objective_excess']:.3e}"
              + (f"; bound {kern2[name]['bound_ms']:.4f} ms "
                 f"({kern2[name]['bound_by']}), group width L="
                 f"{kern2[name]['lanes']}" if "lanes" in kern2[name]
                 else ""))

    # 5. the cold-CD kernels
    kern_cd = phase_kernels_cd(torch, gram, cd)
    kern.update(kern_cd)
    for name, rec in kern_cd.items():
        print(f"kernel {name}: max_abs_err {rec['max_abs_err']:.3e} "
              f"kernel {rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms")

    # 6. K = 96 and K = 128
    for name, rec in phase_kernels_wide(torch, gram, fss, cd).items():
        print(f"kernel {name} M=2048: max_abs_err {rec['max_abs_err']:.3e} "
              f"kernel {rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms"
              + (f" library {rec['library_ms']:.4f} ms"
                 if "library_ms" in rec else "")
              + (f" bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})"
                 if "bound_ms" in rec else "")
              + (f" group width L={rec['lanes']}" if "lanes" in rec else ""))

    # 7. small fits, card against CPU (every fit runs; then fatal if any
    # disagreed)
    failures = []
    for label, kw in (("masked 120x2000 K=8", {}),
                      ("dense 120x2000 K=8", dict(partition=0)),
                      ("masked 120x500 K=40", dict(k=40, m=500)),
                      ("masked 120x2000 K=8 alpha=0", dict(alpha=0.0)),
                      # tests/test_torch_dense.py's ridge fit (partition=1):
                      # col_gram_xty at K=6, then Cholesky
                      ("masked 40x300 K=6 alpha=0", dict(
                          k=6, m=300, n=40, levels=(2, 4, 7), seeds=(1, 5),
                          lam=2.0, alpha=0.0, true_k=6, init="package",
                          witness=True)),
                      ("cold CD masked 120x2000 K=8", COLD),
                      ("cold CD dense 120x2000 K=8", dict(COLD, partition=0)),
                      # levels (4, 8, 30): R of full rank at K=40 (with (2,
                      # 4, 9) its rank is at most 23, and the cold-CD fit
                      # moves by ~1e-5 with the last bit of its grams)
                      ("cold CD masked 120x500 K=40, levels (4, 8, 30)",
                       dict(COLD, k=40, m=500, levels=(4, 8, 30),
                            witness=True)),
                      ("masked 120x300 K=96, 10 iterations",
                       dict(k=96, m=300, max_iter=10, witness=True))):
        rel, failed = phase_small_fit(torch, itt, **kw)
        if failed:
            failures.append(failed)
            print(f"small fit {label}: FAILED")
        else:
            print(f"small fit {label}: card vs cpu max loss rel diff "
                  f"{rel:.3e}")
    if failures:
        fail("; ".join(failures))

    wrappers = {"level_gram": row.level_gram, "row_xty": row.row_xty,
                "feature_sign_fused": fss.feature_sign_fused,
                "masked_eval": ev.masked_eval,
                "col_gram_xty": gram.col_gram_xty,
                "feature_sign": fss.feature_sign,
                "feature_sign_shared": fss.feature_sign_shared,
                "cd_fused": cd.cd_fused, "cd_streamed": cd.cd_streamed,
                "cd_shared": cd.cd_shared, "ctns_cd": ctns.ctns_cd}
    no_cd = dict(cd_fused=0, cd_streamed=0, cd_shared=0, ctns_cd=0)
    no_fss = dict(feature_sign_fused=0, feature_sign=0, feature_sign_shared=0,
                  ctns_cd=0)

    # 8. flagship fits through the user entry point
    flagship = flagship_object(itt)
    masked_path = dict(level_gram=1, row_xty=1, masked_eval=1)
    flag_ms = {}
    launches, fss_masked, flag_ms["masked"] = run_fit(
        torch, flagship, wrappers,
        dict(masked_path, feature_sign_fused=1, **no_cd), "flagship fit",
        partition=1, **FLAG_FIT)
    flag_state = flagship.fit_result.state
    hist = {"flagship fit": [h["loss"] for h in flagship.fit_result.history]}
    dense, fss_dense, flag_ms["dense"] = run_fit(
        torch, flagship, wrappers, dict(feature_sign_shared=1, **no_cd),
        "flagship dense fit", partition=0, **FLAG_FIT)
    dense_state = flagship.fit_result.state
    launches["feature_sign_shared"] = dense["feature_sign_shared"]

    # 9. K=50 masked fit at the prediXcan shape
    predixcan = predixcan_object(itt)
    k50, fss_k50, _ = run_fit(
        torch, predixcan, wrappers,
        dict(masked_path, feature_sign_fused=0, col_gram_xty=1,
             feature_sign=1, **no_cd), "K=50 masked fit", **K50_FIT)
    launches["col_gram_xty"] = k50["col_gram_xty"]
    launches["feature_sign"] = k50["feature_sign"]

    # 10. cold-CD fits of the same problems
    cd_states = {}
    for name, obj, expect, fit_kw, fss_loss in (
            ("cold CD flagship fit", flagship,
             dict(masked_path, cd_fused=1, cd_streamed=0, cd_shared=0),
             dict(FLAG_FIT, partition=1), fss_masked),
            ("cold CD flagship dense fit", flagship,
             dict(cd_shared=1, cd_fused=0, cd_streamed=0),
             dict(FLAG_FIT, partition=0), fss_dense),
            ("cold CD K=50 masked fit", predixcan,
             dict(masked_path, col_gram_xty=1, cd_streamed=1, cd_fused=0,
                  cd_shared=0), K50_FIT, fss_k50)):
        counts, loss, _ = run_fit(torch, obj, wrappers,
                                  dict(expect, **no_fss), name,
                                  monotone=False, **COLD, **fit_kw)
        cd_states[name] = obj.fit_result.state
        hist[name] = [h["loss"] for h in obj.fit_result.history]
        for n in ("cd_fused", "cd_streamed", "cd_shared"):
            if expect.get(n):
                launches[n] = counts[n]
        print(f"{name}: final loss {loss!r} vs FSS fit {fss_loss!r} "
              f"(ratio {loss / fss_loss:.6f})")

    # 11. in-fit profiles: the flagship masked and dense FSS fits, the
    # cold-CD flagship masked and dense fits and the cold-CD K=50 masked fit
    print("profile of the flagship masked fit (FSS), 10 iterations:")
    profile_fit(torch, flagship, wrappers, flag_state, K, LAM, ALPHA)
    print("profile of the flagship dense fit (FSS), 10 iterations:")
    dense_prof = profile_fit(torch, flagship, wrappers, dense_state, K, LAM,
                             ALPHA, masked=False)
    for name, obj, k, lam, alpha, masked in (
            ("cold CD flagship fit", flagship, K, LAM, ALPHA, True),
            ("cold CD flagship dense fit", flagship, K, LAM, ALPHA, False),
            ("cold CD K=50 masked fit", predixcan, 50, K50_FIT["lambda_"],
             K50_FIT["alpha"], True)):
        print(f"profile of the {name}, 10 iterations:")
        profile_fit(torch, obj, wrappers, cd_states[name], k, lam, alpha,
                    masked=masked, **COLD)

    # 12. what the columns cost: counting replays of the FSS and cold-CD
    # iterations
    phase_counts(torch, itt, gram, flagship, flag_state, dense_state,
                 dense_prof["in_fit"]["feature_sign_shared"]["ms_per_launch"],
                 cd_states["cold CD flagship fit"],
                 cd_states["cold CD flagship dense fit"], predixcan,
                 cd_states["cold CD K=50 masked fit"])
    del flagship, predixcan

    # 13. continuous covariates, checkpoint, glm
    kern["ctns_cd"] = phase_covariates(torch, itt, wrappers, masked_path,
                                       flag_ms)
    launches["ctns_cd"] = kern["ctns_cd"]["launches"]

    # 14. the memory-lean fit: uint8 masks, chunked precompute, segment sums
    lean = phase_memory_lean(torch, itt, als, (row, fss, cd, ev, gram),
                             wrappers, hist)
    kern.update(lean)
    for name, rec in lean.items():
        launches[name] = rec["launches"]

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
               "cd_shared": ("fss_shared.cu", tpu + "cd_pallas.py:289"),
               # no Pallas kernel: the XLA while_loop of _ctns_cd
               "ctns_cd": ("ctns_cd.cu", "insider_tpu/ops/continuous.py:101")}
    # the uint8-mask instances of the kernels that read the mask
    for name in lean:
        sources[name] = sources[name.split()[0]]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "insider_tpu_torch/csrc/" + sources[name][0],
         "replaces": sources[name][1],
         "launches": launches[name],
         "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"],
         "bound_ms": kern[name]["bound_ms"],
         "bound_by": kern[name]["bound_by"],
         "library_ms": kern[name].get("library_ms")}
        for name in list(wrappers) + list(lean)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
