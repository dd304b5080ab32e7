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
     feature_sign_shared at K=24 on R^T R, R^T data;
  5. the cold-CD kernels at full width (M=44477): cd_fused at K=24
     (N=377), cd_streamed at K=50 on col_gram_xty grams (N=300; its group
     width printed) and at K=24 against cd_fused (route check), cd_shared
     at K=24; each against its plain version at a short sweep cap and at
     the 200-sweep cap (every column's objective, and element-wise at the
     short cap);
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
 11. profile: torch.profiler over 10 iterations of the flagship masked FSS
     fit, of the cold-CD flagship masked fit and of the cold-CD K=50 masked
     fit, each from the state its fit (phase 8 or 10) ended in; each
     kernel's device ms per iteration and per launch, each wrapper's in-fit
     device ms per launch (its kernels together), and the device busy
     share; fails if a kernel that launched shows no device time;
 12. what the columns cost, by counting replays of the plain iterations
     (printed, not gated): the FSS columns' outer steps, active sets and
     polish sweeps at four states; the cold-CD columns' sweeps in one
     column update at K=24 (the flagship cold-CD masked and dense fits'
     end states) and K=50 (the cold-CD K=50 fit's end state and its fifth
     update), with the bound of that launch, its sweeps counted, and the
     sweeps that columns swept in lockstep, 2 or 4 to a warp, take.
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
the CD kernels' operations count the sweeps their columns take on the
timed input (2 K^2 flops a column-sweep, the sweeps from a replay of the
plain iteration, cd_counts; phase 12 prints the same bound of one
column update in the cold-CD fits); the FSS solves' operations depend on
the iterations, which the kernels do not count, and are left out.  As the
last line {"ok": true, "device": {...}}.
Without CUDA the script exits non-zero and prints no result.
"""

import inspect
import json
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


def fused_bound(n, k, m, sweeps=None):
    """The fused column kernels: mask and data read, R, beta0 read, beta
    written; the gram in three bf16 planes on the tensor cores over the
    K(K+1)/2 pairs, Xty in f32; for CD with `sweeps`, also cd_flops (the
    FSS solve's operations are not counted)."""
    return bound(4 * (2 * n * m + n * k + 2 * k * m),
                 bf16_flop=2 * 3 * pairs(k) * n * m,
                 f32_flop=2 * k * n * m + (0.0 if sweeps is None
                                           else cd_flops(k, sweeps)))


def col_gram_bound(n, k, m):
    """col_gram_xty: mask, data and R read, the (K, K, M) grams and Xty
    written; the pair sums in three bf16 planes on the tensor cores, Xty in
    f32."""
    return bound(4 * (2 * n * m + n * k + k * k * m + k * m),
                 bf16_flop=2 * 3 * pairs(k) * n * m, f32_flop=2 * k * n * m)


def gram_input_bound(k, m, shared, sweeps=None):
    """The FSS / CD kernels on given grams: the grams, xty and beta0 read,
    beta written; for CD with `sweeps`, also cd_flops (the FSS solve's
    operations are not counted)."""
    return bound(4 * ((k * k if shared else k * k * m) + 3 * k * m),
                 f32_flop=0.0 if sweeps is None else cd_flops(k, sweeps))


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
    kernel and plain version, beside the bound: per case the mask, D, F, R
    and the row order read once, the (L, K) output written; the prediction's
    and the contraction's FMAs in f32."""
    n = mask.shape[0]
    k, m = F.shape
    orders = [row_order(row, c, D.shape[0]) for c, _, D in cases]
    b = bound(sum(4 * (n * m + L * m + k * m + n * k + 2 * n + L + 1 + L * k)
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
    two masks (N, M), R and F read once; the prediction's FMAs in f32."""
    n, k = R.shape
    m = F.shape[1]
    b = bound(4 * (3 * n * m + n * k + k * m) + 32, f32_flop=2 * n * k * m)
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
    bnd = gram_input_bound(K, M, shared=True)
    out["feature_sign_shared"] = dict(
        max_abs_err=float((got - ref).abs().max()),
        ms=timed_ms(torch, lambda: fss.feature_sign_shared(
            XtX, Xty, beta0, LAM, ALPHA, **kw), 10),
        plain_ms=timed_ms(torch, lambda: fss.feature_sign_shared_plain(
            XtX, Xty, beta0, LAM, ALPHA, **kw), 3),
        bound_ms=bnd[0], bound_by=bnd[1])
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
                    **solver):
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
    distance is read.  Returns the card's largest relative distance and
    None, or a failure message."""
    from insider_tpu_torch.kernels.gram import col_gram_xty_plain
    from insider_tpu_torch.model.state import init_state, state_from_numpy
    from insider_tpu_torch.ops import col_update

    sim = itt.simulate_scale(n, m, true_k, level_counts=levels, noise_std=0.5,
                             seed=seeds[0])
    data = sim.data.astype(np.float64)
    data[np.random.default_rng(seeds[1]).random(data.shape) < 0.01] = np.nan

    def exact_col_gram_xty(mask, data, R):
        g, x = col_gram_xty_plain(mask.double(), data.double(), R.double())
        return g.float(), x.float()

    histories = {}
    for dev in ("cuda", "cpu") + (("exact",) if witness else ()):
        run_on = "cpu" if dev == "exact" else dev
        obj = itt.Insider(data, sim.confounder, interaction_idx=[0, 1],
                          max_iter=max_iter, device=run_on)
        counts = [np.unique(c).size for c in obj.confounder.T]
        if init == "small":
            rng = np.random.default_rng(4)
            cfd0 = [(1e-3 * rng.standard_normal((L, k))).astype(np.float32)
                    for L in counts]
            F0 = (1e-3 * rng.standard_normal((k, obj.data.shape[1]))
                  ).astype(np.float32)
        else:
            st = init_state(torch.Generator().manual_seed(obj.seed), counts,
                            obj.data.shape[1], k)
            cfd0 = [f.numpy() for f in st.cfd_factors]
            F0 = st.column_factor.numpy()
        state = state_from_numpy(cfd0, None, F0, run_on)
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
                      f"{alpha}, {solver}) losses card {lc} vs cpu {lp}")
    return float(np.max(np.abs(np.subtract(lc, lp)) / np.abs(lp))), None


def flagship_object(itt):
    """The flagship problem (phases 8, 10, 11) as an Insider on the card."""
    sim = itt.simulate_scale(N, M, K, level_counts=(2, 8, 107),
                             noise_std=1.0, seed=0)
    data = sim.data.astype(np.float64)
    data[np.random.default_rng(0).random(data.shape) < 0.01] = np.nan
    return itt.Insider(data, sim.confounder, interaction_idx=[0, 1],
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
                "cd_fused": "fused_kernel<", "cd_streamed": "streamed_kernel<"}


def profile_fit(torch, obj, wrappers, state, latent_dimension, lambda_,
                alpha, iters=10, **solver):
    """torch.profiler over `iters` iterations of the object's masked fit
    (FSS, or the FitConfig solver settings in `solver`) from `state` (where
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
                    lambda2=lambda_, alpha=alpha, masked=True,
                    global_tol=obj.params["global_tol"],
                    sub_tol=obj.params["sub_tol"], max_iter=iters - 1,
                    seed=obj.seed, **solver)
    problem = als.build_problem(obj.data, obj.confounder,
                                obj.train_indicator + obj.test_indicator,
                                obj.na_indicator, masked=True, device="cuda")
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


def cd_count_summary(torch, name, K, c, bnd=None):
    """One line of cd_counts' distributions: median, p90, max and mean of
    the sweeps and of the active coordinates per column, the share of
    columns at the sweep cap, and for P = 2 and 4 the sweeps that P
    neighbouring columns swept in lockstep take (P times the most of the
    P; cd_streamed's groups, fss_streamed.cu) over the columns' own; with
    `bnd`, the kernel's bound on this input (bound_ms, bound_by), its
    sweeps counted."""
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
    if bnd is not None:
        out.update(bound_ms=bnd[0], bound_by=bnd[1],
                   sweeps_bound_ms=sweep_bound(K, c["sweeps"])[0])
    print(f"CD counts, {name}: " + json.dumps(out))
    return out


def captured_call(torch, name, at, run):
    """The arguments of the `at`-th call (1-based) of
    ops/col_update.<name> (a column-update kernel wrapper) while run()
    runs, as (args, kwargs); the wrapper is restored after."""
    from insider_tpu_torch.ops import col_update

    orig = getattr(col_update, name)
    seen = {"n": 0}

    def spy(*args, **kw):
        seen["n"] += 1
        if seen["n"] == at:
            seen["call"] = (args, kw)
        return orig(*args, **kw)

    setattr(col_update, name, spy)
    try:
        run()
    finally:
        setattr(col_update, name, orig)
    if "call" not in seen:
        fail(f"{name} was called {seen['n']} times, not {at}")
    return seen["call"]


def phase_counts(torch, itt, gram, flagship, flag_state, cd_flag_state,
                 cd_dense_state, predixcan, cd_k50_state):
    """Phase 12: what the FSS columns cost, by a counting replay
    (fss_counts) at four states: phase 3's and phase 4's synthetic inputs,
    the flagship masked fit's warm state (the column update of one
    iteration from the state its phase-8 fit ended in, phase 11's start)
    and the K=50 masked fit's fifth column update from a cold start; and
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
        fused_bound(n, K, m, sweeps=c["sweeps"]))
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
    for name in ("feature_sign", "feature_sign_shared"):
        print(f"{name}: columns matching plain (rtol 2e-5, atol 1e-5): "
              f"{stats2[name]['match_share']:.6f}; max objective excess "
              f"{stats2[name]['max_objective_excess']:.3e}")

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
                "cd_shared": cd.cd_shared}
    no_cd = dict(cd_fused=0, cd_streamed=0, cd_shared=0)
    no_fss = dict(feature_sign_fused=0, feature_sign=0, feature_sign_shared=0)

    # 8. flagship fits through the user entry point
    flagship = flagship_object(itt)
    masked_path = dict(level_gram=1, row_xty=1, masked_eval=1)
    launches, fss_masked, _ = run_fit(
        torch, flagship, wrappers,
        dict(masked_path, feature_sign_fused=1, **no_cd), "flagship fit",
        partition=1, **FLAG_FIT)
    flag_state = flagship.fit_result.state
    dense, fss_dense, _ = run_fit(
        torch, flagship, wrappers, dict(feature_sign_shared=1, **no_cd),
        "flagship dense fit", partition=0, **FLAG_FIT)
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
        for n in ("cd_fused", "cd_streamed", "cd_shared"):
            if expect.get(n):
                launches[n] = counts[n]
        print(f"{name}: final loss {loss!r} vs FSS fit {fss_loss!r} "
              f"(ratio {loss / fss_loss:.6f})")

    # 11. in-fit profiles: the flagship masked FSS fit, the cold-CD
    # flagship masked and K=50 masked fits
    print("profile of the flagship masked fit (FSS), 10 iterations:")
    profile_fit(torch, flagship, wrappers, flag_state, K, LAM, ALPHA)
    for name, obj, k, lam, alpha in (
            ("cold CD flagship fit", flagship, K, LAM, ALPHA),
            ("cold CD K=50 masked fit", predixcan, 50, K50_FIT["lambda_"],
             K50_FIT["alpha"])):
        print(f"profile of the {name}, 10 iterations:")
        profile_fit(torch, obj, wrappers, cd_states[name], k, lam, alpha,
                    **COLD)

    # 12. what the columns cost: counting replays of the FSS and cold-CD
    # iterations
    phase_counts(torch, itt, gram, flagship, flag_state,
                 cd_states["cold CD flagship fit"],
                 cd_states["cold CD flagship dense fit"], predixcan,
                 cd_states["cold CD K=50 masked fit"])
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
         "plain_ms": kern[name]["plain_ms"],
         "bound_ms": kern[name]["bound_ms"],
         "bound_by": kern[name]["bound_by"],
         "library_ms": kern[name].get("library_ms")} for name in wrappers]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
