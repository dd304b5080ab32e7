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
     element-wise at the short cap); then every column kernel (FSS, CD and
     col_gram_xty) at K=24 and K=50 on inputs with a NaN and an Inf in the
     data and a NaN in a warm start: the same non-finite columns as its
     plain version, the others bit for bit its clean input's
     (nonfinite_checks);
  6. K = 96 and K = 128 at M=2048 (N=300): col_gram_xty (with the f64
     gate of phase 4 and its library_ms), feature_sign (and its bound by
     bytes),
     feature_sign_shared (and its bound by its solves' operations),
     cd_streamed and cd_shared against their plain
     versions; feature_sign_shared and cd_shared at K=50 (SHARED_CASES,
     M=44477) with their bounds; past the narrow kernels' K <= 128
     (WIDE_CASES: K = 160 and 256 at M=2048, K = 300 at M=256, where the
     wide FSS solve reads its gram from device memory) every widened
     kernel against its plain version with the gates above, its uint8
     mask bit for bit its f32 mask's, twice bit for bit, timed beside its
     plain version (the plain FSS and CD once, by CUDA events) and its
     bound: col_gram_xty, feature_sign (bytes), feature_sign_shared
     (fss_flops), cd_streamed and cd_shared (the grouped CD loop's
     instances past 128, on a problem of its own with 2K rows, phase 5's
     gates at 10 sweeps and the 200-sweep cap, bound by the sweeps of
     cd_counts' replay; every width of cd_*_widths held to the same gates
     and to the block solve, lanes=128, bit for bit, each timed at the
     cap), ctns_cd (a covariate's system of the
     case's shape, both stop criteria, bit for bit with equal sweeps),
     row_xty (the f64 gate on near-cancelling inputs at the flagship's
     377 x 44477 and levels; timed on two confounders of 12 and 25
     levels), level_gram and masked_eval; then the gram builds past the
     shared-memory ceilings their narrow tiling had (PAST_CEILINGS):
     col_gram_xty at K = 700 (N=300, M=64, f32 and uint8 masks) and
     level_gram at K = 520 with three count planes (L=37, M=256), each held
     to its f64 gate and one-plane control, its grams symmetric bit for
     bit (col_gram_xty), twice bit for bit, and timed;
  7. small fits: the same fit on the card (kernels) and on the CPU (plain
     versions) from one numpy initial state, per-boundary losses agree to
     rtol 1e-5: masked K=8, dense K=8, masked K=40, masked alpha=0 at K=8
     and at tests/test_torch_dense.py's ridge shape (40 x 300, K=6) (FSS
     and Cholesky); masked K=8, dense K=8, masked K=40 with R of full rank
     (cold CD; beside it the CPU fit on exact column grams, printed: how
     far the fit moves with their last bit); masked K=96 (FSS); masked and
     dense K=136 (120 x 100, 10 iterations: the K > 128 kernels);
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
     the uint8 fit's last in-fit call of level_gram (the fast confounders'
     and the interaction's mask counts), row_xty (tissue and donor),
     masked_eval and feature_sign_fused launched again on its inputs and
     held against its plain version (infit_checks; the interaction's
     level grams within the plain version's error and unbiased on their
     diagonal, segment_gram_gate); gates: losses equal bit for bit,
     finite and non-increasing, level_gram twice an iteration, row_xty
     twice,
     feature_sign_fused once, uint8 saving at least 0.99 x 2 N M 3 bytes,
     the build's peak at most 3 GB (N is cut only where the host's memory
     would not hold the set-up, and then printed); small fits card against
     CPU at rtol 1e-5: masked K=8 uint8, masked and dense K=8
     precompute=False, masked K=8 with the 9-level confounder on segment
     sums (the fast route's budget lowered in this process), masked K=40
     uint8 (col_gram_xty); optimize(profile_dir=...) writes a trace with
     the card's kernels and fits the same bits; fit_interaction and the two
     CD solvers, card against CPU;
 15. the command line, the workloads and debug_checks: an ageing-shaped
     CSV (a header, 377 rows, 3 integer confounder columns with levels 2,
     8, 107, every level present, 44477 non-negative expression columns,
     1% NA, some fields quoted, every value written with %.9g) parsed by
     the native load_csv equal bit for bit to the f32 table written (NaN
     at exactly the NA fields; write, build and parse times printed);
     `python -m insider_tpu_torch fit` on it (K=24, lambda 11, alpha 0.4,
     the interaction, --log2, partition 1, global_tol 1e-10, 50
     iterations) as a subprocess: exit 0, its JSON loss and npz factors
     equal bit for bit to the in-process Insider fit of the table that
     cli._load_table reads (subprocess wall time, both fits' ms/iter);
     the same fit through cli.main in this process, launching level_gram,
     row_xty, feature_sign_fused and masked_eval and nothing else, its
     factors the same bits, each kernel's last in-fit call (row_xty's for
     each of the 4 confounders) held against its plain version
     (infit_checks); `tune` as a subprocess (ranks 20, 24, lambdas
     6, 11, alpha 0.4, 30 iterations a trial): exit 0, both CSVs written,
     its result equal to Insider.tune's; each workload module (ageing 377
     x 44477, gtex 600 x 56200, simulation 250 x 200, prediXcan 300 x
     44477, brainspan 500 x 44477, psyencode 800 x 44477) through runpy
     with --max-iter 200 (a cut for time), launch counts set to 0 before
     each: the kernels of its route launched and no other, each kernel's
     last in-fit call (row_xty's for each confounder) launched again and
     held against its plain version (infit_checks), its npz the fit's
     factors, losses finite and non-increasing, ms/iter printed;
     the flagship masked fit, 20 iterations, with debug_checks equal bit
     for bit to the fit without, and a NaN in a train-masked cell raising
     NonFiniteError with the JAX package's tag for V[0];
 16. the sharded fit: a one-rank NCCL group in this process fits the
     flagship problem with ShardingConfig(1, 1), 50 iterations, equal bit
     for bit to phase 8's fit; two worker processes (this script with
     --sharded-worker, under a 600 s wall-clock limit, each exit code
     checked) share the card over gloo and fit the flagship problem at
     full width, 20 iterations: masked FSS at 1 x 2 (level_gram, row_xty,
     feature_sign_fused, masked_eval) and 2 x 1 (col_gram_xty and
     feature_sign in place of the fused kernel), dense FSS and cold-CD
     masked at 1 x 2, each rank's launch counts showing its route and
     each kernel's last in-fit call held against its plain version
     (infit_checks; cd_fused against a witness, cd_infit); then
     DIST_SCALE_r05.json's problem (4096 x 16384, K=8, levels (4, 8),
     lambda 3, alpha 0.4, Bernoulli 0.1 of seed 77, uint8 masks, 30
     iterations) written as a raw f32 file and built by each rank from
     its block alone through file_ingest_callbacks, at 2 x 1 and 1 x 2
     (each rank's largest ingest block and its problem's bytes on the
     card printed); then the settings ported to the sharded fit last
     (SETTING_FITS): the masked FSS flagship fit with precompute=False
     at 1 x 2 and 2 x 1 (every confounder on the segment sums), the FSS
     flagship fit with P=3 covariates masked and dense at 1 x 2 (ctns_cd
     3 launches an iteration on each rank), the 1 x 2 fit checkpointed at
     10 and resumed (bit for bit the uninterrupted fit, rank 0 alone
     writing the whole F), the 1 x 2 masked FSS fit under debug_checks
     with a NaN put into rank 1's data block (both ranks raise the column
     update's NonFiniteError, then fit clean, bit for bit);
     and the GTEx-sized masked fit at 1 x 2, each rank reading its half of
     a raw f32 file the parent writes (the interaction on the segment
     sums; its problem's bytes, fit peak and ms/iter per rank), held to
     the one-process fit of the same file.  Every rank's history equal;
     every per-boundary loss
     (and RMSE) within rel 1e-5 of the one-process fit's, or within twice
     the largest gap of its witnesses, the one-process fit with its
     columns in each order of WITNESS_ORDERS (its sums in other orders,
     witness_fits), where the fit moves that far with the order of its
     sums; ms/iter printed beside the card's name and
     power limit (two ranks on one card measure no multi-card rate);
 17. the iteration as one CUDA graph and the chained boundaries: the
     flagship masked FSS, dense FSS and cold-CD masked fits (50
     iterations), the prediXcan K=50 fit (20), the flagship fit with P=3
     covariates (50) and the flagship masked FSS fit to 200 iterations
     with a global_tol that stops it inside a dispatch (converge_tol),
     each through Insider.fit in three modes: eager (every kernel
     launched from the host, one boundary a dispatch), graph
     boundaries_per_dispatch=1 and graph 5 (the default); the graph fits
     equal the eager fit bit for bit (every history record's numbers,
     the factors, n_iter, converged) and launch its kernels as often
     (plus a chained dispatch's boundary past its stop); ms/iter of each
     mode, the capture time, the wasted iterations and the busy share of
     20 replays of the captured iteration (torch.profiler) printed beside
     the card's name and power limit.  Phase 14 also fits the GTEx-sized
     uint8 problem eagerly: the same losses, its peak beside the graph
     fit's;
 18. rank K above 128: the flagship problem at full width at K = 160
     (simulate_scale(377, 44477, 160, ...), 1% NaNs, lambda 11, alpha
     0.4) through Insider.fit under the graph (10 iterations each): FSS
     masked (partition=1: col_gram_xty, feature_sign, row_xty, level_gram
     and masked_eval launched) and dense (feature_sign_shared), cold CD
     masked (col_gram_xty + cd_streamed) and dense (cd_shared), FSS
     masked with P=3 covariates (ctns_cd exactly 3 launches an
     iteration), no other column kernel; losses finite (non-increasing
     for FSS); ms/iter, the problem's bytes and the fit's peak printed;
     the last level_gram, masked_eval and row_xty calls of the FSS masked
     fit, cd_streamed and cd_shared of the cold-CD fits (phase 5's gates
     with the element-wise one at one sweep, the in-fit bound from
     cd_counts) and ctns_cd of the covariate fit
     (bit for bit) held against their plain versions (infit_checks); a
     profile of one (eager) iteration of each fit from its end state
     (each wrapper's in-fit ms a launch beside its in-fit bound).
A fit on the card runs its first iteration eagerly and the rest as
replays of one captured iteration (train/graph.py): a replay adds the
captured iteration's launches to each wrapper's count, so a fit's counts
are its kernels' launches.  The phases that take the k-th call of a
wrapper (12, 13) run their fit eagerly; infit_checks takes a kernel's
last call, which under the graph is the capture's, its tensors holding
the last replay's values.
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
iteration from the fit's own boundary clock, from iteration 0's boundary
to the last (each dispatch ends by copying its metrics to the host, so
the clock reads a synchronized device; boundary_ms).  Each phase's end
is printed on the smoke's clock ("[phase clock]").
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
(the cold-CD flagship uint8 fit's for cd_fused).  The "<kernel> K=160"
records are the widened kernels at phase 6's K = 160 (N=300, M=2048; the
CD kernels' problem N=320),
their launches phase 18's fits' (the most of any of its fits).  As the
last line {"ok": true, "device": {...}}.
Without CUDA the script exits non-zero and prints no result.
"""

import functools
import gc
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


def blocks_per_sm(torch, entry, *args):
    """The grid's blocks over the card's SMs of a launch whose C library
    reports its blocks (`entry`: insider_row_xty_blocks or
    insider_masked_eval_blocks; None where the library lacks it, as an
    older package tree's does)."""
    from insider_tpu_torch.kernels import _lib

    fn = getattr(_lib.lib(), entry, None)
    if fn is None or not fn.argtypes:
        return None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return fn(*args) / sms


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
        for name, v in near_cancel_row_xty(torch, row, codes, Rm, mask, F, L,
                                           noise).items():
            worst[name] = max(worst[name], v)
        del noise
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


SEGMENT_GRAM_BIAS = 1e-7


def segment_gram_gate(torch, row, mw, F, got):
    """level_gram's output `got` on a segment-sum confounder's mask counts
    (a fit's (L, M) counts of levels of one or two rows each, where
    level_gram_gate's 1e-6 of the largest magnitude is below f32's reach
    over M columns) against the f64 sums: its max error at most the plain
    f32 version's, which it replaces there, and its diagonal unbiased:
    the mean relative error of the (L, K) diagonal within
    SEGMENT_GRAM_BIAS (the plain version's is printed beside it)."""
    exact = row.level_gram_plain(mw.double(), F.double())
    d = torch.arange(F.shape[0], device=F.device)
    stats = {}
    for who, x in (("kernel", got), ("plain f32", row.level_gram_plain(mw,
                                                                       F))):
        err = x.double() - exact
        stats[who] = (float(err.abs().max()),
                      float((err[:, d, d] / exact[:, d, d]).mean()))
    (ek, bk), (ep, bp) = stats["kernel"], stats["plain f32"]
    print(f"segment level_gram vs the f64 sums: max err kernel {ek:.4e}, "
          f"plain f32 {ep:.4e}; diagonal mean relative error kernel "
          f"{bk:+.3e}, plain f32 {bp:+.3e} (limit {SEGMENT_GRAM_BIAS:g})")
    if not (ek <= ep and abs(bk) <= SEGMENT_GRAM_BIAS):
        fail(f"segment level_gram: max err {ek:.4e} (plain {ep:.4e}), "
             f"diagonal bias {bk:+.3e}")


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


# The witness rule's largest share of differing columns at the short cap:
# where the witness differs in more than half of it, the problem moves with
# the last bits of its inputs too far for an element-wise gate at that cap to
# tell a wrong kernel from a right one, and the check fails.
WITNESS_SHARE_CEILING = 0.25


def cd_checks(torch, name, fn, plain, args, G, b, lam, alpha, sweeps,
              times=None, witness=None, short=10, widths=(), replay=False):
    """A CD kernel against its plain version on the same inputs, at a short
    sweep cap (`short`, phase 5's 10), at 10 sweeps and at the cap
    `sweeps`.  At every cap the kernel's output is finite and every
    column's objective exceeds the plain version's by at most 1e-6
    relative, as fss_checks holds the FSS kernels; at the short cap >= 99%
    of the columns also match element-wise (rtol 2e-5 / atol 1e-5).  The
    matching share at the other caps is reported.
    With `witness` (cap -> the plain iteration on the f64 sums rounded to
    f32, cd_infit's witness: inputs that differ from the kernel's in their
    last bits only), a cap whose gate the kernel misses is judged by
    cd_infit's witness rule instead, both distances printed: the objective
    excess at most max(1e-6, 2 x the witness's), and the objective deficit
    (the kernel's objective below the plain version's, as an iteration
    that runs too far or activates too much would leave it) at most
    max(1e-6, 2 x the witness's); at the short cap the share of columns
    differing at most max(1%, 2 x the witness's), a limit that may not pass
    WITNESS_SHARE_CEILING.
    With `times` (a dict), the kernel at the cap is run again, timed (one
    call, CUDA events) and held to its first run bit for bit, and the plain
    version's one call there is timed: times["ms"], times["plain_ms"].
    With `widths` (the kernel's group widths, `lanes`; 128 the block solve
    past K = 128), at every cap each width's output is held to the block
    solve's (lanes=128) and to the output gated above bit for bit, so the
    gates hold for each; with `times` each is timed at the cap (one call):
    times["width_ms"].
    With `replay` (args the gram-input kernels' (G, b, beta0, lam, alpha,
    tol)), the plain output at the cap comes from cd_counts' counting
    replay of the plain loop (its solution the plain version's; timed in
    its place with `times`), whose per-column sweeps the statistics return
    ("sweeps"): one run of the plain loop where a caller also wants the
    sweeps.
    Returns (kernel output at the cap, statistics)."""
    seen, counts = {}, {}

    def plain_at(cap):
        if not (replay and cap == sweeps):
            return plain(*args, cap)
        counts.update(cd_counts(torch, G, b, args[2], lam, alpha, args[5],
                                cap))
        return counts["beta"]

    for cap in dict.fromkeys((short, 10, sweeps)):
        got = fn(*args, cap)
        if times is not None and cap == sweeps:
            again, times["ms"] = timed_once(torch, lambda: fn(*args, cap))
            if not torch.equal(got, again):
                fail(f"{name} differs from itself at {cap} sweeps")
            ref, times["plain_ms"] = timed_once(torch,
                                                lambda: plain_at(cap))
        else:
            ref = plain_at(cap)
        if not bool(torch.isfinite(got).all()):
            fail(f"{name} returned non-finite values at {cap} sweeps")
        fp = objectives(torch, ref, G, b, lam, alpha)

        def distance(out):
            fo = objectives(torch, out, G, b, lam, alpha)
            rel = (fo - fp) / fp.abs().clamp(min=1.0)
            return (float(rel.max()), float((-rel).max()),
                    float(torch.isclose(out, ref, rtol=2e-5, atol=1e-5)
                          .all(0).double().mean()))

        excess, deficit, match = distance(got)
        limits = (1e-6, None, 0.01)
        print(f"{name} at {cap} sweeps: columns matching plain {match:.6f}; "
              f"max objective excess {excess:.3e} (deficit {deficit:.3e}); "
              f"max abs err {float((got - ref).abs().max()):.3e}")
        missed = excess > limits[0] or (cap == short
                                        and match < 1 - limits[2])
        if missed and witness is not None:
            w_out = witness(cap)
            if not bool(torch.isfinite(w_out).all()):
                fail(f"{name}: the witness is not finite at {cap} sweeps")
            ew, dw, mw = distance(w_out)
            limits = (max(1e-6, 2 * ew), max(1e-6, 2 * dw),
                      max(0.01, 2 * (1 - mw)))
            print(f"{name} at {cap} sweeps, beside the witness (the plain "
                  f"iteration on the f64 sums rounded to f32): objective "
                  f"excess {excess:.3e} (witness {ew:.3e}), deficit "
                  f"{deficit:.3e} (witness {dw:.3e}), columns differing "
                  f"{1 - match:.6f} (witness {1 - mw:.6f}); limits "
                  f"{limits[0]:.3e}, {limits[1]:.3e}, {limits[2]:.6f}")
            if cap == short and limits[2] > WITNESS_SHARE_CEILING:
                fail(f"{name}: the witness differs in {1 - mw:.6f} of the "
                     f"columns at {cap} sweeps, past half the ceiling "
                     f"{WITNESS_SHARE_CEILING}: no element-wise gate there")
            if not deficit <= limits[1]:
                fail(f"{name} objective deficit {deficit:.3e} at {cap} "
                     "sweeps")
        seen[cap] = (match, excess, limits)
        if not excess <= limits[0]:
            fail(f"{name} objective excess {excess:.3e} at {cap} sweeps")
        block = fn(*args, cap, lanes=128) if widths else None
        for lanes in widths:
            if not (torch.equal(fn(*args, cap, lanes=lanes), block)
                    and torch.equal(block, got)):
                fail(f"{name} L={lanes} differs from the block solve "
                     f"(lanes=128) or from the output gated above at {cap} "
                     "sweeps")
        if widths:
            print(f"{name} at {cap} sweeps: widths {list(widths)} equal the "
                  "block solve (lanes=128) and the output gated above bit "
                  "for bit")
        if times is not None and cap == sweeps and widths:
            times["width_ms"] = {
                lanes: timed_once(torch, lambda: fn(*args, cap,
                                                     lanes=lanes))[1]
                for lanes in widths}
    if not seen[short][0] >= 1 - seen[short][2][2]:
        fail(f"{name}: {seen[short][0]:.6f} of the columns match plain at "
             f"{short} sweeps")
    stats = dict(short_cap_match_share=seen[short][0],
                 short_cap_max_objective_excess=seen[short][1],
                 match_share=seen[sweeps][0],
                 max_objective_excess=seen[sweeps][1],
                 max_abs_err=float((got - ref).abs().max()),
                 witness_limits=dict((cap, v[2]) for cap, v in seen.items()
                                     if v[2][1] is not None),
                 sweeps=counts.get("sweeps"))
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


def nonfinite_checks(torch, gram, fss, cd):
    """Every column kernel against its plain version on inputs that hold
    non-finite values, at K=24 (N=377) and K=50 (N=300), M=2048: column 1's
    data a NaN at a train element, column 2's an Inf, column 3's warm start
    a NaN.  The columns each kernel gives non-finite must be the plain
    version's (the FSS kernels' all NaN: the plain FSS, as the TPU kernel,
    gives such a column NaN; the CD kernels' those of an Inf or a NaN warm
    start), a poisoned column it keeps finite the plain version's (the CD
    kernels' NaN in Xty, screened out: zero), and every other column the
    kernel's on the clean input bit for bit.  The gram-input kernels take
    the plain grams and Xty of the poisoned input."""
    from insider_tpu_torch.ops.col_update import col_gram_masked

    kw = dict(max_outer=48, polish_sweeps=32, tol=SUB_TOL)

    def poisoned(R, mask, data, beta0):
        data, beta0 = data.clone(), beta0.clone()
        for j, v in ((1, float("nan")), (2, float("inf"))):
            data[int(torch.nonzero(mask[:, j])[0]), j] = v
        beta0[0, 3] = float("nan")
        return R, mask, data, beta0

    def grams(R, mask, data, beta0):
        return (col_gram_masked(R, mask).permute(1, 2, 0).contiguous(),
                R.T @ (mask * data), (R.T @ R).contiguous(),
                (R.T @ data).contiguous(), beta0)

    def calls(k, R, mask, data, beta0):
        G, b, Gs, bs, beta0 = grams(R, mask, data, beta0)
        out = [("col_gram_xty", lambda f: f(mask, data, R)[1],
                gram.col_gram_xty, gram.col_gram_xty_plain),
               ("feature_sign", lambda f: f(G, b, beta0, LAM, ALPHA, **kw),
                fss.feature_sign, fss.feature_sign_plain),
               ("feature_sign_shared",
                lambda f: f(Gs, bs, beta0, LAM, ALPHA, **kw),
                fss.feature_sign_shared, fss.feature_sign_shared_plain),
               ("cd_streamed",
                lambda f: f(G, b, beta0, LAM, ALPHA, SUB_TOL, 200),
                cd.cd_streamed, cd.cd_streamed_plain),
               ("cd_shared",
                lambda f: f(Gs, bs, beta0, LAM, ALPHA, SUB_TOL, 200),
                cd.cd_shared, cd.cd_shared_plain)]
        if k <= fss.FUSED_MAX_K:
            out += [("feature_sign_fused",
                     lambda f: f(mask, data, R, beta0, LAM, ALPHA, **kw),
                     fss.feature_sign_fused, fss.feature_sign_fused_plain),
                    ("cd_fused",
                     lambda f: f(mask, data, R, beta0, LAM, ALPHA, SUB_TOL,
                                 200),
                     cd.cd_fused, cd.cd_fused_plain)]
        return out

    def bad(x):
        return sorted(torch.nonzero(~torch.isfinite(x).all(0))
                      .flatten().tolist())

    for k, n in ((K, N), (50, 300)):
        clean = problem(torch, n, k, 2048, 11)
        for (name, run, kern, plain), (_, run0, _, _) in zip(
                calls(k, *poisoned(*clean)), calls(k, *clean)):
            got, ref, base = run(kern), run(plain), run0(kern)
            cols = bad(got)
            keep = torch.isfinite(got).all(0)
            touched = torch.zeros_like(keep)      # its inputs' columns
            touched[1:3 if name == "col_gram_xty" else 4] = True
            print(f"{name} K={k} on non-finite inputs: non-finite columns "
                  f"{cols}, the plain version's {bad(ref)}")
            if cols != bad(ref):
                fail(f"{name} K={k}: non-finite columns {cols}, the plain "
                     f"version's {bad(ref)}")
            if not torch.equal(got[:, ~touched], base[:, ~touched]):
                fail(f"{name} K={k}: the columns not poisoned differ from "
                     "the clean input's")
            if not torch.equal(got[:, touched & keep],
                               ref[:, touched & keep]):
                fail(f"{name} K={k}: a poisoned column it keeps finite "
                     "differs from the plain version's")
            if name.startswith(("feature_sign", "cd")) and \
                    not torch.isnan(got[:, ~keep]).all():
                fail(f"{name} K={k}: a non-finite column is not all NaN")


def col_gram_record(torch, gram, mask, data, R):
    """col_gram_xty on (mask, data, R) against its plain version (each
    output within 3e-5 of its largest magnitude) and the f64 gate
    (col_gram_gate), timed beside its plain version, its library
    yardstick and its bound.  Returns ((grams, Xty), record)."""
    n, k = R.shape
    m = data.shape[1]
    G, b = gram.col_gram_xty(mask, data, R)
    ref = gram.col_gram_xty_plain(mask, data, R)
    for g, r, what in zip((G, b), ref, ("gram", "xty")):
        e = float((g - r).abs().max())
        if not e <= 3e-5 * float(r.abs().max()):
            fail(f"col_gram_xty K={k} {what} max err {e:.3e}")
    bnd = col_gram_bound(n, k, m)
    return (G, b), dict(
        max_abs_err=max(float((g - r).abs().max())
                        for g, r in zip((G, b), ref)),
        f64_gate=col_gram_gate(torch, gram, f"col_gram_xty K={k}", mask,
                               data, R, (G, b)),
        ms=timed_ms(torch, lambda: gram.col_gram_xty(mask, data, R), 5),
        plain_ms=timed_ms(torch, lambda: gram.col_gram_xty_plain(
            mask, data, R), 3),
        library_ms=col_gram_library_ms(torch, R, mask),
        bound_ms=bnd[0], bound_by=bnd[1])


def phase_kernels_wide(torch, gram, fss, cd):
    """K = 96 and K = 128 (three and four coordinates per lane) at
    M=2048, N=300: every gram-input kernel against its plain version.
    Returns {name: record}."""
    m, n = 2048, 300
    out = {}
    kw = dict(max_outer=48, polish_sweeps=32, tol=SUB_TOL)
    for k in (96, 128):
        R, mask, data, beta0 = problem(torch, n, k, m, k)
        (G, b), out[f"col_gram_xty K={k}"] = col_gram_record(
            torch, gram, mask, data, R)
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
        # feature_sign's bound by its bytes (its solves not counted);
        # feature_sign_shared's by its solves' operations (fss_flops)
        bnd = gram_input_bound(k, m, shared=False)
        out[f"feature_sign K={k}"].update(bound_ms=bnd[0], bound_by=bnd[1])
        bnd = gram_input_bound(k, m, shared=True, fss=fss_counts(
            torch, Gd, Xty, beta0, lam, alpha, **kw))
        out[f"feature_sign_shared K={k}"].update(bound_ms=bnd[0],
                                                  bound_by=bnd[1])
        for name, fn, plain, args, GG, bb in (
                ("cd_streamed", cd.cd_streamed, cd.cd_streamed_plain,
                 (G, b, beta0, lam, alpha, SUB_TOL), G, b),
                ("cd_shared", cd.cd_shared, cd.cd_shared_plain,
                 (XtX, Xty, beta0, lam, alpha, SUB_TOL), Gd, Xty)):
            _, st = cd_checks(torch, f"{name} K={k}", fn, plain, args, GG,
                              bb, lam, alpha, 200, replay=True)
            sw = st.pop("sweeps")
            bnd = gram_input_bound(k, m, shared=name == "cd_shared",
                                   sweeps=sw)
            out[f"{name} K={k}"] = dict(
                st, ms=timed_ms(torch, lambda: fn(*args, 200), 2),
                plain_ms=timed_ms(torch, lambda: plain(*args, 200), 1),
                bound_ms=bnd[0], bound_by=bnd[1])
        out[f"cd_streamed K={k}"]["lanes"] = cd.cd_streamed_widths(k)[0][0]
    # the dense kernels at K=50 (SHARED_CASES[50], M=44477): times and
    # bounds, feature_sign_shared's by its solves' operations, cd_shared's
    # by its sweeps (both counted by a replay of the plain iteration)
    XtX, Xty, beta0, lam, alpha = shared_inputs(torch, 50)
    Gd = XtX[:, :, None].expand(50, 50, Xty.shape[1])
    args = (XtX, Xty, beta0, lam, alpha)
    got = fss.feature_sign_shared(*args, **kw)
    ref, plain_ms = timed_once(torch, lambda: fss.feature_sign_shared_plain(
        *args, **kw))
    share, excess = fss_checks(torch, "feature_sign_shared K=50", got, ref,
                               Gd, Xty, lam, alpha)
    bnd = gram_input_bound(50, Xty.shape[1], shared=True, fss=fss_counts(
        torch, Gd, Xty, beta0, lam, alpha, **kw))
    out["feature_sign_shared K=50"] = dict(
        max_abs_err=float((got - ref).abs().max()), match_share=share,
        max_objective_excess=excess,
        ms=timed_ms(torch, lambda: fss.feature_sign_shared(*args, **kw), 5),
        plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
        lanes=fss.feature_sign_shared_widths(50)[0][0], M=Xty.shape[1])
    args = (XtX, Xty, beta0, lam, alpha, SUB_TOL)
    _, st = cd_checks(torch, "cd_shared K=50", cd.cd_shared,
                      cd.cd_shared_plain, args, Gd, Xty, lam, alpha, 200,
                      replay=True)
    sw = st.pop("sweeps")
    bnd = gram_input_bound(50, Xty.shape[1], shared=True, sweeps=sw)
    out["cd_shared K=50"] = dict(
        st, ms=timed_ms(torch, lambda: cd.cd_shared(*args, 200), 5),
        plain_ms=timed_ms(torch, lambda: cd.cd_shared_plain(*args, 200), 1),
        bound_ms=bnd[0], bound_by=bnd[1], M=Xty.shape[1])
    return out


# Phase 6 past the narrow kernels' K <= 128: (K, N, M).  K = 160 and 256 at
# phase 6's M = 2048; K = 300 on a small M, where the wide FSS solve's gram
# no longer fits a block's shared memory (K > 235) and is read from device
# memory.
WIDE_CASES = ((160, 300, 2048), (256, 300, 2048), (300, 300, 256))
CD_CAP = 200                      # the CD kernels' sweep cap (a fit's)
# the levels of the row kernels' inputs there (the K=50 shape's)
WIDE_LEVELS = (12, 25)
# the gram builds past the shared-memory ceilings of their narrow tiling
# (col_gram_xty K > 664 with f32 masks, level_gram K > ~517 with three
# count planes): (K, N, M) of col_gram_xty, (K, L, M, largest count) of
# level_gram
PAST_CEILINGS = dict(col_gram_xty=(700, 300, 64),
                     level_gram=(520, 37, 256, 70000))


def fss_width_times(torch, name, fn, widths, got, args, kw, bnd):
    """Every width of a gram-input FSS kernel (widths: feature_sign_widths
    or feature_sign_shared_widths; 128 the block solve) run once, timed
    (CUDA events), and its output held to the block solve's (lanes=128)
    and to `got` bit for bit.  Returns {lanes: ms}, the one the kernel runs
    first first."""
    outs, times = {}, {}
    for lanes, _ in widths:
        outs[lanes], times[lanes] = timed_once(
            torch, lambda: fn(*args, **kw, lanes=lanes))
    for lanes, out in outs.items():
        if not (torch.equal(out, outs[128]) and torch.equal(out, got)):
            fail(f"{name} L={lanes} differs from the block solve (lanes=128)"
                 " or from the output gated above")
    print(f"{name}: widths equal the block solve (lanes=128) bit for bit; "
          "each (L, columns an SM, ms, times its bound): "
          + "; ".join(f"L={lanes} {cols} {times[lanes]:.4f} ms "
                      f"{times[lanes] / bnd[0]:.1f}x"
                      for lanes, cols in widths))
    return times


def timed_once(torch, fn):
    """(fn(), its ms): one call timed by CUDA events, for plain versions
    that take seconds a call (the FSS iteration at K >= 160)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def near_cancel_row_xty(torch, row, codes, Rm, mask, F, L, noise):
    """row_xty against its f64 plain version where D and T nearly cancel:
    data = R_minus F + 0.01 noise, so S = D - T is about 1e-3 of D.
    Returns the kernel's, the plain f32 version's and the f32 control's
    (D F^T - T F^T, T = E^T (mask .* R_minus F) in f32) max errors as
    fractions of the f64 result's max |ref|."""
    data = Rm.double() @ F.double() + 0.01 * noise
    E_t = torch.nn.functional.one_hot(codes.long(), L).double().T
    D = (E_t @ (mask.double() * data)).float().contiguous()
    exact = row.row_xty_plain(codes, Rm.double(), mask.double(), D.double(),
                              F.double())
    T = E_t.float() @ (mask * (Rm @ F))
    scale = float(exact.abs().max())
    return {name: float((got.double() - exact).abs().max()) / scale
            for name, got in (
                ("kernel", row.row_xty(codes, Rm, mask, D, F,
                                       **row_order(row, codes, L))),
                ("plain f32", row.row_xty_plain(codes, Rm, mask, D, F)),
                ("f32 control", D @ F.T - T @ F.T))}


def phase_kernels_wider(torch, gram, fss, cd, ctns, row, ev):
    """Phase 6 past K = 128 (WIDE_CASES): every widened kernel against its
    plain version with phases 3-6's gates, run twice (bit for bit), timed
    beside its plain version and its bound, its uint8 mask bit for bit its
    f32 mask where it takes both: col_gram_xty (the f64 gate, library_ms);
    the wide FSS solve as feature_sign on col_gram_xty's grams (bound by
    bytes, as row 7 reckons it) and as feature_sign_shared on R^T R (bound
    by its solves' operations, fss_flops, as row 8 reckons it), each and
    its plain version timed over one call (the kernel's second); row_xty
    (the f64 gate on near-cancelling inputs at the flagship's shape, then
    at the case's shape against its f32 plain version, the two
    confounders' calls timed together); level_gram (the f64 gate,
    library_ms); masked_eval (exact counts).  Returns {"<name> K=<k>":
    record}."""
    out = {}
    kw = dict(max_outer=48, polish_sweeps=32, tol=SUB_TOL)
    lam, alpha = 1.0, 0.5
    for k, n, m in WIDE_CASES:
        rng_c = np.random.default_rng(1000 + k)
        R, mask, data, beta0 = problem(torch, n, k, m, k)
        u8 = mask.to(torch.uint8)
        (G, b), rec = col_gram_record(torch, gram, mask, data, R)
        out[f"col_gram_xty K={k}"] = dict(rec, N=n, M=m)
        for x, y in zip(gram.col_gram_xty(u8, data, R), (G, b)):
            if not torch.equal(x, y):
                fail(f"col_gram_xty K={k}: uint8 mask differs from f32")

        XtX, Xty = (R.T @ R).contiguous(), (R.T @ data).contiguous()
        Gd = XtX[:, :, None].expand(k, k, m)
        for name, args, GG, bb in (
                ("feature_sign", (G, b, beta0, lam, alpha), G, b),
                ("feature_sign_shared", (XtX, Xty, beta0, lam, alpha), Gd,
                 Xty)):
            fn = getattr(fss, name)
            if not torch.equal(args[0], args[0].transpose(0, 1)):
                fail(f"{name} K={k}: the gram is not symmetric bit for bit")
            got = fn(*args, **kw)
            again, ms = timed_once(torch, lambda: fn(*args, **kw))
            if not torch.equal(got, again):
                fail(f"{name} K={k} differs from itself")
            # the plain output from fss_counts' replay of the plain loop
            # (its solution the plain version's), timed in its place
            c, plain_ms = timed_once(torch, lambda: fss_counts(
                torch, GG, bb, beta0, lam, alpha, **kw))
            ref_ = c["beta"]
            bnd = gram_input_bound(k, m, shared=name == "feature_sign_shared",
                                   fss=c)
            share, excess = fss_checks(torch, f"{name} K={k}", got, ref_, GG,
                                       bb, lam, alpha)
            widths = fss_width_times(torch, f"{name} K={k}", fn,
                                     getattr(fss, name + "_widths")(k), got,
                                     args, kw, bnd)
            out[f"{name} K={k}"] = dict(
                max_abs_err=float((got - ref_).abs().max()),
                match_share=share, max_objective_excess=excess,
                ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
                N=n, M=m, lanes=next(iter(widths)), width_ms=widths,
                steps_mean=float(c["steps"].double().mean()))
            del c

        # cold CD past 128: cd_streamed on col_gram_xty's grams, cd_shared
        # on R^T R, of a problem of its own with 2K rows (at N =
        # 300 the grams of K = 256 and 300 are near-singular, and last-bit
        # differences move most columns past rtol 2e-5 by 10 sweeps), at the
        # flagship's lambda and alpha, phase 5's gates at 10 sweeps and at
        # the 200-sweep cap (where missed, cd_infit's witness rule, both
        # distances printed), each timed there over one call beside its
        # plain version's one call, bound by the sweeps its columns take
        # (cd_counts' replay: 2 K^2 flops a column-sweep); every width of
        # cd_*_widths (the grouped loop's instances, the block solve as
        # 128) held to the same gates and to the block bit for bit, each
        # timed at the cap
        del G, b, Gd
        n_cd = 2 * k
        R2, mask2, data2, beta2 = problem(torch, n_cd, k, m, k)
        G, b = gram.col_gram_xty(mask2, data2, R2)
        XtX2 = (R2.T @ R2).contiguous()
        Xty2 = (R2.T @ data2).contiguous()
        Gd = XtX2[:, :, None].expand(k, k, m)
        for name, args, GG in (
                ("cd_streamed", (G, b, beta2, LAM, ALPHA, SUB_TOL), G),
                ("cd_shared", (XtX2, Xty2, beta2, LAM, ALPHA, SUB_TOL),
                 Gd)):
            times = {}
            widths = getattr(cd, name + "_widths")(k)
            _, st = cd_checks(torch, f"{name} K={k}", getattr(cd, name),
                              getattr(cd, name + "_plain"), args, GG,
                              args[1], LAM, ALPHA, CD_CAP, times=times,
                              witness=cd_witness(torch, cd, name, beta2, LAM,
                                                 ALPHA, SUB_TOL, mask2, data2,
                                                 R2),
                              widths=[lanes for lanes, _ in widths],
                              replay=True)
            sw = st.pop("sweeps")
            bnd = gram_input_bound(k, m, shared=name == "cd_shared",
                                   sweeps=sw)
            out[f"{name} K={k}"] = dict(
                max_abs_err=st["max_abs_err"],
                match_share=st["match_share"],
                max_objective_excess=st["max_objective_excess"],
                ms=times["ms"], plain_ms=times["plain_ms"], bound_ms=bnd[0],
                bound_by=bnd[1], sweeps_mean=float(sw.double().mean()),
                capped=float((sw >= CD_CAP).double().mean()),
                witness_limits=st["witness_limits"], N=n_cd, M=m,
                lanes=widths[0][0])
            print(f"{name} K={k}: columns {float(sw.double().mean()):.1f} "
                  f"sweeps on average, "
                  f"{out[f'{name} K={k}']['capped']:.3f} at the cap; each "
                  "width at the cap (L, columns an SM, ms, times its bound): "
                  + "; ".join(f"L={lanes} {cols} {times['width_ms'][lanes]:.4f}"
                              f" ms {times['width_ms'][lanes] / bnd[0]:.1f}x"
                              for lanes, cols in widths))
        del G, b, Gd, R2, mask2, data2, beta2, XtX2, Xty2

        # ctns_cd past 128 (a block of 128 threads; XtX in shared memory at
        # K = 160, read in place at 256 and 300): a covariate's system
        # (F q) F^T, F b of n samples and 2048 genes, both stop criteria,
        # bit for bit its plain version with equal sweeps
        mc = 2048
        c = torch.from_numpy(rng_c.standard_normal(n).astype(
            np.float32)).to("cuda")
        Fc = (0.3 * torch.from_numpy(rng_c.standard_normal((k, mc)))).float(
            ).to("cuda")
        mask_c = (torch.from_numpy(rng_c.random((n, mc))) > 0.1).float().to(
            "cuda")
        data_c = torch.from_numpy(rng_c.standard_normal((n, mc)).astype(
            np.float32)).to("cuda")
        XtXc = ((Fc * ((c * c) @ mask_c)[None]) @ Fc.T).contiguous()
        bc = Fc @ (c @ (mask_c * data_c))
        w0 = torch.zeros(k, device="cuda")
        out[f"ctns_cd K={k}"] = dict(ctns_cd_record(
            torch, ctns, f"ctns_cd K={k}", XtXc, bc, w0, False, 1e-1, reps=5,
            plain_reps=1), N=n, M=mc)
        ctns_cd_record(torch, ctns, f"ctns_cd K={k} loss criterion", XtXc,
                       bc, w0, True, 1e-3, reps=5, plain_reps=1)

        # row_xty: where D and T nearly cancel, at the flagship's shape (N,
        # M and LEVELS, as row_xty_gate: the f32 control's error grows with
        # the sum over M, and at M = 2048 it stays below the limit), then
        # timed at this case's shape beside its f32 plain version
        rng = np.random.default_rng(k)
        full_mask = (torch.from_numpy(rng.random((N, M))) > 0.1).float().to(
            "cuda")
        full_F = (0.3 * torch.from_numpy(rng.standard_normal((k, M)))
                  ).float().to("cuda")
        worst = {}
        for L in LEVELS:
            codes = torch.from_numpy(rng.integers(0, L, N).astype(
                np.int32)).to("cuda")
            Rm = (0.5 * torch.from_numpy(rng.standard_normal((N, k)))
                  ).float().to("cuda")
            noise = torch.from_numpy(rng.standard_normal((N, M))).to("cuda")
            for key, v in near_cancel_row_xty(torch, row, codes, Rm,
                                              full_mask, full_F, L,
                                              noise).items():
                worst[key] = max(worst.get(key, 0.0), v)
        del full_mask, full_F, noise
        print(f"row_xty K={k} max err vs the f64 sum, near-cancelling "
              f"inputs at {N} x {M}, over the four confounders, as a "
              "fraction of max |ref|: " + "; ".join(
                  f"{key} {v:.4e}" for key, v in worst.items())
              + f"; limit {ROW_XTY_RTOL:g}")
        if not worst["kernel"] <= ROW_XTY_RTOL:
            fail(f"row_xty K={k} near-cancelling max err "
                 f"{worst['kernel']:.4e} > {ROW_XTY_RTOL:g}")
        if worst["f32 control"] <= ROW_XTY_RTOL:
            fail(f"row_xty K={k}: the gate does not reject the f32 form "
                 "D F^T - T F^T")
        F = (0.3 * torch.from_numpy(rng.standard_normal((k, m)))).float().to(
            "cuda")
        cases = []
        for L in WIDE_LEVELS:
            codes = torch.from_numpy(rng.integers(0, L, n).astype(
                np.int32)).to("cuda")
            Rm = (0.5 * torch.from_numpy(rng.standard_normal((n, k)))
                  ).float().to("cuda")
            E_t = torch.nn.functional.one_hot(codes.long(), L).float().T
            D = (E_t @ (mask * data)).contiguous()
            row_xty_check(torch, row, f"row_xty K={k} L={L}", codes, Rm,
                          mask, D, F)
            if not torch.equal(row.row_xty(codes, Rm, u8, D, F),
                               row.row_xty(codes, Rm, mask, D, F)):
                fail(f"row_xty K={k}: uint8 mask differs from f32")
            cases.append((codes, Rm, D))
        out[f"row_xty K={k}"] = dict(
            row_xty_times(torch, row, cases, mask, F, reps=5),
            max_abs_err=worst["kernel"], N=n, M=m,
            blocks_per_sm=blocks_per_sm(torch, "insider_row_xty_blocks", n,
                                        m, k))
        mw = torch.from_numpy(rng.integers(0, 40, (sum(WIDE_LEVELS), m))
                              .astype(np.float32)).to("cuda")
        got = row.level_gram(mw, F)
        print(f"level_gram K={k}, L={sum(WIDE_LEVELS)}, M={m}:")
        level_gram_gate(torch, row, mw, F, got)
        if not torch.equal(got, row.level_gram(mw, F)):
            fail(f"level_gram K={k} differs from itself")
        out[f"level_gram K={k}"] = dict(
            level_gram_times(torch, row, mw, F, reps=5),
            max_abs_err=float((got - row.level_gram_plain(mw, F)).abs()
                              .max()), N=n, M=m)
        test = ((1 - mask) * (torch.from_numpy(rng.random(mask.shape))
                              .to("cuda") < 0.5)).float()
        err = masked_eval_check(torch, ev, f"masked_eval K={k}", data, mask,
                                test, Rm, F)
        if [float(x) for x in ev.masked_eval(data, u8, test.to(torch.uint8),
                                             Rm, F)] != [
                float(x) for x in ev.masked_eval(data, mask, test, Rm, F)]:
            fail(f"masked_eval K={k}: uint8 masks differ from f32")
        out[f"masked_eval K={k}"] = dict(
            masked_eval_times(torch, ev, data, mask, test, Rm, F, reps=5),
            max_abs_err=err, N=n, M=m,
            blocks_per_sm=blocks_per_sm(torch, "insider_masked_eval_blocks",
                                        n, m, k))
    out.update(past_ceilings(torch, gram, row))
    return out


def past_ceilings(torch, gram, row):
    """col_gram_xty and level_gram at PAST_CEILINGS' shapes, where their
    narrow tiling's shared memory refused the launch: each against its
    plain version, its f64 gate (which rejects one bf16 plane of the
    table), run twice bit for bit and timed; col_gram_xty's grams symmetric
    bit for bit (in col_gram_gate) and its uint8 mask bit for bit its f32
    mask's; level_gram's counts spread over [0, largest], so that all
    three count planes are in use, and its output bit for bit with the
    largest count given as a fit gives it.  Returns {"<name> K=<k>":
    record}."""
    out = {}
    k, n, m = PAST_CEILINGS["col_gram_xty"]
    R, mask, data, _ = problem(torch, n, k, m, k)
    got, rec = col_gram_record(torch, gram, mask, data, R)
    for what, x in (("a repeat", gram.col_gram_xty(mask, data, R)),
                    ("the uint8 mask", gram.col_gram_xty(
                        mask.to(torch.uint8), data, R))):
        if not all(torch.equal(a, b) for a, b in zip(x, got)):
            fail(f"col_gram_xty K={k}: {what} differs bit for bit")
    out[f"col_gram_xty K={k}"] = dict(rec, N=n, M=m)
    del got, R, mask, data

    k, L, m, largest = PAST_CEILINGS["level_gram"]
    rng = np.random.default_rng(k)
    mw = torch.from_numpy(rng.integers(0, largest + 1, (L, m)).astype(
        np.float32)).to("cuda")
    F = (0.3 * torch.from_numpy(rng.standard_normal((k, m)))).float().to(
        "cuda")
    if not float(mw.max()) >= row.TWO_PLANE_COUNT:
        fail(f"level_gram K={k}: no count reaches the third count plane")
    got = row.level_gram(mw, F)
    print(f"level_gram K={k}, L={L}, M={m}, largest count "
          f"{float(mw.max()):.0f} (three count planes):")
    level_gram_gate(torch, row, mw, F, got)
    for what, x in (("a repeat", row.level_gram(mw, F)),
                    ("the largest count given", row.level_gram(
                        mw, F, float(mw.max())))):
        if not torch.equal(x, got):
            fail(f"level_gram K={k}: {what} differs bit for bit")
    out[f"level_gram K={k}"] = dict(
        level_gram_times(torch, row, mw, F, reps=5),
        max_abs_err=float((got - row.level_gram_plain(mw, F)).abs().max()),
        L=L, M=m, largest_count=float(mw.max()))
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


def flagship_object(itt, sharding=None):
    """The flagship problem (phases 8, 10, 11, 16) as an Insider on the
    card, sharded by `sharding` (phase 16) or not."""
    sim = itt.simulate_scale(N, M, K, level_counts=(2, 8, 107),
                             noise_std=1.0, seed=0)
    data = sim.data.astype(np.float64)
    data[np.random.default_rng(0).random(data.shape) < 0.01] = np.nan
    return itt.Insider(data, sim.confounder, interaction_idx=[0, 1],
                       split_ratio=0.1, sharding=sharding, device="cuda")


def covariate_object(itt, sharding=None):
    """The flagship problem with P=3 continuous covariates (phases 13, 16),
    planted as tools/parity_run.py:129-139 plants them (its Protocol C
    problem): C (N, 3) and W_true (3, K) from default_rng(7), the data
    plus C W_true F_true; the 1% NaNs and the split of flagship_object;
    sharded by `sharding` or not."""
    sim = itt.simulate_scale(N, M, K, level_counts=(2, 8, 107),
                             noise_std=1.0, seed=0)
    rng = np.random.default_rng(7)
    ctns = rng.standard_normal((N, 3)).astype(np.float32)
    w_true = rng.standard_normal((3, K)).astype(np.float32)
    data = (sim.data + (ctns @ w_true) @ sim.gene_factor).astype(np.float64)
    data[np.random.default_rng(0).random(data.shape) < 0.01] = np.nan
    return itt.Insider(data, sim.confounder, ctns, interaction_idx=[0, 1],
                       split_ratio=0.1, sharding=sharding, device="cuda")


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


# the device kernels of the profiled fit's wrappers, by parts of their names
# (the gram-input FSS and CD wrappers' block solves above K = 128:
# wide_kernel<, fss_wide.cuh; cd_streamed's instances on grams read through
# L2: streamed_global_kernel<; ctns_cd's block above 128: ctns_cd_block)
KERNEL_NAMES = {"level_gram": ("level_gram",), "row_xty": ("row_xty",),
                "feature_sign_fused": ("fused_kernel<",),
                "masked_eval": ("masked_eval",),
                "col_gram_xty": ("col_gram_xty",),
                "feature_sign": ("streamed_kernel<", "steps_kernel<",
                                 "wide_kernel<"),
                "feature_sign_shared": ("shared_kernel", "steps_kernel<",
                                        "wide_kernel<"),
                "cd_fused": ("fused_kernel<",),
                "cd_streamed": ("streamed_kernel<", "streamed_global_kernel<",
                                "wide_kernel<"),
                "cd_shared": ("shared_kernel", "wide_kernel<"),
                "ctns_cd": ("ctns_cd_kernel", "ctns_cd_block")}


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
    device time.  CUPTI can drop a window's first kernels (a K = 160 fit's
    first masked_eval call: neither of its two kernels recorded, whichever
    throwaway launches went first), so a wrapper whose kernels show fewer
    launches than it made is timed a launch over the launches recorded.
    Returns {"busy_share", "kernels": {name: record}, ...}."""
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
          f"({iters} iterations, {3 if iters > 1 else 2} boundary evals); "
          f"wrapper launches {launches}")
    in_fit = {}
    for wname, n in launches.items():
        parts = KERNEL_NAMES.get(wname)
        if not (n and parts):
            continue
        mine = [(t, m) for k, (t, m) in times.items()
                if any(part in k for part in parts)]
        us = sum(t for t, _ in mine)
        if not us:
            fail(f"profile: {wname} launched {n} times, no device time")
        seen = min(n, max(m for _, m in mine))
        in_fit[wname] = dict(ms_per_launch=us / 1e3 / seen,
                             ms_per_iter=us / 1e3 / seen * n / iters,
                             launches=n, recorded=seen)
        print(f"  in fit: {wname} {us / 1e3 / seen:.4f} ms per launch "
              f"(its kernels together), {n / iters:g} launches/iter"
              + (f" ({seen} of {n} recorded)" if seen < n else ""))
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
    tol32 = float(np.float32(float(tol)))   # a float or a 0-d tensor
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
    tol = float(np.float32(float(tol)))   # a float or a 0-d tensor
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
    (module, name, at), the `at`-th call of <module>.<name>, counted from 1
    or, where `at` is negative, from the end (-1 its last call); returns
    {key: (args, kwargs)}.  The wrappers are restored after."""
    import collections

    wanted = {}
    for key, (module, name, at) in specs.items():
        wanted.setdefault((module, name), {})[at] = key
    seen, got, origs, recent = {}, {}, {}, {}

    class Spy:
        """Stands in for a wrapper: records its calls and passes them on.
        Its attributes are the wrapper's, so a wrapper spied on in its own
        module (where it counts `<name>.launches += 1`) counts as before."""

        def __init__(self, module, name):
            orig = origs[(module, name)] = getattr(module, name)
            ats = wanted[(module, name)]
            object.__setattr__(self, "_call", (orig, ats, (module, name)))
            recent[(module, name)] = collections.deque(
                maxlen=max([-at for at in ats if at < 0], default=0))

        def __call__(self, *args, **kw):
            orig, ats, key = self._call
            n = seen[key] = seen.get(key, 0) + 1
            if n in ats:
                got[ats[n]] = (args, kw)
            recent[key].append((args, kw))
            return orig(*args, **kw)

        def __getattr__(self, attr):
            return getattr(self._call[0], attr)

        def __setattr__(self, attr, value):
            setattr(self._call[0], attr, value)

    try:
        for module, name in wanted:
            setattr(module, name, Spy(module, name))
        run()
    finally:
        for (module, name), orig in origs.items():
            setattr(module, name, orig)
    for (module, name), ats in wanted.items():
        last = recent[(module, name)]
        for at, key in ats.items():
            if at < 0 and -at <= len(last):
                got[key] = last[at]
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

    # the fifth update's own call: eagerly (under the graph the later
    # iterations are replays of one captured call)
    import insider_tpu_torch.api as api

    with fit_mode(als, api, "eager"):
        (G, b, beta0, lam, alpha), ckw = captured_call(
            torch, "feature_sign", 5,
            lambda: predixcan.fit(verbose=False,
                                  **dict(K50_FIT, max_iter=4)))
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

    with fit_mode(als, api, "eager"):
        (G, b, beta0, lam, alpha, tol, sweeps), _ = captured_call(
            torch, "cd_streamed", 5,
            lambda: predixcan.fit(verbose=False,
                                  **dict(K50_FIT, max_iter=4), **COLD))
    c = cd_counts(torch, G, b, beta0, lam, alpha, tol, sweeps)
    out["cold CD K=50 fit, 5th update"] = cd_count_summary(
        torch, "cold-CD K=50 masked fit's fifth column update", 50, c,
        gram_input_bound(50, b.shape[1], shared=False, sweeps=c["sweeps"]))
    return out


def run_fit(torch, obj, wrappers, expect, name, monotone=True, min_iters=10,
            **fit_kw):
    """Drive one fit through Insider.fit with every launch count set to 0
    just before it; check that the kernels in `expect` launched (and those
    mapped to 0 did not), that losses are finite and, with `monotone`,
    non-increasing; print its history and ms per iteration (boundary_ms,
    over at least min_iters iterations).  Returns the launch counts, the
    final loss and the ms per iteration."""
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
    ms_fit = boundary_ms(hist, min_iters)
    print(f"{name}: {obj.fit_result.n_iter} iterations in {fit_s:.2f} s; "
          f"train_rmse {hist[-1]['train_rmse']!r} test_rmse "
          f"{obj.test_rmse!r}; {ms_fit:.3f} ms/iter over iterations "
          f"1-{hist[-1]['iter']} (boundary evals included; graph "
          f"{obj.fit_result.graphed}, capture "
          f"{obj.fit_result.capture_s * 1e3:.2f} ms)")
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

    # the masked fit's last covariate update's inputs to ctns_cd, its own
    # call: the fit runs eagerly here (phase 17 runs it under the graph)
    import insider_tpu_torch.api as api

    with fit_mode(als, api, "eager"):
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


# where infit_checks finds each kernel's wrapper: the module that calls it
INFIT_MODULES = dict(level_gram="als", row_xty="als", masked_eval="als",
                     feature_sign_fused="col_update",
                     col_gram_xty="col_update", feature_sign="col_update",
                     feature_sign_shared="col_update", cd_fused="col_update",
                     cd_streamed="col_update", cd_shared="col_update",
                     ctns_cd="continuous")


def infit_checks(torch, als, name, run, kernels, rows=0, segment=False,
                 notes=None):
    """Each kernel of a fit held against its plain version on the inputs
    the fit gave it: the last call of each kernel in `kernels` (level_gram,
    masked_eval, feature_sign_fused, col_gram_xty, feature_sign,
    feature_sign_shared, cd_fused) and the last `rows` calls of row_xty
    (the last iteration's, one for each confounder on the fast route, each
    at its own L), captured while run() drives the fit, and launched again after
    it beside the plain versions; with `segment` (a fit with one
    confounder on the segment sums), level_gram's last call through
    kernels/row is that confounder's mask counts (segment_gram_gate) and
    its last through train/als the fast confounders'.  Tolerances those of phases 3 and 5:
    level_gram within LEVEL_GRAM_RTOL of max |ref| of the f64 sums
    (level_gram_gate); row_xty within ROW_XTY_RTOL of max |ref| of the f64
    plain version (the fit's inputs nearly cancel, as row_xty_gate's do);
    masked_eval's SSEs within 1e-5 relative, counts exact
    (masked_eval_check); col_gram_xty within COL_GRAM_RTOL of the f64 sums
    both ways (col_gram_gate); the gram-input FSS and CD kernels' grams
    symmetric bit for bit; the FSS kernels' per-column objective at
    most 1e-6 relative above the plain version's (fss_checks; past K = 128
    fss_wide_infit, on a slice of the columns, and every width bit for bit
    the block solve); cd_fused
    against its plain version and a witness (cd_infit); cd_streamed and
    cd_shared (given their grams, as the plain version is) with phase 5's
    gates (cd_checks: the element-wise one at one sweep, the objective at
    1 and 10 sweeps and at the fit's cap), their in-fit bound
    from cd_counts' replay of the call; ctns_cd bit for bit, equal sweeps
    (ctns_cd_record).  With `notes` (a dict), notes[kernel]["bound"] is
    set to the in-fit bound of the CD kernels and ctns_cd.  Returns what
    run() returns."""
    from insider_tpu_torch.kernels import cd, ctns, eval as ev, fss, gram, row
    from insider_tpu_torch.ops import col_update, continuous
    from insider_tpu_torch.ops.col_update import col_gram_masked

    module = dict(als=als, col_update=col_update, continuous=continuous)
    notes = {} if notes is None else notes
    specs = {k: (module[INFIT_MODULES[k]], k, -1) for k in kernels}
    # the inputs of the CD kernels' witnesses: the streamed grams' mask,
    # data and (permuted) row factor; the dense update's data, row factor
    # and coordinate order
    if "cd_streamed" in kernels:
        specs["cd grams"] = (col_update, "col_gram_xty", -1)
    if "cd_shared" in kernels:
        specs["cd dense update"] = (col_update, "update_columns_dense", -1)
    specs.update({("row_xty", -i): (als, "row_xty", -i)
                  for i in range(1, rows + 1)})
    if segment:
        # the segment route calls the kernel through kernels/row, the fast
        # confounders' launch through the name train/als imported
        specs["level_gram"] = (als, "level_gram", -1)
        specs["segment level_gram"] = (row, "level_gram", -1)
    out = {}
    calls = captured_calls(torch, specs, lambda: out.update(result=run()))
    if segment:
        args, kw = calls.pop("segment level_gram")
        print(f"{name}, in-fit level_gram of the segment-sum confounder "
              f"({tuple(args[0].shape)}, K={args[1].shape[0]}):")
        segment_gram_gate(torch, row, args[0], args[1],
                          row.level_gram(*args, **kw))

    if "level_gram" in calls:
        args, kw = calls.pop("level_gram")
        mw, F = args[:2]
        max_count = args[2] if len(args) > 2 else kw["max_count"]
        print(f"{name}, in-fit level_gram ({tuple(mw.shape)}, K="
              f"{F.shape[0]}):")
        level_gram_gate(torch, row, mw, F, row.level_gram(mw, F, max_count))
    levels = []
    for i in range(rows, 0, -1):
        args, _ = calls.pop(("row_xty", -i))
        codes, Rm, mask, D, F = args[:5]
        levels.append(D.shape[0])
        got = row.row_xty(*args)
        exact = row.row_xty_plain(codes, Rm.double(), mask, D.double(),
                                  F.double())
        scale = float(exact.abs().max())
        err = float((got.double() - exact).abs().max()) / scale
        f32 = float((row.row_xty_plain(codes, Rm, mask, D, F).double()
                     - exact).abs().max()) / scale
        print(f"{name}, in-fit row_xty (L={D.shape[0]}, K={F.shape[0]}, "
              f"mask {mask.dtype}): max err vs the f64 plain version "
              f"{err:.4e} of max |ref| (plain f32 {f32:.4e}); limit "
              f"{ROW_XTY_RTOL:g}")
        if not err <= ROW_XTY_RTOL:
            fail(f"{name}: in-fit row_xty L={D.shape[0]} max err {err:.4e}")
        del exact
    if len(set(levels)) != rows:
        fail(f"{name}: the last {rows} row_xty calls were at L={levels}, "
             "not one for each confounder")
    if "masked_eval" in calls:
        args, _ = calls.pop("masked_eval")
        err = masked_eval_check(torch, ev, f"{name}, in-fit masked_eval",
                                *args)
        print(f"{name}, in-fit masked_eval ({tuple(args[0].shape)}): max abs "
              f"diff {err:.4e} from the plain version")
    if "col_gram_xty" in calls:
        (mask, data, R), _ = calls.pop("col_gram_xty")
        col_gram_gate(torch, gram, f"{name}, in-fit col_gram_xty (K="
                      f"{R.shape[1]}, {tuple(mask.shape)})", mask, data, R,
                      gram.col_gram_xty(mask, data, R))
    for k in ("feature_sign_fused", "feature_sign", "feature_sign_shared"):
        if k not in calls:
            continue
        args, kw = calls.pop(k)
        if k != "feature_sign_fused" and not torch.equal(
                args[0], args[0].transpose(0, 1)):
            fail(f"{name}, in-fit {k}: the gram is not symmetric bit for bit")
        if k != "feature_sign_fused" and args[1].shape[0] > 128:
            notes.setdefault(k, {})["bound"] = fss_wide_infit(
                torch, fss, f"{name}, in-fit {k}", k, args, kw)
            continue
        lam, alpha = args[-2:]
        got = getattr(fss, k)(*args, **kw)
        ref = getattr(fss, k + "_plain")(*args, **kw)
        if k == "feature_sign_fused":
            mask, data, R = args[:3]
            G = col_gram_masked(R, mask.to(R.dtype)).permute(1, 2, 0)
            G, b = G.contiguous(), R.T @ (mask * data)
        elif k == "feature_sign":
            G, b = args[:2]
        else:
            XtX, b = args[:2]
            G = XtX[:, :, None].expand(*XtX.shape, b.shape[1])
        share, excess = fss_checks(torch, f"{name}, in-fit {k}", got, ref, G,
                                   b, lam, alpha)
        print(f"{name}, in-fit {k} (K={got.shape[0]}, M={got.shape[1]}): "
              f"columns matching the plain version {share:.6f}, max "
              f"objective excess {excess:.3e} (limit 1e-6), max abs diff "
              f"{float((got - ref).abs().max()):.3e}")
        del G, b
    if "cd_fused" in calls:
        args, _ = calls.pop("cd_fused")
        cd_infit(torch, cd, f"{name}, in-fit cd_fused (K={args[2].shape[1]}"
                 f", M={args[0].shape[1]})", args)
    for k in ("cd_streamed", "cd_shared"):
        if k not in calls:
            continue
        (G, b, beta0, lam, alpha, tol, sweeps), _ = calls.pop(k)
        kk, m = b.shape
        if not torch.equal(G, G.transpose(0, 1)):
            fail(f"{name}, in-fit {k}: the gram is not symmetric bit for bit")
        Gc = G if k == "cd_streamed" else G[:, :, None].expand(kk, kk, m)
        label = f"{name}, in-fit {k} (K={kk}, M={m})"
        if k == "cd_streamed":
            (mask_w, data_w, R_w), _ = calls.pop("cd grams")
            witness = cd_witness(torch, cd, k, beta0, lam, alpha, tol,
                                 mask_w, data_w, R_w)
        else:
            args_w, kw_w = calls.pop("cd dense update")
            witness = cd_witness(torch, cd, k, beta0, lam, alpha, tol,
                                 None, args_w[0], args_w[1], kw_w["perm"])
        # the element-wise gate at one sweep: the fits' grams at K = 160 are
        # near-singular in f32, and by 10 sweeps their last bits move most
        # columns past rtol 2e-5 (the witness moved 43-46% there), so at 10
        # sweeps and at the cap the objective gates hold the kernel
        _, st = cd_checks(torch, label, getattr(cd, k),
                          getattr(cd, k + "_plain"),
                          (G, b, beta0, lam, alpha, tol), Gc, b, lam, alpha,
                          sweeps, witness=witness, short=1, replay=True)
        sw = st.pop("sweeps")
        bnd = gram_input_bound(kk, m, shared=k == "cd_shared", sweeps=sw)
        notes.setdefault(k, {})["bound"] = bnd
        print(f"{label}: columns {float(sw.double().mean()):.1f} sweeps on "
              f"average, {float((sw >= sweeps).double().mean()):.3f} at the "
              f"cap; in-fit bound {bnd[0]:.4f} ms ({bnd[1]})")
        del Gc
    if "ctns_cd" in calls:
        (XtX, b, w0, lam, tol, sweeps), _ = calls.pop("ctns_cd")
        rec = ctns_cd_record(torch, ctns, f"{name}, in-fit ctns_cd (K="
                             f"{b.shape[0]})", XtX, b, w0, False, tol,
                             plain_reps=1)
        notes.setdefault("ctns_cd", {})["bound"] = (rec["bound_ms"],
                                                    rec["bound_by"])
    return out["result"]


WIDE_INFIT_SLICE = 2048   # columns of a K > 128 in-fit FSS call replayed


def fss_wide_infit(torch, fss, name, k, args, kw):
    """A gram-input FSS kernel's in-fit call past K = 128 (feature_sign or
    feature_sign_shared, args its captured inputs, whose gram infit_checks
    holds symmetric bit for bit): its output at every width of
    feature_sign_widths /
    feature_sign_shared_widths equal to the block solve's (lanes=128) bit
    for bit; and on the first WIDE_INFIT_SLICE columns (the plain FSS at
    this width would take minutes at the fit's M) fss_checks against
    fss_counts' replay of the plain loop, whose statistics give the call's
    bound: the bytes of the whole call beside fss_flops of the slice scaled
    to the call's M.  Returns the bound (ms, by)."""
    xtx, xty, beta0, lam, alpha = args[:5]
    kk, m = xty.shape
    shared = xtx.dim() == 2
    fn = getattr(fss, k)
    got = fn(*args, **kw)
    widths = getattr(fss, k + "_widths")(kk)
    outs = {lanes: fn(*args, **kw, lanes=lanes) for lanes, _ in widths}
    for lanes, out in outs.items():
        if not (torch.equal(out, outs[128]) and torch.equal(out, got)):
            fail(f"{name} (K={kk}, M={m}) L={lanes} differs from the block "
                 "solve (lanes=128)")
    del outs
    print(f"{name} (K={kk}, M={m}): widths "
          f"{[lanes for lanes, _ in widths]} equal the block solve "
          "(lanes=128) bit for bit")
    s = min(m, WIDE_INFIT_SLICE)
    G = (xtx[:, :, None].expand(kk, kk, s) if shared
         else xtx[:, :, :s].contiguous())
    b, b0 = xty[:, :s].contiguous(), beta0[:, :s].contiguous()
    c = fss_counts(torch, G, b, b0, lam, alpha, **kw)
    share, excess = fss_checks(torch, f"{name}, first {s} columns",
                               got[:, :s], c["beta"], G, b, lam, alpha)
    count_summary(torch, f"{name}, first {s} columns", kk, c)
    by_bytes = gram_input_bound(kk, m, shared)
    flops = fss_flops(kk, c) * m / s
    bnd = bound(4 * ((kk * kk if shared else kk * kk * m) + 3 * kk * m),
                f32_flop=flops)
    print(f"{name}, first {s} columns: columns matching the plain version "
          f"{share:.6f}, max objective excess {excess:.3e} (limit 1e-6); "
          f"in-fit bound {bnd[0]:.4f} ms ({bnd[1]}; bytes alone "
          f"{by_bytes[0]:.4f} ms, fss_flops scaled to M {flops:.4e})")
    del G, c
    return bnd


def cd_witness(torch, cd, kind, beta0, lam, alpha, tol, mask, data, R,
               perm=None):
    """The witness of a gram-input CD kernel's check (cd_infit's): the plain
    iteration on the f64 sums, rounded once to f32, of the problem the
    kernel's grams were summed from: for cd_streamed the per-gene grams
    and Xty of (mask, data, R), R's columns in the sweep order; for
    cd_shared R^T R and R^T data, both axes in the coordinate order perm.
    Returns cap -> its output (the sums made on the first call)."""
    from insider_tpu_torch.ops.col_update import col_gram_masked

    made = {}

    def run(cap):
        if not made:
            Rd = R.double()
            if kind == "cd_streamed":
                m = mask.double()
                made["G"] = col_gram_masked(Rd, m).permute(1, 2, 0).float(
                    ).contiguous()
                made["b"] = (Rd.T @ (m * data.double())).float()
            else:
                p = (torch.arange(R.shape[1], device=R.device)
                     if perm is None else perm.long())
                made["G"] = (Rd.T @ Rd)[p][:, p].float().contiguous()
                made["b"] = (Rd.T @ data.double())[p].float().contiguous()
        return getattr(cd, kind + "_plain")(made["G"], made["b"], beta0, lam,
                                            alpha, tol, cap)
    return run


def cd_infit(torch, cd, name, args):
    """cd_fused against its plain version on a fit's own inputs `args`, at
    10 sweeps and at the fit's cap.  There the cold-CD columns are far from
    phase 5's synthetic ones: they converge slowly (phase 12), and the
    objective cancels most of the grams' magnitude, so the last bits in
    which the kernel's exact-split grams and the plain version's f32 grams
    differ move the result more than phase 5's 1e-6 (on the unsharded
    flagship fit's last update, 1.55e-6 at 10 sweeps).  The kernel is
    therefore held to a witness: the plain iteration on the f64 sums
    rounded once to f32 (cd_streamed_plain), which differ from the plain
    version's f32 sums in their last bits only.  Every column's objective
    (in f64, on the f64 sums) may exceed the plain version's by at most
    max(1e-6, 2 x the witness's excess), and the columns that differ
    element-wise from the plain version's (rtol 2e-5 / atol 1e-5) may be
    at most max(1%, 2 x the witness's share)."""
    from insider_tpu_torch.ops.col_update import col_gram_masked

    mask, data, R, beta0, lam, alpha, tol, sweeps = args
    m, Rd = mask.to(torch.float64), R.double()
    G = col_gram_masked(Rd, m).permute(1, 2, 0).contiguous()
    b = Rd.T @ (m * data.double())
    del m, Rd
    for cap in (10, sweeps):
        ref = cd.cd_fused_plain(*args[:-1], cap)
        fp = objectives(torch, ref, G, b, lam, alpha)
        stats = {}
        for who, out in (("kernel", cd.cd_fused(*args[:-1], cap)),
                         ("witness", cd.cd_streamed_plain(
                             G.float(), b.float(), beta0, lam, alpha, tol,
                             cap))):
            if not bool(torch.isfinite(out).all()):
                fail(f"{name}: the {who} is not finite at {cap} sweeps")
            fo = objectives(torch, out, G, b, lam, alpha)
            stats[who] = (
                float(((fo - fp) / fp.abs().clamp(min=1.0)).max()),
                1.0 - float(torch.isclose(out, ref, rtol=2e-5, atol=1e-5)
                            .all(0).double().mean()))
        (ek, dk), (ew, dw) = stats["kernel"], stats["witness"]
        print(f"{name} at {cap} sweeps: max objective excess over the plain "
              f"version {ek:.3e} (witness {ew:.3e}), columns differing "
              f"{dk:.6f} (witness {dw:.6f})")
        if not ek <= max(1e-6, 2 * ew):
            fail(f"{name}: objective excess {ek:.3e} at {cap} sweeps, the "
                 f"witness's {ew:.3e}")
        if not dk <= max(0.01, 2 * dw):
            fail(f"{name}: {dk:.6f} of the columns differ at {cap} sweeps, "
                 f"the witness's {dw:.6f}")


def gtex_fits(torch, itt, als, wrappers, host_gb):
    """The GTEx-sized masked fit, 20 iterations, with uint8 masks and with
    the default f32 masks: each kernel of the uint8 fit against its plain
    version on its in-fit inputs (infit_checks); equal losses bit for
    bit, finite and non-increasing; level_gram twice an iteration (tissue
    and donor in one launch, then the interaction's mask counts, its last
    in-fit call, held in f64), row_xty exactly twice (tissue and donor,
    never the interaction), feature_sign_fused once;
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
            infit_checks(torch, als, "GTEx-sized fit", run,
                         ("level_gram", "masked_eval", "feature_sign_fused"),
                         rows=2, segment=True) if mdt is not None else run())
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
        want = dict(level_gram=2 * iters, row_xty=2 * iters,
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
    # the uint8 fit again, eagerly (phase 17's "eager" mode): the same bits,
    # and the peak beyond the problem without the graph's private pool
    import insider_tpu_torch.api as api

    graphed = obj.fit_result.graphed
    with fit_mode(als, api, "eager"):
        _, losses, ms, mem = measured_fit(
            torch, als, obj, wrappers, expect,
            "GTEx-sized fit, uint8 masks, eager", mask_dtype=torch.uint8,
            **GTEX_FIT)
    if losses != res["uint8"]["losses"]:
        fail(f"GTEx-sized fit: the eager fit's losses {losses} vs "
             f"{res['uint8']['losses']}")
    print(f"GTEx-sized fit: took the graph {graphed}; fit peak beyond the "
          f"problem {res['uint8']['fit_peak'] / GB:.3f} GB with it, "
          f"{mem['fit_peak'] / GB:.3f} GB eager; ms/iter "
          f"{res['uint8']['ms']:.3f} with it, {ms:.3f} eager")
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
    if not (got.graphed and ref.graphed):
        fail("profile_dir: the fit did not take the graph")
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


# Phase 15, the command line and the workloads on the card.  The CLI's fit
# and tune take the ageing workload's configuration (workloads/ageing.py:
# K=24, lambda=11, alpha=0.4, the interaction of the first two
# confounders, global_tol=1e-10) on an ageing-shaped table read from a CSV
# file; each workload module runs with its own configuration on its
# synthetic matrix, at the widths below, cut to WORKLOAD_ITERS iterations.
AGEING_LEVELS = (2, 8, 107)
CLI_FIT = ["--confounder-cols", "3", "--interaction", "0,1", "--log2",
           "--rank", "24", "--lam", "11", "--alpha", "0.4", "--partition",
           "1", "--global-tol", "1e-10", "--max-iter", "50"]
CLI_TUNE = ["--confounder-cols", "3", "--interaction", "0,1", "--log2",
            "--ranks", "20,24", "--lambdas", "6,11", "--alphas", "0.4",
            "--tuning-iter", "30", "--global-tol", "1e-10"]
MASKED_FSS = ("level_gram", "row_xty", "feature_sign_fused", "masked_eval")
MASKED_WIDE = ("level_gram", "row_xty", "col_gram_xty", "feature_sign",
               "masked_eval")
# (module, --synthetic-cols, kernels that must launch, confounders with
# interactions, each of which row_xty serves once an iteration): GTEx v8's
# 56200 genes for gtex, the ageing data's 44477 for the others with a
# synthetic matrix, simulation.rmd's own 200 genes; every fit takes FSS,
# so no CD kernel may launch, nor an FSS kernel of another route
WORKLOADS = (("ageing", 44477, MASKED_FSS, 4),
             ("gtex", 56200, MASKED_FSS, 3),
             ("simulation", 200, MASKED_FSS, 3),
             ("prediXcan", 44477, MASKED_WIDE, 2),
             ("brainspan", 44477, ("feature_sign_shared",), 0),
             ("psyencode", 44477, ("feature_sign_shared",), 0))
WORKLOAD_ITERS = 200     # a cut for time: the published max_iter is 1000
                         # (ageing, gtex, simulation, prediXcan) or 50000


def ageing_table(path):
    """Write phase 15's CSV: a header line, 377 rows of 3 integer
    confounder columns (levels 2, 8, 107, every level present) and 44477
    non-negative expression columns, 2^max(x, 0) - 1 of a planted rank-24
    x (so log2(value + 1) = max(x, 0)), with 1% of the expression fields
    NA and 1% of the other fields quoted; each value the f32 one written
    with %.9g, which reads back exactly.  Returns the f32 table as written
    (NaN at the NA fields)."""
    n, m, k = N, M, K
    rng = np.random.default_rng(15)
    conf = np.column_stack([rng.permutation(np.arange(n) % L) + 1
                            for L in AGEING_LEVELS])
    R = sum(rng.standard_normal((L, k))[conf[:, v] - 1]
            for v, L in enumerate(AGEING_LEVELS))
    F = rng.standard_normal((k, m)) * 0.4 * (rng.random((k, m)) < 0.3)
    x = R @ F + 0.5 * rng.standard_normal((n, m))
    table = np.column_stack([conf, np.exp2(np.maximum(x, 0.0)) - 1.0]
                            ).astype(np.float32)
    del R, F, x
    table[:, 3:][rng.random((n, m)) < 0.01] = np.nan
    quoted = (rng.random(table.shape) < 0.01) & ~np.isnan(table)
    with open(path, "w") as fh:
        names = ["pid", "sid", "did"] + [f"g{j}" for j in range(m)]
        fh.write(",".join(f'"{s}"' if j % 7 == 0 else s
                          for j, s in enumerate(names)) + "\n")
        for i, row in enumerate(table):
            fields = ["%.9g" % v for v in row.tolist()]
            for j in np.flatnonzero(np.isnan(row)):
                fields[j] = "NA"
            for j in np.flatnonzero(quoted[i]):
                fields[j] = f'"{fields[j]}"'
            fh.write(",".join(fields) + "\n")
    return table


def boundary_ms(recs, min_iters=10):
    """ms per iteration from a fit's boundary records (its history or its
    --log-jsonl lines), from its first boundary (iteration 0's, after a
    graph fit's capture) to its last: a chained dispatch's boundaries are
    recorded together when it ends, so only a span of whole dispatches
    reads the time of its iterations.  Fails on a span of fewer than
    min_iters iterations (a fit that stopped early; a fit cut to fewer than
    check_every iterations spans its max_iter tail, one dispatch)."""
    first = min((r for r in recs if r["iter"] >= 0), key=lambda r: r["iter"])
    last = recs[-1]
    if last["iter"] < first["iter"] + min_iters:
        fail(f"a fit stopped before a boundary past its first: {recs}")
    return ((last["elapsed_s"] - first["elapsed_s"])
            / (last["iter"] - first["iter"]) * 1e3)


def same_saved(name, path, obj):
    """Fail unless the npz at path holds obj's factors bit for bit."""
    z = np.load(path)
    arrays = [(f"factor{i}", f) for i, f in enumerate(obj.cfd_matrices)]
    arrays.append(("column_factor", obj.column_factor))
    if sorted(z.files) != sorted(k for k, _ in arrays):
        fail(f"{name}: saved arrays {sorted(z.files)}")
    for key, want in arrays:
        if not np.array_equal(z[key], want):
            fail(f"{name}: {key} differs from the in-process fit")


def counted(torch, wrappers, name, run):
    """run() with every launch count set to 0 just before it; returns its
    result and the counts read just after.  What run() prints (the saved
    fit's JSON line, with NaN where a fit has no test cells) is echoed
    indented, so no line of this script's output but the last two is a
    JSON object."""
    import contextlib
    import io

    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        out = run()
    torch.cuda.synchronize()
    for line in buf.getvalue().splitlines():
        print(f"  {name} printed: {line}")
    return out, {n: w.launches for n, w in wrappers.items()}


def check_path(name, counts, expect, wrappers):
    """Fail unless every kernel in expect launched and no other did."""
    print(f"{name}: launches {counts}")
    for n in wrappers:
        if (counts[n] < 1) if n in expect else (counts[n] != 0):
            fail(f"{name}: {n} launched {counts[n]} times")


def cli_phase(torch, itt, als, wrappers, smi, tmp, env):
    """Phase 15, steps 1-4: the ageing-shaped CSV through the native
    parser, the CLI fit as a subprocess and through cli.main against the
    in-process fit (the latter's kernels against their plain versions on
    its in-fit inputs), and the CLI tune against Insider.tune."""
    from insider_tpu_torch import cli
    from insider_tpu_torch.data import native

    csv = os.path.join(tmp, "ageing.csv")
    t0 = time.time()
    table = ageing_table(csv)
    write_s = time.time() - t0
    t0 = time.time()
    native.lib()
    build_s = time.time() - t0
    build_log = (native.build().parent / "native_build.log").read_text()
    print("native library: built with `"
          + [line for line in build_log.splitlines()
             if line.startswith("$ ")][-1][2:] + "`")
    with open(csv) as fh:
        header = cli._looks_like_header(fh.readline(), ",")
    t0 = time.time()
    got = native.load_csv(csv, ",", skip_header=header)
    parse_s = time.time() - t0
    na = np.isnan(table)
    if (not header or got.shape != table.shape
            or not np.array_equal(np.isnan(got), na)
            or not np.array_equal(got[~na].view(np.uint32),
                                  table[~na].view(np.uint32))):
        fail("native load_csv: the parsed table differs from the one "
             "written")
    print(f"native IO: {os.path.getsize(csv) / 1e6:.1f} MB CSV, "
          f"{table.shape[0]} rows x (3 + {table.shape[1] - 3}) columns "
          f"({int(na.sum())} NA) "
          f"written in {write_s:.2f} s; library build {build_s:.2f} s; "
          f"load_csv {parse_s * 1e3:.1f} ms, equal bit for bit ({smi}; "
          "host times)")
    del table, got

    # 2. the CLI fit as a subprocess, against the in-process fit
    out_sub, log = os.path.join(tmp, "cli.npz"), os.path.join(tmp, "cli.jsonl")
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "insider_tpu_torch", "fit", "--data", csv,
         *CLI_FIT, "--out", out_sub, "--log-jsonl", log], cwd=tmp, env=env,
        capture_output=True, text=True, timeout=600)
    sub_s = time.time() - t0
    if proc.returncode != 0:
        fail(f"CLI fit: exit code {proc.returncode}: {proc.stderr[-3000:]}")
    with open(out_sub + ".json") as fh:
        meta = json.load(fh)
    with open(log) as fh:
        sub_ms = boundary_ms([json.loads(line) for line in fh])
    data, conf = cli._load_table(csv, 3, True, 0)
    obj = itt.Insider(data, conf, interaction_idx=[0, 1], global_tol=1e-10)
    del data
    t0 = time.time()
    obj.fit(24, 11, 0.4, partition=1, max_iter=50, verbose=False)
    in_s = time.time() - t0
    if meta["loss"] != obj.fit_result.loss:
        fail(f"CLI fit: loss {meta['loss']!r} against the in-process "
             f"{obj.fit_result.loss!r}")
    same_saved("CLI fit", out_sub, obj)
    losses = [h["loss"] for h in obj.fit_result.history]
    if not all(np.isfinite(losses)) or any(
            b > a * (1 + 1e-6) for a, b in zip(losses, losses[1:])):
        fail(f"CLI fit: losses not finite and non-increasing: {losses}")
    print(f"CLI fit (subprocess, {N} x {M}, K={K}, 50 iterations): exit 0 "
          f"in {sub_s:.2f} s wall, the fit {sub_ms:.3f} ms/iter from its "
          f"log; the in-process fit {in_s:.2f} s, "
          f"{boundary_ms(obj.fit_result.history):.3f} ms/iter; loss "
          f"{meta['loss']!r} and factors equal bit for bit ({smi})")

    # 3. the same fit through cli.main in this process
    out_main = os.path.join(tmp, "main.npz")
    _, counts = infit_checks(
        torch, als, "CLI fit through cli.main", lambda: counted(
            torch, wrappers, "cli.main", lambda: cli.main(
                ["fit", "--data", csv, *CLI_FIT, "--out", out_main])),
        [k for k in MASKED_FSS if k != "row_xty"], rows=4)
    check_path("CLI fit through cli.main", counts, MASKED_FSS, wrappers)
    same_saved("CLI fit through cli.main", out_main, obj)

    # 4. tune, as a subprocess, against Insider.tune in this process
    tune_dir, own_dir = os.path.join(tmp, "tune"), os.path.join(tmp, "own")
    os.makedirs(tune_dir)
    os.makedirs(own_dir)
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "insider_tpu_torch", "tune", "--data", csv,
         *CLI_TUNE, "--out-dir", tune_dir], cwd=tmp, env=env,
        capture_output=True, text=True, timeout=600)
    tune_s = time.time() - t0
    if proc.returncode != 0:
        fail(f"CLI tune: exit code {proc.returncode}: "
             f"{proc.stderr[-3000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    t0 = time.time()
    want = obj.tune([20, 24], [6.0, 11.0], [0.4], out_dir=own_dir)
    own_s = time.time() - t0
    names = sorted(os.listdir(tune_dir))
    if names != sorted(["insider_rank_tuning_result.csv",
                        f"insider_R{want['latent_rank']}_reg_tuning_"
                        "result.csv"]):
        fail(f"CLI tune wrote {names}")
    if (got["latent_rank"] != want["latent_rank"]
            or got["rank_tuning"] != want["rank_tuning"].tolist()
            or got["reg_tuning"] != want["reg_tuning"].tolist()):
        fail(f"CLI tune: {got} against the in-process {want}")
    print(f"CLI tune (subprocess; ranks 20, 24, lambdas 6, 11, alpha 0.4, "
          f"30 iterations a trial): exit 0 in {tune_s:.2f} s wall, both "
          f"CSVs written, latent_rank {got['latent_rank']} and every trial's "
          f"RMSEs equal to Insider.tune's ({own_s:.2f} s) bit for bit "
          f"({smi})")


def workloads_phase(torch, als, wrappers, smi, tmp):
    """Phase 15, step 5: each workload module in this process (runpy, as
    python -m runs it), at its synthetic width, WORKLOAD_ITERS iterations;
    each kernel of its path held against its plain version on the inputs
    its fit gave it (infit_checks)."""
    import runpy

    print(f"workloads: --max-iter {WORKLOAD_ITERS}, a cut for time (the "
          "published max_iter is 1000, or 50000 for brainspan and "
          "psyencode)")
    argv = sys.argv
    try:
        for name, cols, expect, rows in WORKLOADS:
            out = os.path.join(tmp, f"{name}.npz")
            sys.argv = [name, "--synthetic-cols", str(cols), "--max-iter",
                        str(WORKLOAD_ITERS), "--out", out]

            def run():
                t0 = time.time()
                res = counted(torch, wrappers, name, lambda: runpy.run_module(
                    f"insider_tpu_torch.workloads.{name}",
                    run_name="__main__"))
                return res, time.time() - t0
            (g, counts), wall = infit_checks(
                torch, als, f"workload {name}", run,
                [k for k in expect if k != "row_xty"], rows=rows)
            check_path(f"workload {name}", counts, expect, wrappers)
            obj = g["obj"]
            same_saved(f"workload {name}", out, obj)
            with open(out + ".json") as fh:
                meta = json.load(fh)
            hist = obj.fit_result.history
            losses = [h["loss"] for h in hist]
            if meta["loss"] != losses[-1] or not all(np.isfinite(losses)):
                fail(f"workload {name}: losses {losses}, saved {meta}")
            rises = [(a, b) for a, b in zip(losses, losses[1:])
                     if not b <= a * (1 + 1e-6)]
            if rises:
                fail(f"workload {name}: loss increased: {rises}")
            print(f"workload {name}: {obj.data.shape[0]} x "
                  f"{obj.data.shape[1]}, {obj.fit_result.n_iter} "
                  f"iterations, final loss {losses[-1]!r}; "
                  f"{boundary_ms(hist):.3f} ms/iter; {wall:.2f} s with its "
                  f"set-up ({smi})")
    finally:
        sys.argv = argv


def debug_checks_phase(torch, itt, als, smi):
    """Phase 15, step 6: FitConfig.debug_checks on the card."""
    from insider_tpu_torch.config import FitConfig
    from insider_tpu_torch.model.state import init_state

    obj = flagship_object(itt)
    indicator = obj.train_indicator + obj.test_indicator
    problem = als.build_problem(obj.data, obj.confounder, indicator,
                                obj.na_indicator, masked=True)
    runs, ms = [], []
    for checks in (False, True):
        cfg = FitConfig(latent_dim=K, lambda1=LAM, lambda2=LAM, alpha=ALPHA,
                        masked=True, global_tol=0.0, max_iter=20,
                        debug_checks=checks)
        runs.append(als.optimize(problem, cfg, verbose=False))
        ms.append(boundary_ms(runs[-1].history))
    off, on = runs
    if ([h["loss"] for h in on.history] != [h["loss"] for h in off.history]
            or not all(np.array_equal(a, b) for a, b in zip(
                on.row_matrices + [on.column_factor],
                off.row_matrices + [off.column_factor]))):
        fail("debug_checks: the fit with the checks differs from the fit "
             "without them")
    data = obj.data.copy()
    data[1, 3] = np.nan
    indicator[1, 3] = 1
    poisoned = als.build_problem(data, obj.confounder, indicator,
                                 obj.na_indicator, masked=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    state = init_state(g, poisoned.n_levels, poisoned.shape[1], K)
    want = "non-finite values produced by row update V[0] (optimize_row)"
    try:
        als._als_iteration(poisoned, cfg, state, SUB_TOL)
    except als.NonFiniteError as e:
        if str(e) != want:
            fail(f"debug_checks: raised {str(e)!r}")
    else:
        fail("debug_checks: the poisoned iteration raised nothing")
    print(f"debug_checks: the flagship masked fit, 20 iterations, equal bit "
          f"for bit with and without the checks ({ms[1]:.3f} against "
          f"{ms[0]:.3f} ms/iter, {smi}); a NaN in a train-masked cell "
          f"raised {want!r}")


def phase_cli_workloads(torch, itt, als, wrappers, smi):
    """Phase 15: the command line, the workloads and debug_checks on the
    card.  Every check is fatal."""
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH", "")) if p))
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        cli_phase(torch, itt, als, wrappers, smi, tmp, env)
        workloads_phase(torch, als, wrappers, smi, tmp)
    debug_checks_phase(torch, itt, als, smi)


# Phase 16, the sharded fit.  (a) A one-rank NCCL group in this process
# fits the flagship problem with ShardingConfig(1, 1): every collective is
# a no-op on one rank, so it must equal phase 8's fit bit for bit.  (b)
# Two worker processes (this script with --sharded-worker) share the card
# over gloo (NCCL refuses two ranks on one device) and fit the flagship
# problem at full width, 1 x 2 and 2 x 1, SHARDED_ITERS iterations; each
# rank's launch counts show its route and each kernel's last in-fit call
# is held against its plain version (infit_checks).  (c) The same two
# ranks build DIST_SCALE_r05.json's problem from a raw f32 file through
# file_ingest_callbacks, at 2 x 1 and 1 x 2.  Every per-boundary loss
# within rel 1e-5 of the one-process fit's (MULTIPROC_r05.json's class),
# or within twice the largest gap of its witnesses where the fit itself
# moves more with the order of its sums (witness_fits).
SHARDED_ITERS = 20
# (name, layout, Insider.fit arguments, kernels that launch and no other,
# the one-process fit of phases 8 and 10 it is held to)
COLD_MASKED = ("level_gram", "row_xty", "cd_fused", "masked_eval")
SHARDED_FITS = (
    ("flagship masked FSS fit", (1, 2), dict(partition=1), MASKED_FSS,
     "flagship fit"),
    ("flagship masked FSS fit", (2, 1), dict(partition=1), MASKED_WIDE,
     "flagship fit"),
    ("flagship dense FSS fit", (1, 2), dict(partition=0),
     ("feature_sign_shared",), "flagship dense fit"),
    ("cold CD flagship fit", (1, 2), dict(partition=1, **COLD), COLD_MASKED,
     "cold CD flagship fit"))
# DIST_SCALE_r05.json's configuration (tools/dist_scale_run.py): the data
# simulate_scale(4096, 16384, 8, levels (4, 8), noise 1, seed 5) as a raw
# f32 file, confounder codes from the row index, a Bernoulli(0.1) block
# split of seed 77, uint8 masks, K=8, lambda 3, alpha 0.4, 30 iterations
DIST_SHAPE, DIST_LEVELS, DIST_RATIO, DIST_SEED = (4096, 16384), (4, 8), 0.1, 77
DIST_FIT = dict(latent_dim=8, lambda1=3.0, lambda2=3.0, alpha=0.4,
                masked=True, global_tol=1e-12, sub_tol=1e-5, max_iter=30,
                col_solver="fss", seed=0)
SHARDED_RTOL = 1e-5
WORKER_WALL_S = 600
# (d) The settings the sharded fit runs since they were ported to it, on
# the same two ranks: (name, layout, Insider factory, Insider.fit
# arguments, kernels that launch and no other, ctns_cd launches an
# iteration); each held, as the fits above, to the one-process fit of the
# same factory and arguments and to its witnesses.  The precompute=False
# fits take every confounder on the segment sums.  Then the 1 x 2
# flagship masked fit checkpointed at boundary CKPT_AT and resumed,
# against the 1 x 2 fit above bit for bit, and the same fit under
# debug_checks with a NaN put into rank 1's data block (both ranks must
# raise NAN_MESSAGE), then clean, against the 1 x 2 fit bit for bit.
SETTING_FITS = (
    ("flagship masked FSS fit, precompute=False", (1, 2), "flagship",
     dict(partition=1, precompute=False),
     ("level_gram", "feature_sign_fused", "masked_eval"), 0),
    ("flagship masked FSS fit, precompute=False", (2, 1), "flagship",
     dict(partition=1, precompute=False),
     ("level_gram", "col_gram_xty", "feature_sign", "masked_eval"), 0),
    ("flagship masked FSS fit, P=3 covariates", (1, 2), "covariate",
     dict(partition=1), MASKED_FSS + ("ctns_cd",), 3),
    ("flagship dense FSS fit, P=3 covariates", (1, 2), "covariate",
     dict(partition=0), ("feature_sign_shared",), 0))
FACTORIES = {"flagship": flagship_object, "covariate": covariate_object}
CKPT_AT = 10
NAN_MESSAGE = "non-finite values produced by column update F (optimize_col)"
# (e) The GTEx-sized masked fit (phase 14's problem) at 1 x 2: the parent
# writes simulate_scale's matrix with its 1% NaNs once as a raw f32 file
# and the codes of its three confounders (tissue, tissue x donor, donor),
# numbered over the whole matrix; each rank reads its block of the file
# (its NaNs zeroed, and in neither mask), a Bernoulli(0.1) block split of
# seed 123, uint8 masks, 20 iterations.  Held to the one-process fit of
# the same file and split and to its witnesses.
GTEX_SPLIT = (0.1, 123)
GTEX_SHARDED_FIT = dict(latent_dim=K, lambda1=LAM, lambda2=LAM, alpha=ALPHA,
                        masked=True, max_iter=SHARDED_ITERS, seed=0)


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_codes(r0, r1):
    """The DIST_SCALE confounder codes of rows [r0, r1), from the row index
    alone (tools/dist_scale_run.py:_codes_for_rows)."""
    rows = np.arange(r0, r1, dtype=np.int64)
    return [(rows * (v + 3) // 7 % L).astype(np.int32)
            for v, L in enumerate(DIST_LEVELS)]


# The column orders of a fit's witnesses (witness_fits): reversed; rolled
# by a half, a quarter and three quarters of the columns; reversed and
# rolled by a half; three shuffles (seeds 0-2).  An FSS fit's scatter
# over reorderings has a long tail (on the flagship fits one order of
# four moved 2.3x the other three, PERF.md section 6), so the set is
# this large.
WITNESS_ORDERS = ("reversed", "rolled by M/2", "rolled by M/4",
                  "rolled by 3M/4", "reversed, rolled by M/2", "shuffled 0",
                  "shuffled 1", "shuffled 2")


def column_order(name, m):
    """The column order WITNESS_ORDERS names: new column j is column
    order[j]."""
    idx = np.arange(m)
    if name.startswith("shuffled"):
        return np.random.default_rng(int(name.split()[1])).permutation(m)
    return np.ascontiguousarray({
        "reversed": idx[::-1], "rolled by M/2": np.roll(idx, m // 2),
        "rolled by M/4": np.roll(idx, m // 4),
        "rolled by 3M/4": np.roll(idx, 3 * m // 4),
        "reversed, rolled by M/2": np.roll(idx[::-1], m // 2)}[name])


def witness_fits(torch, als, data, confounder, train, test, fit_cfg, seed,
                 ctns=None, precompute=True):
    """A fit's witnesses: for each order of WITNESS_ORDERS, the one-process
    fit of the problem with its columns in that order, from the initial
    state the fit draws (seed) with F's columns reordered alike.  Column
    for column each is the same fit, its sums over the genes (level grams,
    row Xty, eval) taken in another order, as a sharded fit takes them;
    how far their losses move from the fit's is how far the fit moves with
    the order of its sums.  ctns: the covariates (N, P), or None.  Returns
    {order: [(iter, loss, train_rmse, test_rmse)]}."""
    from insider_tpu_torch.model.state import init_state

    out = {}
    for name in WITNESS_ORDERS:
        order = column_order(name, data.shape[1])
        problem = als.build_problem(
            np.ascontiguousarray(data[:, order]), confounder,
            np.ascontiguousarray(train[:, order]),
            np.ascontiguousarray(test[:, order]), ctns,
            masked=fit_cfg.masked,
            mask_dtype=np.uint8 if train.dtype == np.uint8 else None,
            precompute=precompute)
        g = torch.Generator(device=problem.device).manual_seed(seed)
        state = init_state(g, problem.n_levels, problem.shape[1],
                           fit_cfg.latent_dim, init_std=fit_cfg.init_std,
                           n_ctns=0 if ctns is None else ctns.shape[1])
        state.column_factor = state.column_factor[
            :, torch.as_tensor(order, device=problem.device)].contiguous()
        res = als.optimize(problem, fit_cfg, state=state, verbose=False)
        del problem, state
        torch.cuda.empty_cache()
        out[name] = [(h["iter"], h["loss"], h["train_rmse"],
                      h["test_rmse"]) for h in res.history]
    return out


def flagship_witnesses(torch, itt, als):
    """The witnesses of each one-process flagship fit that phase 16 holds
    a sharded fit to, SHARDED_ITERS iterations: {name: a call of
    witness_fits, made when held needs it}."""
    from insider_tpu_torch.config import FitConfig

    obj = flagship_object(itt)
    out = {}
    for _, _, fit_kw, _, ref_name in SHARDED_FITS:
        if ref_name in out:
            continue
        masked = bool(fit_kw["partition"])
        cfg = FitConfig(
            latent_dim=K, lambda1=LAM, lambda2=LAM, alpha=ALPHA,
            masked=masked, global_tol=obj.params["global_tol"],
            sub_tol=obj.params["sub_tol"], max_iter=SHARDED_ITERS,
            seed=obj.seed, col_solver=fit_kw.get("col_solver", "auto"),
            cd_warm_start=fit_kw.get("cd_warm_start", True))
        out[ref_name] = functools.partial(
            witness_fits, torch, als, obj.data, obj.confounder,
            obj.train_indicator + obj.test_indicator, obj.na_indicator, cfg,
            obj.seed)
    return out


def rel_gaps(got, ref):
    """The largest relative gap of each column past the boundary's
    iteration between two histories of (iter, value, ...) rows, which must
    have the same iterations."""
    if [g[0] for g in got] != [r[0] for r in ref]:
        fail(f"boundaries {[g[0] for g in got]} against "
             f"{[r[0] for r in ref]}")
    g, r = np.asarray(got, np.float64)[:, 1:], np.asarray(ref,
                                                          np.float64)[:, 1:]
    return np.nanmax(np.abs(g - r) / np.abs(r), axis=0)


def launched(rec):
    """The kernels a worker's fit launched, with their counts."""
    return {k: n for k, n in rec["counts"].items() if n}


def factors_of(res):
    """An OptimizeResult's factors, the row factors, W where it has one,
    then the whole F."""
    return res.row_matrices + ([] if res.ctns_factor is None
                               else [res.ctns_factor]) + [res.column_factor]


def equal_to_base(label, hist, factors, base):
    """Fail unless a fit's boundaries [(iter, loss)] and factors equal
    base's bit for bit."""
    if hist != base["history"] or len(factors) != len(base["factors"]) or \
            not all(np.array_equal(a, b)
                    for a, b in zip(factors, base["factors"])):
        fail(f"{label}: differs from the 1x2 flagship masked fit ("
             f"{hist} against {base['history']})")


def setting_fits(torch, itt, wrappers, rank):
    """Phase 16 (d), SETTING_FITS on this rank: each fit's launches (its
    route, ctns_cd exactly its count an iteration), history and ms/iter."""
    from insider_tpu_torch.config import ShardingConfig

    out, objs = [], {}
    for name, layout, factory, fit_kw, expect, ctns_per_iter in SETTING_FITS:
        if (factory, layout) not in objs:
            objs[factory, layout] = FACTORIES[factory](
                itt, ShardingConfig(*layout))
        obj = objs[factory, layout]
        label = f"{name} {layout[0]}x{layout[1]} rank {rank}"
        _, counts = counted(torch, wrappers, label, lambda: obj.fit(
            K, LAM, ALPHA, max_iter=SHARDED_ITERS, verbose=False, **fit_kw))
        check_path(label, counts, expect, wrappers)
        if counts["ctns_cd"] != ctns_per_iter * (SHARDED_ITERS + 1):
            fail(f"{label}: ctns_cd launched {counts['ctns_cd']} times, not "
                 f"{ctns_per_iter} an iteration")
        hist = obj.fit_result.history
        out.append(dict(name=name, layout=layout, counts=counts,
                        history=[(h["iter"], h["loss"]) for h in hist],
                        ms=boundary_ms(hist)))
    return out


def checkpoint_fit(torch, als, wrappers, obj, rank, base, path):
    """Phase 16 (d): the 1 x 2 flagship masked fit to boundary CKPT_AT
    with a checkpoint, then resumed to SHARDED_ITERS: bit for bit base
    (the uninterrupted 1 x 2 fit), the checkpoint written by rank 0 alone
    at each boundary, holding the whole F."""
    writes, save = [], als.save_checkpoint

    def counted_save(*args, **kw):
        writes.append(kw["it"])
        return save(*args, **kw)

    label = f"checkpointed 1x2 flagship fit rank {rank}"
    fit = dict(partition=1, verbose=False, checkpoint_path=path)
    als.save_checkpoint = counted_save
    try:
        obj.fit(K, LAM, ALPHA, max_iter=CKPT_AT, **fit)
        first = obj.fit_result.history
        _, counts = counted(torch, wrappers, label, lambda: obj.fit(
            K, LAM, ALPHA, max_iter=SHARDED_ITERS, resume=True, **fit))
    finally:
        als.save_checkpoint = save
    check_path(label, counts, MASKED_FSS, wrappers)
    res = obj.fit_result
    equal_to_base(label, [(h["iter"], h["loss"])
                          for h in first + res.history[1:]],
                  factors_of(res), base)
    if res.history[0]["loss"] != dict(base["history"])[CKPT_AT]:
        fail(f"{label}: the restored state's loss differs from boundary "
             f"{CKPT_AT}'s")
    with np.load(path) as z:
        saved_F = z["column_factor"]
    if saved_F.shape != (K, obj.data.shape[1]) or not np.array_equal(
            saved_F, res.column_factor):
        fail(f"{label}: the checkpoint's F {saved_F.shape} is not the whole "
             "gathered F")
    if writes != ([0, CKPT_AT, SHARDED_ITERS] if rank == 0 else []):
        fail(f"{label}: wrote the checkpoint at {writes}")
    print(f"{label}: resumed at {CKPT_AT} and equal to the uninterrupted "
          f"fit bit for bit; checkpoint writes {writes}, F {saved_F.shape}")


def debug_checks_fit(torch, als, wrappers, obj, rank, base):
    """Phase 16 (d): the 1 x 2 flagship masked FSS fit under debug_checks,
    a NaN put into the first train element of rank 1's data block once the
    initial loss is evaluated (progress_callback: the fit would stop on a
    non-finite initial loss first).  The first column update reads it
    (feature_sign_fused gives that column NaN, as its plain version does),
    so every rank must raise the column update's NonFiniteError.  Then the
    clean fit under debug_checks, bit for bit base (the 1 x 2 fit without
    them).  Returns the message and the seconds to the raise."""
    from insider_tpu_torch.config import FitConfig, ShardingConfig

    def build():
        return als.build_problem(
            obj.data, obj.confounder, obj.train_indicator + obj.test_indicator,
            obj.na_indicator, masked=True, sharding=ShardingConfig(1, 2))

    cfg = FitConfig(latent_dim=K, lambda1=LAM, lambda2=LAM, alpha=ALPHA,
                    masked=True, global_tol=obj.params["global_tol"],
                    sub_tol=obj.params["sub_tol"], max_iter=SHARDED_ITERS,
                    seed=obj.seed, debug_checks=True)
    problem = build()
    i, j = torch.nonzero(problem.train_mask)[0].tolist()

    def poison(rec):
        if rec["iter"] == -1 and rank == 1:
            problem.data[i, j] = float("nan")

    t0 = time.time()
    try:
        res = als.optimize(problem, cfg, verbose=False,
                           progress_callback=poison)
        message = (f"no raise; stopped at boundary {res.n_iter} with loss "
                   f"{res.loss!r}, diverged {res.diverged}")
    except als.NonFiniteError as e:
        message = str(e)
    raised_s = time.time() - t0
    del problem
    label = f"debug_checks 1x2 flagship masked FSS fit, rank {rank}"
    res, counts = counted(torch, wrappers, label, lambda: als.optimize(
        build(), cfg, verbose=False))
    check_path(label, counts, MASKED_FSS, wrappers)
    equal_to_base(label, [(h["iter"], h["loss"]) for h in res.history],
                  factors_of(res), base)
    print(f"{label}: the poisoned fit raised {message!r} after "
          f"{raised_s:.2f} s; the clean fit equals the unchecked fit bit "
          f"for bit")
    return dict(message=message, raised_s=raised_s)


def gtex_sharded(torch, als, wrappers, rank, job):
    """Phase 16 (e) on this rank: the GTEx-sized fit at 1 x 2 from the
    rank's block of the file, each kernel's last in-fit call held against
    its plain version (infit_checks); the problem's bytes on the card, the
    fit's peak beyond them, ms/iter, and the routes (the interaction's
    on the segment sums: no constants, d is None)."""
    from insider_tpu_torch.config import FitConfig, ShardingConfig
    from insider_tpu_torch.data.native import file_ingest_callbacks

    shape = tuple(job["gtex_shape"])
    data_cb, train_cb, test_cb = file_ingest_callbacks(job["gtex_path"],
                                                       shape, *GTEX_SPLIT)
    codes = np.load(job["gtex_codes"], mmap_mode="r")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    t0 = time.time()
    problem = als.build_problem_distributed(
        lambda index: np.nan_to_num(data_cb(index), nan=0.0), train_cb,
        test_cb, [(lambda v: lambda index: np.array(codes[v][index[0]]))(v)
                  for v in range(len(codes))],
        tuple(job["gtex_levels"]), shape, ShardingConfig(1, 2),
        mask_dtype="uint8")
    torch.cuda.synchronize()
    build_s = time.time() - t0
    after = torch.cuda.memory_allocated()
    routes = ["fast" if d is not None else "segment sums" for d in problem.d]
    label = f"GTEx-sized fit 1x2 rank {rank}"
    if routes != ["fast", "segment sums", "fast"]:
        fail(f"{label}: routes {routes}")
    mem = {}

    def run():
        torch.cuda.reset_peak_memory_stats()
        res = als.optimize(problem, FitConfig(**GTEX_SHARDED_FIT),
                           verbose=False)
        torch.cuda.synchronize()
        mem["peak"] = torch.cuda.max_memory_allocated() - after
        return res

    res, counts = infit_checks(
        torch, als, label, lambda: counted(torch, wrappers, label, run),
        ("level_gram", "masked_eval", "feature_sign_fused"), rows=2,
        segment=True)
    check_path(label, counts, MASKED_FSS, wrappers)
    iters = SHARDED_ITERS + 1
    if counts["row_xty"] != 2 * iters or counts["level_gram"] != 2 * iters:
        fail(f"{label}: row_xty {counts['row_xty']}, level_gram "
             f"{counts['level_gram']} launches in {iters} iterations")
    out = dict(counts=counts, routes=routes, problem_bytes=after - before,
               fit_peak=mem["peak"], build_s=build_s,
               history=[(h["iter"], h["loss"], h["train_rmse"],
                         h["test_rmse"]) for h in res.history],
               ms=boundary_ms(res.history))
    print(f"{label}: routes (tissue, tissue x donor, donor) {routes}; "
          f"problem {out['problem_bytes'] / GB:.3f} GB on the card, fit peak "
          f"beyond it {out['fit_peak'] / GB:.3f} GB, built in {build_s:.1f} s,"
          f" {out['ms']:.3f} ms/iter")
    return out


def sharded_worker(rank, world, address, job_path, out_path):
    """One rank of phase 16 (b) and (c), on card 0 with its peer; writes
    what the parent checks to out_path as JSON.  Every check of its own
    (routes, in-fit kernels) is fatal: the rank exits non-zero."""
    import torch

    torch.cuda.set_device(0)
    import insider_tpu_torch as itt
    from insider_tpu_torch.config import FitConfig, ShardingConfig
    from insider_tpu_torch.data.native import file_ingest_callbacks
    from insider_tpu_torch.sharding import initialize_distributed
    from insider_tpu_torch.train import als

    rank, world = int(rank), int(world)
    initialize_distributed(address, world, rank, backend="gloo")
    with open(job_path) as fh:
        job = json.load(fh)
    wrappers = kernel_wrappers()
    out = {"fits": [], "ingest": []}
    objs, base = {}, None
    for name, layout, fit_kw, expect, _ in SHARDED_FITS:
        if layout not in objs:
            objs[layout] = flagship_object(itt, ShardingConfig(*layout))
        obj = objs[layout]
        label = f"{name} {layout[0]}x{layout[1]} rank {rank}"
        _, counts = infit_checks(
            torch, als, label, lambda: counted(
                torch, wrappers, label, lambda: obj.fit(
                    K, LAM, ALPHA, max_iter=SHARDED_ITERS, verbose=False,
                    **fit_kw)),
            [k for k in expect if k != "row_xty"],
            rows=len(LEVELS) if "row_xty" in expect else 0)
        check_path(label, counts, expect, wrappers)
        hist = obj.fit_result.history
        out["fits"].append(dict(
            name=name, layout=layout, counts=counts,
            history=[(h["iter"], h["loss"]) for h in hist],
            ms=boundary_ms(hist)))
        if base is None:        # the 1x2 flagship masked fit
            base = dict(history=out["fits"][-1]["history"],
                        factors=factors_of(obj.fit_result))
    out["settings"] = setting_fits(torch, itt, wrappers, rank)
    checkpoint_fit(torch, als, wrappers, objs[1, 2], rank, base, job["ckpt"])
    out["debug"] = debug_checks_fit(torch, als, wrappers, objs[1, 2], rank,
                                    base)
    del objs
    for layout in ((2, 1), (1, 2)):
        cbs = file_ingest_callbacks(job["path"], DIST_SHAPE, DIST_RATIO,
                                    DIST_SEED)
        largest = [0]

        def seen(cb):
            def call(index):
                block = cb(index)
                largest[0] = max(largest[0], block.nbytes)
                return block
            return call

        def codes_cb(v):
            return lambda index: dist_codes(
                *index[0].indices(DIST_SHAPE[0])[:2])[v]

        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        problem = als.build_problem_distributed(
            *[seen(cb) for cb in cbs],
            [codes_cb(v) for v in range(len(DIST_LEVELS))], DIST_LEVELS,
            DIST_SHAPE, ShardingConfig(*layout), mask_dtype="uint8")
        torch.cuda.synchronize()
        problem_bytes = torch.cuda.memory_allocated() - before
        label = f"DIST_SCALE file ingest {layout[0]}x{layout[1]} rank {rank}"
        res, counts = counted(torch, wrappers, label, lambda: als.optimize(
            problem, FitConfig(**DIST_FIT), verbose=False))
        check_path(label, counts,
                   MASKED_FSS if layout[0] == 1 else MASKED_WIDE, wrappers)
        out["ingest"].append(dict(
            layout=layout, counts=counts, largest_block=largest[0],
            problem_bytes=problem_bytes, split_variant=problem.split_variant,
            history=[(h["iter"], h["loss"], h["train_rmse"], h["test_rmse"])
                     for h in res.history], ms=boundary_ms(res.history)))
        del problem, res
    out["gtex"] = gtex_sharded(torch, als, wrappers, rank, job)
    with open(out_path, "w") as fh:
        json.dump(out, fh)
    torch.distributed.destroy_process_group()
    return 0


def sharded_one_rank(torch, itt, wrappers, smi, ref):
    """Phase 16 (a): a one-rank NCCL group in this process; the flagship
    masked fit with ShardingConfig(1, 1) equals phase 8's bit for bit."""
    import torch.distributed as dist

    from insider_tpu_torch.config import ShardingConfig
    from insider_tpu_torch.sharding import initialize_distributed

    initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        x = torch.arange(4.0, device="cuda")
        dist.all_reduce(x)
        if dist.get_backend() != "nccl" or x.tolist() != [0.0, 1.0, 2.0,
                                                          3.0]:
            fail(f"one-rank group: backend {dist.get_backend()}, "
                 f"all_reduce gave {x.tolist()}")
        obj = flagship_object(itt, ShardingConfig(1, 1))
        name = "sharded 1x1 flagship fit (one-rank NCCL group)"
        _, counts = counted(torch, wrappers, name, lambda: obj.fit(
            partition=1, verbose=False, **FLAG_FIT))
        check_path(name, counts, MASKED_FSS, wrappers)
        res = obj.fit_result
        if ([h["loss"] for h in res.history] != ref["losses"]
                or not all(np.array_equal(a, b) for a, b in zip(
                    res.row_matrices + [res.column_factor],
                    ref["factors"]))):
            fail(f"{name}: differs from phase 8's unsharded fit")
        print(f"{name}: {res.n_iter} iterations, losses and factors equal "
              f"bit for bit to phase 8's unsharded fit; "
              f"{boundary_ms(res.history):.3f} ms/iter ({smi})")
    finally:
        dist.destroy_process_group()


def sharded_one_process_dist_scale(torch, als, path):
    """Phase 16 (c)'s reference: the one-process fit of the file's matrix
    with the same block split, made in memory (the parent holds the whole
    matrix; the ranks never do), as [(iter, loss, train_rmse,
    test_rmse)], and its witnesses, a call of witness_fits."""
    from insider_tpu_torch.config import FitConfig
    from insider_tpu_torch.data import native

    n, m = DIST_SHAPE
    data = np.fromfile(path, np.float32).reshape(n, m)
    train, test, _ = native.split_mask_block(DIST_SHAPE, (0, n), (0, m),
                                             DIST_RATIO, DIST_SEED,
                                             data_block=data)
    confounder = np.column_stack(dist_codes(0, n))
    problem = als.build_problem(data, confounder, train, test,
                                mask_dtype="uint8")
    res = als.optimize(problem, FitConfig(**DIST_FIT), verbose=False)
    del problem
    hist = [(h["iter"], h["loss"], h["train_rmse"], h["test_rmse"])
            for h in res.history]
    return hist, functools.partial(
        witness_fits, torch, als, data, confounder, train, test,
        FitConfig(**DIST_FIT), DIST_FIT["seed"])


def setting_refs(torch, itt, als):
    """Phase 16 (d)'s references: for each name of SETTING_FITS the
    one-process fit of its factory and arguments, SHARDED_ITERS
    iterations, [(iter, loss)], and its witnesses, a call of
    witness_fits."""
    from insider_tpu_torch.config import FitConfig

    out = {}
    for name, _, factory, fit_kw, _, _ in SETTING_FITS:
        if name in out:
            continue
        obj = FACTORIES[factory](itt)
        obj.fit(K, LAM, ALPHA, max_iter=SHARDED_ITERS, verbose=False,
                **fit_kw)
        cfg = FitConfig(
            latent_dim=K, lambda1=LAM, lambda2=LAM, alpha=ALPHA,
            masked=bool(fit_kw["partition"]),
            global_tol=obj.params["global_tol"],
            sub_tol=obj.params["sub_tol"], max_iter=SHARDED_ITERS,
            seed=obj.seed, col_solver=fit_kw.get("col_solver", "auto"),
            cd_warm_start=fit_kw.get("cd_warm_start", True))
        out[name] = ([(h["iter"], h["loss"])
                      for h in obj.fit_result.history],
                     functools.partial(
                         witness_fits, torch, als, obj.data, obj.confounder,
                         obj.train_indicator + obj.test_indicator,
                         obj.na_indicator, cfg, obj.seed,
                         ctns=obj.ctns_confounder,
                         precompute=fit_kw.get("precompute", True)))
    return out


def gtex_file(itt, tmp):
    """Phase 16 (e)'s inputs, written into tmp: simulate_scale's GTEx-sized
    matrix with 1% NaNs (gtex_object's, made a block of rows at a time) as
    a raw f32 file, and the codes of tissue, tissue x donor and donor,
    numbered over the whole matrix, as an (3, N) int32 .npy.  Returns the
    job's entries."""
    from insider_tpu_torch.api import build_interaction_codes

    sim = itt.simulate_scale(GTEX_N, GTEX_M, K, level_counts=GTEX_LEVELS,
                             noise_std=1.0, seed=0)
    data, conf = sim.data, sim.confounder
    del sim
    rng = np.random.default_rng(0)
    for i0 in range(0, GTEX_N, 1024):
        blk = data[i0:i0 + 1024]
        blk[rng.random(blk.shape) < 0.01] = np.nan
    path = os.path.join(tmp, "gtex.f32")
    np.ascontiguousarray(data, np.float32).tofile(path)
    del data
    raw = [conf[:, 0], build_interaction_codes(conf, [0, 1]), conf[:, 1]]
    codes, levels = [], []
    for c in raw:
        u, inv = np.unique(c, return_inverse=True)
        codes.append(inv.reshape(-1).astype(np.int32))
        levels.append(int(u.size))
    codes_path = os.path.join(tmp, "gtex_codes.npy")
    np.save(codes_path, np.stack(codes))
    return dict(gtex_path=path, gtex_codes=codes_path,
                gtex_shape=[GTEX_N, GTEX_M], gtex_levels=levels)


def gtex_refs(torch, als, job):
    """Phase 16 (e)'s reference: the one-process fit of the file's matrix
    (its NaNs zeroed) with the whole block split, made in memory (the
    parent holds the whole matrix; the ranks never do), as [(iter, loss,
    train_rmse, test_rmse)], its witnesses, a call of witness_fits (which
    keeps the matrix in host memory), and its ms/iter."""
    from insider_tpu_torch.config import FitConfig
    from insider_tpu_torch.data import native

    n, m = job["gtex_shape"]
    data = np.fromfile(job["gtex_path"], np.float32).reshape(n, m)
    train, test, _ = native.split_mask_block((n, m), (0, n), (0, m),
                                             *GTEX_SPLIT, data_block=data)
    np.nan_to_num(data, copy=False, nan=0.0)
    confounder = np.load(job["gtex_codes"]).T
    cfg = FitConfig(**GTEX_SHARDED_FIT)
    problem = als.build_problem(data, confounder, train, test,
                                mask_dtype="uint8")
    res = als.optimize(problem, cfg, verbose=False)
    del problem
    torch.cuda.empty_cache()
    hist = [(h["iter"], h["loss"], h["train_rmse"], h["test_rmse"])
            for h in res.history]
    return hist, functools.partial(
        witness_fits, torch, als, data, confounder, train, test, cfg,
        cfg.seed), boundary_ms(res.history)


def phase_sharded(torch, itt, als, wrappers, smi, ref):
    """Phase 16: the sharded fit.  ref: the one-process fits' histories,
    {name: [(iter, loss)]}, and phase 8's losses and factors."""
    import tempfile

    from insider_tpu_torch.data import native

    t_phase = time.time()
    sharded_one_rank(torch, itt, wrappers, smi, ref["phase 8"])

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=os.pathsep.join(
                   p for p in (root, os.environ.get("PYTHONPATH", "")) if p))
    native.lib()            # built here, before two ranks could race
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        path = os.path.join(tmp, "dist_scale.f32")
        t0 = time.time()
        sim = itt.simulate_scale(*DIST_SHAPE, DIST_FIT["latent_dim"],
                                 level_counts=DIST_LEVELS, noise_std=1.0,
                                 seed=5)
        np.ascontiguousarray(sim.data, np.float32).tofile(path)
        del sim
        write_s = time.time() - t0
        t0 = time.time()
        dist_ref, dist_witnesses = sharded_one_process_dist_scale(
            torch, als, path)
        print(f"DIST_SCALE one-process fit: "
              f"{DIST_SHAPE[0]} x {DIST_SHAPE[1]} raw f32 file "
              f"({os.path.getsize(path)} "
              f"bytes, written in {write_s:.2f} s), built and fitted in "
              f"memory in {time.time() - t0:.2f} s")
        t0 = time.time()
        gtex = gtex_file(itt, tmp)
        print(f"GTEx-sized file: {GTEX_N} x {GTEX_M} raw f32 "
              f"({os.path.getsize(gtex['gtex_path'])} bytes) and the codes of "
              f"{gtex['gtex_levels']} levels, written in "
              f"{time.time() - t0:.1f} s")
        job = os.path.join(tmp, "job.json")
        with open(job, "w") as fh:
            json.dump(dict(gtex, path=path,
                           ckpt=os.path.join(tmp, "flagship_1x2.npz")), fh)
        torch.cuda.empty_cache()
        address = f"127.0.0.1:{free_port()}"
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(2)]
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                for r in range(2)]
        t0 = time.time()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--sharded-worker",
             str(r), "2", address, job, outs[r]], cwd=root, env=env,
            stdout=logs[r], stderr=subprocess.STDOUT) for r in range(2)]
        deadline = time.monotonic() + WORKER_WALL_S
        timed_out = False
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                timed_out = True
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        workers_s = time.time() - t0
        for r, log in enumerate(logs):
            log.seek(0)
            for line in log.read().splitlines():
                print(f"  rank {r}: {line}")
            log.close()
        if timed_out:
            fail(f"sharded workers ran past {WORKER_WALL_S} s and were "
                 "killed")
        codes = [p.returncode for p in procs]
        if any(codes):
            fail(f"sharded workers exited with {codes}")
        results = []
        for out in outs:
            with open(out) as fh:
                results.append(json.load(fh))
        t0 = time.time()
        gtex_ref, gtex_witnesses, gtex_ms = gtex_refs(torch, als, gtex)
        print(f"GTEx-sized one-process fit of the file: "
              f"{time.time() - t0:.1f} s, the fit {gtex_ms:.3f} ms/iter "
              f"({smi})")

    note = (f"({smi}; two ranks share one card over gloo through the host: "
            "these times are no multi-card rate)")
    witness = flagship_witnesses(torch, itt, als)
    settings = setting_refs(torch, itt, als)
    failures, fitted = [], {}

    def held(label, recs, ref, witnesses):
        """Each rank's per-boundary gaps (loss, and the RMSEs where given)
        from the one-process fit, against max(SHARDED_RTOL, 2 x the largest
        of its witnesses'.  witnesses() fits them ({order: history}), once
        for each such call, and only where a gap passes SHARDED_RTOL: below
        it they cannot change the verdict."""
        if any(rec["history"] != recs[0]["history"] for rec in recs):
            failures.append(f"{label}: the ranks' histories differ")
        gaps = np.max([rel_gaps(rec["history"], ref) for rec in recs],
                      axis=0)
        by_boundary = [float(np.max(np.abs(np.subtract(g[1], r[1]))
                                    / abs(r[1])))
                       for g, r in zip(recs[0]["history"], ref)]

        def show(xs):
            return "[" + ", ".join(f"{x:.3e}" for x in xs) + "]"

        head = (f"{label}: largest per-boundary gaps (loss"
                f"{', train and test rmse' if len(gaps) > 1 else ''}) from "
                f"the one-process fit {show(gaps)}")
        tail = f"loss gap by boundary (rank 0) {show(by_boundary)}"
        if (gaps <= SHARDED_RTOL).all():
            print(f"{head}, within {SHARDED_RTOL:g} (no witness needed); "
                  f"{tail}")
            return
        if witnesses not in fitted:
            fitted[witnesses] = witnesses()
        each = {k: rel_gaps([h[:len(ref[0])] for h in w], ref)
                for k, w in fitted[witnesses].items()}
        wgaps = np.max(list(each.values()), axis=0)
        limit = np.maximum(SHARDED_RTOL, 2 * wgaps)
        print(f"{head}, its witnesses' {show(wgaps)} ("
              + ", ".join(f"{k} {v[0]:.3e}" for k, v in each.items())
              + f" in loss), limit {show(limit)}; {tail}")
        if not (gaps <= limit).all():
            failures.append(f"{label}: gaps {gaps.tolist()} past "
                            f"{limit.tolist()}")

    for i, (name, layout, _, _, ref_name) in enumerate(SHARDED_FITS):
        recs = [res["fits"][i] for res in results]
        want = [h for h in ref[ref_name] if h[0] <= SHARDED_ITERS]
        label = f"sharded {name} {layout[0]}x{layout[1]}"
        held(label, recs, want, witness[ref_name])
        print(f"{label}: launches rank 0 {launched(recs[0])}, rank 1 "
              f"{launched(recs[1])}; ms/iter rank 0 {recs[0]['ms']:.3f}, "
              f"rank 1 {recs[1]['ms']:.3f} {note}")
    for i, layout in enumerate(((2, 1), (1, 2))):
        recs = [res["ingest"][i] for res in results]
        label = f"DIST_SCALE file ingest {layout[0]}x{layout[1]}"
        held(label, recs, dist_ref, dist_witnesses)
        if any(rec["split_variant"] != "bernoulli_block" for rec in recs):
            failures.append(f"{label}: split_variant "
                            f"{[rec['split_variant'] for rec in recs]}")
        for r, rec in enumerate(recs):
            print(f"{label} rank {r}: largest ingest block "
                  f"{rec['largest_block']} bytes, problem on the card "
                  f"{rec['problem_bytes']} bytes, launches {launched(rec)}, "
                  f"{rec['ms']:.3f} ms/iter {note}")
    for i, (name, layout, *_) in enumerate(SETTING_FITS):
        recs = [res["settings"][i] for res in results]
        label = f"sharded {name} {layout[0]}x{layout[1]}"
        held(label, recs, *settings[name])
        print(f"{label}: launches rank 0 {launched(recs[0])}, rank 1 "
              f"{launched(recs[1])}; ms/iter rank 0 {recs[0]['ms']:.3f}, "
              f"rank 1 {recs[1]['ms']:.3f} {note}")
    debug = [res["debug"] for res in results]
    print(f"debug_checks 1x2 with a NaN in rank 1's block: rank 0 raised "
          f"{debug[0]['message']!r} after {debug[0]['raised_s']:.2f} s, rank "
          f"1 {debug[1]['message']!r} after {debug[1]['raised_s']:.2f} s")
    if any(d["message"] != NAN_MESSAGE for d in debug):
        failures.append(f"debug_checks 1x2: raised {debug}, not "
                        f"{NAN_MESSAGE!r} on both ranks")
    recs = [res["gtex"] for res in results]
    held("sharded GTEx-sized fit 1x2", recs, gtex_ref, gtex_witnesses)
    for r, rec in enumerate(recs):
        print(f"sharded GTEx-sized fit 1x2 rank {r}: problem "
              f"{rec['problem_bytes']} bytes on the card, fit peak beyond it "
              f"{rec['fit_peak']} bytes, built in {rec['build_s']:.1f} s, "
              f"routes {rec['routes']}, launches {launched(rec)}, "
              f"{rec['ms']:.3f} ms/iter (the one-process fit {gtex_ms:.3f}) "
              f"{note}")
    if failures:
        fail("; ".join(failures))
    print(f"phase 16: the workers {workers_s:.1f} s, the phase "
          f"{time.time() - t_phase:.1f} s")


# Phase 17, the iteration as one CUDA graph and the chained boundaries.
# Each fit in three modes: "eager" (every kernel launched from the host and
# one boundary a dispatch, the fit as it runs off the card:
# train/als.graph_route patched to False), "graph 1" (the iterations as
# replays of one captured iteration, boundaries_per_dispatch=1) and "graph
# 5" (the replays and five boundaries a dispatch decided on the card, the
# default), through Insider.fit (its FitConfig patched for the
# boundaries).  (name, Insider factory, Insider.fit arguments.)
GRAPH_FITS = [
    ("flagship masked FSS", "flagship", dict(partition=1, **FLAG_FIT)),
    ("flagship dense FSS", "flagship", dict(partition=0, **FLAG_FIT)),
    ("cold-CD flagship masked", "flagship",
     dict(partition=1, **FLAG_FIT, **COLD)),
    ("prediXcan K=50", "predixcan", K50_FIT),
    ("flagship P=3 covariates masked", "covariates",
     dict(partition=1, **FLAG_FIT)),
]
GRAPH_MODES = ("eager", "graph 1", "graph 5")
# the converging fit: the flagship masked FSS fit to CONVERGE_ITERS with a
# global_tol that stops it at a boundary inside a dispatch (converge_tol)
CONVERGE_ITERS = 200


def fit_mode(als, api, mode):
    """A context that runs Insider.fit in `mode` (GRAPH_MODES)."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        route, config = als.graph_route, api.FitConfig
        bpd = 1 if mode != "graph 5" else 5
        api.FitConfig = lambda *a, **k: config(
            *a, **dict(k, boundaries_per_dispatch=bpd))
        if mode == "eager":
            als.graph_route = lambda *a, **k: False
        try:
            yield
        finally:
            als.graph_route, api.FitConfig = route, config
    return ctx()


def same_fit(a, b):
    """'' when two OptimizeResults are the same fit bit for bit (every
    history record's numbers, the factors, n_iter, converged, diverged),
    else what differs."""
    if [h["iter"] for h in a.history] != [h["iter"] for h in b.history]:
        return "boundaries differ"
    for x, y in zip(a.history, b.history):
        for k in x:
            if (k != "elapsed_s" and np.float64(x[k]).tobytes()
                    != np.float64(y[k]).tobytes()):
                return f"iter {x['iter']} {k}: {x[k]!r} vs {y[k]!r}"
    for i, (x, y) in enumerate(zip(
            a.row_matrices + [a.column_factor] + [a.ctns_factor],
            b.row_matrices + [b.column_factor] + [b.ctns_factor])):
        if not (x is None and y is None or np.array_equal(x, y)):
            return f"factor {i} differs"
    if (a.n_iter, a.converged, a.diverged) != (b.n_iter, b.converged,
                                               b.diverged):
        return "n_iter, converged or diverged differ"
    return ""


def converge_tol(losses):
    """A global_tol that stops a fit with these boundary losses ({iter:
    loss} every 10 iterations) at a boundary inside a dispatch of five,
    with a later one in it (the second, third or fourth boundary of
    iterations 1-50, 51-100, ...), the latest: between the relative
    decrease there and the least one before it.  Returns (global_tol, the
    boundary)."""
    its = sorted(i for i in losses if i >= 10)
    rel = {b: (losses[b - 10] - losses[b]) / losses[b - 10] for b in its
           if b - 10 in losses}
    for b in reversed(its):               # the latest such boundary
        before = [rel[c] for c in rel if c < b]
        if (b // 10) % 5 in (2, 3, 4) and before and 0 < rel[b] < min(
                before):
            return float(np.sqrt(rel[b] * min(before))), b
    fail(f"converging fit: no boundary inside a dispatch where the relative "
         f"decrease falls below all before it: {rel}")


# the device kernel each wrapper launches once a call, by a part of its name
ONCE_A_CALL = {"level_gram": "level_gram_partial",
               "row_xty": "row_xty_partial",
               "feature_sign_fused": "fused_kernel<", "cd_fused": "fused_kernel<",
               "masked_eval": "masked_eval_partial",
               "col_gram_xty": "col_gram_xty_kernel",
               "feature_sign": "streamed_kernel<",
               "cd_streamed": "streamed_kernel<",
               "feature_sign_shared": "shared_kernel",
               "cd_shared": "shared_kernel", "ctns_cd": "ctns_cd_kernel"}


def graph_busy(torch, als, obj, fit_kw, state, iters=20):
    """torch.profiler around `iters` replays of the fit's captured
    iteration (graph.IterationGraph from `state`, the fit's end): device
    kernel time over the host's window, which ends in a synchronize (None
    where the profiler shows no device kernels), and the ms a replay.
    Fails unless the profiler saw each kernel launched `iters` times its
    count in the capture (per_replay, what a replay adds to the launch
    counts).  The tracer drops the first kernels of its window (once
    every kernel of a first replay and the marker after it), so three
    replays run first, then a marker kernel (torch.cuda._sleep's
    spin_kernel), and only the device events after the marker are
    read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from insider_tpu_torch.config import FitConfig
    from insider_tpu_torch.train import graph

    masked = bool(fit_kw.get("partition", 0))
    cold = fit_kw.get("col_solver") == "cd"
    cfg = FitConfig(latent_dim=fit_kw["latent_dimension"],
                    lambda1=fit_kw["lambda_"], lambda2=fit_kw["lambda_"],
                    alpha=fit_kw["alpha"], masked=masked,
                    col_solver=fit_kw.get("col_solver", "auto"),
                    cd_warm_start=not cold)
    problem = als.build_problem(obj.data, obj.confounder,
                                obj.train_indicator + obj.test_indicator,
                                obj.na_indicator, obj.ctns_confounder,
                                masked=masked, device="cuda")
    perm = (torch.randperm(state.latent_dim).cuda() if cold else None)
    g = graph.IterationGraph(problem, cfg, state, als._als_iteration,
                             SUB_TOL, perm)
    g.run(2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        g.run(3)
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.time()
        g.run(iters)
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    marks = [e.time_range.end for e in events if "spin_kernel" in e.name]
    if not marks:
        fail("graph replays: the profiler shows no marker kernel")
    events = [e for e in events if e.time_range.start >= max(marks)]
    want = {}
    for wname, part in ONCE_A_CALL.items():
        want[part] = want.get(part, 0) + iters * g.per_replay[wname]
    seen = {part: sum(part in e.name for e in events) for part in want}
    print(f"  {iters} replays: the profiler's launches {seen}, the launch "
          f"counts' {want}")
    if seen != want:
        fail(f"graph replays: the profiler saw {seen} launches, the launch "
             f"counts {want} (per_replay {g.per_replay})")
    us = sum(e.time_range.end - e.time_range.start for e in events)
    return (us / wall_us if us else None), wall_us / 1e3 / iters


def phase_graph(torch, itt, als, wrappers, smi):
    """Phase 17: every GRAPH_FITS fit and the converging fit in the three
    modes of GRAPH_MODES, each with every launch count set to 0 just
    before it; the graph fits equal the eager fit bit for bit, launch the
    eager fit's kernels as often (plus the iterations a chained dispatch
    ran past its stop, and their evals); ms/iter of each mode, the
    capture time, the wasted iterations and the graph's busy share
    (graph_busy) printed beside the card's name and power limit.  Returns
    {fit: {mode: record}}."""
    import insider_tpu_torch.api as api

    t_phase = time.time()
    factories = dict(flagship=flagship_object, predixcan=predixcan_object,
                     covariates=covariate_object)
    objs = {}
    out, failures = {}, []

    def drive(name, obj, fit_kw, mode):
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        with fit_mode(als, api, mode):
            obj.fit(verbose=False, **fit_kw)
        torch.cuda.synchronize()
        res = obj.fit_result
        return res, {n: w.launches for n, w in wrappers.items()}

    fits = list(GRAPH_FITS)
    flag = objs["flagship"] = flagship_object(itt)
    flag.params["global_tol"] = 0.0
    ref, _ = drive("converging fit, its losses", flag,
                   dict(FLAG_FIT, partition=1, max_iter=CONVERGE_ITERS),
                   "graph 5")
    flag.params["global_tol"] = 1e-9
    tol, stop = converge_tol({h["iter"]: h["loss"] for h in ref.history})
    fits.append(("flagship masked FSS converging mid-dispatch", "flagship",
                 dict(FLAG_FIT, partition=1, max_iter=CONVERGE_ITERS,
                      global_tol=tol)))
    for name, factory, fit_kw in fits:
        if factory not in objs:
            objs[factory] = factories[factory](itt)
        obj = objs[factory]
        kw = {k: v for k, v in fit_kw.items() if k != "global_tol"}
        obj.params["global_tol"] = fit_kw.get("global_tol", 1e-9)
        runs, counts = {}, {}
        for mode in GRAPH_MODES:
            runs[mode], counts[mode] = drive(name, obj, kw, mode)
        obj.params["global_tol"] = 1e-9
        eager = runs["eager"]
        rec = out[name] = {}
        for mode in GRAPH_MODES:
            res = runs[mode]
            rec[mode] = dict(ms=boundary_ms(res.history), capture_s=res.capture_s,
                             graphed=res.graphed, wasted=res.wasted_iters,
                             n_iter=res.n_iter, converged=res.converged)
            if mode == "eager":
                if res.graphed:
                    failures.append(f"{name}: the eager fit took the graph")
                continue
            if not res.graphed:
                print(f"{name}, {mode}: the route was not captured (ran "
                      "eagerly)")
            diff = same_fit(res, eager)
            if diff:
                failures.append(f"{name}, {mode}: {diff}")
            # the boundaries a chained dispatch ran past its stop: their
            # iterations and their evals
            for k, c in counts["eager"].items():
                want = (c + (res.wasted_iters // 10 if c else 0)
                        if k == "masked_eval" else
                        c // (eager.n_iter + 1)
                        * (eager.n_iter + 1 + res.wasted_iters))
                if counts[mode][k] != want:
                    failures.append(f"{name}, {mode}: {k} launched "
                                    f"{counts[mode][k]} times, not {want}")
        launched = {k: c for k, c in counts["graph 5"].items() if c}
        busy, replay_ms = graph_busy(torch, als, obj, kw,
                                     runs["graph 5"].state)
        rec["busy_share"], rec["replay_ms"] = busy, replay_ms
        print(f"{name}: {eager.n_iter} iterations, converged "
              f"{eager.converged}; ms/iter eager "
              f"{rec['eager']['ms']:.4f}, graph 1 "
              f"{rec['graph 1']['ms']:.4f}, graph 5 "
              f"{rec['graph 5']['ms']:.4f}; capture "
              f"{rec['graph 5']['capture_s'] * 1e3:.2f} ms; wasted "
              f"iterations {runs['graph 5'].wasted_iters}; graph busy share "
              f"{'not measured' if busy is None else f'{busy:.3f}'} over "
              f"20 replays ({replay_ms:.4f} ms a replay); graph fits equal "
              f"the eager fit bit for bit: "
              f"{not any(f.startswith(name + ',') for f in failures)}; "
              f"launches (graph 5) {launched} ({smi})")
    conv = out["flagship masked FSS converging mid-dispatch"]
    print(f"converging fit: global_tol {tol!r} stops at iteration {stop}")
    for mode in GRAPH_MODES:
        if not (conv[mode]["converged"] and conv[mode]["n_iter"] == stop):
            failures.append(f"converging fit, {mode}: n_iter "
                            f"{conv[mode]['n_iter']}, converged "
                            f"{conv[mode]['converged']}, not at {stop}")
    if failures:
        fail("; ".join(failures))
    print(f"phase 17: {time.time() - t_phase:.1f} s")
    return out


# Phase 18, rank K above 128 on the card: the flagship problem at its full
# width at K = 160 (simulate_scale(377, 44477, 160, level_counts=(2, 8,
# 107), noise_std=1.0, seed=0), 1% NaNs, lambda 11, alpha 0.4), masked
# (partition=1, 10% held out: col_gram_xty + the wide FSS solve as
# feature_sign, row_xty and masked_eval in tiles of 128 coordinates,
# level_gram) and dense (partition=0: the wide solve as feature_sign_shared),
# then with cold CD (col_solver="cd", cd_warm_start=False: the grouped CD
# loop's instances past 128 as cd_streamed, masked, and cd_shared, dense),
# then masked with P=3 continuous covariates planted as covariate_object
# plants them (ctns_cd's block of 128 threads, 3 launches an iteration),
# under the graph, 10 iterations each (cut from convergence for time; N, M
# and K not cut).
WIDE_K = 160
WIDE_FIT = dict(latent_dimension=WIDE_K, lambda_=LAM, alpha=ALPHA)
WIDE_ITERS = dict(fss=10, cd=10)
NO_CD = dict(cd_fused=0, cd_streamed=0, cd_shared=0, ctns_cd=0)
NO_FSS = dict(feature_sign_fused=0, feature_sign=0, feature_sign_shared=0)
WIDE_COLD_MASKED = ("level_gram", "row_xty", "col_gram_xty", "cd_streamed",
                    "masked_eval")
WIDE_PROFILE_ITERS = 1   # iterations a profile of a K=160 fit: the first,
                         # eager (for time: no capture)


def wide_object(itt, n_ctns=0):
    """The flagship problem at K = 160 as an Insider on the card: the data
    simulated at rank 160, the 1% NaNs and the split of flagship_object;
    with n_ctns = 3, the covariates of covariate_object (C and W_true from
    default_rng(7), the data plus C W_true F_true)."""
    sim = itt.simulate_scale(N, M, WIDE_K, level_counts=(2, 8, 107),
                             noise_std=1.0, seed=0)
    data, ctns = sim.data, None
    if n_ctns:
        rng = np.random.default_rng(7)
        ctns = rng.standard_normal((N, n_ctns)).astype(np.float32)
        w_true = rng.standard_normal((n_ctns, WIDE_K)).astype(np.float32)
        data = data + (ctns @ w_true) @ sim.gene_factor
    data = data.astype(np.float64)
    data[np.random.default_rng(0).random(data.shape) < 0.01] = np.nan
    return itt.Insider(data, sim.confounder, ctns, interaction_idx=[0, 1],
                       split_ratio=0.1, device="cuda")


def phase_wide_rank(torch, itt, als, wrappers, smi):
    """Phase 18: the K = 160 flagship fits through Insider.fit, each on an
    object of its own with its launch counts set to 0 just before it: FSS
    masked and dense, cold CD masked and dense, FSS masked with P=3
    covariates.  Each: the kernels of its route launched and no other
    (ctns_cd exactly 3 times an iteration in the covariate fit), losses
    finite (and non-increasing x (1 + 1e-6) for the FSS fits; a cold-CD
    fit screens its warm start), ms/iter, the problem's bytes on the card
    and the fit's peak beyond them printed (measured_fit); the last in-fit
    calls held against their plain versions (infit_checks): of the FSS
    masked fit level_gram, masked_eval and row_xty (one for each of the
    four confounders; col_gram_xty at K = 160 is held to its plain version
    in phase 6), of the FSS fits feature_sign and feature_sign_shared
    (fss_wide_infit: the gram symmetric bit for bit, every width equal to
    the block solve bit for bit, fss_checks on a slice of the columns
    against fss_counts' replay, whose statistics give the in-fit bound), of
    the cold-CD fits cd_streamed and cd_shared (the gram symmetric bit for
    bit; phase 5's gates, the element-wise one at one sweep, and the in-fit
    bound from cd_counts' replay of that call), of the covariate fit
    ctns_cd (bit for bit, equal sweeps).  Then torch.profiler over
    WIDE_PROFILE_ITERS iterations of each fit from its end state
    (profile_fit): each wrapper's in-fit ms a launch, beside its in-fit
    bound (the gram builds': gram_build_infit_bound).  Returns {kernel:
    launches} of the fits."""
    # (label, fit settings, covariates, launches, in-fit kernels, row_xty
    # calls); the fits of one problem share its object (the masked and the
    # dense problem are one Insider)
    fits = (
        ("FSS masked", dict(partition=1), 0,
         dict(dict.fromkeys(MASKED_WIDE, 1), feature_sign_fused=0,
              feature_sign_shared=0, **NO_CD),
         ["level_gram", "masked_eval", "feature_sign"], 4),
        ("FSS dense", dict(partition=0), 0,
         dict(feature_sign_shared=1, col_gram_xty=0, feature_sign=0,
              feature_sign_fused=0, **NO_CD), ["feature_sign_shared"], 0),
        ("cold CD masked", dict(partition=1, **COLD), 0,
         dict(dict.fromkeys(WIDE_COLD_MASKED, 1), cd_fused=0, cd_shared=0,
              ctns_cd=0, **NO_FSS), ["cd_streamed"], 0),
        ("cold CD dense", dict(partition=0, **COLD), 0,
         dict(cd_shared=1, cd_streamed=0, cd_fused=0, col_gram_xty=0,
              ctns_cd=0, **NO_FSS), ["cd_shared"], 0),
        ("FSS masked P=3", dict(partition=1), 3,
         dict(dict.fromkeys(MASKED_WIDE, 1), feature_sign_fused=0,
              feature_sign_shared=0, ctns_cd=1, cd_fused=0, cd_streamed=0,
              cd_shared=0), ["ctns_cd", "feature_sign"], 0))
    out, table, objs = {}, [], {}
    for label, kw, n_ctns, expect, infit, rows in fits:
        name = f"K={WIDE_K} {label} fit"
        if n_ctns not in objs:
            objs.clear()
            objs[n_ctns] = wide_object(itt, n_ctns)
        obj = objs[n_ctns]
        # garbage collected before each fit, so that no earlier tensor is
        # freed inside the build's memory reading (measured_fit)
        gc.collect()
        notes = {}
        max_iter = WIDE_ITERS["cd" if "cold" in label else "fss"]
        launches, losses, ms, mem = infit_checks(
            torch, als, name, lambda: measured_fit(
                torch, als, obj, wrappers, expect, name,
                monotone="cold" not in label, min_iters=max_iter,
                max_iter=max_iter, **kw, **WIDE_FIT),
            infit, rows=rows, notes=notes)
        n_iter = max_iter + 1
        if n_ctns and launches["ctns_cd"] != n_ctns * n_iter:
            fail(f"{name}: ctns_cd launched {launches['ctns_cd']} times, not "
                 f"{n_ctns} x {n_iter}")
        print(f"{name} at {N} x {M}: {ms:.3f} ms/iter; problem "
              f"{mem['persistent']} bytes on the card, fit peak "
              f"{mem['fit_peak']} bytes beyond it ({smi})")
        for k, n in launches.items():
            if expect.get(k):
                out[k] = max(out.get(k, 0), n)
        solver = COLD if "cold" in label else {}
        print(f"profile of the {name}, {WIDE_PROFILE_ITERS} iterations from "
              "its end state:")
        prof = profile_fit(torch, obj, wrappers, obj.fit_result.state,
                           WIDE_K, LAM, ALPHA, iters=WIDE_PROFILE_ITERS,
                           masked=kw["partition"] == 1, **solver)
        for k in ("level_gram", "col_gram_xty", "row_xty", "masked_eval",
                  "feature_sign", "feature_sign_shared", "cd_streamed",
                  "cd_shared", "ctns_cd"):
            if k not in prof["in_fit"]:
                continue
            bnd = (gram_build_infit_bound(k, WIDE_K) if k in (
                "level_gram", "col_gram_xty") else row_infit_bound(
                    k, WIDE_K) if k in ("row_xty", "masked_eval")
                   else notes.get(k, {}).get("bound") or gram_input_bound(
                       WIDE_K, M, shared=k == "feature_sign_shared"))
            rec = prof["in_fit"][k]
            table.append((name, k, rec["ms_per_launch"],
                          rec["launches"] / WIDE_PROFILE_ITERS, bnd))
        del obj
    objs.clear()
    for name, k, ms_launch, per_iter, bnd in table:
        print(f"in-fit {k} at K={WIDE_K} ({name}): {ms_launch:.4f} ms a "
              f"launch, {per_iter:g} launches/iter; in-fit bound "
              f"{bnd[0]:.6f} ms ({bnd[1]}) ({smi})")
    return out


def gram_build_infit_bound(name, k):
    """(bound_ms, bound_by) of a gram build's call in a masked fit of the
    flagship problem at rank k: level_gram on the 133 levels' mask counts
    (below 65536, two count planes), as level_gram_times counts it, or
    col_gram_xty on N x M, as col_gram_bound counts it."""
    if name == "col_gram_xty":
        return col_gram_bound(N, k, M)
    L = sum(LEVELS)
    return bound(4 * (L * M + k * M + L * k * k),
                 bf16_flop=2 * 3 * 2 * L * pairs(k) * M)


def row_infit_bound(name, k):
    """(bound_ms, bound_by) of a launch of a row kernel in a masked fit of
    the flagship problem at rank k, f32 masks: row_xty's, the mean of its
    four confounders' calls (the mask, D and F read, 2 N M K flops for the
    prediction and 2 L M K for the contraction, as row_xty_times counts
    them); masked_eval's, data and both masks read and 2 N M K flops."""
    if name == "masked_eval":
        return bound(4 * (3 * N * M + N * k + k * M), f32_flop=2 * N * M * k)
    calls = [bound(4 * (N * M + L * M + k * M + N * k + L * k),
                   f32_flop=2 * (N + L) * k * M) for L in LEVELS]
    return (sum(b for b, _ in calls) / len(calls),
            "bytes" if all(by == "bytes" for _, by in calls)
            else "operations")


def kernel_wrappers():
    """{name: wrapper} of every kernel, each with its launch count (which
    a graph replay advances by the launches of its captured iteration)."""
    from insider_tpu_torch.train import graph

    return graph.kernel_wrappers()


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2

    t_main = time.time()

    def lap(phase):
        print(f"[phase clock] phase {phase} done at "
              f"{time.time() - t_main:.1f} s")

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

    lap(1)

    # 2. build
    t0 = time.time()
    _lib.lib()
    build_s = time.time() - t0
    log = (_lib.build().parent / "build.log").read_text()
    print(f"build: {build_s:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    lap(2)

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

    lap(3)

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

    lap(4)

    # 5. the cold-CD kernels
    kern_cd = phase_kernels_cd(torch, gram, cd)
    kern.update(kern_cd)
    for name, rec in kern_cd.items():
        print(f"kernel {name}: max_abs_err {rec['max_abs_err']:.3e} "
              f"kernel {rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms")
    nonfinite_checks(torch, gram, fss, cd)

    lap(5)

    # 6. K = 96 and K = 128
    for name, rec in phase_kernels_wide(torch, gram, fss, cd).items():
        print(f"kernel {name} M={rec.get('M', 2048)}: max_abs_err "
              f"{rec['max_abs_err']:.3e} "
              f"kernel {rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms"
              + (f" library {rec['library_ms']:.4f} ms"
                 if "library_ms" in rec else "")
              + (f" bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})"
                 if "bound_ms" in rec else "")
              + (f" group width L={rec['lanes']}" if "lanes" in rec else ""))

    # 6, past K = 128: the widened kernels at K = 160, 256 and 300
    wide = phase_kernels_wider(torch, gram, fss, cd, ctns, row, ev)
    for name, rec in wide.items():
        shape = " ".join(f"{d}={rec[d]}" for d in ("N", "L", "M")
                         if d in rec)
        print(f"kernel {name} {shape}: max_abs_err "
              f"{rec['max_abs_err']:.3e} kernel {rec['ms']:.4f} ms plain "
              f"{rec['plain_ms']:.4f} ms"
              + (f" library {rec['library_ms']:.4f} ms"
                 if rec.get("library_ms") is not None else "")
              + f" bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})"
              + (f" group width L={rec['lanes']}" if "lanes" in rec else "")
              + f" ({smi})")
    kern.update({name: rec for name, rec in wide.items()
                 if name.endswith(f" K={WIDE_K}")})

    lap(6)

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
                       dict(k=96, m=300, max_iter=10, witness=True)),
                      # past K = 128: col_gram_xty and the wide FSS solve,
                      # row_xty and masked_eval in tiles of 128
                      ("masked 120x100 K=136, 10 iterations",
                       dict(k=136, m=100, max_iter=10, witness=True)),
                      ("dense 120x100 K=136, 10 iterations",
                       dict(k=136, m=100, max_iter=10, partition=0))):
        rel, failed = phase_small_fit(torch, itt, **kw)
        if failed:
            failures.append(failed)
            print(f"small fit {label}: FAILED")
        else:
            print(f"small fit {label}: card vs cpu max loss rel diff "
                  f"{rel:.3e}")
    if failures:
        fail("; ".join(failures))

    wrappers = kernel_wrappers()
    no_cd = dict(cd_fused=0, cd_streamed=0, cd_shared=0, ctns_cd=0)
    no_fss = dict(feature_sign_fused=0, feature_sign=0, feature_sign_shared=0,
                  ctns_cd=0)

    lap(7)

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
    # what phase 16's sharded fits are held to
    one_process = {"phase 8": dict(
        losses=hist["flagship fit"],
        factors=[f.copy() for f in flagship.fit_result.row_matrices
                 + [flagship.fit_result.column_factor]])}

    def boundaries(name, obj):
        one_process[name] = [(h["iter"], h["loss"])
                             for h in obj.fit_result.history]
    boundaries("flagship fit", flagship)
    dense, fss_dense, flag_ms["dense"] = run_fit(
        torch, flagship, wrappers, dict(feature_sign_shared=1, **no_cd),
        "flagship dense fit", partition=0, **FLAG_FIT)
    dense_state = flagship.fit_result.state
    boundaries("flagship dense fit", flagship)
    launches["feature_sign_shared"] = dense["feature_sign_shared"]

    lap(8)

    # 9. K=50 masked fit at the prediXcan shape
    predixcan = predixcan_object(itt)
    k50, fss_k50, _ = run_fit(
        torch, predixcan, wrappers,
        dict(masked_path, feature_sign_fused=0, col_gram_xty=1,
             feature_sign=1, **no_cd), "K=50 masked fit", **K50_FIT)
    launches["col_gram_xty"] = k50["col_gram_xty"]
    launches["feature_sign"] = k50["feature_sign"]

    lap(9)

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
        boundaries(name, obj)
        for n in ("cd_fused", "cd_streamed", "cd_shared"):
            if expect.get(n):
                launches[n] = counts[n]
        print(f"{name}: final loss {loss!r} vs FSS fit {fss_loss!r} "
              f"(ratio {loss / fss_loss:.6f})")

    lap(10)

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

    lap(11)

    # 12. what the columns cost: counting replays of the FSS and cold-CD
    # iterations
    phase_counts(torch, itt, gram, flagship, flag_state, dense_state,
                 dense_prof["in_fit"]["feature_sign_shared"]["ms_per_launch"],
                 cd_states["cold CD flagship fit"],
                 cd_states["cold CD flagship dense fit"], predixcan,
                 cd_states["cold CD K=50 masked fit"])
    del flagship, predixcan

    lap(12)

    # 13. continuous covariates, checkpoint, glm
    kern["ctns_cd"] = phase_covariates(torch, itt, wrappers, masked_path,
                                       flag_ms)
    launches["ctns_cd"] = kern["ctns_cd"]["launches"]

    lap(13)

    # 14. the memory-lean fit: uint8 masks, chunked precompute, segment sums
    lean = phase_memory_lean(torch, itt, als, (row, fss, cd, ev, gram),
                             wrappers, hist)
    kern.update(lean)
    for name, rec in lean.items():
        launches[name] = rec["launches"]

    lap(14)

    # 15. the command line, the workloads and debug_checks
    phase_cli_workloads(torch, itt, als, wrappers, smi)

    lap(15)

    # 16. the sharded fit: one rank over NCCL, two ranks sharing the card
    # over gloo, and the file ingest
    phase_sharded(torch, itt, als, wrappers, smi, one_process)

    lap(16)

    # 17. the iteration as one CUDA graph and the chained boundaries
    phase_graph(torch, itt, als, wrappers, smi)

    lap(17)

    # 18. rank K above 128: the K=160 flagship fits
    for name, n in phase_wide_rank(torch, itt, als, wrappers, smi).items():
        launches[f"{name} K={WIDE_K}"] = n

    lap(18)

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
    # the uint8-mask instances of the kernels that read the mask, and the
    # K=160 instances (the FSS kernels' grouped solve on the steps of
    # fss_wide.cuh and the grouped CD loop; each kernel in its own source)
    wide = [name for name in kern if name.endswith(f" K={WIDE_K}")]
    for name in list(lean) + wide:
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
        for name in list(wrappers) + list(lean) + wide]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-worker"]:
        sys.exit(sharded_worker(*sys.argv[2:]))
    sys.exit(main())
