#!/usr/bin/env python3
"""Time the port's main-path kernels, its FSS kernels and its six fits, for
one package tree, on one NVIDIA GPU.

    python3 chip_ab.py ROOT [--out FILE] [--shared-only | --wide-cd |
                                           --wide-fss |
                                           --wide-row [--force-large] |
                                           --wide-gram [--force-wide]]
    python3 chip_ab.py --share FILE.npz FILE.npz

ROOT is a directory that holds an insider_tpu_torch package: this checkout,
or another commit unpacked into a gitignored directory (e.g. `git archive
<commit> | tar -x -C _checkout/parent`), so that two trees are compared on
one card in one call, in turns: parent, change, change, parent.  The
package is imported from ROOT; the setup helpers come from this
directory's chip_smoke.py, so both trees see the same inputs.  Measured:
  * level_gram at the flagship shape (sum L = 133, K = 24) and at the K=50
    shape (levels 12 and 25, N = 300), kernel and plain version, beside one
    cuBLAS f32 GEMM on the prebuilt table (library_ms), and a checksum of
    its output;
  * row_xty for the four flagship confounders in one timed call and for the
    two K=50 confounders, and masked_eval at both shapes, kernel and plain
    version, beside their bounds, with a checksum of each one's outputs;
  * the fused kernels' gram build alone (feature_sign_fused with
    max_outer=0, polish_sweeps=0; cd_fused with max_sweeps=0);
  * col_gram_xty alone on chip_smoke's phase-4 input at K=50 and its
    phase-6 inputs at K=96 and K=128 (M=2048), beside one cuBLAS f32 GEMM
    on the prebuilt table (library_ms) and its bound, with a checksum of
    the grams and of Xty;
  * the FSS kernels on chip_smoke's fixed inputs, each with a checksum of
    its output (sha256 of the bytes, -0 read as +0), so that two trees
    whose arithmetic is the same agree bit for bit: feature_sign_fused on
    phase 3's input, feature_sign at K=50 on phase 4's (col_gram_xty
    grams) and at K=96, 128 on phase 6's (M=2048), feature_sign_shared at
    K=24 on phase 4's R^T R; feature_sign's records also hold the sum of
    its columns' objectives on the f64 grams, which two trees whose grams
    round differently are compared by;
  * the cold-CD kernels at the 200-sweep cap on chip_smoke's fixed inputs,
    each with a checksum of its output: cd_fused and cd_shared on phase
    5's K=24 input, cd_streamed on phase 5's K=50 input and phase 6's K=96
    and K=128 (M=2048), cd_shared also on R^T R of those three problems;
    where the tree's cd_fused or cd_streamed takes a group width, also at
    each width it has an instance of (with the columns an SM sweeps at
    once), and cd_streamed at every width at K = 16 to 128 on columns that
    all run to the cap (tol 0, M=8192): the times their fixed choices of
    width rest on; with --out, the K=24
    outputs of cd_fused and cd_shared are saved beside FILE (FILE.npz),
    and --share prints the share of the columns of two such files that
    are equal bit for bit;
  * the ms per iteration of the FSS and cold-CD fits, flagship masked and
    dense and K=50 masked, from each fit's own boundary clock, and their
    final losses;
  * torch.profiler over 10 iterations of the flagship masked FSS fit, of
    the cold-CD flagship masked fit (with group widths, also at each width
    cd_fused has at K=24), of the cold-CD flagship dense fit, of the K=50
    masked FSS fit and of the cold-CD
    K=50 masked fit (with group widths, also at each width cd_streamed has
    at K=50), each from where its fit ended: each kernel's device time,
    each wrapper's in-fit ms per launch, the device busy share.
With --wide-cd only the cold-CD kernels past K = 128: cd_streamed and
cd_shared at every group width they have (cd_*_widths; 128 the block
solve) at K = 129, 160, 192, 224, 256, 288, 300, 320 and 321 on
chip_smoke's phase-6 problem of 2K rows (lambda 11, alpha 0.4, the
200-sweep cap; M = 2048, 1024 from K = 288, 512 at 321), each width's
output held to the block solve's (lanes=128) bit for bit at 10 and 200
sweeps, and on columns that all run to the cap (tol 0, lambda 0.05, M =
2048) at K = 160, 192, 224, 256 and 320: the times the kernels' order of
widths rests on.
With --wide-fss only the FSS kernels past K = 128: the K = 160 masked and
dense FSS fits of chip_smoke.py phase 18 (10 iterations each, their
ms/iter), and on the first 2048 columns of each fit's first column update
(iteration 0) and of one eager update from its end state, fss_counts'
statistics (outer steps, active sets, polish sweeps, fss_flops and the
bound) and the kernel at every width it has (feature_sign_widths,
feature_sign_shared_widths; 128 the block solve), also with
polish_sweeps=0 and with max_outer=0, polish_sweeps=0 (the set-up alone);
then chip_smoke's phase-6 FSS problem (300 rows, lambda 1, alpha 0.5) at
K = 129, 160, 192, 224, 256, 288, 300, 320 and 321 (M = 2048, 1024 at
288, 256 from 300) at every width, each width's output held to the block
solve's (lanes=128) bit for bit, with a checksum.
With --wide-gram only the gram builds, col_gram_xty and level_gram, at
K = 24, 50, 96, 128 (the narrow instances) and 129, 160, 192, 224, 256,
288, 300 and 320 on inputs shaped as chip_smoke.py phase 6's (col_gram_xty:
chip_smoke's problem, N = 300; level_gram: 37 levels of counts below 40;
M = 2048, 256 from K = 300), both again at K = 50 and M = 44477 (the K=50
fit's width), and level_gram with the flagship's 133 levels at M = 44477
at K = 24 and at the K = 160 fit's rank: each kernel's ms beside
library_ms (one cuBLAS f32 GEMM on the prebuilt table) and its bound,
with a checksum of its output (col_gram_xty: of the grams and of Xty),
which two trees whose arithmetic is the same agree on.  With --force-wide
as well, the cases up to K = 128 alone, on a copy of ROOT's package in a
temporary directory whose two gram builds take their wide instances at
every K (NARROW_K set to 0 in csrc/col_gram_xty.cu, csrc/level_gram.cu and
kernels/row.py): the figures by which a wide instance could replace its
narrow one.
With --wide-row only row_xty and masked_eval: at K = 24, 50, 96, 128 (the
narrow instances) and 129, 160, 192, 224, 256, 288, 300 and 320 on inputs
shaped as chip_smoke.py phase 6's (N = 300, levels 12 and 25, the two
confounders' row_xty calls timed together, masked_eval on the second's
R_minus; M = 2048, 256 from K = 300), and at the K = 160 fit's shapes (377
x 44477, levels 2, 16, 8, 107; row_xty also each confounder's call alone),
each with f32 and with uint8 masks (bit for bit the f32 ones), kernel and
plain ms beside the bound, the grid's blocks per SM where the tree reports
them, and a checksum of the outputs, which two trees whose arithmetic is
the same agree on; the errors of row_xty, of its f32 plain version and of
the f32 control D F^T - T F^T against the f64 result on the card tests'
near-cancel cases past K = 128 (tests/test_torch_cuda.py test_row_xty,
layout "cancel": the same inputs from the same seeds; the tests' limit is
1e-4 of the f64 result's largest magnitude); then torch.profiler over one
iteration of the K = 160 masked FSS fit (chip_smoke.py phase 18's problem)
after one iteration of it: both kernels' in-fit ms per launch.  With
--force-large as well, the cases past K = 128 at phase 6's shapes alone,
on a copy of ROOT's package in a temporary directory whose row kernels
take the large prediction tile (64 x 128) at every shape
(csrc/predict_tile.cuh, large_tile): the figures by which the large tile
could serve the shapes that take the small one.
Prints one JSON line (and writes it to FILE).  Exits non-zero without
CUDA.
"""

import argparse
import functools
import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import time

import numpy as np


def checksum(x):
    """The first 16 hex digits of the sha256 of a tensor's bytes, -0 read
    as +0."""
    return hashlib.sha256((x + 0.0).contiguous().cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def fss_kernels(torch, cs, gram, fss):
    """{name: {"ms", "checksum"}} of the FSS kernels on chip_smoke's fixed
    inputs (phases 3, 4 and 6), at the fit's max_outer and polish."""
    kw = dict(max_outer=48, polish_sweeps=32, tol=cs.SUB_TOL)
    out = {}

    def rec(name, fn, reps):
        out[name] = dict(ms=cs.timed_ms(torch, fn, reps),
                         checksum=checksum(fn()))
        print(f"chip_ab: {name}: {out[name]['ms']:.4f} ms, checksum "
              f"{out[name]['checksum']}")

    x = cs.flagship_inputs(torch)
    args = (x["train"], x["data"], x["R"], x["beta0"], cs.LAM, cs.ALPHA)
    rec("feature_sign_fused K=24",
        lambda: fss.feature_sign_fused(*args, **kw), 10)
    del x, args
    R, mask, data, beta0 = cs.problem(torch, cs.N, cs.K, cs.M, 5)
    XtX, Xty = (R.T @ R).contiguous(), (R.T @ data).contiguous()
    rec("feature_sign_shared K=24", lambda: fss.feature_sign_shared(
        XtX, Xty, beta0, cs.LAM, cs.ALPHA, **kw), 10)
    for n, k, m, seed, reps in ((300, 50, cs.M, 6, 5), (300, 96, 2048, 96, 3),
                                (300, 128, 2048, 128, 3)):
        R, mask, data, beta0 = cs.problem(torch, n, k, m, seed)
        G, b = gram.col_gram_xty(mask, data, R)
        name = f"feature_sign K={k}"
        rec(name, lambda: fss.feature_sign(G, b, beta0, 1.0, 0.5, **kw),
            reps)
        G, b = gram.col_gram_xty_plain(mask.double(), data.double(),
                                       R.double())
        out[name]["objective"] = float(cs.objectives(
            torch, fss.feature_sign(*gram.col_gram_xty(mask, data, R),
                                    beta0, 1.0, 0.5, **kw),
            G, b, 1.0, 0.5).sum())
        del G, b
    return out


def fss_shared_kernels(torch, cs, fss, saved):
    """{name: record} of feature_sign_shared alone on chip_smoke's
    SHARED_CASES inputs (R^T R), at the fit's max_outer and polish: ms and
    a checksum of its output, and where the tree's kernel takes a group
    width, the same at each width it has (with the columns an SM solves at
    once), and every width's time at K = 5 to 32.  The outputs, and those
    without the polish (polish_sweeps=0), go into `saved`."""
    kw = dict(max_outer=48, polish_sweeps=32, tol=cs.SUB_TOL)
    widths = getattr(fss, "feature_sign_shared_widths", None)
    out = {}
    for k in sorted(cs.SHARED_CASES):
        XtX, Xty, beta0, lam, alpha = cs.shared_inputs(torch, k)

        def run(**w):
            return fss.feature_sign_shared(XtX, Xty, beta0, lam, alpha,
                                           **dict(kw, **w))

        name = f"fss_shared K={k}"
        got = run()
        saved[name] = got.cpu().numpy()
        saved[name + " no polish"] = run(polish_sweeps=0).cpu().numpy()
        for lanes, cols in widths(k) if widths else ((None, None),):
            key = name if lanes is None else f"{name} L={lanes}"
            w = {} if lanes is None else dict(lanes=lanes)
            out[key] = dict(ms=cs.timed_ms(torch, lambda: run(**w), 5),
                            checksum=checksum(run(**w)),
                            columns_per_sm=cols)
            print(f"chip_ab: {key}: {out[key]['ms']:.4f} ms, checksum "
                  f"{out[key]['checksum']}"
                  + (f" ({cols} columns an SM)" if cols else ""))
        if widths:
            out[name] = dict(out[f"{name} L={widths(k)[0][0]}"])
        del XtX, Xty, beta0
    if widths:
        # every width at more K: R^T R of problem() at the flagship's
        # lambda and alpha, the times the fixed choice of width rests on
        for k in (5, 8, 12, 16, 20, 28, 32):
            R, _, data, beta0 = cs.problem(torch, cs.N, k, cs.M, 300 + k)
            XtX, Xty = (R.T @ R).contiguous(), (R.T @ data).contiguous()
            for lanes, cols in widths(k):
                ms = cs.timed_ms(torch, lambda: fss.feature_sign_shared(
                    XtX, Xty, beta0, cs.LAM, cs.ALPHA, **kw, lanes=lanes), 5)
                out[f"widths K={k} L={lanes}"] = dict(ms=ms,
                                                      columns_per_sm=cols)
                print(f"chip_ab: fss_shared K={k} L={lanes}: {ms:.4f} ms "
                      f"({cols} columns an SM)")
    return out


def dense_fit(torch, cs, itt, fss, wrappers, res):
    """The FSS flagship dense fit (ms/iter, final loss) and the profile of
    10 iterations from its end state, into res; where the tree's
    feature_sign_shared takes a group width, the profile at each width."""
    from insider_tpu_torch.ops import col_update

    flag = cs.flagship_object(itt)
    _, loss, ms = cs.run_fit(torch, flag, wrappers, {}, "FSS dense",
                             partition=0, **cs.FLAG_FIT)
    res["dense_fit"] = dict(ms_per_iter=ms, final_loss=loss)
    state = flag.fit_result.state
    print("chip_ab: profile of the flagship dense fit (FSS), 10 "
          "iterations:")
    res["profile_dense"] = cs.profile_fit(torch, flag, wrappers, state, cs.K,
                                          cs.LAM, cs.ALPHA, masked=False)
    if hasattr(fss, "feature_sign_shared_widths"):
        for lanes, _ in fss.feature_sign_shared_widths(cs.K):
            print(f"chip_ab: profile of the flagship dense fit (FSS), "
                  f"L={lanes}:")
            col_update.feature_sign_shared = functools.partial(
                fss.feature_sign_shared, lanes=lanes)
            try:
                res[f"profile_dense L={lanes}"] = cs.profile_fit(
                    torch, flag, wrappers, state, cs.K, cs.LAM, cs.ALPHA,
                    masked=False)
            finally:
                col_update.feature_sign_shared = fss.feature_sign_shared
    return flag


def cd_kernels(torch, cs, gram, cd, saved):
    """{name: {"ms", "checksum"}} of the cold-CD kernels at the 200-sweep
    cap on chip_smoke's fixed inputs (phases 5 and 6); with group widths,
    cd_fused and cd_streamed at each width, and cd_streamed's widths' times
    on columns that all run to the cap (module docstring).  The K=24
    outputs of cd_fused and cd_shared go into `saved`."""
    S = 200
    out = {}
    widths = getattr(cd, "cd_streamed_widths", None)
    fused_widths = getattr(cd, "cd_fused_widths", None)

    def rec(name, fn, reps):
        out[name] = dict(ms=cs.timed_ms(torch, fn, reps),
                         checksum=checksum(fn()))
        print(f"chip_ab: {name}: {out[name]['ms']:.4f} ms, checksum "
              f"{out[name]['checksum']}")

    R, mask, data, beta0 = cs.problem(torch, cs.N, cs.K, cs.M, 7)

    def fused(**kw):
        return cd.cd_fused(mask, data, R, beta0, cs.LAM, cs.ALPHA,
                           cs.SUB_TOL, S, **kw)

    rec("cd_fused K=24", fused, 5)
    saved["cd_fused K=24"] = fused().cpu().numpy()
    if fused_widths:
        for lanes, cols in fused_widths(cs.K):
            rec(f"cd_fused K=24 L={lanes}", lambda: fused(lanes=lanes), 5)
            out[f"cd_fused K=24 L={lanes}"]["columns_per_sm"] = cols
    XtX, Xty = (R.T @ R).contiguous(), (R.T @ data).contiguous()
    rec("cd_shared K=24", lambda: cd.cd_shared(XtX, Xty, beta0, cs.LAM,
                                               cs.ALPHA, cs.SUB_TOL, S), 5)
    saved["cd_shared K=24"] = cd.cd_shared(XtX, Xty, beta0, cs.LAM, cs.ALPHA,
                                           cs.SUB_TOL, S).cpu().numpy()
    # cd_streamed, and cd_shared on R^T R, R^T data of the same problems
    for n, k, m, seed in ((300, 50, cs.M, 8), (300, 96, 2048, 96),
                          (300, 128, 2048, 128)):
        R, mask, data, beta0 = cs.problem(torch, n, k, m, seed)
        G, b = gram.col_gram_xty(mask, data, R)
        args = (G, b, beta0, 1.0, 0.5, cs.SUB_TOL, S)
        rec(f"cd_streamed K={k}", lambda: cd.cd_streamed(*args), 3)
        XtX, Xty = (R.T @ R).contiguous(), (R.T @ data).contiguous()
        rec(f"cd_shared K={k}", lambda: cd.cd_shared(
            XtX, Xty, beta0, 1.0, 0.5, cs.SUB_TOL, S), 3)
        if widths:
            for lanes, _ in widths(k):
                rec(f"cd_streamed K={k} L={lanes}",
                    lambda: cd.cd_streamed(*args, lanes=lanes), 3)
        del G, b
    # every column to the cap: the sweeps alone, per width
    m = 8192
    for k in (16, 24, 33, 40, 48, 50, 57, 64, 72, 80, 96, 103, 113, 128):
        R, mask, data, beta0 = cs.problem(torch, 300, k, m, 200 + k)
        G, b = gram.col_gram_xty(mask, data, R)
        for lanes, cols in widths(k) if widths else ((0, None),):
            kw = dict(lanes=lanes) if widths else {}
            ms = cs.timed_ms(torch, lambda: cd.cd_streamed(
                G, b, beta0, 1.0, 0.5, 0.0, S, **kw), 3)
            out[f"capped K={k} L={lanes}"] = dict(ms=ms, columns_per_sm=cols)
            print(f"chip_ab: cd_streamed K={k} M={m}, every column to the "
                  f"cap, L={lanes or 'its own'}: {ms:.4f} ms"
                  + (f" ({cols} columns an SM)" if widths else ""))
        del G, b
    return out


def wide_cd_kernels(torch, cs, gram, cd):
    """{"<kernel> K=<k> L=<lanes>": {"ms", "checksum", "columns_per_sm"}}
    of the cold-CD kernels past K = 128 at every width (module docstring);
    fails where a width's output differs from the block solve's."""
    out = {}
    cases = ((129, 2048), (160, 2048), (192, 2048), (224, 2048),
             (256, 2048), (288, 1024), (300, 1024), (320, 1024),
             (321, 512))
    for (k, m), capped in [(c, False) for c in cases] + [
            ((k, 2048), True) for k in (160, 192, 224, 256, 320)]:
        if capped:
            R, mask, data, beta0 = cs.problem(torch, 2 * k, k, m, 200 + k)
            lam, alpha, tol = 0.05, 0.5, 0.0
        else:
            R, mask, data, beta0 = cs.problem(torch, 2 * k, k, m, k)
            lam, alpha, tol = cs.LAM, cs.ALPHA, cs.SUB_TOL
        G, b = gram.col_gram_xty(mask, data, R)
        XtX, Xty = (R.T @ R).contiguous(), (R.T @ data).contiguous()
        for name, args in (("cd_streamed", (G, b, beta0, lam, alpha, tol)),
                           ("cd_shared", (XtX, Xty, beta0, lam, alpha,
                                          tol))):
            fn = getattr(cd, name)
            widths = getattr(cd, name + "_widths")(k)
            for cap in (() if capped else (10,)) + (200,):
                block = fn(*args, cap, lanes=128) if k > 128 else None
                for lanes, _ in widths:
                    if not torch.equal(fn(*args, cap, lanes=lanes), block):
                        cs.fail(f"{name} K={k} L={lanes} differs from the "
                                f"block solve at {cap} sweeps")
            for lanes, cols in widths:
                key = (f"{name} K={k} L={lanes}"
                       + (" capped" if capped else ""))
                out[key] = dict(
                    ms=cs.timed_ms(torch, lambda: fn(*args, 200,
                                                     lanes=lanes),
                                   1 if capped else 2),
                    checksum=checksum(fn(*args, 200, lanes=lanes)),
                    columns_per_sm=cols, M=m)
                print(f"chip_ab: {key} M={m}: {out[key]['ms']:.4f} ms, "
                      f"{cols} columns an SM, checksum "
                      f"{out[key]['checksum']}")
        del G, b, XtX, Xty
    return out


WIDE_FSS_SLICE = 2048   # columns of a fit's FSS call replayed and timed


def fit_fss_calls(torch, cs, itt, als, wrappers):
    """The inputs of the K = 160 fits' first and last FSS column updates
    (chip_smoke.py phase 18's masked and dense FSS fits, 10 iterations):
    the first is the fit's eager iteration 0, the last one eager iteration
    from the fit's end state (as profile_fit runs it), each cut to its
    first WIDE_FSS_SLICE columns and copied as the wrapper is called.
    Also the fits' ms/iter.  Returns ({label: (kernel, args, kw)}, {fit:
    ms/iter})."""
    from insider_tpu_torch.config import FitConfig
    from insider_tpu_torch.ops import col_update

    m = WIDE_FSS_SLICE
    calls, fits = {}, {}

    def spy(kernel, label_first, label_last):
        orig = getattr(col_update, kernel)

        def call(*args, **kw):
            if not torch.cuda.is_current_stream_capturing():
                xtx, xty, beta0 = args[:3]
                cut = (xtx if xtx.dim() == 2 else xtx[:, :, :m]).contiguous()
                rec = (kernel, (cut, xty[:, :m].contiguous(),
                                beta0[:, :m].contiguous(), *args[3:]),
                       {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                        for k, v in kw.items()})
                calls.setdefault(label_first, rec)
                calls[label_last] = rec
            return orig(*args, **kw)
        return orig, call

    obj = cs.wide_object(itt)
    for label, partition, kernel in (("masked", 1, "feature_sign"),
                                     ("dense", 0, "feature_sign_shared")):
        orig, call = spy(kernel, f"{label} first", f"{label} fit end")
        setattr(col_update, kernel, call)
        try:
            name = f"K={cs.WIDE_K} FSS {label} fit"
            _, _, fits[name] = cs.run_fit(
                torch, obj, wrappers, {}, name, min_iters=10, max_iter=10,
                partition=partition, **cs.WIDE_FIT)
            # the last update: one eager iteration from the end state
            calls.pop(f"{label} fit end")
            cfg = FitConfig(latent_dim=cs.WIDE_K, lambda1=cs.LAM,
                            lambda2=cs.LAM, alpha=cs.ALPHA,
                            masked=partition == 1,
                            global_tol=obj.params["global_tol"],
                            sub_tol=obj.params["sub_tol"], max_iter=0,
                            seed=obj.seed)
            problem = als.build_problem(
                obj.data, obj.confounder,
                obj.train_indicator + obj.test_indicator, obj.na_indicator,
                obj.ctns_confounder, masked=partition == 1, device="cuda")
            als.optimize(problem, cfg, state=obj.fit_result.state,
                         verbose=False)
            torch.cuda.synchronize()
            calls[f"{label} last"] = calls.pop(f"{label} fit end")
            del problem
        finally:
            setattr(col_update, kernel, orig)
    del obj
    return calls, fits


def wide_fss_kernels(torch, cs, itt, als, gram, fss, wrappers):
    """{"<label>": record} of the FSS kernels past K = 128 (module
    docstring, --wide-fss): on each K = 160 fit's first and last FSS call
    (WIDE_FSS_SLICE columns) fss_counts' statistics and the kernel at
    every width, each also with polish_sweeps=0 and with max_outer=0 and
    polish_sweeps=0 (its gram copy and set-up alone), each width held to
    lanes=128 bit for bit; then chip_smoke.py phase 6's FSS problems (300
    rows, lambda 1, alpha 0.5) at K = 129-321 at every width, held alike,
    with a checksum.  fails where a width differs from the block solve."""
    out = {}

    def widths(name, k):
        if hasattr(fss, name + "_widths"):
            return getattr(fss, name + "_widths")(k)
        return [(128, 1)]

    def run_widths(label, name, args, kw, reps):
        fn = getattr(fss, name)
        ws = widths(name, args[1].shape[0])
        has_lanes = hasattr(fss, name + "_widths")
        block = fn(*args, **kw, **({"lanes": 128} if has_lanes else {}))
        for lanes, cols in ws:
            lkw = dict(kw, lanes=lanes) if has_lanes else kw
            got = fn(*args, **lkw)
            if not torch.equal(got, block):
                cs.fail(f"{label} {name} L={lanes} differs from the block "
                        "solve (lanes=128)")
            key = f"{label} {name} L={lanes}"
            out[key] = dict(ms=cs.timed_ms(torch, lambda: fn(*args, **lkw),
                                           reps),
                            checksum=checksum(got), columns_per_sm=cols,
                            M=args[1].shape[1])
            print(f"chip_ab: {key} M={args[1].shape[1]}: "
                  f"{out[key]['ms']:.4f} ms, {cols} columns an SM, "
                  f"checksum {out[key]['checksum']}")
        return block

    calls, out["fits_ms_per_iter"] = fit_fss_calls(torch, cs, itt, als,
                                                   wrappers)
    print(f"chip_ab: K={cs.WIDE_K} FSS fits ms/iter "
          f"{out['fits_ms_per_iter']}")
    for label, (name, args, kw) in calls.items():
        xtx, xty, beta0, lam, alpha = args[:5]
        k, m = xty.shape
        G = xtx if xtx.dim() == 3 else xtx[:, :, None].expand(k, k, m)
        sym = bool(torch.equal(xtx, xtx.transpose(0, 1)))
        torch.cuda.synchronize()
        t0 = time.time()
        c = cs.fss_counts(torch, G, xty, beta0, lam, alpha,
                          kw.get("max_outer", 48),
                          kw.get("polish_sweeps", 32), kw.get("tol", 0.0))
        torch.cuda.synchronize()
        replay_s = time.time() - t0
        summary = cs.count_summary(torch, f"K={k} {label} {name}", k, c)
        flops = cs.fss_flops(k, c)
        bnd = cs.gram_input_bound(k, m, shared=xtx.dim() == 2, fss=c)
        block = run_widths(f"{label}", name, args, kw, 3)
        plain_equal = bool(torch.equal(block, c["beta"]))
        for part, pkw in (("no polish", dict(kw, polish_sweeps=0)),
                          ("set-up alone", dict(kw, max_outer=0,
                                                polish_sweeps=0))):
            run_widths(f"{label} {part}", name, args, pkw, 3)
        out[f"{label} counts"] = dict(
            summary, kernel=name, fss_flops=flops, bound_ms=bnd[0],
            bound_by=bnd[1], bit_symmetric=sym, replay_s=replay_s,
            block_equals_plain=plain_equal,
            polish_sweeps_mean=float(c["polish_sweeps"].double().mean()))
        print(f"chip_ab: {label} {name} K={k} M={m}: fss_flops {flops:.4e}, "
              f"bound {bnd[0]:.4f} ms ({bnd[1]}); gram bit-symmetric {sym}; "
              f"block equal to the plain replay bit for bit {plain_equal}; "
              f"replay {replay_s:.1f} s")
        del G, c
    calls.clear()

    for k, m in ((129, 2048), (160, 2048), (192, 2048), (224, 2048),
                 (256, 2048), (288, 1024), (300, 256), (320, 256),
                 (321, 256)):
        R, mask, data, beta0 = cs.problem(torch, 300, k, m, k)
        G, b = gram.col_gram_xty(mask, data, R)
        XtX, Xty = (R.T @ R).contiguous(), (R.T @ data).contiguous()
        kw = dict(max_outer=48, polish_sweeps=32, tol=cs.SUB_TOL)
        for name, args in (("feature_sign", (G, b, beta0, 1.0, 0.5)),
                           ("feature_sign_shared", (XtX, Xty, beta0, 1.0,
                                                    0.5))):
            run_widths(f"K={k}", name, args, kw, 1)
        del G, b, XtX, Xty
    return out


WIDE_GRAM_CASES = ((24, 2048), (50, 2048), (96, 2048), (128, 2048),
                   (129, 2048), (160, 2048), (192, 2048), (224, 2048),
                   (256, 2048), (288, 2048), (300, 256), (320, 256),
                   (50, 44477))

# The files of a package tree whose NARROW_K decides where the gram builds'
# wide instances begin (--force-wide).
NARROW_K_FILES = ("csrc/col_gram_xty.cu", "csrc/level_gram.cu",
                  "kernels/row.py")


# The test by which the wide row kernels take their large prediction tile
# (--force-large).
LARGE_TILE_FILE = "csrc/predict_tile.cuh"
LARGE_TILE_TEST = (r"return \(long\)ceil_div\(N, LargeTile::TR\) \* "
                   r"ceil_div\(M, LargeTile::TC\) >= 132;")


def patched_copy(root, into, patches):
    """Copies ROOT's insider_tpu_torch (without its builds) into INTO with
    each (file, pattern, replacement) of `patches` applied; fails unless
    each pattern is found once."""
    import shutil
    pkg = os.path.join(into, "insider_tpu_torch")
    shutil.copytree(os.path.join(root, "insider_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rel, pattern, repl in patches:
        path = os.path.join(pkg, rel)
        with open(path) as f:
            text, n = re.subn(pattern, repl, f.read())
        if n != 1:
            raise SystemExit(f"chip_ab: {rel}: {pattern} found {n} times")
        with open(path, "w") as f:
            f.write(text)
    return into


def force_wide_copy(root, into):
    """patched_copy with NARROW_K = 128 read as NARROW_K = 0 in
    NARROW_K_FILES, so that both gram builds take their wide instances at
    every K."""
    return patched_copy(root, into, [(rel, r"\bNARROW_K = 128\b",
                                      "NARROW_K = 0")
                                     for rel in NARROW_K_FILES])


def force_large_copy(root, into):
    """patched_copy whose wide row kernels take the large prediction tile
    at every shape."""
    return patched_copy(root, into, [(LARGE_TILE_FILE, LARGE_TILE_TEST,
                                      "return true;")])


def wide_gram_kernels(torch, cs, gram, row, narrow_only=False):
    """{"<kernel> K=<k>[ M=<m>][ flagship]": {"ms", "library_ms",
    "bound_ms", "bound_by", "checksum", ...}} of col_gram_xty and
    level_gram at WIDE_GRAM_CASES and level_gram at the flagship's levels
    (module docstring, --wide-gram); with narrow_only the cases up to
    K = 128 alone."""
    out = {}

    def level(key, mw, F, reps):
        r = out[key] = dict(cs.level_gram_times(torch, row, mw, F, reps),
                            checksum=checksum(row.level_gram(mw, F)),
                            M=F.shape[1])
        print(f"chip_ab: {key} L={mw.shape[0]} M={F.shape[1]}: kernel "
              f"{r['ms']:.4f} ms library {r['library_ms']:.4f} ms bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}); checksum "
              f"{r['checksum']}")

    for k, m in WIDE_GRAM_CASES:
        if narrow_only and k > 128:
            continue
        n = 300
        at = f" M={m}" if m == cs.M else ""
        R, mask, data, _ = cs.problem(torch, n, k, m, k)
        G, b = gram.col_gram_xty(mask, data, R)
        bnd = cs.col_gram_bound(n, k, m)
        key = f"col_gram_xty K={k}{at}"
        r = out[key] = dict(
            ms=cs.timed_ms(torch, lambda: gram.col_gram_xty(mask, data, R),
                           10),
            library_ms=cs.col_gram_library_ms(torch, R, mask),
            bound_ms=bnd[0], bound_by=bnd[1], checksum=checksum(G),
            xty_checksum=checksum(b), M=m)
        print(f"chip_ab: {key} M={m}: kernel {r['ms']:.4f} ms library "
              f"{r['library_ms']:.4f} ms bound {bnd[0]:.4f} ms; checksums "
              f"{r['checksum']} {r['xty_checksum']}")
        del G, b, R, mask, data
        rng = np.random.default_rng(k)
        mw = torch.from_numpy(rng.integers(0, 40, (37, m)).astype(
            np.float32)).to("cuda")
        F = (0.3 * torch.from_numpy(rng.standard_normal((k, m)))).float().to(
            "cuda")
        level(f"level_gram K={k}{at}", mw, F, 10)
    x = cs.flagship_inputs(torch)
    mw = x["mw_cat"]
    level(f"level_gram K={cs.K} flagship", mw, x["F"], 10)
    del x
    if narrow_only:
        return out
    rng = np.random.default_rng(cs.WIDE_K)
    F = (0.3 * torch.from_numpy(rng.standard_normal(
        (cs.WIDE_K, mw.shape[1])))).float().to("cuda")
    level(f"level_gram K={cs.WIDE_K} flagship", mw, F, 5)
    return out


WIDE_ROW_CASES = WIDE_GRAM_CASES[:-1]


def row_inputs(torch, n, k, m, levels, seed):
    """Inputs of row_xty and masked_eval at n x m, rank k: a 0/1 mask (f32)
    and a test mask, data, F, and for each level count L of `levels` the
    codes, R_minus and D = E^T (mask .* data), on the card."""
    rng = np.random.default_rng(seed)
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to("cuda")
    mask = t(rng.random((n, m)) > 0.1)
    test = (1.0 - mask) * t(rng.random((n, m)) > 0.5)
    data = t(rng.standard_normal((n, m)))
    F = t(0.3 * rng.standard_normal((k, m)))
    cases = []
    for L in levels:
        codes = torch.from_numpy(rng.integers(0, L, n).astype(
            np.int32)).to("cuda")
        Rm = t(0.5 * rng.standard_normal((n, k)))
        E_t = torch.nn.functional.one_hot(codes.long(), L).float().T
        cases.append((codes, Rm, (E_t @ (mask * data)).contiguous()))
    return mask, test.contiguous(), data, F, cases


def wide_row_record(torch, cs, row, ev, key, mask, test, data, F, cases,
                    reps, out):
    """Times row_xty (the cases in one call) and masked_eval (on the last
    case's R_minus) with f32 and uint8 masks beside their plain versions
    and bounds, with checksums, the uint8 outputs held to the f32 ones bit
    for bit; into out["row_xty <key>"], out["masked_eval <key>"] (uint8:
    " uint8" appended)."""
    n, m = mask.shape
    k = F.shape[0]
    R = cases[-1][1]
    orders = [cs.row_order(row, c, D.shape[0]) for c, _, D in cases]
    for dt in (torch.float32, torch.uint8):
        msk, tst = mask.to(dt), test.to(dt)
        tag = "" if dt == torch.float32 else " uint8"
        got = torch.cat([row.row_xty(c, r, msk, D, F, **o)
                         for (c, r, D), o in zip(cases, orders)])
        sums = torch.stack(list(ev.masked_eval(data, msk, tst, R, F)))
        if dt == torch.uint8 and not (
                torch.equal(got, rx) and torch.equal(sums, es)):
            cs.fail(f"{key}: uint8 masks differ from f32 bit for bit")
        rx, es = got, sums
        r = out[f"row_xty {key}{tag}"] = dict(
            cs.row_xty_times(torch, row, cases, msk, F, reps=reps),
            checksum=checksum(got), N=n, M=m, K=k,
            levels=[D.shape[0] for _, _, D in cases],
            blocks_per_sm=cs.blocks_per_sm(
                torch, "insider_row_xty_blocks", n, m, k))
        e = out[f"masked_eval {key}{tag}"] = dict(
            cs.masked_eval_times(torch, ev, data, msk, tst, R, F, reps=reps),
            checksum=checksum(sums), N=n, M=m, K=k,
            blocks_per_sm=cs.blocks_per_sm(
                torch, "insider_masked_eval_blocks", n, m, k))
        for name, x in (("row_xty", r), ("masked_eval", e)):
            print(f"chip_ab: {name} {key}{tag}: kernel {x['ms']:.4f} ms "
                  f"plain {x['plain_ms']:.4f} ms bound {x['bound_ms']:.4f} "
                  f"ms ({x['bound_by']}); blocks/SM {x['blocks_per_sm']}; "
                  f"checksum {x['checksum']}")


# The card tests' near-cancel cases past K = 128 (N, L, K, M; module
# docstring, --wide-row).
NEAR_CANCEL_CASES = ((200, 8, 160, 8191), (300, 8, 161, 8191),
                     (377, 8, 300, 8191))


def near_cancel_errors(torch, row):
    """{"near-cancel N=<n> L=<l> K=<k> M=<m>": {"kernel", "plain f32",
    "f32 control"}}: each one's max error against the f64 result as a
    fraction of its largest magnitude, on NEAR_CANCEL_CASES built as
    tests/test_torch_cuda.py _row_xty_case builds them (layout "cancel",
    seed N + L + K)."""
    out = {}
    for n, l, k, m in NEAR_CANCEL_CASES:
        rng = np.random.default_rng(n + l + k)
        codes = rng.integers(0, l, n).astype(np.int32)
        R = (0.5 * rng.standard_normal((n, k))).astype(np.float32)
        mask = (rng.random((n, m)) > 0.1).astype(np.float32)
        F = (0.3 * rng.standard_normal((k, m))).astype(np.float32)
        data = R.astype(np.float64) @ F + 0.005 * rng.standard_normal((n, m))
        D = (np.eye(l)[codes].T @ (mask * data)).astype(np.float32)
        codes, R, mask, D, F = (torch.from_numpy(x).to("cuda")
                                for x in (codes, R, mask, D, F))
        exact = row.row_xty_plain(codes, R.double(), mask.double(),
                                  D.double(), F.double())
        E_t = torch.nn.functional.one_hot(codes.long(), l).float().T
        scale = float(exact.abs().max())
        key = f"near-cancel N={n} L={l} K={k} M={m}"
        rec = out[key] = {
            name: float((got.double() - exact).abs().max()) / scale
            for name, got in (
                ("kernel", row.row_xty(codes, R, mask, D, F)),
                ("plain f32", row.row_xty_plain(codes, R, mask, D, F)),
                ("f32 control",
                 D @ F.T - (E_t @ (mask * (R @ F))) @ F.T))}
        print(f"chip_ab: {key}: max err of the f64 result's max |ref|: "
              + "; ".join(f"{name} {v:.4e}" for name, v in rec.items())
              + " (the tests' limit 1e-4)")
    return out


def row_kernel_ms(torch, cs, call, reps):
    """{device kernel: ms a launch} of row_xty's kernels (each launched once
    a call) over `reps` calls of `call` under torch.profiler, a launch over
    the launches recorded (CUPTI can drop a window's first kernels)."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    out = {}
    for name, (us, n) in cs.device_kernel_times(torch, prof).items():
        m = re.search(r"row_xty_\w+", name)
        if m:
            out[m.group(0)] = us / 1e3 / n
    return out


def wide_row_kernels(torch, cs, itt, row, ev, wrappers, wide_only=False):
    """{"<kernel> K=<k>[ M=<m>][ uint8]" or "<kernel> K=160 fit...":
    record} of row_xty and masked_eval at WIDE_ROW_CASES (phase 6's
    shapes), at the K = 160 fit's shapes, on the near-cancel cases and in
    the fit's profile (module docstring, --wide-row); with wide_only the
    cases of WIDE_ROW_CASES past K = 128 alone."""
    out = {}
    for k, m in WIDE_ROW_CASES:
        if wide_only and k <= 128:
            continue
        mask, test, data, F, cases = row_inputs(torch, 300, k, m,
                                                cs.WIDE_LEVELS, 3000 + k)
        wide_row_record(torch, cs, row, ev, f"K={k} M={m}", mask, test,
                        data, F, cases, 10, out)
        del mask, test, data, F, cases
    if wide_only:
        return out
    out.update(near_cancel_errors(torch, row))
    k = cs.WIDE_K
    mask, test, data, F, cases = row_inputs(torch, cs.N, k, cs.M, cs.LEVELS,
                                            4000)
    wide_row_record(torch, cs, row, ev, f"K={k} fit shape", mask, test, data,
                    F, cases, 5, out)
    for (c, r, D) in cases:
        o = cs.row_order(row, c, D.shape[0])
        b = cs.bound(4 * (cs.N * cs.M + D.shape[0] * cs.M + k * cs.M),
                     f32_flop=2 * (cs.N + D.shape[0]) * k * cs.M)
        rec = out[f"row_xty K={k} fit shape L={D.shape[0]}"] = dict(
            ms=cs.timed_ms(torch, lambda: row.row_xty(c, r, mask, D, F, **o),
                           5), bound_ms=b[0], bound_by=b[1],
            device_ms=row_kernel_ms(
                torch, cs, lambda: row.row_xty(c, r, mask, D, F, **o), 5))
        print(f"chip_ab: row_xty K={k} fit shape L={D.shape[0]}: kernel "
              f"{rec['ms']:.4f} ms bound {b[0]:.4f} ms ({b[1]}); device ms "
              "a call: " + "; ".join(f"{name} {v:.4f}" for name, v in
                                     rec["device_ms"].items()))
    del mask, test, data, F, cases
    obj = cs.wide_object(itt)
    obj.fit(verbose=False, partition=1, max_iter=1, **cs.WIDE_FIT)
    print(f"chip_ab: profile of the K={k} masked FSS fit, one iteration:")
    prof = cs.profile_fit(torch, obj, wrappers, obj.fit_result.state, k,
                          cs.LAM, cs.ALPHA, iters=1)
    for name in ("row_xty", "masked_eval"):
        out[f"{name} K={k} in fit"] = prof["in_fit"][name]
    return out


def col_gram_times(torch, cs, gram):
    """{name: record} of col_gram_xty alone on chip_smoke's phase-4 (K=50)
    and phase-6 (K=96, 128) inputs: kernel time, library_ms, bound and
    checksums of the grams and of Xty."""
    out = {}
    for n, k, m, seed, reps in ((300, 50, cs.M, 6, 10),
                                (300, 96, 2048, 96, 10),
                                (300, 128, 2048, 128, 10)):
        R, mask, data, _ = cs.problem(torch, n, k, m, seed)
        G, b = gram.col_gram_xty(mask, data, R)
        bnd = cs.col_gram_bound(n, k, m)
        r = out[f"col_gram_xty K={k}"] = dict(
            ms=cs.timed_ms(torch, lambda: gram.col_gram_xty(mask, data, R),
                           reps),
            library_ms=cs.col_gram_library_ms(torch, R, mask),
            bound_ms=bnd[0], bound_by=bnd[1], checksum=checksum(G),
            xty_checksum=checksum(b))
        print(f"chip_ab: col_gram_xty K={k}: kernel {r['ms']:.4f} ms "
              f"library {r['library_ms']:.4f} ms bound {bnd[0]:.4f} ms; "
              f"checksums {r['checksum']} {r['xty_checksum']}")
        del G, b
    return out


def residual_checksums(torch, cs, row, ev, res, suffix, codes, R_minus, D,
                       mask, data, test, R, F):
    """Checksums of row_xty's outputs (every confounder's, as a fit calls
    it) and of masked_eval's four sums, into res["row_xty" + suffix] and
    res["masked_eval" + suffix]."""
    res["row_xty" + suffix]["checksum"] = checksum(torch.cat([
        row.row_xty(c, r, mask, d, F, **cs.row_order(row, c, d.shape[0]))
        for c, r, d in zip(codes, R_minus, D)]))
    res["masked_eval" + suffix]["checksum"] = checksum(torch.stack(list(
        ev.masked_eval(data, mask, test, R, F))))


def share_equal(a_path, b_path):
    """Prints, for each array of two files that --out saved, the share of
    its columns that are equal bit for bit (-0 read as +0)."""
    a, b = np.load(a_path), np.load(b_path)
    for name in sorted(set(a.files) & set(b.files)):
        x, y = a[name] + 0.0, b[name] + 0.0
        same = (x.view(np.uint32) == y.view(np.uint32)).all(axis=0)
        print(f"chip_ab: {name}: {same.mean():.6f} of {same.size} columns "
              f"equal bit for bit; max abs difference "
              f"{float(np.abs(x - y).max()):.3e}")
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?",
                    help="directory holding insider_tpu_torch")
    ap.add_argument("--out", help="also write the JSON line here")
    ap.add_argument("--share", nargs=2, metavar="NPZ",
                    help="compare two saved output files and exit")
    ap.add_argument("--shared-only", action="store_true",
                    help="only feature_sign_shared alone and the FSS "
                         "dense fit")
    ap.add_argument("--wide-cd", action="store_true",
                    help="only the cold-CD kernels past K = 128, at every "
                         "group width")
    ap.add_argument("--wide-fss", action="store_true",
                    help="only the FSS kernels past K = 128: the K = 160 "
                         "fits' calls, and every width")
    ap.add_argument("--wide-gram", action="store_true",
                    help="only col_gram_xty and level_gram, narrow and "
                         "past K = 128")
    ap.add_argument("--wide-row", action="store_true",
                    help="only row_xty and masked_eval, narrow and past "
                         "K = 128, and at the K = 160 fit's shapes")
    ap.add_argument("--force-wide", action="store_true",
                    help="with --wide-gram: the cases up to K = 128 on a "
                         "copy of ROOT whose gram builds take their wide "
                         "instances at every K")
    ap.add_argument("--force-large", action="store_true",
                    help="with --wide-row: the cases past K = 128 at phase "
                         "6's shapes on a copy of ROOT whose row kernels "
                         "take the large prediction tile at every shape")
    a = ap.parse_args()
    if a.share:
        return share_equal(*a.share)
    if a.root is None:
        ap.error("ROOT is required")
    if a.force_wide and not a.wide_gram:
        ap.error("--force-wide needs --wide-gram")
    if a.force_large and not a.wide_row:
        ap.error("--force-large needs --wide-row")
    root = os.path.abspath(a.root)
    if a.force_wide or a.force_large:
        import tempfile
        copy = tempfile.TemporaryDirectory(prefix="chip_ab_wide_")
        root = (force_wide_copy if a.force_wide else force_large_copy)(
            root, copy.name)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_setup", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    if not torch.cuda.is_available():
        print("chip_ab: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import insider_tpu_torch as itt
    from insider_tpu_torch.kernels import _lib, cd, eval as ev, fss, gram, row
    from insider_tpu_torch.train import als

    if not os.path.abspath(itt.__file__).startswith(root + os.sep):
        cs.fail(f"insider_tpu_torch imported from {itt.__file__}, not {root}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"chip_ab: {root}: {smi}")
    als.disable_tf32()
    t0 = time.time()
    _lib.lib()
    res = dict(root=root, card=smi, build_s=time.time() - t0)
    wrappers = {"level_gram": row.level_gram, "row_xty": row.row_xty,
                "feature_sign_fused": fss.feature_sign_fused,
                "masked_eval": ev.masked_eval,
                "col_gram_xty": gram.col_gram_xty,
                "feature_sign": fss.feature_sign,
                "feature_sign_shared": fss.feature_sign_shared,
                "cd_fused": cd.cd_fused, "cd_streamed": cd.cd_streamed,
                "cd_shared": cd.cd_shared}
    saved = {}
    if a.wide_gram:
        res["force_wide"] = a.force_wide
        res["wide_gram"] = wide_gram_kernels(torch, cs, gram, row,
                                             narrow_only=a.force_wide)
        return finish(a, res, saved)
    if a.wide_row:
        res["force_large"] = a.force_large
        res["wide_row"] = wide_row_kernels(torch, cs, itt, row, ev, wrappers,
                                           wide_only=a.force_large)
        return finish(a, res, saved)
    if a.wide_fss:
        res["wide_fss"] = wide_fss_kernels(torch, cs, itt, als, gram, fss,
                                           wrappers)
        return finish(a, res, saved)
    if a.wide_cd:
        res["wide_cd"] = wide_cd_kernels(torch, cs, gram, cd)
        return finish(a, res, saved)
    res["fss_shared"] = fss_shared_kernels(torch, cs, fss, saved)
    if a.shared_only:
        dense_fit(torch, cs, itt, fss, wrappers, res)
        return finish(a, res, saved)

    # kernels at the flagship shapes
    x = cs.flagship_inputs(torch)
    res["level_gram"] = cs.level_gram_times(torch, row, x["mw_cat"], x["F"])
    res["level_gram"]["checksum"] = checksum(row.level_gram(x["mw_cat"],
                                                            x["F"]))
    res["build_alone"] = cs.build_alone_ms(torch, fss, cd, x)
    res["row_xty"] = cs.row_xty_times(
        torch, row, list(zip(x["codes"], x["R_minus"], x["D"])), x["train"],
        x["F"])
    res["masked_eval"] = cs.masked_eval_times(
        torch, ev, x["data"], x["train"], x["test"], x["R"], x["F"])
    residual_checksums(torch, cs, row, ev, res, "", x["codes"],
                       x["R_minus"], x["D"], x["train"], x["data"],
                       x["test"], x["R"], x["F"])
    del x

    # the K=50 shape
    k50 = cs.k50_inputs(torch)
    res["level_gram_k50"] = cs.level_gram_times(torch, row, k50["mw"],
                                                k50["F"])
    res["level_gram_k50"]["checksum"] = checksum(row.level_gram(k50["mw"],
                                                                k50["F"]))
    res["row_xty_k50"] = cs.row_xty_times(
        torch, row, list(zip(k50["codes"], k50["R_minus"], k50["D"])),
        k50["mask"], k50["F"])
    res["masked_eval_k50"] = cs.masked_eval_times(
        torch, ev, k50["data"], k50["mask"], k50["test"], k50["R"],
        k50["F"])
    residual_checksums(torch, cs, row, ev, res, "_k50", k50["codes"],
                       k50["R_minus"], k50["D"], k50["mask"], k50["data"],
                       k50["test"], k50["R"], k50["F"])
    del k50
    res["col_gram"] = col_gram_times(torch, cs, gram)
    res["fss"] = fss_kernels(torch, cs, gram, fss)
    res["cd"] = cd_kernels(torch, cs, gram, cd, saved)
    for name in ("level_gram", "level_gram_k50", "row_xty", "row_xty_k50",
                 "masked_eval", "masked_eval_k50"):
        r = res[name]
        print(f"chip_ab: {name}: kernel {r['ms']:.4f} ms plain "
              f"{r['plain_ms']:.4f} ms library {r.get('library_ms')} ms "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    print(f"chip_ab: build alone {res['build_alone']}")

    # the six fits, and the profile
    fits, losses = {}, {}

    def fit(name, obj, **kw):
        _, losses[name], fits[name] = cs.run_fit(torch, obj, wrappers, {},
                                                 name, **kw)

    flag = dense_fit(torch, cs, itt, fss, wrappers, res)
    fits["FSS dense"] = res["dense_fit"]["ms_per_iter"]
    losses["FSS dense"] = res["dense_fit"]["final_loss"]
    fit("FSS masked", flag, partition=1, **cs.FLAG_FIT)
    state = flag.fit_result.state
    fit("CD masked", flag, monotone=False, partition=1, **cs.COLD,
        **cs.FLAG_FIT)
    cd_state = flag.fit_result.state
    fit("CD dense", flag, monotone=False, partition=0, **cs.COLD,
        **cs.FLAG_FIT)
    cd_dense_state = flag.fit_result.state
    print("chip_ab: profile of the flagship masked fit (FSS), 10 iterations:")
    res["profile"] = cs.profile_fit(torch, flag, wrappers, state, cs.K,
                                    cs.LAM, cs.ALPHA)
    print("chip_ab: profile of the cold-CD flagship masked fit, 10 "
          "iterations:")
    res["profile_cd"] = cs.profile_fit(torch, flag, wrappers, cd_state, cs.K,
                                       cs.LAM, cs.ALPHA, **cs.COLD)
    print("chip_ab: profile of the cold-CD flagship dense fit, 10 "
          "iterations:")
    res["profile_cd_dense"] = cs.profile_fit(
        torch, flag, wrappers, cd_dense_state, cs.K, cs.LAM, cs.ALPHA,
        masked=False, **cs.COLD)
    if hasattr(cd, "cd_fused_widths"):
        # the same profile at each group width cd_fused has at K=24
        from insider_tpu_torch.ops import col_update

        for lanes, _ in cd.cd_fused_widths(cs.K):
            print(f"chip_ab: profile of the cold-CD flagship masked fit, "
                  f"L={lanes}:")
            col_update.cd_fused = functools.partial(cd.cd_fused, lanes=lanes)
            try:
                res[f"profile_cd L={lanes}"] = cs.profile_fit(
                    torch, flag, wrappers, cd_state, cs.K, cs.LAM, cs.ALPHA,
                    **cs.COLD)
            finally:
                col_update.cd_fused = cd.cd_fused
    del flag
    p50 = cs.predixcan_object(itt)
    fit("FSS K=50", p50, **cs.K50_FIT)
    print("chip_ab: profile of the K=50 masked fit (FSS), 10 iterations:")
    res["profile_k50"] = cs.profile_fit(
        torch, p50, wrappers, p50.fit_result.state, 50,
        cs.K50_FIT["lambda_"], cs.K50_FIT["alpha"])
    fit("CD K=50", p50, monotone=False, **cs.COLD, **cs.K50_FIT)
    print("chip_ab: profile of the cold-CD K=50 masked fit, 10 iterations:")
    res["profile_cd_k50"] = cs.profile_fit(
        torch, p50, wrappers, p50.fit_result.state, 50,
        cs.K50_FIT["lambda_"], cs.K50_FIT["alpha"], **cs.COLD)
    if hasattr(cd, "cd_streamed_widths"):
        # the same profile at each group width the kernel has at K=50
        from insider_tpu_torch.ops import col_update

        for lanes, _ in cd.cd_streamed_widths(50):
            print(f"chip_ab: profile of the cold-CD K=50 masked fit, "
                  f"L={lanes}:")
            col_update.cd_streamed = functools.partial(cd.cd_streamed,
                                                       lanes=lanes)
            try:
                res[f"profile_cd_k50 L={lanes}"] = cs.profile_fit(
                    torch, p50, wrappers, p50.fit_result.state, 50,
                    cs.K50_FIT["lambda_"], cs.K50_FIT["alpha"], **cs.COLD)
            finally:
                col_update.cd_streamed = cd.cd_streamed
    res["fits_ms_per_iter"] = fits
    res["fits_final_loss"] = losses
    print(f"chip_ab: fits ms/iter {fits}; final losses {losses}")
    return finish(a, res, saved)


def finish(a, res, saved):
    """Writes the saved outputs (FILE.npz) and the JSON line (FILE) where
    --out is given, and prints the line."""
    line = json.dumps(res)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        np.savez(os.path.abspath(a.out) + ".npz", **saved)
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
