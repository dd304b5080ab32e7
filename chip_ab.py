#!/usr/bin/env python3
"""Time the port's main-path kernels, its FSS kernels and its six fits, for
one package tree, on one NVIDIA GPU.

    python3 chip_ab.py ROOT [--out FILE]

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
    version, beside their bounds;
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
    and K=128 (M=2048); where the tree's cd_streamed takes a group width,
    also at each width it has an instance of, and every width at K = 16 to
    128 on columns that all run to the cap (tol 0, M=8192), with the
    columns an SM holds of each: the times its fixed choice of width
    rests on;
  * the ms per iteration of the FSS and cold-CD fits, flagship masked and
    dense and K=50 masked, from each fit's own boundary clock, and their
    final losses;
  * torch.profiler over 10 iterations of the flagship masked FSS fit, of
    the K=50 masked FSS fit and of the cold-CD K=50 masked fit (with group
    widths, also at each width cd_streamed has at K=50), each from where
    its fit ended: each kernel's device time, each wrapper's in-fit ms per
    launch, the device busy share.
Prints one JSON line (and writes it to FILE).  Exits non-zero without
CUDA.
"""

import argparse
import functools
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time


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


def cd_kernels(torch, cs, gram, cd):
    """{name: {"ms", "checksum"}} of the cold-CD kernels at the 200-sweep
    cap on chip_smoke's fixed inputs (phases 5 and 6); with group widths,
    cd_streamed at each width, and the widths' times on columns that all
    run to the cap (module docstring)."""
    S = 200
    out = {}
    widths = getattr(cd, "cd_streamed_widths", None)

    def rec(name, fn, reps):
        out[name] = dict(ms=cs.timed_ms(torch, fn, reps),
                         checksum=checksum(fn()))
        print(f"chip_ab: {name}: {out[name]['ms']:.4f} ms, checksum "
              f"{out[name]['checksum']}")

    R, mask, data, beta0 = cs.problem(torch, cs.N, cs.K, cs.M, 7)
    rec("cd_fused K=24", lambda: cd.cd_fused(mask, data, R, beta0, cs.LAM,
                                             cs.ALPHA, cs.SUB_TOL, S), 5)
    XtX, Xty = (R.T @ R).contiguous(), (R.T @ data).contiguous()
    rec("cd_shared K=24", lambda: cd.cd_shared(XtX, Xty, beta0, cs.LAM,
                                               cs.ALPHA, cs.SUB_TOL, S), 5)
    for n, k, m, seed in ((300, 50, cs.M, 8), (300, 96, 2048, 96),
                          (300, 128, 2048, 128)):
        R, mask, data, beta0 = cs.problem(torch, n, k, m, seed)
        G, b = gram.col_gram_xty(mask, data, R)
        args = (G, b, beta0, 1.0, 0.5, cs.SUB_TOL, S)
        rec(f"cd_streamed K={k}", lambda: cd.cd_streamed(*args), 3)
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", help="directory holding insider_tpu_torch")
    ap.add_argument("--out", help="also write the JSON line here")
    a = ap.parse_args()
    root = os.path.abspath(a.root)
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
    del k50
    res["col_gram"] = col_gram_times(torch, cs, gram)
    res["fss"] = fss_kernels(torch, cs, gram, fss)
    res["cd"] = cd_kernels(torch, cs, gram, cd)
    for name in ("level_gram", "level_gram_k50", "row_xty", "row_xty_k50",
                 "masked_eval", "masked_eval_k50"):
        r = res[name]
        print(f"chip_ab: {name}: kernel {r['ms']:.4f} ms plain "
              f"{r['plain_ms']:.4f} ms library {r.get('library_ms')} ms "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    print(f"chip_ab: build alone {res['build_alone']}")

    # the six fits, and the profile
    wrappers = {"level_gram": row.level_gram, "row_xty": row.row_xty,
                "feature_sign_fused": fss.feature_sign_fused,
                "masked_eval": ev.masked_eval,
                "col_gram_xty": gram.col_gram_xty,
                "feature_sign": fss.feature_sign,
                "feature_sign_shared": fss.feature_sign_shared,
                "cd_fused": cd.cd_fused, "cd_streamed": cd.cd_streamed,
                "cd_shared": cd.cd_shared}
    fits, losses = {}, {}

    def fit(name, obj, **kw):
        _, losses[name], fits[name] = cs.run_fit(torch, obj, wrappers, {},
                                                 name, **kw)

    flag = cs.flagship_object(itt)
    fit("FSS masked", flag, partition=1, **cs.FLAG_FIT)
    state = flag.fit_result.state
    fit("FSS dense", flag, partition=0, **cs.FLAG_FIT)
    fit("CD masked", flag, monotone=False, partition=1, **cs.COLD,
        **cs.FLAG_FIT)
    fit("CD dense", flag, monotone=False, partition=0, **cs.COLD,
        **cs.FLAG_FIT)
    print("chip_ab: profile of the flagship masked fit (FSS), 10 iterations:")
    res["profile"] = cs.profile_fit(torch, flag, wrappers, state, cs.K,
                                    cs.LAM, cs.ALPHA)
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
    line = json.dumps(res)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
