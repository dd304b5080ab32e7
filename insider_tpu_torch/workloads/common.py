"""Shared helpers for the workload modules.

Counterpart of workloads/common.py.  Each module mirrors one reference
workload (tests/*.R, SURVEY.md §2c): load a table whose leading columns are
covariates, log2(x+1)-transform, build the Insider object with the
reference's exact configuration, fit, save artifacts.  Real datasets are
external (the reference repo ships none either, .MISSING_LARGE_BLOBS); pass
--data, or omit it to run the same configuration on a shape-matched
synthetic matrix so every workload is executable out of the box.  --device
(default cuda) is where the fit runs.
"""

from __future__ import annotations

import argparse

import numpy as np


def parse_args(name: str, argv=None):
    ap = argparse.ArgumentParser(prog=name)
    ap.add_argument("--data", default=None,
                    help=".npz with 'data'+'confounder', or csv/tsv")
    ap.add_argument("--confounder-cols", type=int, default=None)
    ap.add_argument("--max-iter", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--synthetic-cols", type=int, default=2000,
                    help="gene count for the synthetic fallback")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; needs a card) or cpu")
    return ap.parse_args(argv)


def load_or_simulate(args, n_rows, level_counts, latent_dim, log2=True,
                     confounder_cols=None, seed=0):
    import insider_tpu_torch as itt

    if args.data:
        from insider_tpu_torch.cli import _load_table

        cols = args.confounder_cols or confounder_cols or len(level_counts)
        data, conf = _load_table(args.data, cols, log2, 0)
        return data, conf
    sim = itt.simulate_scale(n_rows, args.synthetic_cols, latent_dim,
                             level_counts=level_counts, seed=seed)
    return sim.data.astype(np.float64), sim.confounder


def save_fitted(obj, out_path: str):
    from insider_tpu_torch.cli import _save_fitted

    _save_fitted(out_path, obj, train_rmse=False)
