"""Misc utility parity with R/utils.R and src/utils.cpp.

The port's copy of insider_tpu/utils.py (numpy only; the JAX package's
module is not imported, since importing it imports JAX).

Each function cites its reference analog.  Some exist purely for inventory
completeness (the reference keeps several helpers that its main path never
calls, SURVEY.md §2).
"""

from __future__ import annotations

import faulthandler
import pickle
import sys
import traceback
from typing import Tuple

import numpy as np


def dump_and_quit(path: str = "last.dump.pkl", status: int = 1):
    """Post-mortem dump then exit (R/utils.R:4-9 `dump_and_quit`).

    Install as sys.excepthook; on an uncaught exception it pickles the
    traceback summary and local frames' variable names to `path` and exits.
    """

    def hook(exc_type, exc, tb):
        info = {
            "type": exc_type.__name__,
            "message": str(exc),
            "traceback": traceback.format_exception(exc_type, exc, tb),
            "frames": [
                {
                    "file": f.filename,
                    "line": f.lineno,
                    "function": f.name,
                }
                for f in traceback.extract_tb(tb)
            ],
        }
        with open(path, "wb") as fh:
            pickle.dump(info, fh)
        faulthandler.dump_traceback(file=sys.stderr)
        sys.exit(status)

    sys.excepthook = hook


def add_by_column(m: np.ndarray, v: np.ndarray) -> np.ndarray:
    """`%+%`: add vector v to matrix m column-wise (R/utils.R:11-17)."""
    return m + np.asarray(v).reshape(1, -1)


def sub_by_column(m: np.ndarray, v: np.ndarray) -> np.ndarray:
    """`%-%`: subtract vector v column-wise (R/utils.R:19-25)."""
    return m - np.asarray(v).reshape(1, -1)


def calculate_idx(idx: int, num_row: int) -> Tuple[int, int]:
    """1-based linear index -> (row, col) in column-major order
    (R/utils.R:27-38, R matrix indexing)."""
    col_idx = idx // num_row
    if idx == col_idx * num_row:
        return num_row, col_idx
    return idx - col_idx * num_row, col_idx + 1


def init_parameters(size: int, init_mean: float = 0.0,
                    init_std: float = 0.001, seed: int = 0) -> np.ndarray:
    """N(mean, std^2) init vector (R/utils.R:40-43)."""
    return np.random.default_rng(seed).normal(init_mean, init_std, size)


def split_str(s: str) -> Tuple[str, str]:
    """GTEx sample-name parser: '<disease>_..._v7_<tissue parts>' ->
    (disease, tissue) (R/utils.R:45-54)."""
    parts = s.split("_")
    idx = parts.index("v7")
    return parts[0], "_".join(parts[idx + 1:])


def obtain_indication_matrix(trainset: np.ndarray,
                             only_positive: bool = False) -> np.ndarray:
    """0/±1 observation indicator (R/utils.R:56-65): 1 where observed,
    -1 where observed and negative (unless only_positive)."""
    out = np.zeros(trainset.shape, np.int8)
    obs = ~np.isnan(trainset)
    out[obs] = 1
    if not only_positive:
        out[obs & (trainset < 0)] = -1
    return out


def is_converged(loss: float, last_loss: float, iter: int = 0,
                 learner: str = "insider", thres: float = 1e-8,
                 verbose: bool = True) -> bool:
    """Relative-delta convergence check with NaN/Inf warning
    (R/utils.R:119-130)."""
    delta = last_loss - loss
    if verbose:
        print(f"{learner} iter {iter}: loss = {loss}, delta_loss = {delta}")
    if np.isnan(loss) or np.isinf(loss):
        print("Loss = NaN or Infinity: current settings does not fit! "
              "Change the settings and try again!")
    return abs(delta) / loss < thres


def rows_equal(a: np.ndarray, b: np.ndarray, tol: float = 1e-8) -> bool:
    """absdiff row comparison (src/utils.cpp:11-14)."""
    return bool(np.all(np.abs(np.asarray(a) - np.asarray(b)) <= tol))


def unique_rows(m: np.ndarray, tol: float = 1e-8) -> np.ndarray:
    """First-occurrence unique rows under absdiff tolerance
    (src/utils.cpp:16-24)."""
    m = np.asarray(m)
    keep = []
    for i in range(m.shape[0]):
        if not any(rows_equal(m[i], m[j], tol) for j in keep):
            keep.append(i)
    return m[keep]


def find_equal_rows(m: np.ndarray, v: np.ndarray, tol: float = 1e-8
                    ) -> np.ndarray:
    """Indices of rows equal to v under absdiff tolerance
    (src/utils.cpp:26-35)."""
    m = np.asarray(m)
    return np.flatnonzero([rows_equal(row, v, tol) for row in m])


def objective(X: np.ndarray, y: np.ndarray, beta: np.ndarray, lam: float,
              alpha: float) -> float:
    """Elastic-net objective (src/utils.cpp:37-44)."""
    r = y - X @ beta
    return (0.5 * float(r @ r)
            + 0.5 * (1 - alpha) * lam * float(beta @ beta)
            + alpha * lam * float(np.abs(beta).sum()))
