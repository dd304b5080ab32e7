"""Hyperparameter tuning: two-stage rank then (lambda, alpha) grid.

Counterpart of insider_tpu/tune/grid.py with batch_grid=False (the serial
sweep; the device-batched grid of tune/batched.py is not ported), itself a
transliteration of `tune()` (R/insider.R:81-176): stage 1 sweeps latent rank
with a fresh init per trial and short `tuning_iter` runs, writing
`insider_rank_tuning_result.csv` incrementally; the rank minimizing held-out
test RMSE wins (:135-139).  Stage 2 sweeps expand.grid(lambda, alpha) --
lambda varying fastest, as R's expand.grid -- writing
`insider_R<rank>_reg_tuning_result.csv`.

When the rank sweep is followed by a reg sweep, rank trials run with
(lambda=0.1, alpha=0) exactly as the reference (:120-121).  Trial t of the
rank sweep draws its initial factors from seed obj.seed + t, trial t of the
grid from obj.seed + 1000 + t.
"""

from __future__ import annotations

import csv
import os
from typing import List

import numpy as np
import torch

from insider_tpu_torch.config import FitConfig
from insider_tpu_torch.model.state import InsiderState, init_state
from insider_tpu_torch.train import als

RANK_HEADER = ["latent_rank", "train_rmse", "test_rmse"]
REG_HEADER = ["lambda", "alpha", "train_rmse", "test_rmse"]


def _as_list(x):
    if np.isscalar(x):
        return [x]
    return list(x)


def draw_state(problem: als.Problem, rank: int, seed: int,
               init_std: float) -> InsiderState:
    """A trial's initial factors, W included where the problem has
    continuous covariates, drawn from a generator on the problem's device
    seeded with `seed`."""
    generator = torch.Generator(device=problem.device)
    generator.manual_seed(seed)
    return init_state(generator, problem.n_levels, problem.shape[1], rank,
                      n_ctns=0 if problem.ctns is None
                      else problem.ctns.shape[1], init_std=init_std)


def _run_trial(problem, obj, rank, lam, alpha, trial_seed, tuning_iter):
    cfg = FitConfig(
        latent_dim=int(rank),
        lambda1=float(lam),
        lambda2=float(lam),
        alpha=float(alpha),
        masked=True,
        global_tol=obj.params["global_tol"],
        sub_tol=obj.params["sub_tol"],
        max_iter=int(tuning_iter),
        seed=trial_seed,
    )
    state = draw_state(problem, cfg.latent_dim, trial_seed, cfg.init_std)
    return als.optimize(problem, cfg, state=state, verbose=False)


def _append_csv(path, header, row):
    exists = os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        if not exists:
            w.writerow(header)
        w.writerow(row)


def tune(obj, latent_dimension, lambda_=0.1, alpha=0.0, out_dir="."):
    """Returns dict(rank_tuning, latent_rank, reg_tuning) like
    R/insider.R:175."""
    ranks = [int(r) for r in _as_list(latent_dimension)]
    lambdas = [float(x) for x in _as_list(lambda_)]
    alphas = [float(a) for a in _as_list(alpha)]

    if len(ranks) <= 1 and len(lambdas) <= 1 and len(alphas) <= 1:
        raise ValueError(
            "TUNING: either latent_dimension or (lambda, alpha) must have "
            "length > 1 (R/insider.R:87-89)"
        )

    problem = obj.tuning_problem()
    tuning_iter = obj.params["tuning_iter"]
    will_reg_sweep = len(lambdas) > 1 or len(alphas) > 1

    rank_tuning: List[list] = []
    if len(ranks) > 1:
        rank_csv = os.path.join(out_dir, "insider_rank_tuning_result.csv")
        if will_reg_sweep:
            lam_t, alpha_t = 0.1, 0.0          # R/insider.R:120-121
        else:
            lam_t, alpha_t = lambdas[0], alphas[0]
        for t, rank in enumerate(ranks):
            res = _run_trial(problem, obj, rank, lam_t, alpha_t,
                             trial_seed=obj.seed + t,
                             tuning_iter=tuning_iter)
            row = [rank, res.train_rmse, res.test_rmse]
            rank_tuning.append(row)
            _append_csv(rank_csv, RANK_HEADER, row)
        best = int(np.argmin([r[2] for r in rank_tuning]))
        latent_rank = ranks[best]               # argmin test rmse, :135-139
    else:
        latent_rank = ranks[0]

    reg_tuning: List[list] = []
    if will_reg_sweep:
        reg_csv = os.path.join(
            out_dir, f"insider_R{latent_rank}_reg_tuning_result.csv")
        # expand.grid: first factor (lambda) varies fastest (R/insider.R:145)
        grid = [(lam, al) for al in alphas for lam in lambdas]
        for t, (lam, al) in enumerate(grid):
            res = _run_trial(problem, obj, latent_rank, lam, al,
                             trial_seed=obj.seed + 1000 + t,
                             tuning_iter=tuning_iter)
            row = [lam, al, res.train_rmse, res.test_rmse]
            reg_tuning.append(row)
            _append_csv(reg_csv, REG_HEADER, row)

    return {
        "rank_tuning": np.asarray(rank_tuning) if rank_tuning else None,
        "latent_rank": latent_rank,
        "reg_tuning": np.asarray(reg_tuning) if reg_tuning else None,
    }
