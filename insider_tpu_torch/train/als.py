"""The alternating-minimization loop, masked path on one device.

Counterpart of insider_tpu/train/als.py (`optimize()`, src/optimize.cpp:
256-422): per iteration, block Gauss-Seidel ridge updates of every
confounder's level factor, then the elastic-net column update; every
`check_every` iterations a boundary evaluates the loss and applies the
reference's convergence protocol (relative-loss stop, sub_tol decay ladder).

PyTorch runs eagerly, so an iteration is a sequence of kernel launches on
the problem's device: the level grams (kernels/row.level_gram), one row_xty
per confounder with a batched K x K Cholesky solve, and the fused FSS column
kernel (kernels/fss.feature_sign_fused); a boundary runs the fused eval
kernel (kernels/eval.masked_eval) and copies seven f64 sums to the host,
which decides the boundary in f64 -- the JAX package's
boundaries_per_dispatch=1 behaviour.  On CPU tensors every kernel wrapper
runs its plain version.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from insider_tpu_torch.config import FitConfig, decay_from_delta_loss
from insider_tpu_torch.kernels.eval import masked_eval
from insider_tpu_torch.kernels.row import level_gram, row_xty
from insider_tpu_torch.model.state import InsiderState, init_state
from insider_tpu_torch.ops import col_update, losses
from insider_tpu_torch.ops.row_update import _ridge_solve_batched, one_hot_levels

logger = logging.getLogger("insider_tpu_torch")


def disable_tf32() -> None:
    """Keep TF32 out of every f32 contraction.  The JAX package runs every
    real x real contraction at f32 HIGHEST; TF32 keeps ~3 decimal digits,
    and a gram must never see it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass
class Problem:
    """One masked fit problem, staged on `device`.

    Per confounder v: codes[v] (N,) int32 level codes and d[v] = E_v^T
    (mask .* data) (L_v, M), E_v the one-hot level membership; mw_cat stacks
    every confounder's E_v^T mask into one (sum L, M) matrix, which the
    level-gram kernel reads in one launch (insider_tpu/train/als.py:343-402).
    """

    data: torch.Tensor          # (N, M) f32, NaNs zeroed
    train_mask: torch.Tensor    # (N, M) f32 0/1
    test_mask: torch.Tensor     # (N, M) f32 0/1
    codes: List[torch.Tensor]
    n_levels: Tuple[int, ...]
    mw_cat: torch.Tensor
    d: List[torch.Tensor]

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def device(self):
        return self.data.device


def build_problem(data: np.ndarray, confounder: np.ndarray,
                  train_indicator: np.ndarray, test_indicator: np.ndarray,
                  ctns_confounder: Optional[np.ndarray] = None,
                  masked: bool = True, device="cpu",
                  sharding=None) -> Problem:
    """Stage host arrays on `device` and precompute the row constants.

    confounder: (N, C) integer level codes per discrete confounder (any
    labels; densified per column as the reference's `unique()` indexing,
    src/optimize.cpp:296-313).  Masks are stored as f32.
    """
    if ctns_confounder is not None:
        raise NotImplementedError(
            "continuous covariates are not ported yet")
    if not masked:
        raise NotImplementedError(
            "the dense (partition=0) path is not ported yet")
    if sharding is not None:
        raise NotImplementedError("sharding is not ported yet")
    disable_tf32()
    device = torch.device(device)
    confounder = np.asarray(confounder)
    codes_np, n_levels = [], []
    for c in range(confounder.shape[1]):
        levels, inv = np.unique(confounder[:, c], return_inverse=True)
        codes_np.append(inv.reshape(-1).astype(np.int32))
        n_levels.append(int(levels.size))

    def put(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    data_t = put(data)
    train_t = put(train_indicator)
    test_t = put(test_indicator)
    codes = [torch.as_tensor(c, device=device) for c in codes_np]
    wx = train_t * data_t
    mw, d = [], []
    for c, L in zip(codes, n_levels):
        E_t = one_hot_levels(c, L).T.contiguous()        # (L, N)
        mw.append(torch.matmul(E_t, train_t))
        d.append(torch.matmul(E_t, wx))
    del wx
    return Problem(data=data_t, train_mask=train_t, test_mask=test_t,
                   codes=codes, n_levels=tuple(n_levels),
                   mw_cat=torch.cat(mw, dim=0), d=d)


def _row_factor(problem: Problem, state: InsiderState) -> torch.Tensor:
    """R = sum_v V_v[codes_v]  (src/optimize.cpp:365-373)."""
    R = state.cfd_factors[0][problem.codes[0]]
    for v in range(1, len(problem.codes)):
        R = R + state.cfd_factors[v][problem.codes[v]]
    return R


def update_row_factor(xtx: torch.Tensor, codes: torch.Tensor,
                      R_minus: torch.Tensor, mask: torch.Tensor,
                      D: torch.Tensor, F: torch.Tensor,
                      lam: float) -> torch.Tensor:
    """One confounder's masked per-level ridge update -> (L, K).

    Counterpart of insider_tpu/ops/row_update.update_row_factor_masked_fast
    with its level grams `xtx` (L, K, K) precomputed (kernels/row.level_gram
    runs once for every confounder): Xty from the row_xty kernel, then the
    batched SPD solve.
    """
    xty = row_xty(codes, R_minus, mask, D, F)
    return _ridge_solve_batched(xtx, xty, lam)


def _als_iteration(problem: Problem, config: FitConfig, state: InsiderState,
                   sub_tol_eff: float) -> InsiderState:
    """One full ALS iteration (src/optimize.cpp:325-379), masked path."""
    F = state.column_factor
    mask = problem.train_mask
    R = _row_factor(problem, state)

    # every confounder's level grams use the same F: one launch for all
    xtx_cat = level_gram(problem.mw_cat, F)
    level_xtx = torch.split(xtx_cat, list(problem.n_levels), dim=0)

    cfd_new = list(state.cfd_factors)
    for v, codes in enumerate(problem.codes):
        R_minus = R - cfd_new[v][codes]
        V = update_row_factor(level_xtx[v], codes, R_minus, mask,
                              problem.d[v], F, config.lambda1)
        cfd_new[v] = V
        R = R_minus + V[codes]

    # rebuild the row factor exactly, then update the columns (:365-376)
    R = _row_factor(problem, InsiderState(cfd_new, None, F))
    F_new = col_update.update_columns_masked(
        problem.data, mask, R, F, config.lambda2, config.alpha, sub_tol_eff,
        max_fss_outer=config.max_fss_outer, fss_polish=config.fss_polish,
        max_fss_polish_sweeps=config.max_fss_polish_sweeps)
    return InsiderState(cfd_new, None, F_new)


def _evaluate(problem: Problem, state: InsiderState) -> torch.Tensor:
    """The boundary metrics as one (7,) f64 vector (losses.pack_metrics)."""
    R = _row_factor(problem, state)
    ev = masked_eval(problem.data, problem.train_mask, problem.test_mask, R,
                     state.column_factor)
    reg = losses.regularization_sums(state.cfd_factors, state.ctns_factor,
                                     state.column_factor)
    return losses.pack_metrics(ev, reg)


@dataclasses.dataclass
class OptimizeResult:
    row_matrices: List[np.ndarray]
    ctns_factor: Optional[np.ndarray]
    column_factor: np.ndarray
    train_rmse: float
    test_rmse: float
    loss: float
    n_iter: int
    history: List[dict]
    state: InsiderState
    # True when the run was aborted because the loss went NaN/Inf.
    diverged: bool = False
    # True iff the relative-loss stop fired (src/optimize.cpp:405).
    converged: bool = False


def optimize(problem: Problem, config: FitConfig,
             state: Optional[InsiderState] = None,
             generator: Optional[torch.Generator] = None,
             log_jsonl: Optional[str] = None, verbose: bool = True,
             progress_callback: Optional[Callable[[dict], None]] = None
             ) -> OptimizeResult:
    """Run ALS to convergence with the reference's protocol
    (src/optimize.cpp:256-422): initial loss before the loop (:320-323); a
    check when `iter % check_every == 0` at the end of that iteration
    (:381); stop when (pre - loss) / pre < global_tol (:405); sub_tol decay
    ladder from the loss delta (:389-403); abort when the loss is not finite.

    state: initial factors (e.g. model.state.state_from_numpy); when None
    they are drawn from `generator`, or from a generator on the problem's
    device seeded with config.seed.
    """
    if not config.masked:
        raise NotImplementedError(
            "the dense (masked=False) path is not ported yet")
    disable_tf32()
    if state is None:
        M = problem.shape[1]
        if generator is None:
            generator = torch.Generator(device=problem.device)
            generator.manual_seed(config.seed)
        state = init_state(generator, problem.n_levels, M,
                           config.latent_dim, init_std=config.init_std)

    def finalize(vec):
        return losses.finalize_metrics_vec(vec, config.lambda1,
                                           config.lambda2, config.alpha,
                                           masked=True)

    history: List[dict] = []
    jl = open(log_jsonl, "a") if log_jsonl else None

    def emit(rec):
        history.append(rec)
        if jl:
            jl.write(json.dumps(rec) + "\n")
            jl.flush()
        if verbose:
            logger.info(
                "iter %d: loss=%.12g train_rmse=%.12g test_rmse=%.12g "
                "delta=%.6g decay=%g", rec["iter"], rec["loss"],
                rec["train_rmse"], rec["test_rmse"],
                rec.get("delta_loss", float("nan")), rec.get("decay", 1.0))
        if progress_callback:
            progress_callback(rec)

    try:
        t0 = time.time()
        m = finalize(_evaluate(problem, state))
        loss = m["loss"]
        emit({"iter": -1, **m, "elapsed_s": time.time() - t0})
        diverged = not np.isfinite(loss)
        if diverged:
            logger.warning("infinite or missing values in loss at init; "
                           "aborting")

        decay = 1.0
        it = 0
        converged = False
        while (not diverged) and it <= config.max_iter:
            # advance to the end of the next check boundary (iters it..b)
            boundary = it if it % config.check_every == 0 else (
                (it // config.check_every + 1) * config.check_every)
            boundary = min(boundary, config.max_iter)
            sub_tol_eff = float(np.float32(config.sub_tol * decay))
            for _ in range(boundary - it + 1):
                state = _als_iteration(problem, config, state, sub_tol_eff)
            it = boundary + 1

            pre_loss = loss
            m = finalize(_evaluate(problem, state))
            loss = m["loss"]
            delta_loss = pre_loss - loss
            decay = decay_from_delta_loss(delta_loss)
            emit({"iter": boundary, **m, "delta_loss": delta_loss,
                  "decay": decay, "elapsed_s": time.time() - t0})
            if not np.isfinite(loss):
                diverged = True
                logger.warning("infinite or missing values in loss at iter "
                               "%d; aborting", boundary)
                break
            if (pre_loss - loss) / pre_loss < config.global_tol:
                converged = True
                break
            if boundary >= config.max_iter:
                break
    finally:
        if jl:
            jl.close()

    return OptimizeResult(
        row_matrices=[f.cpu().numpy() for f in state.cfd_factors],
        ctns_factor=None,
        column_factor=state.column_factor.cpu().numpy(),
        train_rmse=m["train_rmse"],
        test_rmse=m["test_rmse"],
        loss=loss,
        n_iter=it - 1,
        history=history,
        state=state,
        diverged=diverged,
        converged=converged,
    )
