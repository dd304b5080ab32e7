"""The alternating-minimization loop on one device.

Counterpart of insider_tpu/train/als.py (`optimize()`, src/optimize.cpp:
256-422), for the model X ~= (sum_v E_v V_v + C W) F: per iteration, block
Gauss-Seidel ridge updates of every confounder's level factor V_v, then of
each continuous covariate's coefficient row of W, then the elastic-net
column update of F; every `check_every` iterations a boundary evaluates the
loss and applies the reference's convergence protocol (relative-loss stop,
sub_tol decay ladder), and with a checkpoint path saves the state there.

PyTorch runs eagerly, so an iteration is a sequence of kernel launches on
the problem's device.  Masked problems (partition=1, tuning): the level
grams (kernels/row.level_gram) of every fast confounder in one launch, one
row_xty per fast confounder with a batched K x K Cholesky solve, one
covariate CD kernel launch per continuous covariate (kernels/ctns.ctns_cd,
ops/continuous), and the masked column update (ops/col_update: the fused
FSS or CD kernel, or col_gram_xty + the streamed FSS or CD kernel for
K > 32); a boundary runs the fused eval kernel (kernels/eval.masked_eval).
Dense problems (partition=0): plain row updates with the shared gram
F F^T, the covariates' closed-form K x K solves, and the shared-gram FSS
or CD kernel; a boundary sums the whole residual.  A confounder without
per-problem constants (past the fast route's memory budgets, or every
one when the problem is built with precompute=False) takes the
segment-sum update on the add-back residual (ops/row_update), and a
covariate without them the update on that residual (ops/continuous).
The masks are stored as f32 or uint8 (build_problem's mask_dtype); the
kernels read either as it is stored.
Cold CD (col_solver="cd", cd_warm_start=False) sweeps each column update in
one coordinate order from draw_perm.  A boundary copies seven f64 sums to
the host, which decides it in f64 -- the JAX package's
boundaries_per_dispatch=1 behaviour.  On CPU tensors every kernel wrapper
runs its plain version.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from insider_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from insider_tpu_torch.config import FitConfig, decay_from_delta_loss
from insider_tpu_torch.kernels.eval import masked_eval
from insider_tpu_torch.kernels.row import level_gram, level_order, row_xty
from insider_tpu_torch.model.state import InsiderState, init_state
from insider_tpu_torch.ops import col_update, continuous, losses, row_update
from insider_tpu_torch.ops.row_update import (_ridge_solve_batched,
                                              one_hot_levels)

logger = logging.getLogger("insider_tpu_torch")


def disable_tf32() -> None:
    """Keep TF32 out of every f32 contraction.  The JAX package runs every
    real x real contraction at f32 HIGHEST; TF32 keeps ~3 decimal digits,
    and a gram must never see it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass
class Problem:
    """One fit problem, staged on `device`.

    Per confounder v: codes[v] (N,) int32 level codes.  The row constants
    (insider_tpu/train/als.py:343-402) exist for a confounder on the fast
    route only, whose one-hot E_v and (L_v, M) level sums fit the budgets
    _FAST_E_BYTES and _FAST_LM_BYTES; the others (and every confounder of
    a problem built with precompute=False) have None in d, row_order and
    counts, and take the segment-sum update (ops/row_update).  Masked:
    d[v] = E_v^T (mask .* data) (L_v, M), and mw_cat stacks the fast
    confounders' E_v^T mask, in confounder order, into one (sum L, M)
    matrix, which the level-gram kernel reads in one launch
    (max_level_count, its largest count, sets the kernel's count planes),
    and row_order[v] holds confounder v's rows sorted by level
    (kernels/row.level_order), which the row_xty kernel reads in place of
    the codes.  Dense: d[v] = E_v^T data and counts[v] (L_v,) the level
    sizes.  With P continuous covariates, ctns (N, P) and, unless built
    with precompute=False, their constants: masked ctns_q = (c^2)^T mask
    and ctns_bc = c^T (mask .* data), dense ctns_dc = c^T data, each
    (P, M), and ctns_cc = c^T c (P,) (insider_tpu/train/als.py:386-402).
    """

    data: torch.Tensor          # (N, M) f32, NaNs zeroed
    train_mask: torch.Tensor    # (N, M) f32 or uint8 0/1
    test_mask: torch.Tensor     # (N, M) f32 or uint8 0/1
    codes: List[torch.Tensor]
    n_levels: Tuple[int, ...]
    masked: bool
    d: List[Optional[torch.Tensor]]
    mw_cat: Optional[torch.Tensor] = None       # masked, fast confounders
    max_level_count: Optional[float] = None     # masked only: mw_cat.max()
    row_order: Optional[List[Optional[Tuple[torch.Tensor, ...]]]] = None
    counts: Optional[List[Optional[torch.Tensor]]] = None  # dense only
    ctns: Optional[torch.Tensor] = None         # (N, P) or None
    ctns_q: Optional[torch.Tensor] = None       # masked, (P, M)
    ctns_bc: Optional[torch.Tensor] = None      # masked, (P, M)
    ctns_dc: Optional[torch.Tensor] = None      # dense, (P, M)
    ctns_cc: Optional[torch.Tensor] = None      # dense, (P,)

    def fast(self) -> List[int]:
        """The confounders that take the fast route (their constants)."""
        return [v for v, d in enumerate(self.d) if d is not None]

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def device(self):
        return self.data.device


def resolve_device(device) -> torch.device:
    """The device a problem lives on.  "cuda" (the default of the entry
    points) runs the CUDA kernels and needs a card; "cpu" runs their plain
    PyTorch versions.  Nothing falls back from one to the other."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} (the default) needs an NVIDIA GPU and "
            "torch.cuda.is_available() is False; pass device=\"cpu\" to run "
            "the plain PyTorch versions of the kernels on the CPU")
    return device


# Reference parameters that the port takes at their positions but does not
# implement yet: the value that does what the reference's default does,
# and the ROADMAP item that will port the others.
UNPORTED = {"sharding": (None, "Queue 1 item 9")}


def check_unported(**given) -> None:
    """Raise NotImplementedError, naming the parameter and its ROADMAP
    item, for each parameter of UNPORTED given another value than its
    default."""
    for name, value in given.items():
        default, item = UNPORTED[name]
        if value is default or (default is not None and value == default):
            continue
        raise NotImplementedError(
            f"{name}={value!r} is not ported yet (ROADMAP {item}); only "
            f"{name}={default!r} is taken")


def check_dtype(dtype) -> None:
    """The reference's build_problem dtype: the port computes in f32 and
    takes it as numpy's, torch's or None; anything else raises."""
    if dtype is None or dtype is torch.float32:
        return
    try:
        if np.dtype(dtype) == np.float32:
            return
    except TypeError:
        pass
    raise NotImplementedError(
        f"dtype={dtype!r}: the port computes in float32 only (numpy's or "
        "torch's float32, or None)")


def mask_storage(mask_dtype) -> torch.dtype:
    """The dtype the indicator matrices are stored in, for the reference's
    mask_dtype (numpy's, torch's or the JAX package's dtype, or its name):
    float32 for None (the reference's default); uint8 for any 1-byte dtype
    (bool, int8, uint8: the memory-lean mode, a quarter of the bytes,
    insider_tpu/train/als.py:218); float32 for any wider one.  The masks
    hold 0 and 1, which every numeric dtype holds exactly, so the stored
    values, and the fit, are the same whatever the dtype; the kernels read
    float32 or uint8, and a plain torch op that needs float32 casts them
    itself."""
    if mask_dtype is None:
        return torch.float32
    if isinstance(mask_dtype, torch.dtype):
        size = mask_dtype.itemsize
    elif str(mask_dtype) == "bfloat16":   # numpy knows it only by ml_dtypes
        size = 2
    else:
        try:
            dt = np.dtype(mask_dtype)
        except TypeError:
            dt = None
        if dt is None or not (dt.kind in "biufc" or dt.name == "bfloat16"):
            raise TypeError(f"mask_dtype={mask_dtype!r} is not a numeric "
                            "dtype")
        size = dt.itemsize
    return torch.uint8 if size == 1 else torch.float32


# Memory budgets of the fast row route, the JAX package's
# (insider_tpu/train/als.py:326-327): a confounder whose one-hot E (N, L)
# or two (L, M) level-sum matrices would pass them takes the segment-sum
# update instead, with no per-problem constants.
_FAST_E_BYTES = 256 * 1024 * 1024
_FAST_LM_BYTES = 512 * 1024 * 1024

# The precompute runs over column chunks when its (N, M) f32 transients
# (the widened mask and mask .* data of a chunk) would pass this budget
# (insider_tpu/train/als.py:330-351).
_PRECOMPUTE_TRANSIENT_BYTES = 1 * 1024 * 1024 * 1024


def precompute_chunk(N: int, M: int) -> int:
    """Columns of one precompute chunk: all M within the budget, else
    max(1024, budget // (4 N) rounded down to a multiple of 256)."""
    if N * M * 4 <= _PRECOMPUTE_TRANSIENT_BYTES:
        return M
    return max(1024, _PRECOMPUTE_TRANSIENT_BYTES // (4 * N) // 256 * 256)


def fast_route(N: int, M: int, L: int) -> bool:
    """True when a confounder of L levels takes the fast row route."""
    return N * L * 4 <= _FAST_E_BYTES and 2 * L * M * 4 <= _FAST_LM_BYTES


def build_problem(data: np.ndarray, confounder: np.ndarray,
                  train_indicator: np.ndarray, test_indicator: np.ndarray,
                  ctns_confounder: Optional[np.ndarray] = None,
                  masked: bool = True, dtype=torch.float32, sharding=None,
                  mask_dtype=None, precompute: bool = True, *,
                  device="cuda") -> Problem:
    """Stage host arrays on `device` and precompute the row constants.

    confounder: (N, C) integer level codes per discrete confounder (any
    labels; densified per column as the reference's `unique()` indexing,
    src/optimize.cpp:296-313).  ctns_confounder: (N, P) continuous
    covariates (a 1-D array is one column), or None.  masked=False
    builds the dense (partition=0) problem, whose updates read every
    element.  mask_dtype: the masks' storage, float32 for None or a
    wider dtype, uint8 for a 1-byte one (mask_storage).  precompute=False builds no row constants: every
    confounder and covariate then takes the segment-sum update
    (insider_tpu/train/als.py:191), the memory-lean mode for shapes near
    the card's memory.  With precompute, each confounder within the fast
    route's budgets (fast_route) gets its constants, and they are built
    over column chunks (precompute_chunk), so no (N, M) f32 transient
    larger than a chunk exists.  The positional parameters are the JAX
    package's, in its order: dtype takes f32 only (check_dtype); sharding
    is not ported and takes only its default (check_unported).  device
    (keyword-only): "cuda" (default; raises without a card) or "cpu".
    """
    check_dtype(dtype)
    check_unported(sharding=sharding)
    mdt = mask_storage(mask_dtype)
    disable_tf32()
    device = resolve_device(device)
    confounder = np.asarray(confounder)
    codes_np, n_levels = [], []
    for c in range(confounder.shape[1]):
        levels, inv = np.unique(confounder[:, c], return_inverse=True)
        codes_np.append(inv.reshape(-1).astype(np.int32))
        n_levels.append(int(levels.size))

    def put(x, dt=torch.float32):
        np_dt = np.uint8 if dt is torch.uint8 else np.float32
        return torch.as_tensor(np.asarray(x, np_dt), device=device)

    data_t = put(data)
    codes = [torch.as_tensor(c, device=device) for c in codes_np]
    problem = Problem(data=data_t, train_mask=put(train_indicator, mdt),
                      test_mask=put(test_indicator, mdt), codes=codes,
                      n_levels=tuple(n_levels), masked=masked,
                      d=[None] * len(codes))
    if ctns_confounder is not None:
        ctns = np.asarray(ctns_confounder)
        problem.ctns = put(ctns[:, None] if ctns.ndim == 1 else ctns)
    if precompute:
        _precompute_row_constants(problem)
    return problem


def _precompute_row_constants(problem: Problem) -> None:
    """Fill in the row constants of `problem` (see Problem), column chunk
    by column chunk (insider_tpu/train/als.py:343-402): each chunk's mask
    is widened to f32 and multiplied into the data once, and every
    constant's columns of that chunk are contracted from them."""
    data, mask, C = problem.data, problem.train_mask, problem.ctns
    N, M = data.shape
    fast = [v for v, L in enumerate(problem.n_levels) if fast_route(N, M, L)]
    sizes = [problem.n_levels[v] for v in fast]
    dev = data.device
    E_cat = (torch.cat([one_hot_levels(problem.codes[v], L).T
                        for v, L in zip(fast, sizes)]).contiguous()
             if fast else None)                   # (sum L, N)
    Lsum = sum(sizes)

    def zeros(rows):
        return torch.zeros((rows, M), dtype=torch.float32, device=dev)

    d_cat = zeros(Lsum)
    mw_cat = zeros(Lsum) if problem.masked else None
    P = 0 if C is None else C.shape[1]
    q, bc, dc = (zeros(P), zeros(P), None) if problem.masked else (
        None, None, zeros(P))
    chunk = precompute_chunk(N, M)
    for c0 in range(0, M, chunk):
        c1 = min(c0 + chunk, M)
        x, m = data[:, c0:c1], None
        if problem.masked:
            m = mask[:, c0:c1].to(torch.float32).contiguous()
            x = m * x                                  # wx, this chunk only
        if fast:
            d_cat[:, c0:c1] = torch.matmul(E_cat, x)
            if problem.masked:
                mw_cat[:, c0:c1] = torch.matmul(E_cat, m)
        if P and problem.masked:
            q[:, c0:c1] = torch.matmul((C * C).T, m)
            bc[:, c0:c1] = torch.matmul(C.T, x)
        elif P:
            dc[:, c0:c1] = torch.matmul(C.T, x)
        del x, m                 # before the next chunk's are allocated
    d = list(torch.split(d_cat, sizes, dim=0)) if fast else []
    for v, dv in zip(fast, d):
        problem.d[v] = dv
    if problem.masked:
        problem.row_order = [None] * len(problem.codes)
        for v in fast:
            problem.row_order[v] = level_order(problem.codes[v],
                                               problem.n_levels[v])
        if fast:
            problem.mw_cat = mw_cat
            problem.max_level_count = float(mw_cat.max())
        if P:
            problem.ctns_q, problem.ctns_bc = q, bc
    else:
        counts = list(torch.split(E_cat.sum(dim=1), sizes)) if fast else []
        problem.counts = [None] * len(problem.codes)
        for v, cv in zip(fast, counts):
            problem.counts[v] = cv
        if P:
            problem.ctns_dc = dc
            problem.ctns_cc = torch.sum(C * C, dim=0)


def _row_factor(problem: Problem, state: InsiderState) -> torch.Tensor:
    """R = sum_v V_v[codes_v] + C W  (src/optimize.cpp:365-373)."""
    R = state.cfd_factors[0][problem.codes[0]]
    for v in range(1, len(problem.codes)):
        R = R + state.cfd_factors[v][problem.codes[v]]
    if problem.ctns is not None:
        R = R + torch.matmul(problem.ctns, state.ctns_factor)
    return R


def _update_covariates(problem: Problem, config: FitConfig, W: torch.Tensor,
                       R: torch.Tensor, F: torch.Tensor,
                       gram: Optional[torch.Tensor]) -> torch.Tensor:
    """Each continuous covariate's coefficient row of W (P, K) in turn,
    Gauss-Seidel against the row factor R = sum_v V_v[codes_v] + C W that
    holds the new confounder factors (src/optimize.cpp:341-350,
    insider_tpu/train/als.py:593-628): masked, one ctns_cd launch each, on
    the per-problem constants or, in a problem built without them, on the
    add-back residual; dense (gram = F F^T), the closed form, likewise.
    Returns the new W."""
    rows = list(W.unbind(0))
    for j in range(len(rows)):
        c = problem.ctns[:, j]
        R_minus = R - torch.outer(c, rows[j])
        if problem.masked and problem.ctns_q is not None:
            w = continuous.update_ctns_row_masked_fast(
                problem.ctns_q[j], problem.ctns_bc[j], problem.train_mask,
                R_minus, F, c, rows[j], config.lambda1, tol=config.ctns_tol,
                max_sweeps=config.max_ctns_sweeps)
        elif problem.masked:
            w = continuous.update_ctns_row_masked(
                problem.data - losses.predict(R_minus, F),
                problem.train_mask, F, c, rows[j], config.lambda1,
                tol=config.ctns_tol, max_sweeps=config.max_ctns_sweeps)
        elif problem.ctns_dc is not None:
            w = continuous.update_ctns_row_dense_fast(
                problem.ctns_dc[j], problem.ctns_cc[j], R_minus, F, gram, c,
                config.lambda1)
        else:
            w = continuous.update_ctns_row_dense(
                problem.data - losses.predict(R_minus, F), F, gram, c,
                config.lambda1)
        rows[j] = w
        R = R_minus + torch.outer(c, w)
    return torch.stack(rows)


def update_row_factor(xtx: torch.Tensor, codes: torch.Tensor,
                      R_minus: torch.Tensor, mask: torch.Tensor,
                      D: torch.Tensor, F: torch.Tensor,
                      lam: float, row_order=None) -> torch.Tensor:
    """One confounder's masked per-level ridge update -> (L, K).

    Counterpart of insider_tpu/ops/row_update.update_row_factor_masked_fast
    with its level grams `xtx` (L, K, K) precomputed (kernels/row.level_gram
    runs once for every confounder): Xty from the row_xty kernel, then the
    batched SPD solve.  row_order: these codes' rows sorted by level
    (Problem.row_order), or None to derive them.
    """
    xty = row_xty(codes, R_minus, mask, D, F, row_order)
    return _ridge_solve_batched(xtx, xty, lam)


def draw_perm(generator: torch.Generator, K: int) -> torch.Tensor:
    """The coordinate order of one cold-CD column update: a (K,) int64
    permutation from a CPU generator, so a fit on the card and one on the
    CPU sweep in the same orders.  The JAX package draws it from its PRNG
    key (insider_tpu/ops/col_update.py:439-443), which torch cannot
    reproduce; tests replace this function to inject an order."""
    return torch.randperm(K, generator=generator)


def _col_kw(config: FitConfig, perm: Optional[torch.Tensor]) -> dict:
    """The column update's solver arguments.  "auto" and "fss": FSS and
    its polish.  "cd" with cd_warm_start: FSS and a polish of up to
    max_cd_sweeps sweeps (insider_tpu/ops/col_update.py:402-416).  Cold
    "cd": the coordinate order `perm` and at most max_cd_sweeps sweeps
    (perm is None only at alpha == 0, where the update solves ridge)."""
    if config.col_solver == "cd" and not config.cd_warm_start:
        return dict(perm=perm, max_cd_sweeps=config.max_cd_sweeps)
    if config.col_solver == "cd":
        return dict(max_fss_outer=config.max_fss_outer, fss_polish=True,
                    max_fss_polish_sweeps=config.max_cd_sweeps)
    return dict(max_fss_outer=config.max_fss_outer,
                fss_polish=config.fss_polish,
                max_fss_polish_sweeps=config.max_fss_polish_sweeps)


def _als_iteration(problem: Problem, config: FitConfig, state: InsiderState,
                   sub_tol_eff: float,
                   perm: Optional[torch.Tensor] = None) -> InsiderState:
    """One full ALS iteration (src/optimize.cpp:325-379).  perm: the
    cold-CD coordinate order of this iteration's column update."""
    if not problem.masked:
        return _als_iteration_dense(problem, config, state, sub_tol_eff,
                                    perm)
    F = state.column_factor
    mask = problem.train_mask
    R = _row_factor(problem, state)

    # every fast confounder's level grams use the same F: one launch for all
    level_xtx = [None] * len(problem.codes)
    fast = problem.fast()
    if fast:
        xtx_cat = level_gram(problem.mw_cat, F, problem.max_level_count)
        for v, xtx in zip(fast, torch.split(
                xtx_cat, [problem.n_levels[v] for v in fast], dim=0)):
            level_xtx[v] = xtx

    cfd_new = list(state.cfd_factors)
    for v, codes in enumerate(problem.codes):
        R_minus = R - cfd_new[v][codes]
        if level_xtx[v] is not None:
            V = update_row_factor(level_xtx[v], codes, R_minus, mask,
                                  problem.d[v], F, config.lambda1,
                                  problem.row_order[v])
        else:
            V = row_update.update_row_factor_masked(
                problem.data - losses.predict(R_minus, F), mask, F, codes,
                problem.n_levels[v], config.lambda1)
        cfd_new[v] = V
        R = R_minus + V[codes]

    W = state.ctns_factor
    if problem.ctns is not None:
        W = _update_covariates(problem, config, W, R, F, None)

    # rebuild the row factor exactly, then update the columns (:365-376)
    R = _row_factor(problem, InsiderState(cfd_new, W, F))
    F_new = col_update.update_columns_masked(
        problem.data, mask, R, F, config.lambda2, config.alpha, sub_tol_eff,
        **_col_kw(config, perm))
    return InsiderState(cfd_new, W, F_new)


def _als_iteration_dense(problem: Problem, config: FitConfig,
                         state: InsiderState, sub_tol_eff: float,
                         perm: Optional[torch.Tensor] = None) -> InsiderState:
    """One dense (partition=0) ALS iteration: every level's gram is its
    size times F F^T (insider_tpu/train/als.py:576-587, 647-658)."""
    F = state.column_factor
    gram = torch.matmul(F, F.T)
    R = _row_factor(problem, state)
    cfd_new = list(state.cfd_factors)
    for v, codes in enumerate(problem.codes):
        R_minus = R - cfd_new[v][codes]
        L = problem.n_levels[v]
        if problem.d[v] is not None:
            V = row_update.update_row_factor_dense_fast(
                one_hot_levels(codes, L), problem.d[v],
                problem.counts[v], R_minus, F, gram, config.lambda1)
        else:
            V = row_update.update_row_factor_dense(
                problem.data - losses.predict(R_minus, F), F, gram, codes, L,
                config.lambda1)
        cfd_new[v] = V
        R = R_minus + V[codes]

    W = state.ctns_factor
    if problem.ctns is not None:
        W = _update_covariates(problem, config, W, R, F, gram)

    R = _row_factor(problem, InsiderState(cfd_new, W, F))
    F_new = col_update.update_columns_dense(
        problem.data, R, F, config.lambda2, config.alpha, sub_tol_eff,
        **_col_kw(config, perm))
    return InsiderState(cfd_new, W, F_new)


def _evaluate(problem: Problem, state: InsiderState) -> torch.Tensor:
    """The boundary metrics as one (7,) f64 vector (losses.pack_metrics)."""
    R = _row_factor(problem, state)
    if problem.masked:
        ev = masked_eval(problem.data, problem.train_mask, problem.test_mask,
                         R, state.column_factor)
    else:
        ev = losses.evaluate_dense(
            problem.data - losses.predict(R, state.column_factor))
    reg = losses.regularization_sums(state.cfd_factors, state.ctns_factor,
                                     state.column_factor)
    return losses.pack_metrics(ev, reg)


def _profiled(run, state, device, path):
    """run(state) under torch.profiler (the card's kernels too, where the
    problem lives there), its trace written to `path` as Chrome JSON."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        state = run(state)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(path)
    return state


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
             log_jsonl: Optional[str] = None, verbose: bool = True,
             progress_callback: Optional[Callable[[dict], None]] = None,
             checkpoint_path: Optional[str] = None, resume: bool = False,
             profile_dir: Optional[str] = None, *,
             generator: Optional[torch.Generator] = None
             ) -> OptimizeResult:
    """Run ALS to convergence with the reference's protocol
    (src/optimize.cpp:256-422): initial loss before the loop (:320-323); a
    check when `iter % check_every == 0` at the end of that iteration
    (:381); stop when (pre - loss) / pre < global_tol (:405); sub_tol decay
    ladder from the loss delta (:389-403); abort when the loss is not finite.

    state: initial factors (e.g. model.state.state_from_numpy); when None
    they are drawn from `generator`, or from a generator on the problem's
    device seeded with config.seed (W too, when the problem has continuous
    covariates).  The problem decides masked or dense
    (build_problem(masked=...)), as in the JAX package.  Cold CD draws one
    coordinate order per iteration (draw_perm) from a CPU generator seeded
    with config.seed.  On the card the rank is checked against the column
    kernels' limit before anything runs (ops/col_update.check_rank).

    checkpoint_path: save the state at every check boundary (checkpoint.py,
    the JAX package's format, with the decay ladder and the loss delta in
    `extra` and the cold-CD order stream beside the factors); with resume
    and no `state`, an existing checkpoint restarts the run at the
    iteration after its own, with its decay ladder, so the resumed run
    continues the uninterrupted one (insider_tpu/train/als.py:941-960).
    profile_dir: trace the second step chunk (the iterations up to the
    first boundary after the first one, as the JAX package traces its
    second chunk, insider_tpu/train/als.py:1094-1095) with torch.profiler
    and write it there as a Chrome trace, trace_iter_<first>_<last>.json;
    the fit computes the same bits with and without it.
    The positional parameters are the JAX package's, in its order;
    generator is keyword-only.
    """
    disable_tf32()
    cold_cd = (config.col_solver == "cd" and not config.cd_warm_start
               and config.alpha != 0.0)
    perm_gen = torch.Generator().manual_seed(config.seed) if cold_cd else None
    start_iter, resume_decay = 0, 1.0
    if (resume and checkpoint_path and state is None
            and os.path.exists(checkpoint_path)):
        state, meta = load_checkpoint(checkpoint_path, device=problem.device,
                                      generator=perm_gen)
        start_iter = meta["iter"] + 1
        resume_decay = float(meta.get("extra", {}).get("decay", 1.0))
        if verbose:
            logger.info("resumed from %s at iter %d (decay=%g)",
                        checkpoint_path, meta["iter"], resume_decay)
    col_update.check_rank(
        config.latent_dim if state is None else state.latent_dim,
        problem.device)
    if state is None:
        M = problem.shape[1]
        if generator is None:
            generator = torch.Generator(device=problem.device)
            generator.manual_seed(config.seed)
        n_ctns = 0 if problem.ctns is None else problem.ctns.shape[1]
        state = init_state(generator, problem.n_levels, M,
                           config.latent_dim, n_ctns=n_ctns,
                           init_std=config.init_std)

    def finalize(vec):
        return losses.finalize_metrics_vec(vec, config.lambda1,
                                           config.lambda2, config.alpha,
                                           masked=problem.masked)

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

        decay = resume_decay
        it = start_iter
        converged = False
        while (not diverged) and it <= config.max_iter:
            # advance to the end of the next check boundary (iters it..b)
            boundary = it if it % config.check_every == 0 else (
                (it // config.check_every + 1) * config.check_every)
            boundary = min(boundary, config.max_iter)
            sub_tol_eff = float(np.float32(config.sub_tol * decay))

            def run_chunk(state):
                for _ in range(boundary - it + 1):
                    perm = (draw_perm(perm_gen, state.latent_dim) if cold_cd
                            else None)
                    state = _als_iteration(problem, config, state,
                                           sub_tol_eff, perm)
                return state

            if profile_dir and len(history) == 2:
                state = _profiled(run_chunk, state, problem.device,
                                  os.path.join(profile_dir,
                                               f"trace_iter_{it}_{boundary}"
                                               ".json"))
            else:
                state = run_chunk(state)
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
            if checkpoint_path:
                save_checkpoint(checkpoint_path, state, it=boundary,
                                loss=loss, extra={"decay": decay,
                                                  "delta_loss": delta_loss},
                                generator=perm_gen)
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
        ctns_factor=(None if state.ctns_factor is None
                     else state.ctns_factor.cpu().numpy()),
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
