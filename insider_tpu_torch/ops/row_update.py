"""Row-side (confounder-level) batched ridge updates.

Counterpart of insider_tpu/ops/row_update.py (`optimize_row`,
src/optimize.cpp:139-198, and the standalone `fit_interaction`,
src/fit_interaction.cpp:10-90).  A whole confounder updates in a few
batched ops:

  masked:  XtX_l = sum_{i in level l} F diag(w_i) F^T
                 = (per-level mask counts Mw) @ (K^2, M) outer-product table
           Xty_l = (D - E^T (mask .* (R_minus F))) F^T
  dense:   XtX_l = n_l F F^T,   Xty_l = (D - E^T (R_minus F)) F^T
  solve:   batched K x K SPD solve over all L levels at once.

The masked forms are the plain versions of the two row kernels
(kernels/row.py); the fit composes the kernels and the solve in
train/als.py:update_row_factor.  The dense update is plain PyTorch, as in
the JAX package, which runs no kernel for it.

A confounder with no per-problem constants (too many levels for the fast
route's memory budgets, or a problem built with precompute=False) takes
the segment-sum forms, update_row_factor_masked and
update_row_factor_dense: the level sums of the add-back residual
(segment_sum, a fixed-order index_put_), plain PyTorch on every device, as
the JAX package runs them outside any kernel, but for the masked level
grams, which come from the level_gram kernel.  Each is two
steps, the level systems (masked_level_system, dense_level_system) and
the batched ridge solve, so that a sharded fit sums each rank's
(L, K, K) and (L, K) systems over its blocks in between (train/als.py).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from insider_tpu_torch.ops.linalg import spd_solve


def one_hot_levels(codes: torch.Tensor, n_levels: int,
                   dtype=torch.float32) -> torch.Tensor:
    """Dense one-hot membership matrix E (N, L) — the index_matrices of
    src/optimize.cpp:296-313."""
    return torch.nn.functional.one_hot(codes.long(), n_levels).to(dtype)


def factor_outer_table(F: torch.Tensor) -> torch.Tensor:
    """(K, M) -> (K*K, M) table of f_kj * f_lj."""
    K, M = F.shape
    return (F[:, None, :] * F[None, :, :]).reshape(K * K, M)


def level_gram_masked(mask_by_level: torch.Tensor,
                      F: torch.Tensor) -> torch.Tensor:
    """Per-level masked Grams: (L, M) x (K, M) -> (L, K, K).

    mask_by_level[l, j] = number of member rows of level l with entry (i, j)
    observed.
    """
    K = F.shape[0]
    PF = factor_outer_table(F)                       # (K*K, M)
    return torch.matmul(mask_by_level, PF.T).reshape(-1, K, K)


def _ridge_solve_batched(XtX: torch.Tensor, Xty: torch.Tensor,
                         lam: float) -> torch.Tensor:
    """Solve (XtX_l + lam*I) v_l = Xty_l for all l.  XtX: (L,K,K), Xty: (L,K).

    lam is added in the factors' f32, as the JAX package does
    (src/optimize.cpp:174-175).
    """
    K = XtX.shape[-1]
    eye = torch.eye(K, dtype=XtX.dtype, device=XtX.device)
    return spd_solve(XtX + lam * eye, Xty)


def masked_level_xty(E: torch.Tensor, R_minus: torch.Tensor,
                     mask: torch.Tensor, D: torch.Tensor,
                     F: torch.Tensor) -> torch.Tensor:
    """(D - E^T (mask .* (R_minus F))) F^T -> (L, K).

    The add-back residual is data - R_minus @ F, so the masked level sums
    split as E^T(W .* data) - E^T(W .* (R_minus F)) = D - T.  S = D - T is
    formed per column before the contraction with F (the cancellation fix of
    insider_tpu/kernels/row_pallas.py).
    """
    P = torch.matmul(R_minus, F)                     # (N, M)
    T = torch.matmul(E.T, mask * P)                  # (L, M)
    return torch.matmul(D - T, F.T)                  # (L, K)


def dense_level_xty(E: torch.Tensor, Ddense: torch.Tensor,
                    R_minus: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """The dense per-level update's right-hand sides (src/optimize.cpp:
    178-191; insider_tpu/ops/row_update.py:130-145): (Ddense - E^T
    (R_minus F)) F^T -> (L, K), E (N, L) one-hot levels, Ddense (L, M) =
    E^T data, R_minus (N, K) the row factor without this confounder.  The
    fit solves them with the level grams counts * F F^T
    (train/als._als_iteration_dense)."""
    P = torch.matmul(R_minus, F)                     # (N, M)
    S = Ddense - torch.matmul(E.T, P)                # (L, M)
    return torch.matmul(S, F.T)                      # (L, K)


def segment_sum(x: torch.Tensor, codes: torch.Tensor,
                n_levels: int) -> torch.Tensor:
    """(N, ...) -> (L, ...): the sums of x's rows by level code, each
    level's rows added in row order on either device, with no float
    atomics, so a fit gives the same bits on every run and the card the
    CPU's.  On a CUDA tensor, index_put_ with accumulate=True: torch always
    runs it as a stable sort of the codes and one pass over each level's
    rows (index_add_ there adds by atomics).  On the CPU, index_add_, which
    adds the rows one after another (index_put_'s accumulate there adds by
    atomics across threads)."""
    out = torch.zeros((n_levels,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    if x.is_cuda:
        return out.index_put_((codes.long(),), x, accumulate=True)
    return out.index_add_(0, codes.long(), x)


def masked_level_system(residual_plus: torch.Tensor, mask: torch.Tensor,
                        F: torch.Tensor, codes: torch.Tensor, n_levels: int,
                        max_count=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The masked per-level ridge systems by segment sums (src/optimize.cpp:
    150-176; insider_tpu/ops/row_update.py:77-91): (XtX (L, K, K), Xty
    (L, K)).

    residual_plus (N, M): the residual with this confounder added back;
    mask (N, M) 0/1, f32 or uint8 (widened inside this call only); F
    (K, M); codes (N,) level codes in [0, L).  The level grams are the
    (L, M) mask counts against the (K^2, M) outer-product table, by the
    level_gram kernel (kernels/row.level_gram, its plain version
    level_gram_masked on the CPU), whose exact planes keep the sums
    unbiased at any M (on an H100 cuBLAS's f32 GEMM read a GTEx-sized
    interaction's diagonal 1.4-1.8e-5 low).  max_count: the largest mask
    count of any level (a fit's Problem.segment_max_count), or None to
    read it from the counts.  Both systems are linear in the rows and the
    columns, so on a block of the matrix they are the block's share of
    the whole matrix's systems.
    """
    from insider_tpu_torch.kernels.row import level_gram

    Mw = segment_sum(mask.to(F.dtype), codes, n_levels)        # (L, M)
    S = segment_sum(mask * residual_plus, codes, n_levels)     # (L, M)
    XtX = level_gram(Mw, F, max_count)                         # (L, K, K)
    Xty = torch.matmul(S, F.T)                                 # (L, K)
    return XtX, Xty


def update_row_factor_masked(residual_plus: torch.Tensor,
                             mask: torch.Tensor, F: torch.Tensor,
                             codes: torch.Tensor, n_levels: int,
                             lam: float) -> torch.Tensor:
    """Masked (tuning==1) per-level ridge by segment sums -> (L, K): the
    systems of masked_level_system, then one batched SPD solve."""
    return _ridge_solve_batched(
        *masked_level_system(residual_plus, mask, F, codes, n_levels), lam)


def dense_level_system(residual_plus: torch.Tensor, F: torch.Tensor,
                       gram: torch.Tensor, codes: torch.Tensor,
                       n_levels: int,
                       counts=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense (tuning==0) per-level ridge systems by segment sums
    (src/optimize.cpp:178-191; insider_tpu/ops/row_update.py:148-163):
    (XtX (L, K, K), Xty (L, K)), each level's gram its size times gram =
    F F^T.  counts: the (L,) level sizes (a fit's Problem.counts), or None
    to count them here, a bincount that reads its largest code on the
    host.  Xty is linear in the rows and the columns, as in
    masked_level_system; XtX is as whole as counts and gram are."""
    if counts is None:
        counts = torch.bincount(codes.long(), minlength=n_levels)
    counts = counts.to(F.dtype)
    S = segment_sum(residual_plus, codes, n_levels)            # (L, M)
    XtX = counts[:, None, None] * gram                         # (L, K, K)
    Xty = torch.matmul(S, F.T)
    return XtX, Xty


def update_row_factor_dense(residual_plus: torch.Tensor, F: torch.Tensor,
                            gram: torch.Tensor, codes: torch.Tensor,
                            n_levels: int, lam: float,
                            counts=None) -> torch.Tensor:
    """Dense (tuning==0) per-level ridge by segment sums -> (L, K): the
    systems of dense_level_system, then one batched SPD solve."""
    return _ridge_solve_batched(
        *dense_level_system(residual_plus, F, gram, codes, n_levels, counts),
        lam)


def fit_interaction(residual: torch.Tensor, train_indicator: torch.Tensor,
                    interaction_codes, column_factor: torch.Tensor,
                    masked: bool = True) -> torch.Tensor:
    """Standalone per-level least squares (src/fit_interaction.cpp:10-90;
    insider_tpu/ops/row_update.py:166-190) -> (L, K).

    The reference compiles it but never calls it (R folds interactions
    into the confounders, R/insider.R:34-40); kept for parity.  It solves
    the unregularized normal equations (its lambda is unused,
    fit_interaction.cpp:54,82): the segment-sum updates with lam = 0.
    residual, train_indicator (N, M) and column_factor (K, M) are tensors
    on one device; interaction_codes (N,) are 0-based level codes, a host
    array (numpy) or a tensor, read on the host for L = max + 1.
    """
    codes_np = np.asarray(interaction_codes.cpu()
                          if isinstance(interaction_codes, torch.Tensor)
                          else interaction_codes)
    n_levels = int(codes_np.max()) + 1
    codes = torch.as_tensor(codes_np.astype(np.int64),
                            device=residual.device)
    F = column_factor
    if masked:
        return update_row_factor_masked(residual, train_indicator, F, codes,
                                        n_levels, lam=0.0)
    gram = torch.matmul(F, F.T)
    return update_row_factor_dense(residual, F, gram, codes, n_levels,
                                   lam=0.0)
