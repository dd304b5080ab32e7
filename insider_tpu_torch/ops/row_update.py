"""Row-side (confounder-level) batched ridge updates, fast paths.

Counterpart of insider_tpu/ops/row_update.py (`optimize_row`,
src/optimize.cpp:139-198).  A whole confounder updates in a few batched
ops:

  masked:  XtX_l = sum_{i in level l} F diag(w_i) F^T
                 = (per-level mask counts Mw) @ (K^2, M) outer-product table
           Xty_l = (D - E^T (mask .* (R_minus F))) F^T
  dense:   XtX_l = n_l F F^T,   Xty_l = (D - E^T (R_minus F)) F^T
  solve:   batched K x K SPD solve over all L levels at once.

The masked forms are the plain versions of the two row kernels
(kernels/row.py); the fit composes the kernels and the solve in
train/als.py:update_row_factor.  The dense update is plain PyTorch, as in
the JAX package, which runs no kernel for it.
"""

from __future__ import annotations

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


def update_row_factor_dense_fast(E: torch.Tensor, Ddense: torch.Tensor,
                                 counts: torch.Tensor, R_minus: torch.Tensor,
                                 F: torch.Tensor, gram: torch.Tensor,
                                 lam: float) -> torch.Tensor:
    """Dense per-level ridge with precomputed constants -> (L, K)
    (src/optimize.cpp:178-191; insider_tpu/ops/row_update.py:130-145).

    E (N, L) one-hot levels, Ddense (L, M) = E^T data, counts (L,) level
    sizes, R_minus (N, K) the row factor without this confounder, gram
    (K, K) = F F^T.
    """
    P = torch.matmul(R_minus, F)                     # (N, M)
    S = Ddense - torch.matmul(E.T, P)                # (L, M)
    XtX = counts[:, None, None] * gram               # (L, K, K)
    Xty = torch.matmul(S, F.T)                       # (L, K)
    return _ridge_solve_batched(XtX, Xty, lam)
