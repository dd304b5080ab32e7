"""Row-side (confounder-level) batched ridge updates, masked fast path.

Counterpart of insider_tpu/ops/row_update.py (`optimize_row`,
src/optimize.cpp:139-198).  A whole confounder updates in a few batched
ops:

  XtX_l = sum_{i in level l} F diag(w_i) F^T
        = (per-level mask counts Mw) @ (K^2, M) factor outer-product table
  Xty_l = (D - E^T (mask .* (R_minus F))) F^T
  solve: batched K x K SPD solve over all L levels at once.

These are the plain forms of the two row kernels (kernels/row.py); the fit
composes the kernels and the solve in train/als.py:update_row_factor.
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

