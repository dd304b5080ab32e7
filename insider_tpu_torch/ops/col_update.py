"""Column-side elastic-net update, masked FSS path.

Counterpart of insider_tpu/ops/col_update.py (`optimize_col`,
src/optimize.cpp:200-253).  The port runs the JAX package's production
column solver: per gene, the masked gram and Xty are built from the row
factor, feature-sign search solves the elastic net exactly, and a plain-CD
polish at optimize()'s effective sub_tol follows — all inside one kernel
(kernels/fss.py).
"""

from __future__ import annotations

import torch

from insider_tpu_torch.kernels.fss import feature_sign_fused


def col_gram_masked(R: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-column masked Grams XtX_j = R^T diag(mask_j) R  ->  (M, K, K).

    One (M, N) @ (N, K^2) matmul against the row-factor outer-product table
    (src/optimize.cpp:207-219).
    """
    N, K = R.shape
    PR = (R[:, :, None] * R[:, None, :]).reshape(N, K * K)
    return torch.matmul(mask.T, PR).reshape(-1, K, K)


def update_columns_masked(
    data: torch.Tensor,     # (N, M) — optimize() passes data, not the residual
                            # (src/optimize.cpp:376)
    mask: torch.Tensor,     # (N, M) 0/1 train indicator, f32
    R: torch.Tensor,        # (N, K) row factor
    F_prev: torch.Tensor,   # (K, M) warm start
    lam: float,
    alpha: float,
    tol: float,
    max_fss_outer: int = 48,
    fss_polish: bool = True,
    max_fss_polish_sweeps: int = 32,
) -> torch.Tensor:
    """Masked (tuning==1) column update, src/optimize.cpp:203-230, with the
    FSS solver and its polish (insider_tpu/ops/col_update.py:345-377)."""
    if alpha == 0.0:
        raise NotImplementedError(
            "alpha == 0 (ridge column solves) is not ported yet")
    return feature_sign_fused(
        mask, data, R, F_prev, lam, alpha, max_outer=max_fss_outer,
        polish_sweeps=max_fss_polish_sweeps if fss_polish else 0, tol=tol)
