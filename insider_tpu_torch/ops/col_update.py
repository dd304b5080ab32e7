"""Column-side elastic-net updates.

Counterpart of insider_tpu/ops/col_update.py (`optimize_col`,
src/optimize.cpp:200-253), with the FSS solver and its polish, cold
strong-rule coordinate descent (CD) and the alpha == 0 ridge solves:

  masked (partition=1)  per-gene masked grams; K <= 32 builds them inside
                        the fused kernel (feature_sign_fused, cd_fused),
                        K > 32 streams them (col_gram_xty, then
                        feature_sign or cd_streamed).
  dense (partition=0)   one gram R^T R shared by every gene
                        (feature_sign_shared, cd_shared).
  alpha == 0            batched Cholesky solves of the ridge systems,
                        whatever the solver.

An update runs cold CD when it is given a coordinate order `perm`, and FSS
otherwise; train/als._col_kw maps FitConfig's solver names onto these
arguments.  Cold CD sweeps coordinates in a fixed order, so the caller's
`perm` sets it, as the JAX package permutes R's columns (or both axes of
the dense gram) with one random order per update and un-permutes the
solution (insider_tpu/ops/col_update.py:436-446, :545-551).

Under a mesh (sharding/mesh.py) each rank updates the F columns of its
block.  With one row block the update is local to the column block and
takes the route above; with several, each rank's col_gram_xty partial
grams and Xty are summed over the row blocks and the streamed solvers run
on them, at any K (insider_tpu/ops/col_update.py:360, where the fused
kernels need the whole row axis on the device).  The dense gram R^T R and
R^T data are summed over the row blocks likewise.

Every solver takes any K, on the card and on the CPU: above 128 the
gram-input FSS and CD kernels run their wide solves, one column a block
(csrc/fss_wide.cuh); on the CPU the plain versions run, as the JAX
package's CPU path does.
"""

from __future__ import annotations

import torch

from insider_tpu_torch.kernels.cd import cd_fused, cd_shared, cd_streamed
from insider_tpu_torch.kernels.fss import (FUSED_MAX_K, feature_sign,
                                           feature_sign_fused,
                                           feature_sign_shared)
from insider_tpu_torch.kernels.gram import col_gram_xty
from insider_tpu_torch.ops.linalg import spd_solve
from insider_tpu_torch.ops.row_update import _ridge_solve_batched
from insider_tpu_torch.sharding import comm


def col_gram_masked(R: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-column masked Grams XtX_j = R^T diag(mask_j) R  ->  (M, K, K).

    One (M, N) @ (N, K^2) matmul against the row-factor outer-product table
    (src/optimize.cpp:207-219).
    """
    N, K = R.shape
    PR = (R[:, :, None] * R[:, None, :]).reshape(N, K * K)
    return torch.matmul(mask.T, PR).reshape(-1, K, K)


def _order(perm, device):
    """perm and its inverse on `device`."""
    perm = perm.to(device=device, dtype=torch.long)
    return perm, torch.argsort(perm)


def update_columns_masked(
    data: torch.Tensor,     # (N, M) — optimize() passes data, not the residual
                            # (src/optimize.cpp:376)
    mask: torch.Tensor,     # (N, M) 0/1 train indicator, f32 or uint8,
                            # as stored: the kernels read either
    R: torch.Tensor,        # (N, K) row factor
    F_prev: torch.Tensor,   # (K, M) warm start
    lam: float,
    alpha: float,
    tol: float,
    max_fss_outer: int = 48,
    fss_polish: bool = True,
    max_fss_polish_sweeps: int = 32,
    perm: torch.Tensor = None,
    max_cd_sweeps: int = 200,
    mesh=None,
) -> torch.Tensor:
    """Masked (tuning==1) column update, src/optimize.cpp:203-230.

    alpha == 0: ridge solves on the per-gene grams and Xty from
    col_gram_xty (insider_tpu/ops/col_update.py:339-344).  alpha > 0 with
    `perm` (a (K,) permutation): cold strong-rule CD in that coordinate
    order, at most max_cd_sweeps sweeps (:417-478); without it, FSS and its
    polish (:345-390).  The JAX package takes its fused kernels when the
    TPU's VMEM holds them and its streamed route otherwise; the port picks
    by K, on every device: the fused kernel for K <= 32, the streamed route
    (col_gram_xty, then the solver on its grams) for K > 32.  mesh: this
    rank's place in a sharded fit (see the module docstring); with several
    row blocks the streamed route at any K.
    """
    K = R.shape[1]
    fused = K <= FUSED_MAX_K and (mesh is None or mesh.cfg.rows == 1)

    def grams(R):
        XtXt, Xty = col_gram_xty(mask, data, R)
        return comm.psum(XtXt, mesh, "rows"), comm.psum(Xty, mesh, "rows")

    if alpha == 0.0:
        XtXt, Xty = grams(R)
        F = _ridge_solve_batched(XtXt.permute(2, 0, 1), Xty.T, lam)
        return F.T.contiguous()
    if perm is not None:
        perm, inv = _order(perm, R.device)
        Rp = R[:, perm].contiguous()
        beta0 = F_prev[perm].contiguous()
        if fused:
            F = cd_fused(mask, data, Rp, beta0, lam, alpha, tol, max_cd_sweeps)
        else:
            F = cd_streamed(*grams(Rp), beta0, lam, alpha, tol,
                            max_cd_sweeps)
        return F[inv].contiguous()
    kw = dict(max_outer=max_fss_outer,
              polish_sweeps=max_fss_polish_sweeps if fss_polish else 0,
              tol=tol)
    if fused:
        return feature_sign_fused(mask, data, R, F_prev, lam, alpha, **kw)
    return feature_sign(*grams(R), F_prev, lam, alpha, **kw)


def update_columns_dense(
    data: torch.Tensor,     # (N, M)
    R: torch.Tensor,        # (N, K) row factor
    F_prev: torch.Tensor,   # (K, M) warm start
    lam: float,
    alpha: float,
    tol: float,
    max_fss_outer: int = 48,
    fss_polish: bool = True,
    max_fss_polish_sweeps: int = 32,
    perm: torch.Tensor = None,
    max_cd_sweeps: int = 200,
    mesh=None,
) -> torch.Tensor:
    """Dense (tuning==0) column update, src/optimize.cpp:232-247, and
    insider_tpu/ops/col_update.py:484-552.  XtX = R^T R and Xty = R^T data
    are plain matmuls there too (:512-513), summed over the row blocks
    under a mesh.  Solvers as update_columns_masked; cold CD permutes both
    axes of the gram."""
    K = R.shape[1]
    XtX = comm.psum(torch.matmul(R.T, R), mesh, "rows")  # (K, K) shared
    Xty = comm.psum(torch.matmul(R.T, data), mesh, "rows")   # (K, M)
    if alpha == 0.0:
        A = XtX + lam * torch.eye(K, dtype=R.dtype, device=R.device)
        return spd_solve(A, Xty.T).T.contiguous()
    if perm is not None:
        perm, inv = _order(perm, R.device)
        F = cd_shared(XtX[perm][:, perm].contiguous(), Xty[perm].contiguous(),
                      F_prev[perm].contiguous(), lam, alpha, tol,
                      max_cd_sweeps)
        return F[inv].contiguous()
    return feature_sign_shared(
        XtX, Xty, F_prev, lam, alpha, max_outer=max_fss_outer,
        polish_sweeps=max_fss_polish_sweeps if fss_polish else 0, tol=tol)
