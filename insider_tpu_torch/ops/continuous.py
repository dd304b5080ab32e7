"""Continuous-covariate coefficient updates.

Counterpart of insider_tpu/ops/continuous.py (`optimize_continuous_v2`,
src/optimize.cpp:77-137; optimize() calls only v2, :345).  One covariate
column c (N,) with coefficient row w (K,) is a K-dimensional ridge problem,
projected into K-space once:

    XtX_kl = sum_ij c_i^2 mask_ij F_kj F_lj  =  (F * q) F^T,
             q_j = (c^2)^T mask_j
    b_k    = c^T (mask .* resid_plus) F_k

then solved by sequential-coordinate ridge CD with the reference's stop
rule sum |delta w| < 1e-1 (src/optimize.cpp:122): the JAX package's
_ctns_cd is here kernels/ctns.ctns_cd, one launch on the card, whose plain
version (ctns_cd_plain) is _ctns_cd's loop.  The dense path is the closed
form (src/optimize.cpp:127-131), a K x K SPD solve.  The mask may be
stored as f32 or uint8; a matmul that reads it widens it to f32 inside
that call only.

mesh: this rank's place in a sharded fit (sharding/mesh.py), whose
tensors are then the rank's blocks (mask and residual, c and R_minus of
its rows, F, q, bc and dc of its columns; gram, cc whole).  Each system
is contracted to its (M,) and K-space pieces on the block, each sum over
the rows then summed over 'rows' and each contraction over the columns
over 'cols' (sharding/comm.py), so every rank solves the same system and
gets the same w.  Without a mesh the sums are no-ops.
"""

from __future__ import annotations

import torch

from insider_tpu_torch.kernels.ctns import ctns_cd
from insider_tpu_torch.ops.linalg import spd_solve
from insider_tpu_torch.sharding import comm


def _masked_system(resid_plus, mask, F, c, mesh=None):
    q = torch.matmul(c * c, mask.to(c.dtype))                # (M,)
    u = torch.matmul(c, mask * resid_plus)                   # (M,)
    q, u = comm.psum_many([q, u], mesh, "rows")
    XtX = torch.matmul(F * q[None, :], F.T)                  # (K, K)
    b = torch.matmul(F, u)                                   # (K,)
    XtX, b = comm.psum_many([XtX, b], mesh, "cols")
    return XtX, b


def update_ctns_row_masked(resid_plus: torch.Tensor, mask: torch.Tensor,
                           F: torch.Tensor, c: torch.Tensor,
                           w0: torch.Tensor, lam: float, tol: float = 1e-1,
                           max_sweeps: int = 100, mesh=None) -> torch.Tensor:
    """Masked (tuning==1) path of optimize_continuous_v2.  resid_plus (N, M):
    the residual with this covariate added back; mask (N, M); F (K, M);
    c (N,); w0 (K,) warm start."""
    XtX, b = _masked_system(resid_plus, mask, F, c, mesh)
    return ctns_cd(XtX, b, w0, lam, tol, max_sweeps)


def update_ctns_row_masked_fast(q: torch.Tensor, bc: torch.Tensor,
                                mask: torch.Tensor, R_minus: torch.Tensor,
                                F: torch.Tensor, c: torch.Tensor,
                                w0: torch.Tensor, lam, tol: float = 1e-1,
                                max_sweeps: int = 100,
                                mesh=None) -> torch.Tensor:
    """Masked path with the per-problem constants q = (c^2)^T mask and
    bc = c^T (mask .* data), both (M,): the add-back residual is
    data - R_minus F, so c^T (mask .* resid) = bc - c^T (mask .* (R_minus F)),
    and the correction contracts over rows first, v_j = sum_k
    [mask^T (c .* R_minus)]_jk F_kj: one (M, N) @ (N, K) product, no (N, M)
    predict (insider_tpu/ops/continuous.py:48-76)."""
    XtX = torch.matmul(F * q[None, :], F.T)
    G = torch.matmul(mask.to(c.dtype).T, R_minus * c[:, None])  # (M, K)
    v = comm.psum(torch.sum(G.T * F, dim=0), mesh, "rows")   # (M,)
    b = torch.matmul(F, bc - v)
    XtX, b = comm.psum_many([XtX, b], mesh, "cols")
    return ctns_cd(XtX, b, w0, lam, tol, max_sweeps)


def update_ctns_row_masked_v1(resid_plus: torch.Tensor, mask: torch.Tensor,
                              F: torch.Tensor, c: torch.Tensor,
                              w0: torch.Tensor, lam: float,
                              tol: float = 1e-3,
                              max_sweeps: int = 100) -> torch.Tensor:
    """optimize_continuous (v1, src/optimize.cpp:15-63): v2's CD, stopped
    on the sweep's loss decrease < 1e-3 (:59).  Unused by optimize(),
    kept for API parity, as in the JAX package."""
    XtX, b = _masked_system(resid_plus, mask, F, c)
    return ctns_cd(XtX, b, w0, lam, tol, max_sweeps, loss_criterion=True)


def update_ctns_row_dense(resid_plus: torch.Tensor, F: torch.Tensor,
                          gram: torch.Tensor, c: torch.Tensor,
                          lam: float, mesh=None) -> torch.Tensor:
    """Dense (tuning==0) closed form, src/optimize.cpp:127-131: gram = F F^T
    (K, K), resid_plus (N, M)."""
    K = F.shape[0]
    rc, cc = comm.psum_many([torch.matmul(resid_plus.T, c),
                             torch.dot(c, c).reshape(1)], mesh, "rows")
    Xty = comm.psum(torch.matmul(F, rc), mesh, "cols")
    A = cc.reshape(()) * gram + lam * torch.eye(K, dtype=F.dtype,
                                                device=F.device)
    return spd_solve(A, Xty)


def update_ctns_row_dense_fast(dc: torch.Tensor, cc: torch.Tensor,
                               R_minus: torch.Tensor, F: torch.Tensor,
                               gram: torch.Tensor, c: torch.Tensor,
                               lam, mesh=None) -> torch.Tensor:
    """Dense closed form with the constants dc = c^T data (M,) and
    cc = c^T c: resid_plus^T c = data^T c - (R_minus F)^T c."""
    K = F.shape[0]
    cR = comm.psum(torch.matmul(c, R_minus), mesh, "rows")   # (K,)
    pc = torch.matmul(cR, F)                                 # (M,)
    Xty = comm.psum(torch.matmul(F, dc - pc), mesh, "cols")
    A = cc * gram + lam * torch.eye(K, dtype=F.dtype, device=F.device)
    return spd_solve(A, Xty)
