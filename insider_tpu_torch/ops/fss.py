"""Batched feature-sign search (FSS) for the per-column elastic net, in
plain torch.

Counterpart of the iteration that the JAX package's FSS kernel runs
(insider_tpu/kernels/fss_pallas.py:_fss_compute), not of its jnp path
(insider_tpu/ops/fss.py + a randomly permuted CD polish): the port's CUDA
kernel (kernels/fss.py) follows the TPU kernel, and this is its plain
version.  Per column j, with G_j the masked gram and b_j = Xty_j, minimize

    f(beta) = 1/2 beta^T G_j beta - b_j^T beta + l2/2 ||beta||^2 + l1 ||beta||_1.

Outer step (all columns at once, converged columns frozen):
  1. solve the active subsystem (G + l2 I)[act, act] beta* = (b - l1 theta)[act]
     by forward elimination without pivoting + back substitution;
  2. step toward beta* up to the first sign crossing, whose coordinates
     become exact zeros; a just-activated coordinate (active, beta == 0) is
     exempt from the crossing test (livelock guard);
  3. if no crossing, activate ONE KKT violator per column (the largest
     |grad|, first index on ties) with |grad| > l1 + KKT_RTOL (l1 + max|b|);
     the column converges when there is none.
Then a plain-CD polish in fixed coordinate order 0..K-1, per-column stop on
sweep decrease <= tol, with the cancellation-free decrease of
insider_tpu/ops/col_update.py.
"""

from __future__ import annotations

import numpy as np
import torch

# Relative KKT slack (insider_tpu/kernels/fss_pallas.py:KKT_RTOL).
KKT_RTOL = 1e-5


def penalties(lam, alpha):
    """(l1, l2) = (lam*alpha, lam*(1-alpha)) rounded as the f32 kernels
    compute them, returned as Python floats."""
    lam = np.float32(lam)
    alpha = np.float32(alpha)
    return float(lam * alpha), float(lam * (np.float32(1.0) - alpha))


def _active_solve(G, act, rhs, l2):
    """Solve the active subsystems.  G: (K, K, M), act/rhs: (K, M).

    Inactive rows/columns become identity with zero rhs, which decouples
    them exactly.  No pivoting: active principal blocks are SPD (ridge l2 on
    the diagonal), inactive pivots are exactly 1.
    """
    K = G.shape[0]
    U = G * act[:, None, :] * act[None, :, :]
    rhs = (rhs * act).clone()
    idx = torch.arange(K, device=G.device)
    U[idx, idx] = U[idx, idx] + l2 * act + (1.0 - act)
    for k in range(K):
        inv = 1.0 / U[k, k]
        rowk = U[k] * inv                                 # (K, M)
        rhsk = rhs[k] * inv
        U[k] = rowk
        rhs[k] = rhsk
        if k + 1 < K:
            colk = U[k + 1:, k].clone()                   # (K-k-1, M)
            U[k + 1:] = U[k + 1:] - colk[:, None, :] * rowk[None, :, :]
            rhs[k + 1:] = rhs[k + 1:] - colk * rhsk
    for k in range(K - 1, 0, -1):
        rhs[:k] = rhs[:k] - U[:k, k] * rhs[k]
    return rhs


def _gram_times(G, beta):
    """G_j @ beta_j for every column.  G: (K, K, M), beta: (K, M)."""
    return torch.sum(G * beta[None, :, :], dim=1)


def _first_max_pick(score, viol):
    """One-hot (K, M) of the first coordinate attaining the column max of
    `score` among violators."""
    best = score.max(dim=0, keepdim=True).values
    first = (score >= best) & viol
    K = score.shape[0]
    idx = torch.arange(K, device=score.device)[:, None].expand_as(score)
    first_idx = torch.where(first, idx, K).min(dim=0, keepdim=True).values
    return (idx == first_idx) & first, best


def feature_sign_search(G: torch.Tensor, xty: torch.Tensor,
                        beta0: torch.Tensor, lam, alpha, max_outer: int = 48,
                        polish_sweeps: int = 0, tol: float = 0.0):
    """Exact batched elastic-net solve over all columns (alpha > 0).

    G: (K, K, M) per-column grams, gene axis last as the kernels take them
    (a broadcast view of one (K, K) gram is fine); xty, beta0: (K, M).
    Returns beta (K, M) f32.  polish_sweeps > 0 appends plain-CD sweeps at
    tolerance `tol`.
    """
    l1, l2 = penalties(lam, alpha)
    tol = float(np.float32(tol))
    K, M = xty.shape
    beta = beta0.clone()
    act = (beta != 0.0).to(beta.dtype)
    theta = torch.sign(beta)
    conv = torch.zeros((1, M), dtype=torch.bool, device=beta.device)
    scale = xty.abs().max(dim=0, keepdim=True).values
    thresh = l1 + KKT_RTOL * (l1 + scale)

    for _ in range(max_outer):
        if bool(conv.all()):
            break
        beta_star = _active_solve(G, act, xty - l1 * theta, l2)
        # line search to the first sign crossing; beta != 0 exempts
        # just-activated coordinates (livelock guard)
        flip = (act > 0.5) & (torch.sign(beta_star) != theta) & (beta != 0.0)
        denom = beta - beta_star
        safe = torch.where(flip & (denom != 0.0), denom, 1.0)
        t_k = torch.where(flip, beta / safe, 1.0).clamp(0.0, 1.0)
        t = t_k.min(dim=0, keepdim=True).values           # (1, M)
        live = ~conv
        move = (act > 0.5) & live
        beta = torch.where(move, beta + t * (beta_star - beta), beta)
        crossed = flip & (t_k <= t) & (t < 1.0) & live
        beta = torch.where(crossed, 0.0, beta)
        # active iff nonzero — also for frozen columns, whose beta did not move
        act = (beta != 0.0).to(beta.dtype)
        theta = torch.sign(beta)

        # single-violator KKT activation on solved columns
        solved = (t >= 1.0) & live
        grad = _gram_times(G, beta) + l2 * beta - xty
        viol = (act < 0.5) & (grad.abs() > thresh) & solved
        score = torch.where(viol, grad.abs(), -1.0)
        pick, best = _first_max_pick(score, viol)
        has_viol = best > 0.0
        act = torch.where(pick, 1.0, act)
        theta = torch.where(pick, -torch.sign(grad), theta)
        conv = conv | (solved & ~has_viol)

    if polish_sweeps > 0:
        beta = _polish(G, xty, beta, l1, l2, polish_sweeps, tol)
    return beta


def _polish(G, xty, beta, l1, l2, max_sweeps, tol):
    """Plain-CD sweeps in fixed coordinate order from the FSS solution,
    per-column do-while stop on sweep decrease <= tol
    (coordinate_descent.cpp:112-114)."""
    K, M = beta.shape
    beta = beta.clone()
    idx = torch.arange(K, device=G.device)
    d = G[idx, idx]                                       # (K, M)
    s = _gram_times(G, beta)
    denom = d + l2
    denom = torch.where(denom > 0.0, denom, 1.0)
    inv_denom = 1.0 / denom
    half_denom = 0.5 * denom
    inv_l1 = float(np.float32(1.0) / np.float32(max(l1, 1e-30)))
    conv = torch.zeros((1, M), dtype=torch.bool, device=beta.device)
    for _ in range(max_sweeps):
        if bool(conv.all()):
            break
        dec = torch.zeros((1, M), dtype=beta.dtype, device=beta.device)
        for k in range(K):
            b_k = beta[k:k + 1]
            u = xty[k:k + 1] - s[k:k + 1] + b_k * d[k:k + 1]
            w = (torch.sign(u) * torch.clamp(u.abs() - l1, min=0.0)
                 * inv_denom[k:k + 1])
            w = torch.where(conv, b_k, w)
            delta = w - b_k
            # cancellation-free decrease: both terms nonnegative
            xi = torch.where(w != 0.0, torch.sign(w),
                             torch.clamp(u * inv_l1, -1.0, 1.0))
            dec = dec + (half_denom[k:k + 1] * delta * delta
                         + l1 * (b_k.abs() - xi * b_k))
            s = s + G[k] * delta
            beta[k:k + 1] = w
        conv = conv | (dec.abs() <= tol)
    return beta
