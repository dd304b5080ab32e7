"""The per-column elastic-net solvers in plain torch: batched feature-sign
search (FSS) and cyclic coordinate descent (CD).

Counterparts of the iterations that the JAX package's kernels run
(insider_tpu/kernels/fss_pallas.py:_fss_compute, cd_pallas.py:_cd_compute),
not of its jnp path (insider_tpu/ops/fss.py + randomly permuted CD): the
port's CUDA kernels (kernels/fss.py, kernels/cd.py) follow the TPU kernels,
and these are their plain versions.  elastic_net_cd is the cold
strong-rule CD and, without the strong rule, the FSS polish.

FSS: per column j, with G_j the masked gram and b_j = Xty_j, minimize

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
Then a plain-CD polish in fixed coordinate order 0..K-1.

CD convergence accounting: a column stops when a full sweep's loss decrease
is <= tol (coordinate_descent.cpp:112-114).  The decrease of one
coordinate update is taken in the JAX package's cancellation-free form
    -delta_f_k = 1/2 (d + l2) (w - o)^2 + l1 (|o| - xi o),
    xi = sign(w) if w != 0 else clip(u / l1, -1, 1),
two nonnegative terms, computable to full relative precision in f32.
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


def elastic_net_cd(G: torch.Tensor, xty: torch.Tensor, beta0: torch.Tensor,
                   lam, alpha, tol, max_sweeps: int,
                   use_strong_rule: bool = True,
                   perms=None) -> torch.Tensor:
    """Cyclic CD over all columns at once, coordinates in fixed order.

    The iteration of the TPU kernel (insider_tpu/kernels/cd_pallas.py:
    _cd_compute), the plain version of the port's CD kernels.  G: (K, K, M)
    per-column grams, gene axis last (a broadcast view of one (K, K) gram is
    fine); xty, beta0: (K, M).  Returns beta (K, M).

    use_strong_rule: screen with thr = alpha (2 lam - max_k |xty|) in f32,
    zeroing the warm start of the screened coordinates; after a sweep whose
    decrease is <= tol, activate EVERY inactive coordinate with
    |s - xty| > l1, and converge only when there is none
    (coordinate_descent.cpp:74-79, 118-124).  Without it every coordinate
    is active: the FSS polish.  A column stops after at most max_sweeps.
    perms: None, or a (max_sweeps, K) integer array whose row i is the
    coordinate order of sweep i, shared by every column (the JAX package's
    make_sweep_perms, insider_tpu/ops/col_update.py:81-88).
    """
    l1, l2 = penalties(lam, alpha)
    tol = float(np.float32(float(tol)))   # a float or a 0-d tensor
    K, M = xty.shape
    dev = xty.device
    if use_strong_rule:
        lam32, alpha32 = np.float32(lam), np.float32(alpha)
        mx = xty.abs().max(dim=0, keepdim=True).values
        thr = float(alpha32) * (float(np.float32(2.0) * lam32) - mx)
        active = xty.abs() >= thr
        beta = beta0 * active.to(beta0.dtype)
    else:
        active = torch.ones((K, M), dtype=torch.bool, device=dev)
        beta = beta0.clone()
    idx = torch.arange(K, device=dev)
    d = G[idx, idx]                                       # (K, M)
    s = _gram_times(G, beta)
    denom = d + l2
    denom = torch.where(denom > 0.0, denom, 1.0)
    inv_denom = 1.0 / denom
    half_denom = 0.5 * denom
    inv_l1 = float(np.float32(1.0) / np.float32(max(l1, 1e-30)))
    conv = torch.zeros((1, M), dtype=torch.bool, device=dev)
    for sweep in range(max_sweeps):
        if bool(conv.all()):
            break
        # screened coordinates and converged columns do not move; the mask
        # is frozen for the whole sweep
        upd = active & ~conv
        dec = torch.zeros((1, M), dtype=beta.dtype, device=dev)
        for k in (range(K) if perms is None else
                  [int(i) for i in perms[sweep]]):
            b_k = beta[k:k + 1]
            u = xty[k:k + 1] - s[k:k + 1] + b_k * d[k:k + 1]
            w = (torch.sign(u) * torch.clamp(u.abs() - l1, min=0.0)
                 * inv_denom[k:k + 1])
            w = torch.where(upd[k:k + 1], w, b_k)
            delta = w - b_k
            # cancellation-free decrease: both terms nonnegative
            xi = torch.where(w != 0.0, torch.sign(w),
                             torch.clamp(u * inv_l1, -1.0, 1.0))
            dec = dec + (half_denom[k:k + 1] * delta * delta
                         + l1 * (b_k.abs() - xi * b_k))
            s = s + G[k] * delta
            beta[k:k + 1] = w
        cand = ~conv & (dec.abs() <= tol)
        if use_strong_rule:
            viol = ~active & ((s - xty).abs() > l1)
            active = active | (viol & cand)
            conv = conv | (cand & ~viol.any(dim=0, keepdim=True))
        else:
            conv = conv | cand
    return beta


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
        # the polish is plain CD: every coordinate active, no screening
        # (insider_tpu/ops/col_update.py:397-400)
        beta = elastic_net_cd(G, xty, beta, lam, alpha, tol, polish_sweeps,
                              use_strong_rule=False)
    return beta
