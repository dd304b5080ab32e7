"""Post-fit GLM interaction inference.

Counterpart of insider_tpu/analysis/glm.py (`glm_interaction`,
R/glm_interaction.R:2-30): for each interaction level, regress the stacked
residual rows of that level's samples on the gene factor F^T (no
intercept, gaussian family) and report coefficients and p-values.  The
design is F^T repeated n_l times, so the normal equations collapse to a
closed form that solves every level at once, in f32 on the device:

    XtX_l = n_l F F^T          Xty_l = F (sum of level-l residual rows)
    beta_l = XtX_l^{-1} Xty_l
    RSS_l  = sum ||rows||^2 - 2 beta^T Xty + beta^T XtX beta
    t_kl   = beta_kl / sqrt(sigma2_l (XtX_l^{-1})_kk),  dof_l = n_l M - K

The p-values 2 P(T > |t|) of the Student-t with dof_l degrees of freedom
are computed on the host in f64 numpy, by the regularized incomplete beta
I_x(dof / 2, 1 / 2) (betainc below), since torch has no betainc and scipy
is not a dependency of the package.  betainc evaluates the continued
fraction by Lentz's method; at the Student-t's b = 1/2 and a >= 15 it takes
DiDonato & Morris's asymptotic expansion BGRAT (ACM TOMS 18 (1992),
Algorithm 708) instead, because at the flagship shape dof reaches ~10^6,
and near |t| ~ 2 the fraction's terms there cancel: it kept only ~10
digits at a = 5e6.  Like
the reference, `train_indicator`, `tol` and `n_cores` are accepted and
unused.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from insider_tpu_torch.train.als import resolve_device

# Continued fraction: terms until a factor is within EPS of 1; at large a
# it needs on the order of sqrt(a) terms.
_CF_EPS = 1e-16
_CF_MAX_TERMS = 200_000
_TINY = 1e-300
# BGRAT at b = 1/2: from a >= _BGRAT_MIN_A, for x near 1 (1 - x below
# _BGRAT_MAX_Y), while u = -(a - 1/4) ln x stays below _BGRAT_MAX_U (above
# it exp(-u) underflows, and the fraction converges fast).
_BGRAT_MIN_A = 15.0
_BGRAT_MAX_Y = 0.3
_BGRAT_MAX_U = 600.0
_BGRAT_TERMS = 30
# Stirling's series for ln Gamma(x) - ((x - 1/2) ln x - x + ln(2 pi) / 2),
# accurate to 1e-16 for x >= _STIRLING_MIN.
_STIRLING = (1 / 12, -1 / 360, 1 / 1260, -1 / 1680, 1 / 1188)
_STIRLING_MIN = 10.0


def _stirling_tail(x):
    r = 1.0 / (x * x)
    acc = np.zeros_like(x)
    for c in reversed(_STIRLING):
        acc = acc * r + c
    return acc / x


def _log_beta(a, b):
    """ln B(a, b), elementwise.  Where the larger argument is at least
    _STIRLING_MIN, ln Gamma(big) - ln Gamma(big + small) comes from the
    difference of Stirling's series with log1p, not from two lgammas of
    ~10^7 whose difference would keep only ~8 digits."""
    big, small = np.maximum(a, b), np.minimum(a, b)
    lg = np.vectorize(math.lgamma, otypes=[np.float64])
    direct = lg(a) + lg(b) - lg(a + b)
    safe = np.where(big >= _STIRLING_MIN, big, _STIRLING_MIN)
    ratio = (-(safe - 0.5) * np.log1p(small / safe)
             - small * np.log(safe + small) + small
             + _stirling_tail(safe) - _stirling_tail(safe + small))
    return np.where(big >= _STIRLING_MIN, lg(small) + ratio, direct)


def _betacf(a, b, x):
    """The continued fraction of I_x(a, b) (without its front factor),
    elementwise by the modified Lentz method, for x < (a + 1) / (a + b + 2),
    where it converges."""
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = np.ones_like(x)
    d = 1.0 - qab * x / qap
    d = 1.0 / np.where(np.abs(d) < _TINY, _TINY, d)
    h = d.copy()
    todo = np.ones(x.shape, bool)
    for m in range(1, _CF_MAX_TERMS + 1):
        m2 = 2.0 * m
        for aa in (m * (b - m) * x / ((qam + m2) * (a + m2)),
                   -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))):
            d = 1.0 + aa * d
            d = 1.0 / np.where(np.abs(d) < _TINY, _TINY, d)
            c = 1.0 + aa / c
            c = np.where(np.abs(c) < _TINY, _TINY, c)
            step = d * c
            h = np.where(todo, h * step, h)
        todo &= np.abs(step - 1.0) >= _CF_EPS
        if not todo.any():
            break
    return h


def _bgrat_coefficients(b, n_terms):
    """The p_n of DiDonato & Morris's eq. 9.3, for BGRAT at this b."""
    p = [1.0]
    for n in range(1, n_terms):
        pn = sum((m * b - n) * p[n - m] / math.factorial(2 * m + 1)
                 for m in range(1, n))
        p.append(pn / n + (b - 1.0) / math.factorial(2 * n + 1))
    return p


_BGRAT_P = _bgrat_coefficients(0.5, _BGRAT_TERMS)


def _bgrat_half(a, x, y):
    """I_x(a, 1/2) for large a by BGRAT (eqs. 9-9.6): with T = a - 1/4 and
    u = -T ln x, the incomplete gamma Q(1/2, u) = erfc(sqrt(u)) and its
    correction series in (ln x / 2)^2."""
    b = 0.5
    t = a + (b - 1.0) / 2.0
    lx = np.where(y < 0.35, np.log1p(-y), np.log(x))
    u = -t * lx
    # ln Gamma(a + b) - ln Gamma(a) = ln Gamma(b) - ln B(a, b)
    log_gamma_ratio = math.lgamma(b) - _log_beta(a, np.full_like(a, b))
    log_h = b * np.log(u) - u - math.lgamma(b)
    prefix = np.exp(log_h + log_gamma_ratio - b * np.log(t))
    q = np.vectorize(math.erfc, otypes=[np.float64])(np.sqrt(u))
    j = q / np.exp(log_h)
    total = prefix * j
    lx2 = (lx / 2.0) ** 2
    lxp = np.ones_like(x)
    t4 = 4.0 * t * t
    b2n = b
    done = np.zeros(x.shape, bool)
    for pn in _BGRAT_P[1:]:
        j = (b2n * (b2n + 1.0) * j + (u + b2n + 1.0) * lxp) / t4
        lxp = lxp * lx2
        b2n += 2.0
        r = prefix * pn * j
        total = np.where(done, total, total + r)
        done |= np.abs(r) < 1e-17 * np.abs(total)
        if done.all():
            break
    return total


def betainc(a, b, x):
    """The regularized incomplete beta I_x(a, b) in f64, elementwise (a, b
    > 0, 0 <= x <= 1; NaN elsewhere), as scipy.special.betainc."""
    a, b, x = np.broadcast_arrays(*(np.asarray(v, np.float64)
                                    for v in (a, b, x)))
    out = np.full(x.shape, np.nan)
    ok = (a > 0) & (b > 0) & (x >= 0) & (x <= 1)
    out[ok & (x == 0)] = 0.0
    out[ok & (x == 1)] = 1.0
    inner = ok & (x > 0) & (x < 1)
    if not inner.any():
        return out
    a, b, x = a[inner], b[inner], x[inner]
    y = 1.0 - x
    val = np.empty_like(x)
    bgrat = ((b == 0.5) & (a >= _BGRAT_MIN_A) & (y < _BGRAT_MAX_Y)
             & (-(a - 0.25) * np.log(x) <= _BGRAT_MAX_U))
    if bgrat.any():
        val[bgrat] = _bgrat_half(a[bgrat], x[bgrat], y[bgrat])
    front = np.exp(a * np.log(x) + b * np.log(y) - _log_beta(a, b))
    # the fraction converges below (a + 1) / (a + b + 2); above it,
    # I_x(a, b) = 1 - I_{1-x}(b, a)
    flip = (x >= (a + 1.0) / (a + b + 2.0)) & ~bgrat
    lo = ~flip & ~bgrat
    if lo.any():
        val[lo] = front[lo] * _betacf(a[lo], b[lo], x[lo]) / a[lo]
    if flip.any():
        val[flip] = 1.0 - front[flip] * _betacf(b[flip], a[flip],
                                                y[flip]) / b[flip]
    out[inner] = val
    return out


def student_t_pvalue(t, dof):
    """Two-sided p-value 2 P(T > |t|) of the Student-t with dof degrees of
    freedom, in f64: I_x(dof / 2, 1 / 2) at x = dof / (dof + t^2)."""
    t = np.asarray(t, np.float64)
    dof = np.asarray(dof, np.float64)
    return betainc(dof / 2.0, 0.5, dof / (dof + t * t))


def _glm_batched(residual, codes, n_levels, F):
    """beta (L, K), t (L, K) and dof (L,) of every level, on the operands'
    device in f32."""
    K, M = F.shape
    gram = torch.matmul(F, F.T)                                  # (K, K)
    counts = torch.zeros(n_levels, dtype=F.dtype, device=F.device)
    counts.index_add_(0, codes, torch.ones_like(codes, dtype=F.dtype))
    S = torch.zeros((n_levels, M), dtype=F.dtype, device=F.device)
    S.index_add_(0, codes, residual)                             # (L, M)
    yty = torch.zeros(n_levels, dtype=F.dtype, device=F.device)
    yty.index_add_(0, codes, torch.sum(residual * residual, dim=1))
    Xty = torch.matmul(S, F.T)                                   # (L, K)
    XtX = counts[:, None, None] * gram                           # (L, K, K)
    L_chol, _ = torch.linalg.cholesky_ex(XtX)
    XtX_inv = torch.cholesky_inverse(L_chol)
    beta = torch.einsum("lkj,lj->lk", XtX_inv, Xty)
    rss = (yty - 2.0 * torch.sum(beta * Xty, dim=1)
           + torch.einsum("lk,lkj,lj->l", beta, XtX, beta))
    dof = counts * M - K
    sigma2 = rss / torch.clamp(dof, min=1.0)
    se = torch.sqrt(sigma2[:, None]
                    * torch.diagonal(XtX_inv, dim1=1, dim2=2))
    return beta, beta / se, dof


def glm_interaction(residual: np.ndarray,
                    train_indicator: Optional[np.ndarray],
                    interaction_indicator: np.ndarray,
                    column_factor: np.ndarray, tol: float = 1e-10,
                    n_cores: int = 10, *, device="cuda"
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (coeff_matrix, pval_matrix), each (n_levels, K): levels in
    sorted order of the interaction codes.  residual (N, M), column_factor
    (K, M).  device (keyword-only): "cuda" (default; raises without a card)
    or "cpu"."""
    del train_indicator, tol, n_cores  # unused, as in the reference
    device = resolve_device(device)
    codes_raw = np.asarray(interaction_indicator).ravel()
    levels, inv = np.unique(codes_raw, return_inverse=True)

    def put(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    beta, t, dof = _glm_batched(put(residual),
                                put(inv.reshape(-1), torch.int64),
                                levels.size, put(column_factor))
    t_h = t.cpu().numpy().astype(np.float64)
    dof_h = dof.cpu().numpy().astype(np.float64)[:, None]
    return beta.cpu().numpy(), student_t_pvalue(t_h, dof_h)
