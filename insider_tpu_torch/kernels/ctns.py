"""The continuous covariate's K-space ridge CD kernel.

No Pallas counterpart: it replaces the XLA while_loop of
insider_tpu/ops/continuous.py:_ctns_cd (src/optimize.cpp:102-126).  The
wrapper runs the CUDA kernel (csrc/ctns_cd.cu, one warp) on CUDA tensors
and its plain version on CPU tensors; a CUDA tensor never reaches the plain
version.  `ctns_cd.launches` counts the kernel's launches.
"""

from __future__ import annotations

import numpy as np
import torch

from insider_tpu_torch.kernels import _lib

# A lane holds four coordinates of the warp's 32 lanes.
MAX_K = 128


def ctns_cd_plain(XtX, b, w0, lam, tol, max_sweeps: int = 100,
                  loss_criterion: bool = False):
    """Plain version of ctns_cd -> (w (K,), sweeps (1,) int32).

    _ctns_cd's loop, one coordinate at a time, every product and sum an
    f32 operation of its own.  s = XtX w0 starts from zero with the same
    rank-1 steps as the sweeps, and the sweep's criterion adds |delta| (or
    the decrement 0.5 (XtX_kk + lam) delta^2) in coordinate order: the sums
    of the JAX package's matmul and reduction in a fixed order, which the
    kernel follows bit for bit.  The stop test runs on the host against
    tol rounded to f32, as the JAX package compares it."""
    K = XtX.shape[0]
    diag = torch.diagonal(XtX)
    s = torch.zeros_like(b)
    for k in range(K):
        s = s + XtX[:, k] * w0[k]
    w = w0.clone()
    tol32 = float(np.float32(tol))
    crit, sweeps = float("inf"), 0
    while crit >= tol32 and sweeps < max_sweeps:
        acc = torch.zeros((), dtype=w.dtype, device=w.device)
        for k in range(K):
            u = b[k] - s[k] + w[k] * diag[k]
            w_new = u / (diag[k] + lam)
            delta = w_new - w[k]
            acc = (acc + 0.5 * (diag[k] + lam) * delta * delta
                   if loss_criterion else acc + delta.abs())
            s = s + XtX[:, k] * delta
            w[k] = w_new
        crit = float(acc)
        sweeps += 1
    return w, torch.tensor([sweeps], dtype=torch.int32, device=w.device)


def ctns_cd(XtX: torch.Tensor, b: torch.Tensor, w0: torch.Tensor, lam, tol,
            max_sweeps: int = 100, loss_criterion: bool = False, *,
            with_sweeps: bool = False):
    """Sequential ridge CD of one covariate's coefficients in K-space.

    XtX (K, K), b (K,), w0 (K,) warm start, f32; 1 <= K <= 128 on the
    card; max_sweeps >= 1.  Sweeps coordinates 0..K-1 until a sweep's
    sum |delta w| (loss_criterion: its sum of 0.5 (XtX_kk + lam) delta^2)
    is below tol, or max_sweeps sweeps.  Returns w (K,), or with
    with_sweeps (w, sweeps) where sweeps is a (1,) int32 tensor on the
    operands' device: the kernel decides the stop on the card, so nothing
    here waits on the device."""
    if int(max_sweeps) < 1:
        raise ValueError(f"ctns_cd: max_sweeps={max_sweeps} must be >= 1")
    if _lib.on_cpu("ctns_cd", XtX, b, w0):
        w, sweeps = ctns_cd_plain(XtX, b, w0, lam, tol, max_sweeps,
                                  loss_criterion)
        return (w, sweeps) if with_sweeps else w
    _lib.require_cuda("ctns_cd", XtX, b, w0)
    K = b.shape[0]
    if XtX.shape != (K, K) or w0.shape != (K,):
        raise ValueError("ctns_cd: shapes do not agree")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"ctns_cd: K={K} is outside the CUDA kernel's "
                         f"1..{MAX_K}")
    w = torch.empty_like(w0)
    sweeps = torch.empty(1, dtype=torch.int32, device=w0.device)
    with torch.cuda.device(w0.device):
        err = _lib.lib().insider_ctns_cd(
            XtX.data_ptr(), b.data_ptr(), w0.data_ptr(), w.data_ptr(),
            sweeps.data_ptr(), float(np.float32(lam)),
            float(np.float32(tol)), int(max_sweeps), int(bool(loss_criterion)),
            K, _lib.stream(w0))
    _lib.check(err, "ctns_cd")
    ctns_cd.launches += 1
    return (w, sweeps) if with_sweeps else w


ctns_cd.launches = 0
