"""The gram-fused feature-sign-search column kernel.

Counterpart of insider_tpu/kernels/fss_pallas.py:feature_sign_fused_pallas.
The wrapper runs the CUDA kernel (csrc/fss.cu) on CUDA tensors and its plain
version on CPU tensors; a CUDA tensor never reaches the plain version.
`feature_sign_fused.launches` counts the kernel's launches.
"""

from __future__ import annotations

import numpy as np
import torch

from insider_tpu_torch.kernels import _lib
from insider_tpu_torch.ops.fss import feature_sign_search, penalties

# The kernel keeps one coordinate per lane of a warp.
MAX_K = 32


def feature_sign_fused_plain(mask, data, R, beta0, lam, alpha,
                             max_outer: int = 48, polish_sweeps: int = 0,
                             tol: float = 0.0) -> torch.Tensor:
    """Plain version of feature_sign_fused: the grams and Xty as matmuls,
    then ops/fss.feature_sign_search."""
    from insider_tpu_torch.ops.col_update import col_gram_masked

    xty = torch.matmul(R.T, mask * data)
    return feature_sign_search(col_gram_masked(R, mask), xty, beta0, lam,
                               alpha, max_outer=max_outer,
                               polish_sweeps=polish_sweeps, tol=tol)


def feature_sign_fused(mask: torch.Tensor, data: torch.Tensor,
                       R: torch.Tensor, beta0: torch.Tensor, lam, alpha,
                       max_outer: int = 48, polish_sweeps: int = 0,
                       tol: float = 0.0) -> torch.Tensor:
    """Per-gene masked elastic net by FSS (+ plain-CD polish).

    mask, data (N, M); R (N, K); beta0 (K, M) warm start; all f32.  Each
    column's gram sum_i mask_ij r_i r_i^T and Xty sum_i r_i mask_ij data_ij
    are built inside the kernel.  Returns beta (K, M).
    """
    if _lib.on_cpu("feature_sign_fused", mask, data, R, beta0):
        return feature_sign_fused_plain(mask, data, R, beta0, lam, alpha,
                                        max_outer, polish_sweeps, tol)
    _lib.require_cuda("feature_sign_fused", mask, data, R, beta0)
    N, K = R.shape
    M = mask.shape[1]
    if mask.shape != (N, M) or data.shape != (N, M) or beta0.shape != (K, M):
        raise ValueError("feature_sign_fused: shapes do not agree")
    if K > MAX_K:
        raise ValueError(f"feature_sign_fused: K={K} > {MAX_K} is not "
                         "supported by the CUDA kernel")
    l1, l2 = penalties(lam, alpha)
    lib = _lib.lib()
    out = torch.empty((K, M), dtype=torch.float32, device=R.device)
    with torch.cuda.device(R.device):
        err = lib.insider_fss_fused(
            mask.data_ptr(), data.data_ptr(), R.data_ptr(), beta0.data_ptr(),
            out.data_ptr(), l1, l2, float(np.float32(tol)), N, M, K,
            int(max_outer), int(polish_sweeps), _lib.stream(R))
    _lib.check(err, "feature_sign_fused")
    feature_sign_fused.launches += 1
    return out


feature_sign_fused.launches = 0
