"""The feature-sign-search (FSS) column kernels.

Counterparts of insider_tpu/kernels/fss_pallas.py:
  feature_sign_fused   feature_sign_fused_pallas   grams built in the kernel
  feature_sign         feature_sign_pallas         streamed (K, K, M) grams
  feature_sign_shared  feature_sign_shared_pallas  one (K, K) gram (dense)
Each wrapper runs its CUDA kernel (csrc/fss.cu, fss_streamed.cu,
fss_shared.cu, all on the solver of csrc/fss_core.cuh) on CUDA tensors and
its plain version (ops/fss.feature_sign_search) on CPU tensors; a CUDA
tensor never reaches the plain version.  `<wrapper>.launches` counts the
kernel's launches.
"""

from __future__ import annotations

import numpy as np
import torch

from insider_tpu_torch.kernels import _lib
from insider_tpu_torch.ops.fss import feature_sign_search, penalties

# The fused kernel keeps one coordinate per lane of a warp; the streamed and
# shared kernels keep up to four.
FUSED_MAX_K = 32
MAX_K = 128


def fused_mask(mask: torch.Tensor) -> torch.Tensor:
    """The mask as the fused kernels read it: a uint8 mask is staged as
    the 16-byte aligned chunks that cover its rows, so a view that starts
    off a chunk is copied first (an f32 mask is staged by element)."""
    if mask.dtype == torch.uint8 and mask.data_ptr() % 16:
        return mask.clone()
    return mask


def feature_sign_fused_plain(mask, data, R, beta0, lam, alpha,
                             max_outer: int = 48, polish_sweeps: int = 0,
                             tol: float = 0.0) -> torch.Tensor:
    """Plain version of feature_sign_fused: the grams and Xty as matmuls,
    then ops/fss.feature_sign_search."""
    from insider_tpu_torch.ops.col_update import col_gram_masked

    mask = mask.to(R.dtype)
    xty = torch.matmul(R.T, mask * data)
    G = col_gram_masked(R, mask).permute(1, 2, 0).contiguous()
    return feature_sign_search(G, xty, beta0, lam, alpha,
                               max_outer=max_outer,
                               polish_sweeps=polish_sweeps, tol=tol)


def feature_sign_fused(mask: torch.Tensor, data: torch.Tensor,
                       R: torch.Tensor, beta0: torch.Tensor, lam, alpha,
                       max_outer: int = 48, polish_sweeps: int = 0,
                       tol: float = 0.0) -> torch.Tensor:
    """Per-gene masked elastic net by FSS (+ plain-CD polish).

    mask, data (N, M); R (N, K); beta0 (K, M) warm start; all f32, the
    mask f32 or uint8 (the kernel widens each value as it reads it, so
    both give the same bits).  Each column's gram sum_i mask_ij r_i r_i^T
    and Xty sum_i r_i mask_ij data_ij are built inside the kernel.
    Returns beta (K, M).

    The mask must hold only 0 and 1: the kernel takes it into the bf16
    tensor-core gram build as it is (exact for 0/1 only; other values are
    truncated to bf16 and give wrong grams without an error).  The plain
    version computes the general weighted sums.
    """
    if _lib.on_cpu("feature_sign_fused", mask, data, R, beta0):
        return feature_sign_fused_plain(mask, data, R, beta0, lam, alpha,
                                        max_outer, polish_sweeps, tol)
    _lib.require_cuda("feature_sign_fused", data, R, beta0)
    mask = fused_mask(mask)
    mask_is_u8 = _lib.require_mask("feature_sign_fused", R, mask)
    N, K = R.shape
    M = mask.shape[1]
    if mask.shape != (N, M) or data.shape != (N, M) or beta0.shape != (K, M):
        raise ValueError("feature_sign_fused: shapes do not agree")
    if K > FUSED_MAX_K:
        raise ValueError(f"feature_sign_fused: K={K} > {FUSED_MAX_K} is not "
                         "supported by the CUDA kernel")
    l1, l2 = penalties(lam, alpha)
    lib = _lib.lib()
    out = torch.empty((K, M), dtype=torch.float32, device=R.device)
    with torch.cuda.device(R.device):
        err = lib.insider_fss_fused(
            mask.data_ptr(), mask_is_u8, data.data_ptr(), R.data_ptr(),
            beta0.data_ptr(), out.data_ptr(), l1, l2, float(np.float32(tol)),
            N, M, K,
            int(max_outer), int(polish_sweeps), _lib.stream(R))
    _lib.check(err, "feature_sign_fused")
    feature_sign_fused.launches += 1
    return out


feature_sign_fused.launches = 0


def _launch_on_grams(what: str, c_entry: str, xtx, gram_shape, xty, beta0,
                     lam, alpha, max_outer, polish_sweeps, tol, *shared):
    """Check the operands of a gram-input FSS kernel and launch it (the
    streamed kernel also takes a column counter; `shared`: the shared-gram
    kernel's group width)."""
    _lib.require_cuda(what, xtx, xty, beta0)
    K, M = xty.shape
    if xtx.shape != gram_shape or beta0.shape != (K, M):
        raise ValueError(f"{what}: shapes do not agree")
    if K > MAX_K:
        raise ValueError(f"{what}: K={K} > {MAX_K} is not supported by the "
                         "CUDA kernel")
    l1, l2 = penalties(lam, alpha)
    out = torch.empty((K, M), dtype=torch.float32, device=xty.device)
    counter = ([_lib.column_counter(xty)]
               if c_entry == "insider_fss_streamed" else [])
    with torch.cuda.device(xty.device):
        err = getattr(_lib.lib(), c_entry)(
            xtx.data_ptr(), xty.data_ptr(), beta0.data_ptr(), out.data_ptr(),
            *[c.data_ptr() for c in counter], l1, l2,
            float(np.float32(tol)), M, K, int(max_outer),
            int(polish_sweeps), *shared, _lib.stream(xty))
    _lib.check(err, what)
    return out


def feature_sign_plain(xtx, xty, beta0, lam, alpha, max_outer: int = 48,
                       polish_sweeps: int = 0,
                       tol: float = 0.0) -> torch.Tensor:
    """Plain version of feature_sign: ops/fss.feature_sign_search."""
    return feature_sign_search(xtx, xty, beta0, lam, alpha,
                               max_outer=max_outer,
                               polish_sweeps=polish_sweeps, tol=tol)


def feature_sign(xtx: torch.Tensor, xty: torch.Tensor, beta0: torch.Tensor,
                 lam, alpha, max_outer: int = 48, polish_sweeps: int = 0,
                 tol: float = 0.0) -> torch.Tensor:
    """Per-gene elastic net by FSS (+ plain-CD polish) on streamed grams.

    xtx (K, K, M) per-gene grams, gene axis last (kernels/gram.col_gram_xty);
    xty, beta0 (K, M); all f32.  Returns beta (K, M).
    """
    if _lib.on_cpu("feature_sign", xtx, xty, beta0):
        return feature_sign_plain(xtx, xty, beta0, lam, alpha, max_outer,
                                  polish_sweeps, tol)
    K, M = xty.shape
    out = _launch_on_grams("feature_sign", "insider_fss_streamed", xtx,
                           (K, K, M), xty, beta0, lam, alpha, max_outer,
                           polish_sweeps, tol)
    feature_sign.launches += 1
    return out


feature_sign.launches = 0


def feature_sign_shared_plain(xtx, xty, beta0, lam, alpha,
                              max_outer: int = 48, polish_sweeps: int = 0,
                              tol: float = 0.0) -> torch.Tensor:
    """Plain version of feature_sign_shared: ops/fss.feature_sign_search on
    the gram broadcast to every column (a view, not a copy)."""
    K, M = xty.shape
    return feature_sign_search(xtx[:, :, None].expand(K, K, M), xty, beta0,
                               lam, alpha, max_outer=max_outer,
                               polish_sweeps=polish_sweeps, tol=tol)


def feature_sign_shared(xtx: torch.Tensor, xty: torch.Tensor,
                        beta0: torch.Tensor, lam, alpha, max_outer: int = 48,
                        polish_sweeps: int = 0, tol: float = 0.0,
                        lanes: int = 0) -> torch.Tensor:
    """Per-gene elastic net by FSS (+ plain-CD polish) against ONE (K, K)
    gram shared by every column: the dense column update.

    xtx (K, K); xty, beta0 (K, M); all f32.  Returns beta (K, M).  lanes:
    the kernel's group width L (K <= 32: P = 32 / L columns a warp; above,
    32, one column a warp), 0 for the one it runs at this K, else one of
    feature_sign_shared_widths(K) (it raises where not): a hook for tests
    and timings, as every width gives the same bits.  The plain version has
    no lanes.
    """
    if _lib.on_cpu("feature_sign_shared", xtx, xty, beta0):
        return feature_sign_shared_plain(xtx, xty, beta0, lam, alpha,
                                         max_outer, polish_sweeps, tol)
    K = xty.shape[0]
    out = _launch_on_grams("feature_sign_shared", "insider_fss_shared", xtx,
                           (K, K), xty, beta0, lam, alpha, max_outer,
                           polish_sweeps, tol, int(lanes))
    feature_sign_shared.launches += 1
    return out


feature_sign_shared.launches = 0


def feature_sign_shared_widths(K: int, device=None) -> list:
    """[(L, columns an SM solves at once)] of feature_sign_shared's
    instances at this K on the CUDA device (the current one by default),
    the one it runs first."""
    return _lib.widths("insider_fss_shared_widths", K, device)
