"""The streamed per-gene masked gram and Xty builder.

Counterpart of insider_tpu/kernels/gram_pallas.py:col_gram_xty_pallas.  The
wrapper runs the CUDA kernel (csrc/col_gram_xty.cu: the grams on the bf16
tensor cores from exact planes, whose arithmetic ops/planes.
planes_col_gram_xty writes out) on CUDA tensors and its plain version on CPU
tensors; a CUDA tensor never reaches the plain version.
`col_gram_xty.launches` counts the kernel's launches.
"""

from __future__ import annotations

import torch

from insider_tpu_torch.kernels import _lib

# The kernel's Xty threads hold up to 64 coordinates, two threads a column.
MAX_K = 128


def col_gram_xty_plain(mask, data, R):
    """Plain version of col_gram_xty: the masked grams as one matmul against
    the outer-product table (ops/col_update.col_gram_masked), Xty as
    R^T (mask .* data)."""
    from insider_tpu_torch.ops.col_update import col_gram_masked

    mask = mask.to(R.dtype)
    XtXt = col_gram_masked(R, mask).permute(1, 2, 0).contiguous()
    return XtXt, torch.matmul(R.T, mask * data)


def col_gram_xty(mask: torch.Tensor, data: torch.Tensor, R: torch.Tensor):
    """Per-gene masked grams and right-hand sides of the column update.

    mask (N, M) 0/1, f32 or uint8; data (N, M) and R (N, K) f32.  Returns
    (XtXt (K, K, M), Xty (K, M)) in the JAX package's layout, gene axis
    last: XtXt[k, l, j] = sum_i mask_ij R_ik R_il and Xty[k, j] =
    sum_i R_ik mask_ij data_ij.  The kernel's grams are symmetric bit for
    bit.  The mask must hold only 0 and 1: the kernel's bf16 gram build is
    exact for 0/1 only.
    """
    if _lib.on_cpu("col_gram_xty", mask, data, R):
        return col_gram_xty_plain(mask, data, R)
    _lib.require_cuda("col_gram_xty", data, R)
    mask_is_u8 = _lib.require_mask("col_gram_xty", R, mask)
    N, K = R.shape
    M = mask.shape[1]
    if mask.shape != (N, M) or data.shape != (N, M):
        raise ValueError("col_gram_xty: shapes do not agree")
    if K > MAX_K:
        raise ValueError(f"col_gram_xty: K={K} > {MAX_K} is not supported "
                         "by the CUDA kernel")
    # the kernel copies the rows of mask and data as the 16-byte aligned
    # chunks that cover them; a view that starts off a chunk is copied first
    if mask.data_ptr() % 16:
        mask = mask.clone()
    if data.data_ptr() % 16:
        data = data.clone()
    lib = _lib.lib()
    gram = torch.empty((K, K, M), dtype=torch.float32, device=R.device)
    xty = torch.empty((K, M), dtype=torch.float32, device=R.device)
    with torch.cuda.device(R.device):
        err = lib.insider_col_gram_xty(
            mask.data_ptr(), mask_is_u8, data.data_ptr(),
            R.data_ptr(), gram.data_ptr(), xty.data_ptr(), N, M, K,
            _lib.stream(R))
    _lib.check(err, "col_gram_xty")
    col_gram_xty.launches += 1
    return gram, xty


col_gram_xty.launches = 0
