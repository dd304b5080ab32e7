"""The streamed per-gene masked gram and Xty builder.

Counterpart of insider_tpu/kernels/gram_pallas.py:col_gram_xty_pallas.  The
wrapper runs the CUDA kernel (csrc/col_gram_xty.cu: the grams on the bf16
tensor cores from exact planes, whose arithmetic ops/planes.
planes_col_gram_xty writes out) on CUDA tensors and its plain version on CPU
tensors; a CUDA tensor never reaches the plain version.
`col_gram_xty.launches` counts the kernel's launches.

Any K below 32768 on the card: the kernel's Xty blocks take 128
coordinates each and its pair blocks 128 pairs each.  Up to K = 128 a pair
block stages all K rows of R a k-step; past it a pair block owns a 16 x 8
tile of the triangle and stages only those 24 rows, from a (K, N) copy of
R^T that the kernel writes into scratch the wrapper allocates, so no shared
memory grows with K.  What bounds K is the output: K^2 M f32, at M =
44477 4.55 GB at K = 160 and 11.66 GB at K = 256, as the JAX package's
streamed route holds them whole (insider_tpu/ops/col_update.py:378-390).
"""

from __future__ import annotations

import torch

from insider_tpu_torch.kernels import _lib


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
    last (4 K^2 M bytes of grams: module docstring): XtXt[k, l, j] = sum_i mask_ij R_ik R_il and Xty[k, j] =
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
    # the kernel copies the rows of mask and data as the 16-byte aligned
    # chunks that cover them; a view that starts off a chunk is copied first
    if mask.data_ptr() % 16:
        mask = mask.clone()
    if data.data_ptr() % 16:
        data = data.clone()
    lib = _lib.lib()
    gram = torch.empty((K, K, M), dtype=torch.float32, device=R.device)
    xty = torch.empty((K, M), dtype=torch.float32, device=R.device)
    scratch = torch.empty(lib.insider_col_gram_xty_scratch(N, K),
                          dtype=torch.float32, device=R.device)
    with torch.cuda.device(R.device):
        err = lib.insider_col_gram_xty(
            mask.data_ptr(), mask_is_u8, data.data_ptr(),
            R.data_ptr(), scratch.data_ptr(), scratch.numel(),
            gram.data_ptr(), xty.data_ptr(), N, M, K, _lib.stream(R))
    _lib.check(err, "col_gram_xty")
    col_gram_xty.launches += 1
    return gram, xty


col_gram_xty.launches = 0
