"""The fused masked-evaluation kernel.

Counterpart of insider_tpu/kernels/eval_pallas.py:masked_eval_pallas.  The
wrapper runs the CUDA kernel (csrc/masked_eval.cu) on CUDA tensors and its
plain version on CPU tensors; a CUDA tensor never reaches the plain version.
`masked_eval.launches` counts the kernel's launches.
"""

from __future__ import annotations

import torch

from insider_tpu_torch.kernels import _lib
from insider_tpu_torch.ops.losses import EvalSums, evaluate_masked, predict

# The kernel keeps a column of F in registers, at most 128 coordinates.
MAX_K = 128


def masked_eval_plain(data, train_mask, test_mask, R, F) -> EvalSums:
    """Plain version of masked_eval: the (N, M) residual, then f64 sums,
    the masks widened to f32."""
    return evaluate_masked(data - predict(R, F), train_mask.to(data.dtype),
                           test_mask.to(data.dtype))


def masked_eval(data: torch.Tensor, train_mask: torch.Tensor,
                test_mask: torch.Tensor, R: torch.Tensor,
                F: torch.Tensor) -> EvalSums:
    """Train/test SSE and counts of data - R F under the two masks, as f64
    scalar tensors on the operands' device.  data (N, M), R (N, K),
    F (K, M), f32; the masks (N, M) 0/1, both f32 or both uint8 (the kernel
    widens each value as it reads it, so both give the same bits);
    1 <= K <= 128 on the card.  The kernel's counts are exact
    for 0/1 masks, as the fit's train and test indicators are (it adds a
    few mask values in f32 before their f64 sum); the plain version adds
    every value in f64."""
    if _lib.on_cpu("masked_eval", data, train_mask, test_mask, R, F):
        return masked_eval_plain(data, train_mask, test_mask, R, F)
    _lib.require_cuda("masked_eval", data, R, F)
    mask_is_u8 = _lib.require_mask("masked_eval", data, train_mask,
                                   test_mask)
    N, K = R.shape
    M = F.shape[1]
    if (data.shape != (N, M) or train_mask.shape != (N, M)
            or test_mask.shape != (N, M) or F.shape != (K, M)):
        raise ValueError("masked_eval: shapes do not agree")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"masked_eval: K={K} is outside the CUDA kernel's "
                         f"1..{MAX_K}")
    lib = _lib.lib()
    out = torch.empty(4, dtype=torch.float64, device=data.device)
    scratch = torch.empty(lib.insider_masked_eval_scratch(N, M, K),
                          dtype=torch.float64, device=data.device)
    with torch.cuda.device(data.device):
        err = lib.insider_masked_eval(
            data.data_ptr(), train_mask.data_ptr(), test_mask.data_ptr(),
            mask_is_u8, R.data_ptr(), F.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), scratch.numel(), N, M, K, _lib.stream(data))
    _lib.check(err, "masked_eval")
    masked_eval.launches += 1
    return EvalSums(out[0], out[1], out[2], out[3])


masked_eval.launches = 0
