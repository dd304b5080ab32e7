"""Row-side kernels: the per-level grams and right-hand sides of the
confounder ridge updates.

Counterparts of insider_tpu/kernels/row_pallas.py.  Each wrapper runs its
CUDA kernel (csrc/level_gram.cu, csrc/row_xty.cu) on CUDA tensors and its
plain version on CPU tensors; a CUDA tensor never reaches the plain version.
`<wrapper>.launches` counts the kernel's launches.
"""

from __future__ import annotations

import torch

from insider_tpu_torch.kernels import _lib
from insider_tpu_torch.ops.row_update import (level_gram_masked,
                                              masked_level_xty,
                                              one_hot_levels)


def level_gram_plain(mw: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """Plain version of level_gram."""
    return level_gram_masked(mw, F)


def level_gram(mw: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """Per-level masked grams Mw @ outer_table(F)^T: (L, M), (K, M) ->
    (L, K, K).  Counterpart of row_pallas.level_gram_pallas.  Mw holds
    integer counts below 65536: the kernel splits them into two exact bf16
    planes (train/als.build_problem refuses masked problems on the card
    whose counts could reach that)."""
    if _lib.on_cpu("level_gram", mw, F):
        return level_gram_plain(mw, F)
    _lib.require_cuda("level_gram", mw, F)
    L, M = mw.shape
    K = F.shape[0]
    if F.shape[1] != M:
        raise ValueError(f"level_gram: Mw {tuple(mw.shape)} vs F "
                         f"{tuple(F.shape)}")
    lib = _lib.lib()
    out = torch.empty((L, K, K), dtype=torch.float32, device=mw.device)
    scratch = torch.empty(lib.insider_level_gram_scratch(L, M, K),
                          dtype=torch.float32, device=mw.device)
    with torch.cuda.device(mw.device):
        err = lib.insider_level_gram(
            mw.data_ptr(), F.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            scratch.numel(), L, M, K, _lib.stream(mw))
    _lib.check(err, "level_gram")
    level_gram.launches += 1
    return out


level_gram.launches = 0


def row_xty_plain(codes, R_minus, mask, D, F) -> torch.Tensor:
    """Plain version of row_xty."""
    return masked_level_xty(one_hot_levels(codes, D.shape[0]), R_minus,
                            mask, D, F)


def row_xty(codes: torch.Tensor, R_minus: torch.Tensor, mask: torch.Tensor,
            D: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """(D - E^T (mask .* (R_minus F))) F^T -> (L, K), E = one_hot(codes).

    Counterpart of row_pallas.row_xty_auto (row_xty_pallas and its
    row-chunked variant).  codes: (N,) int32 level codes in [0, L), L =
    D.shape[0]; R_minus (N, K), mask (N, M), D (L, M), F (K, M), f32.
    """
    if _lib.on_cpu("row_xty", codes, R_minus, mask, D, F):
        return row_xty_plain(codes, R_minus, mask, D, F)
    _lib.require_cuda("row_xty", codes, dtypes=(torch.int32,))
    _lib.require_cuda("row_xty", R_minus, mask, D, F)
    N, K = R_minus.shape
    L, M = D.shape
    if (codes.shape != (N,) or mask.shape != (N, M)
            or F.shape != (K, M)):
        raise ValueError("row_xty: shapes do not agree")
    lib = _lib.lib()
    n_scratch = lib.insider_row_xty_scratch(M, L, K)
    if n_scratch == 0:
        raise ValueError(f"row_xty: L={L} levels at K={K} exceed the "
                         "kernel's shared memory")
    out = torch.empty((L, K), dtype=torch.float32, device=D.device)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=D.device)
    with torch.cuda.device(D.device):
        err = lib.insider_row_xty(
            codes.data_ptr(), R_minus.data_ptr(), mask.data_ptr(),
            D.data_ptr(), F.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            scratch.numel(), N, M, L, K, _lib.stream(D))
    _lib.check(err, "row_xty")
    row_xty.launches += 1
    return out


row_xty.launches = 0
