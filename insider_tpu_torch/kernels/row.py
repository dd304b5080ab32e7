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


# The largest per-level count the kernel holds exactly (f32's exact
# integer range), and the one below which two count planes do.
MAX_COUNT = 1 << 24
TWO_PLANE_COUNT = 1 << 16
NARROW_K = 128      # the kernel's narrow instance takes K up to this


def level_gram(mw: torch.Tensor, F: torch.Tensor,
               max_count=None) -> torch.Tensor:
    """Per-level masked grams Mw @ outer_table(F)^T: (L, M), (K, M) ->
    (L, K, K).  Counterpart of row_pallas.level_gram_pallas.

    Mw holds integer counts.  The kernel splits them into exact bf16 planes
    (csrc/mma.cuh): two when every count is below 65536, three below 2**24,
    so a level may hold any number of rows.  max_count: the largest count
    in Mw, which a fit computes once per problem (train/als.build_problem);
    taken from Mw (a device-to-host read) when not given.  A max_count
    outside [0, 2**24) raises ValueError; one below Mw's largest count
    gives wrong grams.  Any K below 32768 on the card: up to K = 128 a
    block of the kernel owns 64 consecutive pairs (k1, k2) and stages all K
    rows of F a step; past it a block owns an 8 x 8 tile of the triangle
    and stages only those 16 rows, so no shared memory grows with K.  What
    bounds K is the bytes: the output, L K^2 f32, and the kernel's partial
    sums, L K (K + 1) / 2 f32 for each of its column ranges."""
    if _lib.on_cpu("level_gram", mw, F):
        return level_gram_plain(mw, F)
    _lib.require_cuda("level_gram", mw, F)
    L, M = mw.shape
    K = F.shape[0]
    if F.shape[1] != M:
        raise ValueError(f"level_gram: Mw {tuple(mw.shape)} vs F "
                         f"{tuple(F.shape)}")
    if max_count is None:
        max_count = float(mw.max())
    if not 0 <= max_count < MAX_COUNT:
        raise ValueError(f"level_gram: counts must lie in [0, {MAX_COUNT}), "
                         f"got a largest count of {max_count}")
    planes = 2 if max_count < TWO_PLANE_COUNT else 3
    # the wide instance copies rows of F as the 16-byte aligned chunks that
    # cover them; a view that starts off a chunk is copied first (the narrow
    # instance copies 4 bytes at a time)
    if K > NARROW_K and F.data_ptr() % 16:
        F = F.clone()
    lib = _lib.lib()
    out = torch.empty((L, K, K), dtype=torch.float32, device=mw.device)
    scratch = torch.empty(lib.insider_level_gram_scratch(L, M, K, planes),
                          dtype=torch.float32, device=mw.device)
    with torch.cuda.device(mw.device):
        err = lib.insider_level_gram(
            mw.data_ptr(), F.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            scratch.numel(), L, M, K, planes, _lib.stream(mw))
    _lib.check(err, "level_gram")
    level_gram.launches += 1
    return out


level_gram.launches = 0


def level_order(codes: torch.Tensor, n_levels: int):
    """The rows sorted by level, for row_xty: (order (N,), offsets (L+1,),
    ends (N,)), int32 on codes' device.  order is a stable sort of the row
    indices by code; the rows of level l are order[offsets[l]:offsets[l+1]],
    so offsets[l] is the number of codes below l (rows whose code lies
    outside [0, L) fall outside every level); ends[p] is l where sorted
    position p is the last row of level l, else -1."""
    codes = codes.long()
    order = torch.argsort(codes, stable=True)
    ranked = codes[order]
    offsets = torch.searchsorted(
        ranked, torch.arange(n_levels + 1, device=codes.device))
    last = torch.ones_like(ranked, dtype=torch.bool)
    last[:-1] = ranked[1:] != ranked[:-1]
    inside = (ranked >= 0) & (ranked < n_levels)
    ends = torch.where(last & inside, ranked, torch.full_like(ranked, -1))
    return order.to(torch.int32), offsets.to(torch.int32), ends.to(torch.int32)


def row_xty_plain(codes, R_minus, mask, D, F) -> torch.Tensor:
    """Plain version of row_xty, in the operands' dtype (f32 as the
    kernel; f64 for an accuracy reference), the mask widened to it."""
    return masked_level_xty(one_hot_levels(codes, D.shape[0], R_minus.dtype),
                            R_minus, mask.to(R_minus.dtype), D, F)


def row_xty(codes: torch.Tensor, R_minus: torch.Tensor, mask: torch.Tensor,
            D: torch.Tensor, F: torch.Tensor, levels=None) -> torch.Tensor:
    """(D - E^T (mask .* (R_minus F))) F^T -> (L, K), E = one_hot(codes).

    Counterpart of row_pallas.row_xty_auto (row_xty_pallas and its
    row-chunked variant).  codes: (N,) int32 level codes in [0, L), L =
    D.shape[0]; R_minus (N, K), D (L, M), F (K, M), f32; mask (N, M) 0/1,
    f32 or uint8 (the kernel widens each value as it reads it, so both
    give the same bits); any L and any K (above 128 the prediction is
    built in register tiles of rows x columns, csrc/predict_tile.cuh, each
    level's sums over a tile of the sorted rows go to scratch, and a
    second kernel adds them before it forms D - T).  levels:
    the rows sorted by level, level_order(codes, L), which the kernel
    reads in place of the codes; a fit computes them once per problem
    (train/als.build_problem), and they are derived here when not given.
    """
    if _lib.on_cpu("row_xty", codes, R_minus, mask, D, F):
        return row_xty_plain(codes, R_minus, mask, D, F)
    _lib.require_cuda("row_xty", codes, dtypes=(torch.int32,))
    _lib.require_cuda("row_xty", R_minus, D, F)
    mask_is_u8 = _lib.require_mask("row_xty", D, mask)
    N, K = R_minus.shape
    L, M = D.shape
    if (codes.shape != (N,) or mask.shape != (N, M)
            or F.shape != (K, M)):
        raise ValueError("row_xty: shapes do not agree")
    order, offsets, ends = (level_order(codes, L) if levels is None
                            else levels)
    _lib.require_cuda("row_xty", codes, order, offsets, ends,
                      dtypes=(torch.int32,))
    if (order.shape != (N,) or offsets.shape != (L + 1,)
            or ends.shape != (N,)):
        raise ValueError("row_xty: levels must be (N,), (L + 1,), (N,)")
    lib = _lib.lib()
    out = torch.empty((L, K), dtype=torch.float32, device=D.device)
    scratch = torch.empty(lib.insider_row_xty_scratch(N, M, L, K),
                          dtype=torch.float32, device=D.device)
    with torch.cuda.device(D.device):
        err = lib.insider_row_xty(
            order.data_ptr(), offsets.data_ptr(), ends.data_ptr(),
            R_minus.data_ptr(), mask.data_ptr(), mask_is_u8, D.data_ptr(),
            F.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), scratch.numel(), N, M, L, K,
            _lib.stream(D))
    _lib.check(err, "row_xty")
    row_xty.launches += 1
    return out


row_xty.launches = 0
