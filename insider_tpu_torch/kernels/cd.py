"""The cold strong-rule coordinate-descent (CD) column kernels.

Counterparts of insider_tpu/kernels/cd_pallas.py and cd_packed.py:
  cd_fused     elastic_net_cd_fused_pallas,      grams built in the kernel
               elastic_net_cd_fused_packed_pallas
  cd_streamed  elastic_net_cd_pallas,            streamed (K, K, M) grams
               elastic_net_cd_packed_pallas
  cd_shared    elastic_net_cd_shared_pallas      one (K, K) gram (dense)
The packed TPU kernels run the iteration of the unpacked ones in a sublane
layout; on the GPU that layout question does not arise, so each pair maps
onto one kernel.  Each wrapper runs its CUDA kernel on CUDA tensors: the
CD instances of the FSS kernels' templates (csrc/fss.cu, fss_streamed.cu,
fss_shared.cu), on the cold-CD loop of csrc/fss_core.cuh
(cd_group_columns) up to K = 320.  On CPU tensors it runs its plain version
(ops/fss.elastic_net_cd); a CUDA tensor never reaches the plain version.
`<wrapper>.launches` counts the kernel's launches.

Every kernel sweeps coordinates in the fixed order 0..K-1: the caller
permutes the problem to randomize it (ops/col_update.py).

Up to K = 320 the loop runs P = 32 / L columns on one warp, one to each
group of L lanes, the groups sweeping in lockstep.  cd_fused runs four
columns a warp (L = 8) and hands a group whose column converged the
block's next column at the next sweep boundary (csrc/fss.cu, header), as
cd_shared does with L = 8, 16 or 32 by K, 32 past K = 64
(csrc/fss_shared.cu); cd_streamed runs two columns a warp (L = 16), with
no refill, and past K = 128 one column a warp on a gram in shared memory
(L = 32), past K = 192 first two on grams read through L2 (L = 16)
(csrc/fss_streamed.cu, header).  The widths each kernel has at a K are
cd_fused_widths, cd_streamed_widths and cd_shared_widths, the one it runs
listed first; their `lanes` argument forces one, a hook for tests and
timings.  Each column's arithmetic, and so its bits, do not depend on L,
on the columns that share its warp or on when it was taken.  Past 128
coordinates cd_streamed and cd_shared also have the block solve, one
column a block of 128 threads (csrc/fss_wide.cuh, whose sweep loop the
wide FSS polish shares), as width 128: the only instance past K = 320,
and bit for bit the grouped loop on the symmetric grams every caller
gives.  It and the instances that read their grams through L2 take a
column counter and the scratch whose size their C entry reports
(insider_cd_*_scratch), which the wrapper allocates beside the output, as
kernels/fss.py does; cd_fused stays at K <= 32.

A column whose warm start holds a NaN or an Inf, or whose Xty an Inf,
comes out all NaN, where the plain version's and the TPU kernel's come out
non-finite; a NaN in Xty fails the screen, as there, and the column
solves to zero.
"""

from __future__ import annotations

import numpy as np
import torch

from insider_tpu_torch.kernels import _lib
from insider_tpu_torch.kernels.fss import FUSED_MAX_K, fused_mask
from insider_tpu_torch.ops.fss import elastic_net_cd


def _f32(lam, alpha):
    """lam and alpha as the kernels take them, rounded to f32."""
    return float(np.float32(lam)), float(np.float32(alpha))


def cd_fused_plain(mask, data, R, beta0, lam, alpha, tol,
                   max_sweeps: int = 200) -> torch.Tensor:
    """Plain version of cd_fused: the grams and Xty as matmuls, then
    ops/fss.elastic_net_cd."""
    from insider_tpu_torch.ops.col_update import col_gram_masked

    mask = mask.to(R.dtype)
    xty = torch.matmul(R.T, mask * data)
    G = col_gram_masked(R, mask).permute(1, 2, 0).contiguous()
    return elastic_net_cd(G, xty, beta0, lam, alpha, tol, max_sweeps)


def cd_fused(mask: torch.Tensor, data: torch.Tensor, R: torch.Tensor,
             beta0: torch.Tensor, lam, alpha, tol,
             max_sweeps: int = 200, lanes: int = 0) -> torch.Tensor:
    """Per-gene masked elastic net by cold strong-rule CD.

    mask, data (N, M); R (N, K), its columns in the sweep order; beta0
    (K, M) warm start in the same order; all f32, the mask f32 or uint8
    (the same bits either way, as for feature_sign_fused).  tol: a float
    or one f32 on the card, as for fss.feature_sign_fused.  Each column's
    gram and Xty are built inside the kernel.  Returns beta (K, M).
    lanes: the kernel's group width L, 0 for the one it runs at this K,
    else one of cd_fused_widths(K) (it raises where not): a hook for tests
    and timings, as every width gives the same bits.  The plain version
    has no lanes.

    The mask must hold only 0 and 1, as for fss.feature_sign_fused: the
    kernel's bf16 gram build is exact for 0/1 only, and other values give
    wrong grams without an error.
    """
    if _lib.on_cpu("cd_fused", mask, data, R, beta0):
        return cd_fused_plain(mask, data, R, beta0, lam, alpha, tol,
                              max_sweeps)
    _lib.require_cuda("cd_fused", data, R, beta0)
    mask = fused_mask(mask)
    mask_is_u8 = _lib.require_mask("cd_fused", R, mask)
    N, K = R.shape
    M = mask.shape[1]
    if mask.shape != (N, M) or data.shape != (N, M) or beta0.shape != (K, M):
        raise ValueError("cd_fused: shapes do not agree")
    if K > FUSED_MAX_K:
        raise ValueError(f"cd_fused: K={K} > {FUSED_MAX_K} is not supported "
                         "by the CUDA kernel")
    lam, alpha = _f32(lam, alpha)
    tol = _lib.tol_on_device(tol, R)
    out = torch.empty((K, M), dtype=torch.float32, device=R.device)
    with torch.cuda.device(R.device):
        err = _lib.lib().insider_cd_fused(
            mask.data_ptr(), mask_is_u8, data.data_ptr(), R.data_ptr(),
            beta0.data_ptr(), out.data_ptr(), lam, alpha, tol.data_ptr(),
            N, M, K,
            int(max_sweeps), int(lanes), _lib.stream(R))
    _lib.check(err, "cd_fused")
    cd_fused.launches += 1
    return out


cd_fused.launches = 0


def cd_fused_widths(K: int, device=None) -> list:
    """[(L, columns an SM sweeps at once)] of cd_fused's instances at this
    K, the one it runs first."""
    return _lib.widths("insider_cd_fused_widths", K, device)


def cd_streamed_plain(xtx, xty, beta0, lam, alpha, tol,
                      max_sweeps: int = 200) -> torch.Tensor:
    """Plain version of cd_streamed: ops/fss.elastic_net_cd."""
    return elastic_net_cd(xtx, xty, beta0, lam, alpha, tol, max_sweeps)


def cd_streamed(xtx: torch.Tensor, xty: torch.Tensor, beta0: torch.Tensor,
                lam, alpha, tol, max_sweeps: int = 200,
                lanes: int = 0) -> torch.Tensor:
    """Per-gene elastic net by cold strong-rule CD on streamed grams.

    xtx (K, K, M) per-gene grams, gene axis last, symmetric
    (kernels/gram.col_gram_xty); xty, beta0 (K, M); all f32, coordinates in
    the sweep order; any K.  Returns beta (K, M).  lanes: the kernel's
    group width L (P = 32 / L columns a warp; 128 past K = 128, one column
    a block), 0 for the one it runs at this K, else one of
    cd_streamed_widths(K) (it raises where not): a hook for tests and
    timings, as every width gives the same bits.  The plain version has no
    lanes.
    """
    if _lib.on_cpu("cd_streamed", xtx, xty, beta0):
        return cd_streamed_plain(xtx, xty, beta0, lam, alpha, tol, max_sweeps)
    K, M = xty.shape
    out = _lib.launch_on_grams("cd_streamed", "insider_cd_streamed", xtx,
                               (K, K, M), xty, beta0, *_f32(lam, alpha), tol,
                               max_sweeps, lanes, scratch_ints=(lanes,))
    cd_streamed.launches += 1
    return out


cd_streamed.launches = 0


def cd_streamed_widths(K: int, device=None) -> list:
    """[(L, columns an SM holds)] of cd_streamed's instances at this K, the
    one it runs first."""
    return _lib.widths("insider_cd_streamed_widths", K, device)


def cd_shared_plain(xtx, xty, beta0, lam, alpha, tol,
                    max_sweeps: int = 200) -> torch.Tensor:
    """Plain version of cd_shared: ops/fss.elastic_net_cd on the gram
    broadcast to every column (a view, not a copy)."""
    K, M = xty.shape
    return elastic_net_cd(xtx[:, :, None].expand(K, K, M), xty, beta0, lam,
                          alpha, tol, max_sweeps)


def cd_shared(xtx: torch.Tensor, xty: torch.Tensor, beta0: torch.Tensor,
              lam, alpha, tol, max_sweeps: int = 200,
              lanes: int = 0) -> torch.Tensor:
    """Per-gene elastic net by cold strong-rule CD against ONE (K, K) gram
    shared by every column: the dense column update.

    xtx (K, K), symmetric; xty, beta0 (K, M); all f32, coordinates in the
    sweep order; any K.  Returns beta (K, M).  lanes: the kernel's group
    width L, 0 for the one it runs at this K, else one of
    cd_shared_widths(K) (it raises where not), as for cd_streamed.
    """
    if _lib.on_cpu("cd_shared", xtx, xty, beta0):
        return cd_shared_plain(xtx, xty, beta0, lam, alpha, tol, max_sweeps)
    K = xty.shape[0]
    out = _lib.launch_on_grams("cd_shared", "insider_cd_shared", xtx, (K, K),
                               xty, beta0, *_f32(lam, alpha), tol, max_sweeps,
                               lanes, scratch_ints=(lanes,))
    cd_shared.launches += 1
    return out


cd_shared.launches = 0


def cd_shared_widths(K: int, device=None) -> list:
    """[(L, columns an SM sweeps at once)] of cd_shared's instances at this
    K, the one it runs first."""
    return _lib.widths("insider_cd_shared_widths", K, device)
