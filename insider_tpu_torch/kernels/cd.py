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
fss_shared.cu), all on the one cold-CD loop of csrc/fss_core.cuh
(cd_group_columns).  On CPU tensors it runs its plain version
(ops/fss.elastic_net_cd); a CUDA tensor never reaches the plain version.
`<wrapper>.launches` counts the kernel's launches.

Every kernel sweeps coordinates in the fixed order 0..K-1: the caller
permutes the problem to randomize it (ops/col_update.py).

The loop runs P = 32 / L columns on one warp, one to each group of L
lanes, the groups sweeping in lockstep.  cd_fused runs four columns a warp
(L = 8) and hands a group whose column converged the block's next column
at the next sweep boundary (csrc/fss.cu, header), as cd_shared does with
L = 8, 16 or 32 by K (csrc/fss_shared.cu); cd_streamed runs two columns a
warp (L = 16), with no refill (csrc/fss_streamed.cu, header).  The widths
cd_fused and cd_streamed have at a K are cd_fused_widths and
cd_streamed_widths; their `lanes` argument forces one, a hook for tests
and timings.  Each column's arithmetic, and so its bits, do not depend on
L, on the columns that share its warp or on when it was taken.
"""

from __future__ import annotations

import numpy as np
import torch

from insider_tpu_torch.kernels import _lib
from insider_tpu_torch.kernels.fss import FUSED_MAX_K, MAX_K, fused_mask
from insider_tpu_torch.ops.fss import elastic_net_cd


def _scalars(lam, alpha, tol):
    return (float(np.float32(lam)), float(np.float32(alpha)),
            float(np.float32(tol)))


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
    (the same bits either way, as for feature_sign_fused).  Each column's
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
    out = torch.empty((K, M), dtype=torch.float32, device=R.device)
    with torch.cuda.device(R.device):
        err = _lib.lib().insider_cd_fused(
            mask.data_ptr(), mask_is_u8, data.data_ptr(), R.data_ptr(),
            beta0.data_ptr(), out.data_ptr(), *_scalars(lam, alpha, tol),
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


def _launch_on_grams(what: str, c_entry: str, xtx, gram_shape, xty, beta0,
                     lam, alpha, tol, max_sweeps, *streamed):
    """Check the operands of a gram-input CD kernel and launch it (the
    streamed kernel also takes a column counter; `streamed`: its group
    width)."""
    _lib.require_cuda(what, xtx, xty, beta0)
    K, M = xty.shape
    if xtx.shape != gram_shape or beta0.shape != (K, M):
        raise ValueError(f"{what}: shapes do not agree")
    if K > MAX_K:
        raise ValueError(f"{what}: K={K} > {MAX_K} is not supported by the "
                         "CUDA kernel")
    out = torch.empty((K, M), dtype=torch.float32, device=xty.device)
    counter = [_lib.column_counter(xty).data_ptr()] if streamed else []
    with torch.cuda.device(xty.device):
        err = getattr(_lib.lib(), c_entry)(
            xtx.data_ptr(), xty.data_ptr(), beta0.data_ptr(), out.data_ptr(),
            *counter, *_scalars(lam, alpha, tol), M, K, int(max_sweeps),
            *streamed, _lib.stream(xty))
    _lib.check(err, what)
    return out


def cd_streamed_plain(xtx, xty, beta0, lam, alpha, tol,
                      max_sweeps: int = 200) -> torch.Tensor:
    """Plain version of cd_streamed: ops/fss.elastic_net_cd."""
    return elastic_net_cd(xtx, xty, beta0, lam, alpha, tol, max_sweeps)


def cd_streamed(xtx: torch.Tensor, xty: torch.Tensor, beta0: torch.Tensor,
                lam, alpha, tol, max_sweeps: int = 200,
                lanes: int = 0) -> torch.Tensor:
    """Per-gene elastic net by cold strong-rule CD on streamed grams.

    xtx (K, K, M) per-gene grams, gene axis last (kernels/gram.col_gram_xty);
    xty, beta0 (K, M); all f32, coordinates in the sweep order.  Returns
    beta (K, M).  lanes: the kernel's group width L, 0 for the one it runs
    at this K, else one of cd_streamed_widths(K) (it raises where not): a
    hook for tests and timings, as every width gives the same bits.  The
    plain version has no lanes.
    """
    if _lib.on_cpu("cd_streamed", xtx, xty, beta0):
        return cd_streamed_plain(xtx, xty, beta0, lam, alpha, tol, max_sweeps)
    K, M = xty.shape
    out = _launch_on_grams("cd_streamed", "insider_cd_streamed", xtx,
                           (K, K, M), xty, beta0, lam, alpha, tol, max_sweeps,
                           int(lanes))
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
              lam, alpha, tol, max_sweeps: int = 200) -> torch.Tensor:
    """Per-gene elastic net by cold strong-rule CD against ONE (K, K) gram
    shared by every column: the dense column update.

    xtx (K, K); xty, beta0 (K, M); all f32, coordinates in the sweep order.
    Returns beta (K, M).
    """
    if _lib.on_cpu("cd_shared", xtx, xty, beta0):
        return cd_shared_plain(xtx, xty, beta0, lam, alpha, tol, max_sweeps)
    K = xty.shape[0]
    out = _launch_on_grams("cd_shared", "insider_cd_shared", xtx, (K, K), xty,
                           beta0, lam, alpha, tol, max_sweeps)
    cd_shared.launches += 1
    return out


cd_shared.launches = 0
