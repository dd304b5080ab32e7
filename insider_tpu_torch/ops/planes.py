"""The exact bf16 splits of the tensor-core gram builds, in plain PyTorch.

The CUDA kernels csrc/level_gram.cu, csrc/fss.cu and csrc/col_gram_xty.cu
run f32 sums on the bf16 tensor cores (csrc/mma.cuh).  A bf16 x bf16
product is exact in f32, so a sum of products of exact bf16 planes,
accumulated in f32, is the f32 sum of the unsplit values up to the order of
summation:

  bf16_planes   an f32 value as hi + mid + lo, each plane rounded to nearest
                even from the remainder of the one before: the TPU kernels'
                insider_tpu/kernels/fss_pallas.py:_bf16_planes;
  count_planes  an integer count in [0, 2**24), f32's exact integer range,
                as hi = 65536 floor(c / 65536), mid = 256 floor((c - hi) /
                256) and lo = c - hi - mid, each exact in bf16; below 65536
                the kernel takes mid and lo alone (hi is 0);
  a 0/1 mask is exact in bf16 as it is.

planes_level_gram, planes_masked_gram and planes_col_gram_xty compute what
the kernels compute, plane product by plane product, with the plain f32
matmul as the accumulator (not bit for bit: the tensor cores round
otherwise).  They document the kernels' arithmetic and let the tests hold it
against the f32 plain versions, the f64 sums and the JAX package.  The fit
never calls them.
"""

from __future__ import annotations

from typing import Tuple

import torch

from insider_tpu_torch.ops.row_update import factor_outer_table


def bf16_planes(x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Exact three-way bf16 split of an f32 tensor: hi + mid + lo == x.
    Every plane is a multiple of x's f32 ulp, so for |x| >= 2**-103 all
    three are normal numbers."""
    hi = x.to(torch.bfloat16)
    r1 = x - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def count_planes(c: torch.Tensor, n: int = 3) -> Tuple[torch.Tensor, ...]:
    """Exact bf16 split of integer counts held in f32: n = 3 for counts in
    [0, 2**24), hi = 65536 floor(c / 65536), mid = 256 floor((c - hi) /
    256), lo = c - hi - mid; n = 2 for counts below 65536, (mid, lo).  Each
    step is exact in f32."""
    hi = torch.floor(c * (1.0 / 65536.0)) * 65536.0
    rest = c - hi
    mid = torch.floor(rest * (1.0 / 256.0)) * 256.0
    planes = (hi, mid, rest - mid)[3 - n:]
    return tuple(x.to(torch.bfloat16) for x in planes)


def planes_dot(lhs, rhs) -> torch.Tensor:
    """sum_a sum_b lhs[a] @ rhs[b] over bf16 planes, each product of two
    bf16 values exact in f32, accumulated in f32."""
    out = None
    for a in lhs:
        for b in rhs:
            term = torch.matmul(a.float(), b.float())
            out = term if out is None else out + term
    return out


def planes_level_gram(mw: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """level_gram as csrc/level_gram.cu computes it: the products of the
    count planes of Mw (L, M), two below 65536 and three above, and the
    three planes of F's outer-product table, summed in f32 -> (L, K, K)."""
    K = F.shape[0]
    table = factor_outer_table(F).T.contiguous()                 # (M, K^2)
    n = 2 if float(mw.max()) < 65536 else 3
    return planes_dot(count_planes(mw, n),
                      bf16_planes(table)).reshape(-1, K, K)


# col_gram_xty's k-step: the rows of one mma.sync m16n8k16 product.
K_STEP = 16


def planes_col_gram_xty(mask: torch.Tensor, data: torch.Tensor,
                        R: torch.Tensor):
    """col_gram_xty as csrc/col_gram_xty.cu computes it: the three planes of
    R's outer-product table over the K(K+1)/2 pairs k1 <= k2 against the
    bf16 mask, each k-step of K_STEP rows summed from zero in f32 (lo, then
    mid, then hi plane) and added into the running f32 sums, each pair's
    sums written to (k1, k2) and (k2, k1) -> (K, K, M), symmetric bit for
    bit; Xty (K, M) in f32, each k-step from zero and then added."""
    N, K = R.shape
    k1, k2 = torch.triu_indices(K, K, device=R.device)
    pad = (-N) % K_STEP

    def steps(x):                                    # (steps, K_STEP, cols)
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        return x.reshape(-1, K_STEP, x.shape[1])

    m = steps(mask.to(torch.float32))
    lo_mid_hi = [steps(p.float()).transpose(1, 2)
                 for p in reversed(bf16_planes(R[:, k1] * R[:, k2]))]
    step = None
    for p in lo_mid_hi:
        term = torch.bmm(p, m)
        step = term if step is None else step + term
    gram = torch.empty((K, K, mask.shape[1]), dtype=torch.float32,
                       device=R.device)
    sums = _running_sum(step)
    gram[k1, k2] = sums
    gram[k2, k1] = sums
    xty = _running_sum(torch.bmm(steps(R).transpose(1, 2),
                                 m * steps(data.to(torch.float32))))
    return gram, xty


def _running_sum(steps: torch.Tensor) -> torch.Tensor:
    """steps[0] + steps[1] + ... in f32, in order."""
    out = steps[0].clone()
    for s in steps[1:]:
        out += s
    return out


def planes_masked_gram(R: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The per-column masked grams as csrc/fss.cu computes them: the three
    planes of R's (K^2, N) outer-product table against the bf16 mask (N, M),
    summed in f32 -> (M, K, K), the layout of ops/col_update.col_gram_masked."""
    K = R.shape[1]
    table = factor_outer_table(R.T.contiguous())                 # (K^2, N)
    g = planes_dot(bf16_planes(table), [mask.to(torch.bfloat16)])
    return g.T.reshape(-1, K, K)
