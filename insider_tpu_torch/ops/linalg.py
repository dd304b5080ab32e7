"""Small-K batched SPD solves.

Counterpart of insider_tpu/ops/linalg.py.  The JAX package unrolls a
Gauss-Jordan elimination because that suits the TPU's vector unit; on the
CPU and the GPU a batched Cholesky factorization does the same job.  Every
system here is SPD with a ridge term on the diagonal
(src/optimize.cpp:174: XtX.diag() += lambda).
"""

from __future__ import annotations

import torch


def spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b.  A: (..., K, K), b: (..., K) -> (..., K)."""
    # cholesky_ex: no host sync for the error flag; a non-SPD system gives
    # non-finite factors, which optimize()'s divergence abort catches.  The
    # two triangular solves (cuBLAS trsm on the card) in place of
    # cholesky_solve, whose batched form on the card (MAGMA's
    # spotrs_batched) allocates device memory at each call and so cannot
    # be captured in a CUDA graph (train/graph.py); eager and captured
    # fits solve alike.
    L, _ = torch.linalg.cholesky_ex(A)
    y = torch.linalg.solve_triangular(L, b.unsqueeze(-1), upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True).squeeze(-1)
