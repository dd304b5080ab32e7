"""Single-problem solver entry points mirroring the reference's exported
C++ functions (src/RcppExports.cpp:112-119: `coordinate_descent`,
`strong_coordinate_descent`).

Counterpart of insider_tpu/ops/solvers.py: thin wrappers over the port's
cyclic CD (ops/fss.elastic_net_cd) on one column, in f32, numpy in and
numpy out, on `device` (keyword-only: "cuda", the default, or "cpu").  Each sweep visits the coordinates in its own
random order, as the JAX package's make_sweep_perms gives one a sweep
(insider_tpu/ops/col_update.py:81-88), drawn from a torch CPU generator
seeded with `seed`; the JAX PRNG stream itself cannot be reproduced, so
the two packages sweep in other orders and agree at convergence.
"""

from __future__ import annotations

import numpy as np
import torch

from insider_tpu_torch.ops.fss import elastic_net_cd

MAX_SWEEPS = 1000


def _solve_one(X, y, wstart, lam, alpha, tol, use_strong_rule, seed,
               device):
    from insider_tpu_torch.train.als import disable_tf32, resolve_device

    disable_tf32()
    device = resolve_device(device)
    X, y, w0 = (torch.as_tensor(np.asarray(a, np.float32), device=device)
                for a in (X, y, wstart))
    K = X.shape[1]
    gen = torch.Generator().manual_seed(int(seed))
    perms = torch.stack([torch.randperm(K, generator=gen)
                         for _ in range(MAX_SWEEPS)])
    beta = elastic_net_cd(torch.matmul(X.T, X)[:, :, None],
                          torch.matmul(X.T, y)[:, None], w0[:, None],
                          float(lam), float(alpha), float(tol), MAX_SWEEPS,
                          use_strong_rule=use_strong_rule, perms=perms)
    return beta[:, 0].cpu().numpy()


def coordinate_descent(X, y, wstart, lam, alpha, XtX=None, Xty=None,
                       tol=1e-5, seed=0, *, device="cuda"):
    """Plain cyclic CD (src/coordinate_descent.cpp:11-54).  The reference
    reads an uninitialized loss on its first convergence check (:28); here
    the first sweep always runs and convergence is decided from exact
    per-sweep decrements.  XtX and Xty are recomputed (kept for the
    signature)."""
    del XtX, Xty
    return _solve_one(X, y, wstart, lam, alpha, tol, False, seed, device)


def strong_coordinate_descent(X, y, wstart, lam, alpha, XtX=None, Xty=None,
                              tol=1e-5, seed=0, *, device="cuda"):
    """Strong-rule CD with KKT reactivation
    (src/coordinate_descent.cpp:57-127)."""
    del XtX, Xty
    return _solve_one(X, y, wstart, lam, alpha, tol, True, seed, device)
