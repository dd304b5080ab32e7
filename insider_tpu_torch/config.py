"""Fit configuration of the PyTorch port.

Counterpart of insider_tpu/config.py.  The port runs a slice of the JAX
package's settings: the masked and the dense fit with the feature-sign-search
(FSS) column solver or the reference's strong-rule coordinate descent (CD),
ridge solves at alpha == 0, every check boundary decided on the host.
Settings outside that slice raise NotImplementedError when the config is
built, so a run never silently takes a path the port does not have.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Optimization hyperparameters for one `optimize` run.

    Mirrors the argument list of the reference's optimize()
    (src/optimize.cpp:256-257) plus the constants it hardcodes.
    """

    latent_dim: int = 10
    # Ridge penalty on all row-side factors (lambda1, src/utils.cpp:85).
    lambda1: float = 1.0
    # Elastic-net penalty on the gene/column factor (lambda2, src/utils.cpp:88-91).
    lambda2: float = 1.0
    # Elastic-net mixing: alpha*L1 + (1-alpha)*L2 (src/utils.cpp:88-91).
    alpha: float = 0.1
    # tuning==1: masked (train-only) updates; tuning==0: dense whole-matrix
    # fast path (src/optimize.cpp:150,178 and R `partition`, R/insider.R:209).
    # optimize() follows the problem's own flag (build_problem(masked=...)).
    masked: bool = True
    # Relative-loss stopping criterion, checked every `check_every` iterations
    # (src/optimize.cpp:381,405).
    global_tol: float = 1e-10
    # Base tolerance of the per-column elastic-net subproblem
    # (src/optimize.cpp:376; default 1e-5 at R/insider.R:18).
    sub_tol: float = 1e-5
    max_iter: int = 10000
    # Convergence/metrics cadence (src/optimize.cpp:327,381: `iter % 10`).
    check_every: int = 10
    # Check boundaries per host decision.  The port decides every boundary
    # on the host in float64, so 1 is the only value it runs.
    boundaries_per_dispatch: int = 1
    # Init distribution N(0, init_std^2) (R/utils.R:40-43).
    init_std: float = 1e-3
    seed: int = 0
    # Column sub-solver for alpha > 0: "fss" = the feature-sign search with
    # its polish (ops/fss.py); "cd" = strong-rule coordinate descent, the
    # reference's algorithm (coordinate_descent.cpp:57); "auto" = "fss".
    col_solver: str = "auto"
    # Safety cap on CD sweeps inside one column update (the reference loops
    # unboundedly, coordinate_descent.cpp:82-114).  KKT reactivation
    # (coordinate_descent.cpp:118-124) is folded into the same sweep loop
    # (ops/fss.elastic_net_cd), so this single cap bounds it too.
    max_cd_sweeps: int = 200
    # col_solver="cd" warm start: solve the sign pattern exactly with one
    # FSS pass first, then plain CD sweeps from that point (the FSS polish,
    # at most max_cd_sweeps) until the reference's stopping criterion
    # (per-column sweep decrease <= tol, coordinate_descent.cpp:112-114)
    # fires.  Same unique optimum, same stopping contract, far fewer sweeps
    # than cold CD (the JAX package measured the MEDIAN flagship column at
    # more than 200 cold sweeps).  False = the pure reference trajectory
    # (cold strong-rule CD, in the coordinate order train/als.draw_perm
    # draws for each column update).
    cd_warm_start: bool = True
    # Outer-step cap for the FSS solver.
    max_fss_outer: int = 48
    # Plain-CD polish after FSS, at optimize()'s effective sub_tol.
    fss_polish: bool = True
    max_fss_polish_sweeps: int = 32
    # Continuous-covariate CD stop: sum|delta w| < ctns_tol
    # (src/optimize.cpp:122), with a cap on its sweeps.
    ctns_tol: float = 1e-1
    max_ctns_sweeps: int = 100
    # The finiteness sanitizer of the JAX package is not ported yet.
    debug_checks: bool = False

    def __post_init__(self):
        if self.col_solver not in ("auto", "fss", "cd"):
            raise ValueError(f"col_solver must be auto|cd|fss, got "
                             f"{self.col_solver!r}")
        if self.debug_checks:
            raise NotImplementedError("debug_checks is not ported yet")
        if self.boundaries_per_dispatch != 1:
            raise NotImplementedError(
                "the port decides every boundary on the host: "
                "boundaries_per_dispatch must be 1")


def decay_from_delta_loss(delta_loss: float) -> float:
    """Map a 10-iter loss decrease to the sub_tol decay factor.

    Exact transliteration of the if-ladder at src/optimize.cpp:389-403.
    """
    d = delta_loss / 1000.0
    if d <= 1e-6:
        return 1e-6
    if d <= 1e-5:
        return 1e-5
    if d <= 1e-4:
        return 1e-4
    if d <= 1e-3:
        return 1e-3
    if d <= 1e-2:
        return 1e-2
    if d <= 1e-1:
        return 1e-1
    return 1.0
