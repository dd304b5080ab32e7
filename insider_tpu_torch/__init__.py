"""insider_tpu_torch -- the INSIDER fit in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

A port of the JAX package insider_tpu, which stays the reference.  The
factorization is

    X ~= (sum_v E_v V_v + C W) F

with per-level ridge row updates, ridge updates of the continuous
covariates' coefficients W, and a per-gene elastic-net column update solved
by feature-sign search or coordinate descent (ridge solves at alpha == 0).
On CUDA tensors the kernels of the fit (level grams, row Xty, the
covariates' K-space CD, the fused, streamed and shared-gram FSS and CD
column solves, the streamed column grams, masked eval) are CUDA C++ built
at first use from insider_tpu_torch/csrc/; on CPU tensors their plain
PyTorch versions run.

    Insider(...)            - model object (splitter + interaction setup)
    .tune(...)              - two-stage rank / (lambda, alpha) search
    .fit(...)               - final fit (partition=1 masked, partition=0 dense)
    optimize(...)           - the ALS loop
    tune(...)               - the search of .tune, on an Insider
    glm_interaction(...)    - per-level GLM inference after the fit
    save_checkpoint(...), load_checkpoint(...) - the fit state on disk
    fit_interaction(...)    - standalone unregularized per-level solve
    coordinate_descent(...), strong_coordinate_descent(...) - one elastic
                              net by cyclic CD (the reference's exports)
"""

from insider_tpu_torch.analysis.glm import glm_interaction
from insider_tpu_torch.api import FitResult, Insider
from insider_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from insider_tpu_torch.config import FitConfig
from insider_tpu_torch.data.simulate import (simulate_insider_data,
                                             simulate_scale)
from insider_tpu_torch.data.splitter import SplitResult, ratio_splitter
from insider_tpu_torch.model.state import (InsiderState, init_state,
                                           state_from_numpy)
from insider_tpu_torch.ops.row_update import fit_interaction
from insider_tpu_torch.ops.solvers import (coordinate_descent,
                                           strong_coordinate_descent)
from insider_tpu_torch.train.als import build_problem, optimize
from insider_tpu_torch.tune.grid import tune

__version__ = "0.1.0"

__all__ = [
    "Insider",
    "FitResult",
    "FitConfig",
    "ratio_splitter",
    "SplitResult",
    "simulate_insider_data",
    "simulate_scale",
    "InsiderState",
    "init_state",
    "state_from_numpy",
    "build_problem",
    "optimize",
    "tune",
    "glm_interaction",
    "save_checkpoint",
    "load_checkpoint",
    "fit_interaction",
    "coordinate_descent",
    "strong_coordinate_descent",
]
