"""User-facing object API.

Counterpart of insider_tpu/api.py (R/insider.R:18-67,190-216): `Insider`
owns the data, the seeded train/test element split and the confounder matrix
with the interaction pseudo-confounder inserted; `.tune()` runs the two-stage
rank / (lambda, alpha) search and `.fit()` the final fit (partition=1 masked,
partition=0 dense) on the object's device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from insider_tpu_torch.config import FitConfig
from insider_tpu_torch.data.splitter import ratio_splitter
from insider_tpu_torch.train import als


def build_interaction_codes(confounder: np.ndarray,
                            interaction_idx: Sequence[int]) -> np.ndarray:
    """1-based level codes of the interaction of the selected confounder
    columns, enumerated in first-appearance order (R/insider.R:34-39)."""
    sub = np.asarray(confounder)[:, list(interaction_idx)]
    _, first_idx, inv = np.unique(sub, axis=0, return_index=True,
                                  return_inverse=True)
    order = np.argsort(np.argsort(first_idx))
    return (order[inv.reshape(-1)] + 1).astype(np.int64)


class Insider:
    """INSIDER model object (R/insider.R:18).

    interaction_idx is 0-based.  The interaction pseudo-confounder is
    inserted as column 2 of the confounder matrix (R/insider.R:40).
    ctns_confounder: (N, P) continuous covariates, the C of C W (a 1-D
    array is one column), or None.  The positional parameters are the JAX
    package's, in its order; sharding is not ported (only None).  device
    (keyword-only): where the problem and the factors live: "cuda" (the
    default) runs the CUDA kernels and raises without a card, "cpu" runs
    their plain PyTorch versions.
    """

    def __init__(self, data: np.ndarray, confounder: np.ndarray,
                 ctns_confounder: Optional[np.ndarray] = None,
                 interaction_idx: Optional[Sequence[int]] = None,
                 split_ratio: float = 0.1, global_tol: float = 1e-9,
                 sub_tol: float = 1e-5, tuning_iter: int = 30,
                 max_iter: int = 50000, rm_na_col: bool = True,
                 split_seed: int = 123, seed: int = 0, sharding=None, *,
                 device="cuda"):
        als.check_unported(sharding=sharding)
        self.device = als.resolve_device(device)
        data = np.asarray(data, np.float64)
        confounder = np.asarray(confounder)
        if confounder.ndim == 1:
            confounder = confounder[:, None]
        if confounder.shape[0] != data.shape[0]:
            raise ValueError("confounder rows must match data rows")

        split = ratio_splitter(data, ratio=split_ratio, rm_na_col=rm_na_col,
                               seed=split_seed)
        self.split = split
        self.data = split.data

        if interaction_idx is not None:
            idx = list(interaction_idx)
            if len(idx) < 2:
                raise ValueError("interaction_idx must select at least 2 "
                                 "confounders (R/insider.R:45)")
            if max(idx) >= confounder.shape[1]:
                raise ValueError("interaction_idx out of range of "
                                 "confounder (R/insider.R:31)")
            inter = build_interaction_codes(confounder, idx)
            self.confounder = np.column_stack(
                [confounder[:, 0], inter, confounder[:, 1:]])
        else:
            self.confounder = confounder.copy()

        if ctns_confounder is not None:
            ctns = np.asarray(ctns_confounder, np.float64)
            self.ctns_confounder = ctns[:, None] if ctns.ndim == 1 else ctns
        else:
            self.ctns_confounder = None
        self.train_indicator = split.train_indicator
        self.test_indicator = split.test_indicator
        self.na_indicator = split.na_indicator
        self.params = dict(global_tol=global_tol, sub_tol=sub_tol,
                           tuning_iter=tuning_iter, max_iter=max_iter)
        self.seed = seed

        # populated by fit()
        self.cfd_matrices: Optional[List[np.ndarray]] = None
        self.column_factor: Optional[np.ndarray] = None
        self.test_rmse: Optional[float] = None
        self.fit_result: Optional[als.OptimizeResult] = None

    def tune(self, latent_dimension, lambda_=0.1, alpha=0.0, out_dir="."):
        """Two-stage rank / (lambda, alpha) search (R/insider.R:81-176)."""
        from insider_tpu_torch.tune.grid import tune as _tune

        return _tune(self, latent_dimension, lambda_, alpha, out_dir=out_dir)

    def fit(self, latent_dimension, lambda_, alpha, partition=0,
            verbose=True, log_jsonl=None, col_solver="auto", use_pallas=None,
            checkpoint_path=None, resume=False, mask_dtype=None,
            precompute=True, max_iter=None, *, state=None,
            cd_warm_start=True):
        """Final fit (R/insider.R:190-216).  partition=1: only the observed
        (train + test) elements drive the updates and the NA cells form the
        held-out "test" mask.  partition=0: the dense whole-matrix fit.
        (R/insider.R:207-209: train+test is passed as the train mask, NA as
        the test mask, partition as `tuning`.)  col_solver: "auto" | "fss" |
        "cd".  checkpoint_path (+ resume): boundary snapshots and resume
        from the last (train/als.optimize).  mask_dtype: the masks'
        storage, None (f32) or any numeric dtype: a 1-byte one (bool,
        int8, uint8) stores them as uint8, a quarter of the bytes, a wider
        one as f32; the same fit bit for bit (train/als.mask_storage).  precompute=False: no
        per-problem row constants, every confounder and covariate takes
        the segment-sum update (the memory-lean mode for shapes near the
        card's memory; train/als.build_problem).  With continuous
        covariates, cfd_matrices ends with W (P, K), as in the JAX
        package.  The positional parameters are the JAX package's, in its
        order.  use_pallas has no counterpart (the port runs the kernels
        on a CUDA device and their plain versions on the CPU) and must be
        None.
        Keyword-only, the port's own: cd_warm_start=False makes "cd" the
        reference's cold strong-rule CD (FitConfig.cd_warm_start); state:
        optional initial factors (model.state.state_from_numpy)."""
        if use_pallas is not None:
            raise ValueError(
                f"use_pallas={use_pallas!r}: the port has no such switch; it "
                "runs the CUDA kernels on a CUDA device and their plain "
                "versions on the CPU (ROADMAP, Port constraints); pass "
                "use_pallas=None")
        masked = bool(partition)
        cfg = FitConfig(
            latent_dim=int(latent_dimension), lambda1=float(lambda_),
            lambda2=float(lambda_), alpha=float(alpha), masked=masked,
            global_tol=self.params["global_tol"],
            sub_tol=self.params["sub_tol"],
            max_iter=int(self.params["max_iter"] if max_iter is None
                         else max_iter),
            seed=self.seed, col_solver=col_solver,
            cd_warm_start=cd_warm_start)
        indicator = self.train_indicator + self.test_indicator
        problem = als.build_problem(self.data, self.confounder, indicator,
                                    self.na_indicator, self.ctns_confounder,
                                    masked=masked, mask_dtype=mask_dtype,
                                    precompute=precompute, device=self.device)
        result = als.optimize(problem, cfg, state=state, verbose=verbose,
                              log_jsonl=log_jsonl,
                              checkpoint_path=checkpoint_path, resume=resume)
        self.cfd_matrices = result.row_matrices
        if result.ctns_factor is not None:
            self.cfd_matrices = self.cfd_matrices + [result.ctns_factor]
        self.column_factor = result.column_factor
        self.test_rmse = result.test_rmse
        self.fit_result = result
        return self

    def tuning_problem(self) -> als.Problem:
        """The masked problem used by tune(): train vs held-out test."""
        return als.build_problem(self.data, self.confounder,
                                 self.train_indicator, self.test_indicator,
                                 self.ctns_confounder, masked=True,
                                 device=self.device)


FitResult = als.OptimizeResult
