"""Masked train/test element splitting.

Host-side (numpy) equivalent of `ratio_splitter` (R/utils.R:78-117): an
element-wise split of the data matrix — NaNs are excluded from both sets, a
seeded sample of `ratio` of the observed elements becomes the test set, and
(optionally) columns with no nonzero training entry are dropped.

Deviations from the reference, on purpose:
  * numpy Philox RNG instead of R's Mersenne seed-123 (R/utils.R:89); results
    are seed-deterministic but not bitwise-identical to R.  Parity targets are
    tolerance-based (SURVEY.md §6).
  * the reference keeps the *unfiltered* data while filtering the indicator
    matrices when columns are dropped (R/insider.R:25 vs R/utils.R:104-109),
    a latent dimension mismatch.  We filter everything consistently.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SplitResult:
    trainset: np.ndarray          # data with NaN and test entries zeroed
    testset: np.ndarray           # zeros except test entries
    train_indicator: np.ndarray   # uint8 {0,1}
    test_indicator: np.ndarray    # uint8 {0,1}
    na_indicator: np.ndarray      # uint8 {0,1}
    kept_cols: np.ndarray         # int indices of retained columns

    @property
    def data(self) -> np.ndarray:
        """Full matrix (train + test values), NaNs as 0 — what the driver
        consumes (R/insider.R:25-26 semantics, minus the ordering bug)."""
        return self.trainset + self.testset


def ratio_splitter(
    data: np.ndarray,
    ratio: float = 0.1,
    rm_na_col: bool = True,
    seed: int = 123,
) -> SplitResult:
    data = np.asarray(data, np.float64).copy()
    na = np.isnan(data)
    data[na] = 0.0
    train = ~na

    rng = np.random.default_rng(seed)
    observed = np.flatnonzero(~na.ravel())
    n_test = int(np.floor(observed.size * ratio))
    test_idx = rng.choice(observed, size=n_test, replace=False)
    del observed                      # (N M,) int64: free it before the sets

    test = np.zeros(data.shape, bool)
    test.ravel()[test_idx] = True
    train &= ~test

    testset = np.where(test, data, 0.0)
    trainset = np.where(train, data, 0.0)

    if rm_na_col:
        # Reference counts nonzero *values* per column of the test-zeroed data
        # (R/utils.R:102), not mask coverage — mirrored here.
        keep = (trainset != 0).sum(axis=0) > 0
    else:
        keep = np.ones(data.shape[1], bool)
    kept_cols = np.flatnonzero(keep)

    def sub(m):
        # every column kept: the array as it is, not a copy (a cohort-scale
        # matrix takes gigabytes a copy)
        return m if keep.all() else np.ascontiguousarray(m[:, keep])

    return SplitResult(
        trainset=sub(trainset),
        testset=sub(testset),
        train_indicator=sub(train).astype(np.uint8),
        test_indicator=sub(test).astype(np.uint8),
        na_indicator=sub(na).astype(np.uint8),
        kept_cols=kept_cols,
    )
