"""Synthetic data generation with planted ground-truth factors.

Port of the only self-contained validation path in the reference:
tests/simulation.rmd:19-74 — a (v1_num*v2_num) x gene_num matrix generated
from known rank-K factors for two crossed confounders plus their interaction,
with 30% exact-zero columns in the gene factor and gaussian noise.  Recovery
of the planted structure is the correctness check (SURVEY.md §4).

Also provides a scale-parameterized generator for benchmarks (the 50k x 200k
and 500k x 1M synthetic configs of BASELINE.json).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class SimulatedData:
    data: np.ndarray          # (N, M) expr + noise
    expr: np.ndarray          # (N, M) noiseless signal
    confounder: np.ndarray    # (N, C) integer level codes, 1-based like the
                              # reference (README.md:72: "integer and > 0")
    factors: Tuple[np.ndarray, ...]   # planted row-side factors (L_v, K)
    gene_factor: np.ndarray   # planted (K, M)


def simulate_insider_data(
    v1_num: int = 50,
    v2_num: int = 5,
    gene_num: int = 200,
    latent_dim: int = 5,
    noise_std: float = 1.0,
    gene_sparsity: float = 0.3,
    seed: int = 0,
    with_interaction: bool = True,
) -> SimulatedData:
    """The simulation.rmd design: rows = full v1 x v2 cross, one row each."""
    rng = np.random.default_rng(seed)
    n = v1_num * v2_num

    v1_codes = np.repeat(np.arange(1, v1_num + 1), v2_num)       # :40-45
    v2_codes = np.tile(np.arange(1, v2_num + 1), v1_num)
    inter_codes = np.arange(1, n + 1)                            # all rows unique

    v1_rep = rng.standard_normal((v1_num, latent_dim))
    v2_rep = rng.standard_normal((v2_num, latent_dim))
    gene_rep = rng.standard_normal((latent_dim, gene_num))
    zero_cols = rng.choice(gene_num, int(gene_sparsity * gene_num), replace=False)
    gene_rep[:, zero_cols] = 0.0                                  # :25-26

    factors = [v1_rep, v2_rep]
    expr = v1_rep[v1_codes - 1] @ gene_rep + v2_rep[v2_codes - 1] @ gene_rep
    cols = [v1_codes, v2_codes]
    if with_interaction:
        inter_rep = rng.standard_normal((n, latent_dim))
        expr = expr + inter_rep[inter_codes - 1] @ gene_rep       # :59-61
        factors.append(inter_rep)
        cols.append(inter_codes)

    noise = noise_std * rng.standard_normal((n, gene_num))
    return SimulatedData(
        data=expr + noise,
        expr=expr,
        confounder=np.stack(cols, axis=1).astype(np.int64),
        factors=tuple(factors),
        gene_factor=gene_rep,
    )


def simulate_scale(
    n_rows: int,
    n_cols: int,
    latent_dim: int,
    level_counts: Tuple[int, ...] = (8, 32),
    noise_std: float = 1.0,
    gene_sparsity: float = 0.3,
    seed: int = 0,
    dtype=np.float32,
) -> SimulatedData:
    """Benchmark-scale generator: arbitrary shape, arbitrary confounders.

    Memory-light: builds the matrix in one pass as sums of gathered factor
    rows times the gene factor.
    """
    rng = np.random.default_rng(seed)
    gene_rep = rng.standard_normal((latent_dim, n_cols)).astype(dtype)
    zero_cols = rng.choice(n_cols, int(gene_sparsity * n_cols), replace=False)
    gene_rep[:, zero_cols] = 0.0

    factors, cols = [], []
    row_factor = np.zeros((n_rows, latent_dim), dtype)
    for lv in level_counts:
        v = rng.standard_normal((lv, latent_dim)).astype(dtype)
        c = rng.integers(1, lv + 1, size=n_rows)
        factors.append(v)
        cols.append(c)
        row_factor += v[c - 1]

    expr = row_factor @ gene_rep
    data = expr + noise_std * rng.standard_normal((n_rows, n_cols)).astype(dtype)
    return SimulatedData(
        data=data,
        expr=expr,
        confounder=np.stack(cols, axis=1).astype(np.int64),
        factors=tuple(factors),
        gene_factor=gene_rep,
    )
