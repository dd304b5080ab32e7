"""Factor state and its initialization.

Counterpart of insider_tpu/model/state.py.  The JAX state is a pytree that
also threads a PRNG key through the CD sweep permutations; the port's FSS
column path draws no random numbers, so the state is the factors alone.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class InsiderState:
    """Factor state for one optimize() run.

    cfd_factors: one (L_v, K) factor per discrete confounder (incl. the
      interaction pseudo-confounder) — the V_v of `cfd_matrices`
      (src/optimize.cpp:281-291).
    ctns_factor: (P, K) continuous-covariate coefficients W, or None.
    column_factor: (K, M) shared gene factor F.
    """

    cfd_factors: List[torch.Tensor]
    ctns_factor: Optional[torch.Tensor]
    column_factor: torch.Tensor

    @property
    def latent_dim(self) -> int:
        return self.column_factor.shape[0]


def init_state(generator: torch.Generator, n_levels: Sequence[int],
               n_cols: int, latent_dim: int, n_ctns: int = 0,
               init_std: float = 1e-3) -> InsiderState:
    """Fresh N(0, init_std^2) factors (R/utils.R:40-43), drawn from
    `generator` on its own device in f32: the confounder factors, then W
    (n_ctns, latent_dim) when n_ctns > 0, then F -- the JAX package's
    order (insider_tpu/model/state.py:58-84)."""
    def draw(*shape):
        return init_std * torch.randn(*shape, generator=generator,
                                      device=generator.device,
                                      dtype=torch.float32)

    cfd = [draw(lv, latent_dim) for lv in n_levels]
    ctns = draw(n_ctns, latent_dim) if n_ctns else None
    return InsiderState(cfd, ctns, draw(latent_dim, n_cols))


def state_from_numpy(cfd_factors: Sequence[np.ndarray],
                     ctns_factor: Optional[np.ndarray],
                     column_factor: np.ndarray,
                     device) -> InsiderState:
    """Carry factors from numpy (e.g. the JAX package's init_state) onto
    `device` as f32 tensors."""
    def put(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return InsiderState(
        [put(f) for f in cfd_factors],
        None if ctns_factor is None else put(ctns_factor),
        put(column_factor),
    )
