"""Checkpoint / resume for ALS runs.

Counterpart of insider_tpu/checkpoint.py, in its format, so that a
checkpoint written by either package loads in the other: one .npz of the
factors (`cfd_<i>`, `ctns` when there are covariates, `column_factor`, and
`key`, which the JAX loader requires) plus a JSON sidecar `<path>.json` of
{n_cfd, has_ctns, iter, loss, extra}.  The port draws no JAX PRNG key: it
writes a zero uint32 (2,) key and ignores the key of a JAX checkpoint.  It
stores instead the state of its cold-CD coordinate-order generator
(train/als.draw_perm) as `perm_generator`, which the JAX loader ignores, so
that a resumed cold-CD fit continues the same order stream.  Both files are
written to a temporary name and renamed into place (os.replace).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from insider_tpu_torch.model.state import InsiderState, state_from_numpy


def save_checkpoint(path: str, state: InsiderState, it: int = 0,
                    loss: float = float("nan"), extra: Optional[dict] = None,
                    *, generator: Optional[torch.Generator] = None) -> None:
    """Write state to `path` (.npz) and `path`.json atomically.
    generator (keyword-only): a CPU generator whose state is stored beside
    the factors (the cold-CD order stream), or None."""
    arrays = {f"cfd_{i}": f.cpu().numpy()
              for i, f in enumerate(state.cfd_factors)}
    if state.ctns_factor is not None:
        arrays["ctns"] = state.ctns_factor.cpu().numpy()
    arrays["column_factor"] = state.column_factor.cpu().numpy()
    arrays["key"] = np.zeros(2, np.uint32)
    if generator is not None:
        arrays["perm_generator"] = generator.get_state().numpy()
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, path)
    meta = {"n_cfd": len(state.cfd_factors),
            "has_ctns": state.ctns_factor is not None,
            "iter": int(it), "loss": float(loss), "extra": extra or {}}
    tmp = path + ".json.tmp"
    with open(tmp, "w") as fh:
        json.dump(meta, fh)
    os.replace(tmp, path + ".json")


def load_checkpoint(path: str, *, device="cuda",
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[InsiderState, dict]:
    """Read (state, meta) from a checkpoint of either package, the factors
    as f32 tensors on `device`.  generator: a CPU generator that takes the
    stored order-stream state, where the checkpoint holds one (a JAX
    checkpoint does not: the generator is left as it is)."""
    with open(path + ".json") as fh:
        meta = json.load(fh)
    with np.load(path) as z:
        state = state_from_numpy(
            [z[f"cfd_{i}"] for i in range(meta["n_cfd"])],
            z["ctns"] if meta["has_ctns"] else None, z["column_factor"],
            device)
        if generator is not None and "perm_generator" in z.files:
            generator.set_state(torch.from_numpy(z["perm_generator"]))
    return state, meta
