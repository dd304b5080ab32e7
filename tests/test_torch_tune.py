"""The port's two-stage tune() against the JAX package's serial tune()
(batch_grid=False), on a tiny grid: 2 ranks, then 2 lambdas x 2 alphas.

Both sides get the same problem and the same initial factors for every
trial: the port's state draw (tune/grid.draw_state) is replaced by the JAX
init_state of the trial's seed.  The JAX side runs its kernel path
(use_pallas=True, Pallas entries in interpret mode) and decides every
boundary on the host (boundaries_per_dispatch=1), as the port does.  CSV
rows agree to rtol 1e-5 in the RMSEs.
"""

import csv
import functools
import importlib
import os

import jax
import numpy as np
import pytest
import torch

import insider_tpu as it
import insider_tpu.kernels.eval_pallas as ep
import insider_tpu.kernels.fss_pallas as fsp
import insider_tpu.kernels.row_pallas as rp
import insider_tpu_torch as itt
from insider_tpu.config import FitConfig as JaxFitConfig
from insider_tpu.model.state import init_state as jax_init_state
from insider_tpu_torch.model.state import state_from_numpy

# each package's attribute `tune` is the function, not the module
jax_grid = importlib.import_module("insider_tpu.tune.grid")
grid = importlib.import_module("insider_tpu_torch.tune.grid")

RANKS, LAMBDAS, ALPHAS = [2, 4], [1.0, 2.0], [0.2, 0.5]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture()
def same_trials(monkeypatch):
    """The JAX tune on its kernel path in interpret mode, one host decision
    per boundary; the port's trials drawn from the JAX init_state."""
    for mod, name in ((rp, "row_xty_pallas"), (rp, "row_xty_chunked_pallas"),
                      (rp, "level_gram_pallas"),
                      (fsp, "feature_sign_fused_pallas"),
                      (ep, "masked_eval_pallas")):
        def interp(*args, _orig=getattr(mod, name), **kw):
            kw["interpret"] = True
            return _orig(*args, **kw)

        monkeypatch.setattr(mod, name, interp)
    monkeypatch.setattr(jax_grid, "FitConfig",
                        functools.partial(JaxFitConfig, use_pallas=True,
                                          boundaries_per_dispatch=1))

    def jax_draw(problem, rank, seed, init_std):
        st = jax_init_state(jax.random.PRNGKey(seed), problem.n_levels,
                            problem.shape[1], rank, init_std=init_std)
        return state_from_numpy([np.asarray(f) for f in st.cfd_factors],
                                None, np.asarray(st.column_factor),
                                problem.device)

    monkeypatch.setattr(grid, "draw_state", jax_draw)
    yield


def _read(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], np.asarray(rows[1:], np.float64)


def test_tune_matches_jax(same_trials, tmp_path):
    sim = it.simulate_scale(40, 120, 4, level_counts=(2, 4, 7),
                            noise_std=0.5, seed=3)
    data = sim.data.astype(np.float64)
    data[np.random.default_rng(6).random(data.shape) < 0.01] = np.nan
    kw = dict(interaction_idx=[0, 1], tuning_iter=5)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    jres = jax_grid.tune(it.Insider(data, sim.confounder, **kw), RANKS,
                         LAMBDAS, ALPHAS, out_dir=str(jdir), batch_grid=False)
    tres = itt.Insider(data, sim.confounder, device="cpu", **kw).tune(
        RANKS, LAMBDAS, ALPHAS, out_dir=str(tdir))

    assert tres["latent_rank"] == jres["latent_rank"]
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for name in os.listdir(jdir):
        th, trows = _read(tdir / name)
        jh, jrows = _read(jdir / name)
        assert th == jh
        n_keys = 2 if name.endswith("reg_tuning_result.csv") else 1
        np.testing.assert_array_equal(trows[:, :n_keys], jrows[:, :n_keys])
        np.testing.assert_allclose(trows[:, n_keys:], jrows[:, n_keys:],
                                   rtol=1e-5)
    for key in ("rank_tuning", "reg_tuning"):
        np.testing.assert_allclose(tres[key], jres[key], rtol=1e-5)
    # lambda varies fastest (R's expand.grid)
    assert [tuple(r[:2]) for r in tres["reg_tuning"]] == [
        (lam, al) for al in ALPHAS for lam in LAMBDAS]


def test_tune_rejects_scalar_grid():
    sim = it.simulate_scale(12, 20, 2, level_counts=(2, 3), seed=0)
    with pytest.raises(ValueError, match="length > 1"):
        itt.Insider(sim.data, sim.confounder, device="cpu").tune(4, 1.0, 0.5)
