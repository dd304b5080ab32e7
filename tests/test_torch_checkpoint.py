"""Checkpoint / resume of the port, within the port and across packages.

A checkpoint is the JAX package's .npz + .json pair (insider_tpu/
checkpoint.py), so each package loads the other's.  Within the port a run
stopped at a boundary and resumed equals the uninterrupted run bit for bit
(the state is f32 both in memory and on disk, the decay ladder and the
cold-CD order stream are restored), as tests/test_cli_checkpoint.py:54-89
checks for the JAX package.  Across packages the resumed runs agree at the
port's tolerance against the JAX package, per-boundary losses rtol 1e-5.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

import insider_tpu as it
from insider_tpu import checkpoint as jax_ckpt
from insider_tpu.config import FitConfig as JaxFitConfig
from insider_tpu.train import als as jax_als
import insider_tpu_torch as itt
from insider_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from insider_tpu_torch.config import FitConfig
from insider_tpu_torch.model.state import state_from_numpy
from insider_tpu_torch.train import als


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _data(seed=3, with_ctns=True):
    sim = it.simulate_insider_data(v1_num=6, v2_num=2, gene_num=30,
                                   latent_dim=2, seed=seed,
                                   with_interaction=False)
    c = (np.random.default_rng(seed).normal(size=(sim.data.shape[0], 2))
         if with_ctns else None)
    return sim.data, sim.confounder, c


def _port_problem(masked=True, **kw):
    data, confounder, c = _data(**kw)
    obj = itt.Insider(data, confounder, c, split_ratio=0.1, device="cpu")
    if masked:
        return obj.tuning_problem()
    return als.build_problem(obj.data, obj.confounder,
                             obj.train_indicator + obj.test_indicator,
                             obj.na_indicator, c, masked=False, device="cpu")


def _cfg(**kw):
    return FitConfig(**dict(dict(latent_dim=2, lambda1=1.0, lambda2=1.0,
                                 alpha=0.3, max_iter=50, global_tol=0.0),
                            **kw))


def test_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    state = state_from_numpy(
        [rng.standard_normal((3, 4)), rng.standard_normal((5, 4))],
        rng.standard_normal((2, 4)), rng.standard_normal((4, 9)), "cpu")
    gen = torch.Generator().manual_seed(5)
    torch.randperm(7, generator=gen)
    path = str(tmp_path / "state.npz")
    save_checkpoint(path, state, it=30, loss=1.5, extra={"decay": 1e-3},
                    generator=gen)
    assert not os.path.exists(path + ".tmp")
    assert not os.path.exists(path + ".json.tmp")
    gen2 = torch.Generator().manual_seed(0)
    got, meta = load_checkpoint(path, device="cpu", generator=gen2)
    for a, b in zip(state.cfd_factors + [state.ctns_factor,
                                         state.column_factor],
                    got.cfd_factors + [got.ctns_factor, got.column_factor]):
        assert b.dtype == torch.float32 and torch.equal(a, b)
    assert meta == {"n_cfd": 2, "has_ctns": True, "iter": 30, "loss": 1.5,
                    "extra": {"decay": 1e-3}}
    assert torch.equal(torch.randperm(7, generator=gen2),
                       torch.randperm(7, generator=gen))
    with np.load(path) as z:
        assert z["key"].dtype == np.uint32 and z["key"].shape == (2,)


def test_round_trip_without_covariates(tmp_path):
    state = state_from_numpy([np.ones((2, 3))], None, np.zeros((3, 5)), "cpu")
    path = str(tmp_path / "s.npz")
    save_checkpoint(path, state)
    got, meta = load_checkpoint(path, device="cpu")
    assert got.ctns_factor is None and not meta["has_ctns"]
    assert meta["iter"] == 0 and np.isnan(meta["loss"])


@pytest.mark.parametrize("solver,masked", [
    (dict(), True), (dict(col_solver="cd", cd_warm_start=False), True),
    (dict(), False), (dict(col_solver="cd", cd_warm_start=False), False)])
def test_resume_equals_uninterrupted_run(tmp_path, solver, masked):
    """Stopped at iteration 20 with a checkpoint and resumed to 50, the fit
    equals the uninterrupted one bit for bit, with the decay ladder engaged
    and, for cold CD, the coordinate-order stream continued."""
    prob = _port_problem(masked=masked)
    cfg = _cfg(masked=masked, **solver)
    full = als.optimize(prob, cfg, verbose=False)
    path = str(tmp_path / "state.npz")
    als.optimize(prob, dataclasses.replace(cfg, max_iter=20), verbose=False,
                 checkpoint_path=path)
    _, meta = load_checkpoint(path, device="cpu")
    assert meta["iter"] == 20 and meta["extra"]["decay"] < 1.0
    resumed = als.optimize(prob, cfg, verbose=False, checkpoint_path=path,
                           resume=True)
    assert resumed.history[1]["iter"] == 30
    full_by_iter = {h["iter"]: h for h in full.history}
    for h in resumed.history[1:]:
        assert h["loss"] == full_by_iter[h["iter"]]["loss"], h["iter"]
        assert h["decay"] == full_by_iter[h["iter"]]["decay"], h["iter"]
    # the resumed run's initial evaluation is the checkpoint's boundary
    assert resumed.history[0]["loss"] == full_by_iter[20]["loss"]
    for a, b in zip(resumed.row_matrices + [resumed.ctns_factor,
                                           resumed.column_factor],
                    full.row_matrices + [full.ctns_factor,
                                         full.column_factor]):
        np.testing.assert_array_equal(a, b)


def test_resume_without_checkpoint_starts_fresh(tmp_path):
    prob = _port_problem()
    cfg = _cfg(max_iter=10)
    path = str(tmp_path / "none.npz")
    a = als.optimize(prob, cfg, verbose=False)
    b = als.optimize(prob, cfg, verbose=False, checkpoint_path=path,
                     resume=True)
    assert [h["loss"] for h in a.history] == [h["loss"] for h in b.history]
    assert os.path.exists(path) and os.path.exists(path + ".json")


def test_insider_fit_takes_checkpoint_and_resume(tmp_path):
    data, confounder, c = _data()
    path = str(tmp_path / "fit.npz")
    obj = itt.Insider(data, confounder, c, device="cpu")
    obj.fit(2, 1.0, 0.3, partition=1, verbose=False, max_iter=20,
            checkpoint_path=path)
    _, meta = load_checkpoint(path, device="cpu")
    assert meta["iter"] == 20 and meta["has_ctns"]
    first = obj.fit_result.history
    obj.fit(2, 1.0, 0.3, 1, False, None, "auto", None, path, True,
            max_iter=40)
    assert obj.fit_result.history[0]["loss"] == first[-1]["loss"]
    assert [h["iter"] for h in obj.fit_result.history] == [-1, 30, 40]


def _jax_problem(masked=True):
    data, confounder, c = _data()
    obj = it.Insider(data, confounder, c, split_ratio=0.1)
    if masked:
        return obj.tuning_problem()
    return jax_als.build_problem(obj.data, obj.confounder,
                                 obj.train_indicator + obj.test_indicator,
                                 obj.na_indicator, c, masked=False)


def _jax_cfg(max_iter, masked=True):
    return JaxFitConfig(latent_dim=2, lambda1=1.0, lambda2=1.0, alpha=0.3,
                        masked=masked, max_iter=max_iter, global_tol=0.0,
                        use_pallas=False, boundaries_per_dispatch=1)


def _assert_tails_match(port, jax_res, after=20):
    p = {h["iter"]: h for h in port.history if h["iter"] > after}
    j = {h["iter"]: h for h in jax_res.history if h["iter"] > after}
    assert sorted(p) == sorted(j) and p
    for i in p:
        for fld in ("loss", "train_rmse"):
            assert p[i][fld] == pytest.approx(j[i][fld], rel=1e-5), (i, fld)


def _copy(path, to):
    """A second copy of a checkpoint: a resumed run overwrites its own."""
    for ext in ("", ".json"):
        shutil.copy(path + ext, to + ext)
    return to


@pytest.mark.parametrize("masked", [True, False])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, masked):
    path = str(tmp_path / "jax.npz")
    jax_als.optimize(_jax_problem(masked), _jax_cfg(20, masked),
                     verbose=False, checkpoint_path=path)
    jax_state, jmeta = jax_ckpt.load_checkpoint(path)
    port_path = _copy(path, str(tmp_path / "port.npz"))
    state, meta = load_checkpoint(port_path, device="cpu")
    assert meta == jmeta and meta["iter"] == 20
    for a, b in zip(jax_state.cfd_factors + [jax_state.ctns_factor,
                                             jax_state.column_factor],
                    state.cfd_factors + [state.ctns_factor,
                                         state.column_factor]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jres = jax_als.optimize(_jax_problem(masked), _jax_cfg(50, masked),
                            verbose=False, checkpoint_path=path, resume=True)
    pres = als.optimize(_port_problem(masked), _cfg(masked=masked),
                        verbose=False, checkpoint_path=port_path,
                        resume=True)
    assert pres.history[1]["iter"] == jres.history[1]["iter"] == 30
    _assert_tails_match(pres, jres)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    path = str(tmp_path / "port.npz")
    prob = _port_problem()
    als.optimize(prob, _cfg(max_iter=20), verbose=False,
                 checkpoint_path=path)
    jax_path = _copy(path, str(tmp_path / "jax.npz"))
    state, meta = load_checkpoint(path, device="cpu")
    jstate, jmeta = jax_ckpt.load_checkpoint(jax_path)
    assert jmeta == meta
    for a, b in zip(state.cfd_factors + [state.ctns_factor,
                                         state.column_factor],
                    jstate.cfd_factors + [jstate.ctns_factor,
                                          jstate.column_factor]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jres = jax_als.optimize(_jax_problem(), _jax_cfg(50), verbose=False,
                            checkpoint_path=jax_path, resume=True)
    pres = als.optimize(prob, _cfg(), verbose=False, checkpoint_path=path,
                        resume=True)
    assert pres.history[1]["iter"] == jres.history[1]["iter"] == 30
    _assert_tails_match(pres, jres)
