"""The port's entry points take the JAX package's positional parameters.

Insider.__init__, Insider.fit, Insider.tune, train/als.build_problem,
train/als.build_problem_distributed, train/als.optimize, fit_interaction,
the two CD solvers, FitConfig and tune/grid.tune of insider_tpu_torch
bind every positional
argument of the reference's signature to the same name at the same
position, with the reference's defaults; the port's own parameters are keyword-only; every
combination with `sharding` runs, and on a 1 x 1 layout gives what the
call without a sharding gives; use_pallas has no counterpart and must be
None.
"""

import dataclasses
import importlib
import inspect
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import insider_tpu_torch as itt
from insider_tpu import api as japi
from insider_tpu.config import FitConfig as JaxFitConfig
from insider_tpu.ops import row_update as jrow
from insider_tpu.ops import solvers as jsolvers
from insider_tpu.train import als as jals
from insider_tpu_torch.config import FitConfig, ShardingConfig
from insider_tpu_torch.train import als

ENTRIES = {
    "Insider.__init__": (japi.Insider.__init__, itt.Insider.__init__),
    "Insider.fit": (japi.Insider.fit, itt.Insider.fit),
    "Insider.tune": (japi.Insider.tune, itt.Insider.tune),
    "build_problem": (jals.build_problem, als.build_problem),
    "build_problem_distributed": (jals.build_problem_distributed,
                                  als.build_problem_distributed),
    "optimize": (jals.optimize, als.optimize),
    "coordinate_descent": (jsolvers.coordinate_descent,
                           itt.coordinate_descent),
    "strong_coordinate_descent": (jsolvers.strong_coordinate_descent,
                                  itt.strong_coordinate_descent),
    "fit_interaction": (jrow.fit_interaction, itt.fit_interaction),
    "FitConfig": (JaxFitConfig, FitConfig),
    "tune": (importlib.import_module("insider_tpu.tune.grid").tune,
             importlib.import_module("insider_tpu_torch.tune.grid").tune),
}
POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
              inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _positional(fn):
    return [p for p in inspect.signature(fn).parameters.values()
            if p.kind in POSITIONAL and p.name != "self"]


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_positional_parameters_bind_alike(entry):
    ref, port = (_positional(f) for f in ENTRIES[entry])
    assert [p.name for p in port] == [p.name for p in ref]
    for r, p in zip(ref, port):
        if r.name == "dtype":            # jnp.float32 -> torch.float32
            assert np.dtype(r.default) == np.float32
            assert p.default is torch.float32
        else:
            assert p.default == r.default, r.name


@pytest.mark.parametrize("entry,name", [
    ("Insider.__init__", "device"), ("Insider.fit", "state"),
    ("Insider.fit", "cd_warm_start"), ("build_problem", "device"),
    ("build_problem_distributed", "device"), ("optimize", "generator")])
def test_port_only_parameters_are_keyword_only(entry, name):
    ref, port = (inspect.signature(f).parameters for f in ENTRIES[entry])
    assert name not in ref
    assert port[name].kind == inspect.Parameter.KEYWORD_ONLY
    extra = {n for n, p in port.items() if n not in ref}
    assert all(port[n].kind == inspect.Parameter.KEYWORD_ONLY for n in extra)


def _data(seed=0, n=24, m=30):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, m))
    confounder = np.column_stack([rng.integers(0, 2, n),
                                  rng.integers(0, 3, n)])
    return data, confounder


def _obj():
    data, confounder = _data()
    return itt.Insider(data, confounder, device="cpu")


def _problem():
    obj = _obj()
    return als.build_problem(obj.data, obj.confounder, obj.train_indicator,
                             obj.test_indicator, device="cpu")


def _config():
    return FitConfig(latent_dim=2, lambda1=1.0, lambda2=1.0, alpha=0.4,
                     max_iter=2)


CALLS = {
    "Insider.__init__": lambda **kw: itt.Insider(*_data(), device="cpu",
                                                 **kw),
    "Insider.fit": lambda **kw: _obj().fit(2, 1.0, 0.4, verbose=False,
                                           max_iter=2, **kw),
    "build_problem": lambda **kw: als.build_problem(
        *_data(), np.ones((24, 30)), np.zeros((24, 30)), device="cpu", **kw),
    "optimize": lambda **kw: als.optimize(_problem(), _config(),
                                          verbose=False, **kw),
}


def _problem_of(sharding):
    obj = _obj()
    return als.build_problem(obj.data, obj.confounder, obj.train_indicator,
                             obj.test_indicator, sharding=sharding,
                             device="cpu")


def _segment_sum_fit(sharding, path):
    saved = als._FAST_E_BYTES
    als._FAST_E_BYTES = 0          # every confounder past the budget
    try:
        problem = CALLS["build_problem"](sharding=sharding)
    finally:
        als._FAST_E_BYTES = saved
    assert problem.d == [None, None]
    return problem, als.optimize(problem, _config(), verbose=False)


def _resumed(sharding, path):
    problem = _problem_of(sharding)
    als.optimize(problem, _config(), verbose=False, checkpoint_path=path)
    return als.optimize(problem, dataclasses.replace(_config(), max_iter=4),
                        verbose=False, checkpoint_path=path, resume=True)


CTNS = np.linspace(0.0, 1.0, 24)
# each combination of `sharding` with another setting, as a call of
# (sharding, a checkpoint path)
SHARDED = {
    "Insider.__init__ ctns_confounder": lambda s, path: itt.Insider(
        *_data(), CTNS, sharding=s, device="cpu").fit(
            2, 1.0, 0.4, verbose=False, max_iter=2),
    "build_problem ctns_confounder": lambda s, path: CALLS["build_problem"](
        ctns_confounder=CTNS, sharding=s),
    "build_problem segment_sum": _segment_sum_fit,
    "build_problem no_precompute": lambda s, path: CALLS["build_problem"](
        sharding=s, precompute=False, masked=False),
    "Insider.fit no_precompute": lambda s, path: itt.Insider(
        *_data(), sharding=s, device="cpu").fit(
            2, 1.0, 0.4, verbose=False, max_iter=2, precompute=False),
    "Insider.fit checkpoint_path": lambda s, path: itt.Insider(
        *_data(), sharding=s, device="cpu").fit(
            2, 1.0, 0.4, verbose=False, max_iter=2, checkpoint_path=path),
    "optimize checkpoint_path": lambda s, path: als.optimize(
        _problem_of(s), _config(), verbose=False, checkpoint_path=path),
    "optimize resume": _resumed,
    "optimize debug_checks": lambda s, path: als.optimize(
        _problem_of(s), FitConfig(latent_dim=2, max_iter=2,
                                  debug_checks=True), verbose=False),
}


def _outcome(out):
    """What a call gave: a problem's constants, or a fit's losses and
    factors, with the checkpoint it saved."""
    if isinstance(out, tuple):
        return [_outcome(x) for x in out]
    if isinstance(out, als.Problem):
        return [out.d, out.mw_cat, out.max_level_count, out.counts,
                out.ctns, out.ctns_q, out.ctns_bc, out.ctns_dc, out.ctns_cc]
    res = out.fit_result if isinstance(out, itt.Insider) else out
    return [[h["loss"] for h in res.history], res.row_matrices,
            res.ctns_factor, res.column_factor]


def _same(a, b) -> bool:
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if a is None or isinstance(a, (int, float)):
        return a == b
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("call", sorted(SHARDED))
def test_sharded_combinations_run(call, tmp_path):
    """sharding is ported with every setting: each combination runs and,
    here on a 1 x 1 layout, gives what the call without a sharding gives,
    bit for bit, checkpoints too."""
    got = SHARDED[call](ShardingConfig(), str(tmp_path / "sharded.npz"))
    ref = SHARDED[call](None, str(tmp_path / "plain.npz"))
    assert _same(_outcome(got), _outcome(ref))
    if "checkpoint_path" in call or "resume" in call:
        with open(tmp_path / "sharded.npz.json") as fh, open(
                tmp_path / "plain.npz.json") as gh:
            assert json.load(fh) == json.load(gh)


def _losses(out):
    return [h["loss"] for h in _history(out)]


@pytest.mark.parametrize("value", [np.uint8, torch.uint8, jnp.uint8])
def test_build_problem_mask_dtype_runs(value):
    """mask_dtype is ported: the masks are stored as uint8, with the same
    values, and every row constant is the f32 problem's."""
    ref, got = CALLS["build_problem"](), CALLS["build_problem"](
        mask_dtype=value)
    assert got.train_mask.dtype == got.test_mask.dtype == torch.uint8
    assert torch.equal(got.train_mask.float(), ref.train_mask)
    assert torch.equal(got.mw_cat, ref.mw_cat)
    for a, b in zip(got.d, ref.d):
        assert torch.equal(a, b)


@pytest.mark.parametrize("partition", [1, 0])
def test_fit_mask_dtype_runs(partition):
    """Insider.fit with uint8 masks fits what it fits with f32 masks, bit
    for bit."""
    ref = _obj().fit(2, 1.0, 0.4, partition, False, max_iter=3)
    got = _obj().fit(2, 1.0, 0.4, partition, False, max_iter=3,
                     mask_dtype=np.uint8)
    assert _losses(got) == _losses(ref)


@pytest.mark.parametrize("value,stored", [
    (np.bool_, torch.uint8), (torch.bool, torch.uint8),
    (np.int8, torch.uint8), ("int8", torch.uint8),
    (np.float16, torch.float32), (torch.bfloat16, torch.float32),
    (jnp.bfloat16, torch.float32), ("bfloat16", torch.float32),
    (np.float64, torch.float32), (torch.int32, torch.float32),
    (np.float32, torch.float32)])
def test_build_problem_mask_dtype_any_numeric_runs(value, stored):
    """Every numeric mask_dtype the JAX package takes runs: a 1-byte one
    stores the masks as uint8, a wider one as f32, with the same values
    and the same row constants."""
    ref, got = CALLS["build_problem"](), CALLS["build_problem"](
        mask_dtype=value)
    assert got.train_mask.dtype == got.test_mask.dtype == stored
    assert torch.equal(got.train_mask.float(), ref.train_mask)
    assert torch.equal(got.test_mask.float(), ref.test_mask)
    assert torch.equal(got.mw_cat, ref.mw_cat)


def test_build_problem_mask_dtype_rejects_others():
    """A dtype that is not numeric cannot hold a 0/1 mask."""
    with pytest.raises(TypeError, match="mask_dtype"):
        CALLS["build_problem"](mask_dtype=np.str_)


@pytest.mark.parametrize("entry", ["Insider.fit", "build_problem"])
def test_precompute_runs(entry):
    """precompute=False is ported: no row constants are built, and the fit
    on the segment-sum route agrees with the fast one (rtol 1e-5: the same
    sums in another order)."""
    if entry == "build_problem":
        got = CALLS[entry](precompute=False)
        assert got.d == [None, None] and got.mw_cat is None
        assert got.row_order is None and got.ctns_q is None
        return
    ref = _obj().fit(2, 1.0, 0.4, 1, False, max_iter=3)
    got = _obj().fit(2, 1.0, 0.4, 1, False, max_iter=3, precompute=False)
    np.testing.assert_allclose(_losses(got), _losses(ref), rtol=1e-5)


def test_profile_dir_runs(tmp_path):
    """profile_dir is ported: the second step chunk is traced into it as
    Chrome JSON, and the fit's losses are those without it, bit for bit."""
    ref = CALLS["optimize"]()
    got = CALLS["optimize"](profile_dir=str(tmp_path / "prof"))
    assert _losses(got) == _losses(ref)
    (trace,) = (tmp_path / "prof").iterdir()
    assert trace.name == "trace_iter_1_2.json"
    assert "traceEvents" in json.loads(trace.read_text())


def _history(out):
    return (out.fit_result if isinstance(out, itt.Insider) else out).history


@pytest.mark.parametrize("entry", ["Insider.fit", "optimize"])
def test_checkpoint_path_runs(tmp_path, entry):
    """checkpoint_path is ported: the run saves its last boundary there."""
    path = str(tmp_path / "ckpt.npz")
    out = CALLS[entry](checkpoint_path=path)
    with open(path + ".json") as fh:
        assert json.load(fh)["iter"] == _history(out)[-1]["iter"] == 2


@pytest.mark.parametrize("entry", ["Insider.fit", "optimize"])
def test_resume_runs(tmp_path, entry):
    """resume is ported: with a checkpoint at the last boundary, the run
    evaluates the restored state and has nothing left to do; without one
    it starts fresh."""
    path = str(tmp_path / "ckpt.npz")
    fresh = _history(CALLS[entry](checkpoint_path=path, resume=True))
    assert [h["iter"] for h in fresh] == [-1, 0, 2]
    again = _history(CALLS[entry](checkpoint_path=path, resume=True))
    assert [h["iter"] for h in again] == [-1]
    assert again[0]["loss"] == fresh[-1]["loss"]


@pytest.mark.parametrize("value", [True, False])
def test_use_pallas_raises(value):
    with pytest.raises(ValueError, match="use_pallas"):
        CALLS["Insider.fit"](use_pallas=value)


def test_use_pallas_by_position_raises():
    """fit's eighth positional argument is the reference's use_pallas: the
    call below used to run the port with max_iter=0 and raise nothing."""
    obj = _obj()
    with pytest.raises(ValueError, match="use_pallas"):
        obj.fit(24, 11.0, 0.4, 1, True, None, "auto", False)
    assert obj.fit_result is None


@pytest.mark.parametrize("dtype", [None, np.float32, torch.float32,
                                   jnp.float32, "float32"])
def test_build_problem_takes_f32(dtype):
    ref, got = CALLS["build_problem"](), CALLS["build_problem"](dtype=dtype)
    assert torch.equal(got.data, ref.data)
    assert got.data.dtype == torch.float32


@pytest.mark.parametrize("dtype", [np.float64, torch.float64, jnp.bfloat16,
                                   "int8"])
def test_build_problem_rejects_other_dtypes(dtype):
    with pytest.raises(NotImplementedError, match="dtype"):
        CALLS["build_problem"](dtype=dtype)


def test_defaults_given_by_position_fit_alike():
    """Every reference parameter given its default by position computes
    what the call that leaves them out computes."""
    a, b = _obj(), _obj()
    a.fit(2, 1.0, 0.4, 1, False, max_iter=3)
    b.fit(2, 1.0, 0.4, 1, False, None, "auto", None, None, False, None,
          True, 3)
    assert b.fit_result.n_iter == a.fit_result.n_iter
    np.testing.assert_array_equal(b.column_factor, a.column_factor)
    assert b.fit_result.loss == a.fit_result.loss
