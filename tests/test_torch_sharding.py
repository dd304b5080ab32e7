"""The port's sharded fit on a 4-rank gloo group against the JAX package's
sharded fit and against the port's one-process fit.

The problem is tests/test_sharding.py's (16 x 128, K=3, levels (3, 5), 20
iterations), every fit from one numpy initial state (the JAX package's
init_state).  The port's fits run once, on four CPU processes joined by
gloo (tests/torch_dist.py, under a hard wall-clock limit), at the layouts
(1, 4), (2, 2) and (4, 1) (tests/torch_sharded_jobs.py); the JAX package's
on its 8-device virtual CPU mesh.  Besides the masked and dense fits,
every layout fits the settings of jobs.SETTINGS: every confounder on the
segment-sum route, precompute=False masked and dense, continuous
covariates masked and dense, a checkpointed fit resumed, and the clean
fit under debug_checks; and a NaN put into one rank's block makes every
rank raise the one-process fit's NonFiniteError.  Tolerances: against the
JAX package's sharded fit test_sharding.py's own (loss rel 1e-4, factors
rtol 5e-3 / atol 1e-4); against the port's one-process fit the
per-boundary losses within rel 1e-5 (MULTIPROC_r05.json's class: the sums
are the same, in another order); across the ranks, for a 1 x 1 layout
against no layout, and for a resumed fit against the uninterrupted one,
bit for bit.
"""

import shutil

import jax
import numpy as np
import pytest

import insider_tpu as it
import torch_dist
import torch_sharded_jobs as jobs
from insider_tpu import api as japi
from insider_tpu.checkpoint import load_checkpoint as jax_load_checkpoint
from insider_tpu.config import FitConfig as JaxFitConfig
from insider_tpu.config import ShardingConfig as JaxSharding
from insider_tpu.model.state import init_state as jax_init_state
from insider_tpu.train import als as jals
from insider_tpu_torch.config import ShardingConfig

N, M = 16, 128
FITS = ([(case, layout) for layout in jobs.LAYOUTS
         for case in jobs.EVERY_LAYOUT]
        + [(case, (2, 2)) for case in jobs.AT_2x2])


def _levels(confounder):
    return tuple(int(np.unique(confounder[:, c]).size)
                 for c in range(confounder.shape[1]))


def _jax_state(key, n_levels, m, n_ctns=0):
    st = jax_init_state(jax.random.PRNGKey(key), n_levels, m, jobs.K,
                        n_ctns=n_ctns)
    return ([np.asarray(f) for f in st.cfd_factors],
            None if st.ctns_factor is None else np.asarray(st.ctns_factor),
            np.asarray(st.column_factor))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    sim = it.simulate_scale(N, M, jobs.K, level_counts=(3, 5), seed=0)
    raw = sim.data.astype(np.float64)
    split = it.ratio_splitter(raw, ratio=0.1)
    levels = _levels(sim.confounder)
    states = {p: _jax_state(7, levels, M, p)
              for p in {0, *jobs.CTNS.values()}}
    obj = japi.Insider(raw, sim.confounder)
    icfd, _, iF = _jax_state(obj.seed, _levels(obj.confounder),
                             obj.data.shape[1])
    ctns = np.random.default_rng(17).standard_normal((N, 2))
    return dict(data=split.data, confounder=sim.confounder,
                train=split.train_indicator, test=split.test_indicator,
                states=states, raw=raw, insider_cfd=icfd, insider_F=iF,
                ctns=ctns, ckpt_dir=str(tmp_path_factory.mktemp("ckpt")))


@pytest.fixture(scope="module")
def one_process(inputs):
    out = {case: jobs.fit_case(inputs, case) for case in jobs.CASES}
    out["insider"] = jobs.insider_fit(inputs)
    out["insider ctns"] = jobs.insider_fit(inputs, ctns=True)
    return out


def _copy(path, to):
    """A copy of the checkpoint at path (its .npz and .json), at `to`."""
    for ext in ("", ".json"):
        shutil.copy(path + ext, to + ext)
    return to


@pytest.fixture(scope="module")
def ranks(inputs, one_process, tmp_path_factory):
    """What every rank's sharded fits gave, in rank order.  The group also
    resumes from a copy of the one-process fit's checkpoint at
    jobs.CKPT_AT."""
    src = _copy(jobs.ckpt_path(inputs, None, jobs.CKPT_AT),
                jobs.ckpt_path(inputs, None, "resume_src"))
    return torch_dist.spawn(4, "torch_sharded_jobs:sharding_job",
                            dict(inputs, one_process_ckpt=src),
                            tmp_path_factory.mktemp("sharding"))


def _jax_fit(inputs, case, layout):
    """The JAX package's fit of CASES[case] on the 8-device mesh; for
    "checkpoint_resume", resumed from a copy of the port's sharded
    checkpoint at jobs.CKPT_AT on the same layout."""
    build_kw, cfg_kw = jobs.CASES[case]
    P = jobs.CTNS.get(case, 0)
    with jobs.fast_budget(jals, 0 if case in jobs.SEGMENT_SUM
                          else jals._FAST_E_BYTES):
        problem = jals.build_problem(
            inputs["data"], inputs["confounder"], inputs["train"],
            inputs["test"], inputs["ctns"][:, :P] if P else None,
            sharding=JaxSharding(*layout), **build_kw)
    cfg = JaxFitConfig(**dict(jobs.BASE, **cfg_kw))
    if case == "checkpoint_resume":
        sharding = ShardingConfig(*layout)
        path = _copy(jobs.ckpt_path(inputs, sharding, jobs.CKPT_AT),
                     jobs.ckpt_path(inputs, sharding, "jax"))
        return jals.optimize(problem, cfg, verbose=False,
                             checkpoint_path=path, resume=True)
    state = jax_init_state(jax.random.PRNGKey(7), problem.n_levels, M,
                           jobs.K, n_ctns=P)
    return jals.optimize(problem, cfg, state=state, verbose=False)


def _same_boundaries(got, ref, rtol):
    assert [h[0] for h in got["history"]] == [h[0] for h in ref["history"]]
    np.testing.assert_allclose([h[1] for h in got["history"]],
                               [h[1] for h in ref["history"]], rtol=rtol)
    np.testing.assert_allclose([h[2] for h in got["history"]],
                               [h[2] for h in ref["history"]], rtol=rtol)


@pytest.mark.parametrize("case,layout", [
    (case, layout) for layout in jobs.LAYOUTS for case in ("masked", "dense")]
    + [("ridge", (2, 2))] + [(case, (2, 2)) for case in jobs.SETTINGS])
def test_sharded_fit_matches_jax_sharded(inputs, ranks, case, layout):
    """tests/test_sharding.py's check, the port's sharded fit in place of
    the JAX package's single-device one; with covariates W too."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    ref = _jax_fit(inputs, case, layout)
    got = ranks[0][case, layout]
    assert got["history"][-1][1] == pytest.approx(ref.loss, rel=1e-4)
    if case == "ridge":       # test_sharded_ridge_path holds the loss only
        return
    np.testing.assert_allclose(got["F"], ref.column_factor, rtol=5e-3,
                               atol=1e-4)
    for a, b in zip(got["V"], ref.row_matrices):
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=1e-4)
    assert (got["W"] is None) == (ref.ctns_factor is None)
    if got["W"] is not None:
        np.testing.assert_allclose(got["W"], ref.ctns_factor, rtol=5e-3,
                                   atol=1e-4)


@pytest.mark.parametrize("case,layout", FITS)
def test_sharded_fit_matches_one_process(ranks, one_process, case, layout):
    """Per-boundary losses and train RMSEs within rel 1e-5 of the port's
    one-process fit, and the same boundaries."""
    _same_boundaries(ranks[0][case, layout], one_process[case], 1e-5)


@pytest.mark.parametrize("case,layout", FITS)
def test_ranks_agree(ranks, case, layout):
    """Every rank leaves each boundary with the same sums, so the same
    decisions: history and n_iter equal bit for bit; the gathered F and
    the replicated V too."""
    first = ranks[0][case, layout]
    for out in ranks[1:]:
        got = out[case, layout]
        # (the dense fit's test RMSE is NaN: no test set)
        np.testing.assert_array_equal(got["history"], first["history"])
        assert got["n_iter"] == first["n_iter"]
        assert np.array_equal(got["F"], first["F"])
        assert got["F"].shape == (jobs.K, M)
        for a, b in zip(got["V"], first["V"]):
            assert np.array_equal(a, b)
        assert np.array_equal(got["W"], first["W"])


@pytest.mark.parametrize("layout", jobs.UNCHAINED_LAYOUTS)
def test_sharded_chain_is_bit_for_bit_the_unchained(ranks, layout):
    """On every rank the chained fit (boundaries_per_dispatch=5, each
    boundary decided on the device from the all-reduced f64 sums) equals
    the fit of one boundary a dispatch, bit for bit."""
    for out in ranks:
        got, ref = out["masked", layout], out["masked_unchained", layout]
        np.testing.assert_array_equal(got["history"], ref["history"])
        assert (got["n_iter"], got["converged"]) == (ref["n_iter"],
                                                     ref["converged"])
        assert np.array_equal(got["F"], ref["F"])
        for a, b in zip(got["V"], ref["V"]):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("case", sorted(jobs.CASES))
def test_one_by_one_layout_is_bit_for_bit(inputs, one_process, case):
    """ShardingConfig(1, 1) with no process group fits what no sharding
    fits, bit for bit: every collective is a no-op on one rank."""
    got = jobs.fit_case(inputs, case, ShardingConfig(1, 1))
    ref = one_process[case]
    np.testing.assert_array_equal(got["history"], ref["history"])
    assert np.array_equal(got["F"], ref["F"])
    for a, b in zip(got["V"], ref["V"]):
        assert np.array_equal(a, b)
    assert np.array_equal(got["W"], ref["W"])


def test_insider_sharded_fit_matches_jax_and_one_process(inputs, ranks,
                                                          one_process):
    """Insider(..., sharding=ShardingConfig(2, 2)).fit(...) against the
    JAX package's Insider on the same layout (test_sharding.py's
    tolerances) and against the port's one-process Insider (rel 1e-5 a
    boundary)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    ref = japi.Insider(inputs["raw"], inputs["confounder"],
                       max_iter=jobs.ITERS, sharding=JaxSharding(2, 2))
    ref.fit(jobs.K, 1.0, 0.4, partition=1, verbose=False)
    for out in ranks:
        got = out["insider"]
        _same_boundaries(got, one_process["insider"], 1e-5)
        assert got["history"][-1][1] == pytest.approx(ref.fit_result.loss,
                                                      rel=1e-4)
        np.testing.assert_allclose(got["F"], ref.column_factor, rtol=5e-3,
                                   atol=1e-4)


def test_insider_sharded_fit_with_covariates_matches_one_process(
        ranks, one_process):
    """Insider(raw, confounder, ctns, sharding=ShardingConfig(2, 2)).fit
    from the state it draws: every rank within rel 1e-5 a boundary of the
    one-process Insider, W the same on every rank."""
    ref = one_process["insider ctns"]
    for out in ranks:
        got = out["insider ctns"]
        _same_boundaries(got, ref, 1e-5)
        assert got["W"].shape == (2, jobs.K)
        assert np.array_equal(got["W"], ranks[0]["insider ctns"]["W"])
        np.testing.assert_allclose(got["W"], ref["W"], rtol=5e-3, atol=1e-4)


@pytest.mark.parametrize("layout", jobs.LAYOUTS)
def test_sharded_resume_is_bit_for_bit_the_uninterrupted_fit(ranks, layout):
    """On every rank, the fit checkpointed at boundary 10 and resumed to 20
    equals the uninterrupted fit of the same layout bit for bit: each
    boundary, the restored state's loss (boundary 10's) and the factors."""
    for out in ranks:
        got, ref = out["checkpoint_resume", layout], out["masked", layout]
        np.testing.assert_array_equal(got["history"], ref["history"])
        at = [h for h in ref["history"] if h[0] == jobs.CKPT_AT]
        assert got["restored"][1:] == at[0][1:]
        assert np.array_equal(got["F"], ref["F"])
        for a, b in zip(got["V"], ref["V"]):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("layout", jobs.LAYOUTS)
def test_sharded_checkpoint_is_written_once_with_the_whole_F(ranks,
                                                             layout):
    """Rank 0 alone writes the checkpoint, once a boundary (0 and 10, then
    20 after the resume), and the file holds the whole (K, M) F: at the
    end the fit's gathered F, bit for bit."""
    for r, out in enumerate(ranks):
        got = out["checkpoint_resume", layout]
        assert got["writes"] == ([0, jobs.CKPT_AT, jobs.ITERS] if r == 0
                                 else [])
        assert got["file_F"].shape == (jobs.K, M)
        assert np.array_equal(got["file_F"], got["F"])


def test_sharded_checkpoint_loads_in_jax(inputs, ranks):
    """The JAX package's load_checkpoint reads the 2 x 2 fit's checkpoint
    at boundary 10: its meta, and the factors the port reads, with the
    whole F.  (test_sharded_fit_matches_jax_sharded resumes the JAX
    package's sharded fit from it.)"""
    from insider_tpu_torch.checkpoint import load_checkpoint

    path = jobs.ckpt_path(inputs, ShardingConfig(2, 2), jobs.CKPT_AT)
    jstate, jmeta = jax_load_checkpoint(path)
    state, meta = load_checkpoint(path, device="cpu")
    assert jmeta == meta and meta["iter"] == jobs.CKPT_AT
    assert np.asarray(jstate.column_factor).shape == (jobs.K, M)
    for a, b in zip(state.cfd_factors + [state.column_factor],
                    jstate.cfd_factors + [jstate.column_factor]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_one_process_checkpoint_resumes_a_sharded_fit(ranks, one_process):
    """The 2 x 2 fit resumed from the one-process fit's checkpoint at
    boundary 10 restores its loss and ends within rel 1e-5 of the
    one-process resumed fit, alike on every rank."""
    ref = {h[0]: h for h in one_process["checkpoint_resume"]["history"]}
    for out in ranks:
        got = out["resumed from one process"]
        assert [h[0] for h in got["history"]] == [-1, jobs.ITERS]
        np.testing.assert_array_equal(
            got["history"], ranks[0]["resumed from one process"]["history"])
        for h, it_ in zip(got["history"], (jobs.CKPT_AT, jobs.ITERS)):
            np.testing.assert_allclose(h[1:3], ref[it_][1:3], rtol=1e-5)


def test_sharded_checkpoint_resumes_a_one_process_fit(inputs, ranks):
    """The one-process fit resumed from the 2 x 2 fit's checkpoint at
    boundary 10 ends within rel 1e-5 of the sharded resumed fit."""
    src = _copy(jobs.ckpt_path(inputs, ShardingConfig(2, 2), jobs.CKPT_AT),
                jobs.ckpt_path(inputs, None, "from_2x2"))
    got = jobs.resume_case(inputs, src)
    ref = {h[0]: h for h in ranks[0]["checkpoint_resume", (2, 2)]["history"]}
    assert [h[0] for h in got["history"]] == [-1, jobs.ITERS]
    for h, it_ in zip(got["history"], (jobs.CKPT_AT, jobs.ITERS)):
        np.testing.assert_allclose(h[1:3], ref[it_][1:3], rtol=1e-5)


def test_failed_checkpoint_write_raises_on_every_rank(inputs, ranks):
    """Rank 0's write of a 2 x 2 fit's checkpoint raising ValueError: rank
    0 raises it, every other rank an OSError naming the file, and the
    group then fits on (no rank was left in a collective: the ranks'
    "insider" fits)."""
    path = jobs.ckpt_path(inputs, ShardingConfig(2, 2), "failed")
    for r, out in enumerate(ranks):
        got = out["failed save"]
        if r == 0:
            assert got == dict(type="ValueError",
                               message="rank 0's write failed")
        else:
            assert got["type"] == "OSError" and repr(path) in got["message"]
        np.testing.assert_array_equal(out["insider"]["history"],
                                      ranks[0]["insider"]["history"])


@pytest.mark.parametrize("layout", jobs.LAYOUTS)
def test_nan_in_one_rank_block_raises_on_every_rank(inputs, ranks, layout):
    """debug_checks with a NaN put into rank 1's data block after the
    initial loss: every rank raises the NonFiniteError the one-process fit
    raises for the same element, the column update's (rank 1's F block
    alone is not finite where the layout has one row block), after the
    same collectives (none is left open: the group then fits on, ranks'
    "insider" fits)."""
    ref = jobs.poisoned_fit(inputs, layout, sharded=False)
    assert ref["message"] == ("non-finite values produced by column "
                              "update F (optimize_col)")
    for out in ranks:
        got = out["poisoned", layout]
        assert got["message"] == ref["message"]
        assert got["at"] == ref["at"]
        assert got["collectives"] == ranks[0]["poisoned",
                                               layout]["collectives"] > 0
