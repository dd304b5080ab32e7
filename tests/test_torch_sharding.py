"""The port's sharded fit on a 4-rank gloo group against the JAX package's
sharded fit and against the port's one-process fit.

The problem is tests/test_sharding.py's (16 x 128, K=3, levels (3, 5), 20
iterations), every fit from one numpy initial state (the JAX package's
init_state).  The port's fits run once, on four CPU processes joined by
gloo (tests/torch_dist.py, under a hard wall-clock limit), at the layouts
(1, 4), (2, 2) and (4, 1) (tests/torch_sharded_jobs.py); the JAX package's
on its 8-device virtual CPU mesh.  Tolerances: against the JAX package's
sharded fit test_sharding.py's own (loss rel 1e-4, factors rtol 5e-3 /
atol 1e-4); against the port's one-process fit the per-boundary losses
within rel 1e-5 (MULTIPROC_r05.json's class: the sums are the same, in
another order); across the ranks, and for a 1 x 1 layout against no
layout, bit for bit.
"""

import jax
import numpy as np
import pytest

import insider_tpu as it
import torch_dist
import torch_sharded_jobs as jobs
from insider_tpu import api as japi
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


def _jax_state(key, n_levels, m):
    st = jax_init_state(jax.random.PRNGKey(key), n_levels, m, jobs.K)
    return [np.asarray(f) for f in st.cfd_factors], np.asarray(
        st.column_factor)


@pytest.fixture(scope="module")
def inputs():
    sim = it.simulate_scale(N, M, jobs.K, level_counts=(3, 5), seed=0)
    raw = sim.data.astype(np.float64)
    split = it.ratio_splitter(raw, ratio=0.1)
    cfd, F = _jax_state(7, _levels(sim.confounder), M)
    obj = japi.Insider(raw, sim.confounder)
    icfd, iF = _jax_state(obj.seed, _levels(obj.confounder),
                          obj.data.shape[1])
    return dict(data=split.data, confounder=sim.confounder,
                train=split.train_indicator, test=split.test_indicator,
                cfd=cfd, F=F, raw=raw, insider_cfd=icfd, insider_F=iF)


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """What every rank's sharded fits gave, in rank order."""
    return torch_dist.spawn(4, "torch_sharded_jobs:sharding_job", inputs,
                            tmp_path_factory.mktemp("sharding"))


@pytest.fixture(scope="module")
def one_process(inputs):
    out = {case: jobs.fit_case(inputs, case) for case in jobs.CASES}
    out["insider"] = jobs.insider_fit(inputs)
    return out


def _jax_fit(inputs, case, layout):
    """The JAX package's fit of CASES[case] on the 8-device mesh."""
    build_kw, cfg_kw = jobs.CASES[case]
    problem = jals.build_problem(
        inputs["data"], inputs["confounder"], inputs["train"],
        inputs["test"], sharding=JaxSharding(*layout), **build_kw)
    cfg = JaxFitConfig(**dict(jobs.BASE, **cfg_kw))
    state = jax_init_state(jax.random.PRNGKey(7), problem.n_levels, M,
                           jobs.K)
    return jals.optimize(problem, cfg, state=state, verbose=False)


def _same_boundaries(got, ref, rtol):
    assert [h[0] for h in got["history"]] == [h[0] for h in ref["history"]]
    np.testing.assert_allclose([h[1] for h in got["history"]],
                               [h[1] for h in ref["history"]], rtol=rtol)
    np.testing.assert_allclose([h[2] for h in got["history"]],
                               [h[2] for h in ref["history"]], rtol=rtol)


@pytest.mark.parametrize("case,layout", [
    (case, layout) for layout in jobs.LAYOUTS for case in jobs.EVERY_LAYOUT]
    + [("ridge", (2, 2))])
def test_sharded_fit_matches_jax_sharded(inputs, ranks, case, layout):
    """tests/test_sharding.py's check, the port's sharded fit in place of
    the JAX package's single-device one."""
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


REFUSED = {"ctns_confounder": "9a", "Insider ctns_confounder": "9a",
           "segment_sum": "9b", "no_precompute": "9c",
           "checkpoint_path": "9d", "resume": "9d", "debug_checks": "9e"}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_unported_combination_raises_on_every_rank(ranks, name):
    """Each combination the sharded fit does not run yet raises
    NotImplementedError naming its ROADMAP item on every rank, before any
    collective; the group then fits on (ranks' "insider" fit)."""
    for out in ranks:
        message, collectives = out["refusals"][name]
        assert message is not None, f"{name} raised nothing"
        assert f"ROADMAP Queue 1 item {REFUSED[name]}" in message
        assert collectives == 0
