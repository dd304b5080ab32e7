"""build_problem_distributed and file_ingest_callbacks of the port against
build_problem(sharding=...) and the JAX package (tests/test_ingest.py,
tests/test_native_io.py:166).

Four CPU processes joined by gloo (tests/torch_dist.py) build test_ingest.py's
problem (24 x 64, levels (8, 3)) at the layouts (2, 2) and (4, 1) three
ways: from the full host arrays (build_problem(sharding=...)), from each
rank's blocks and from callbacks (build_problem_distributed); every
tensor of the three must be equal bit for bit, and each callback called
once, for the rank's block.  The callbacks' problem is fitted (K=3, 20
iterations, one numpy initial state) and held against the JAX package's
build_problem_distributed fit on the same layout (test_sharding.py's
tolerances) and the port's one-process fit (per-boundary rel 1e-5).  A
raw f32 file (test_native_io.py's 48 x 256) goes through the port's
file_ingest_callbacks at (2, 2) and is fitted against the one-process fit
of the same split made in memory (rel 1e-5); its callbacks' blocks equal
the JAX package's.
"""

import jax
import numpy as np
import pytest

import insider_tpu as it
import torch_dist
import torch_sharded_jobs as jobs
from insider_tpu.config import FitConfig as JaxFitConfig
from insider_tpu.config import ShardingConfig as JaxSharding
from insider_tpu.model.state import init_state as jax_init_state
from insider_tpu.train import als as jals
from insider_tpu_torch.config import FitConfig
from insider_tpu_torch.data import native as tnat
from insider_tpu_torch.model.state import state_from_numpy
from insider_tpu_torch.train import als
from jax_native_private import jax_native  # noqa: F401 (fixture)

FILE_SHAPE = (48, 256)


def _codes(confounder):
    codes, n_levels = [], []
    for c in range(confounder.shape[1]):
        levels, inv = np.unique(confounder[:, c], return_inverse=True)
        codes.append(inv.astype(np.int32))
        n_levels.append(int(levels.size))
    return codes, tuple(n_levels)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    sim = it.simulate_insider_data(v1_num=8, v2_num=3, gene_num=64,
                                   latent_dim=3, seed=0,
                                   with_interaction=False)
    split = it.ratio_splitter(sim.data.astype(np.float64), ratio=0.1)
    codes, n_levels = _codes(sim.confounder)
    st = jax_init_state(jax.random.PRNGKey(0), n_levels,
                        split.data.shape[1], jobs.K)
    fsim = it.simulate_scale(*FILE_SHAPE, jobs.K, level_counts=(2, 4),
                             noise_std=1.0, seed=3)
    path = tmp_path_factory.mktemp("ingest") / "data.f32"
    fsim.data.astype(np.float32).tofile(path)
    fcodes, flevels = _codes(fsim.confounder)
    tnat.lib()              # built once here, not by four ranks at once
    return dict(data=np.asarray(split.data, np.float32),
                train=np.asarray(split.train_indicator, np.float32),
                test=np.asarray(split.test_indicator, np.float32),
                confounder=sim.confounder, codes=codes, n_levels=n_levels,
                cfd=[np.asarray(f) for f in st.cfd_factors],
                F=np.asarray(st.column_factor), path=str(path),
                file_shape=FILE_SHAPE, file_data=fsim.data.astype(np.float32),
                file_confounder=fsim.confounder, file_codes=fcodes,
                file_levels=flevels,
                ctns=np.random.default_rng(5).standard_normal(
                    (split.data.shape[0], 2)))


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return torch_dist.spawn(4, "torch_sharded_jobs:ingest_job", inputs,
                            tmp_path_factory.mktemp("ingest_ranks"))


@pytest.mark.parametrize("source", ["blocks", "callbacks"])
@pytest.mark.parametrize("layout", jobs.INGEST_LAYOUTS)
def test_distributed_build_equals_build_problem(ranks, layout, source):
    """tests/test_ingest.py:110: every tensor of this rank's problem (data,
    masks, codes, level sums, level counts, row orders, largest count) as
    build_problem(sharding=...) makes it, bit for bit; the callbacks called
    once each, for the rank's block only, and only they set
    split_variant."""
    for out in ranks:
        rec = out[layout]
        assert rec[source] == {f: True for f in jobs.INGEST_FIELDS}
        if source == "callbacks":
            (r0, r1), (c0, c1) = rec["block"]
            names = [name for name, _ in rec["calls"]]
            assert sorted(names) == sorted(["data", "train", "test",
                                            "codes0", "codes1"])
            for name, bounds in rec["calls"]:
                want = ((r0, r1),) if name.startswith("codes") else (
                    (r0, r1), (c0, c1))
                assert bounds == want, name
    assert ranks[0][layout]["split_variants"] == (None, "bernoulli_block")


@pytest.mark.parametrize("source", ["blocks", "callbacks"])
@pytest.mark.parametrize("layout", jobs.INGEST_LAYOUTS)
def test_distributed_build_with_covariates_equals_build_problem(
        ranks, layout, source):
    """build_problem_distributed with ctns_confounder (the rank's rows, or
    a callback with n_ctns): the covariates and their constants, summed
    over the row blocks, and the dense level sizes, with and without the
    precompute, as build_problem(sharding=...) makes them, bit for bit;
    the callback called once a build, for the rank's rows and every
    covariate."""
    for out in ranks:
        rec = out[layout]
        for kind, fields in jobs.CTNS_FIELDS.items():
            got = rec["ctns"][kind][["blocks", "callbacks"].index(source)]
            assert got == {f: True for f in fields}, kind
        (r0, r1), _ = rec["block"]
        assert rec["ctns_calls"] == [("ctns", ((r0, r1), (0, 2)))] * len(
            jobs.CTNS_FIELDS)


@pytest.mark.parametrize("layout", jobs.INGEST_LAYOUTS)
def test_distributed_fit_matches_jax(inputs, ranks, layout):
    """The fit of the callbacks' problem against the JAX package's
    build_problem_distributed fit with callbacks on the same layout of its
    8-device mesh, at test_sharding.py's tolerances."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    x, tr, te = inputs["data"], inputs["train"], inputs["test"]
    problem = jals.build_problem_distributed(
        data=lambda idx: x[idx], train_indicator=lambda idx: tr[idx],
        test_indicator=lambda idx: te[idx],
        codes=[(lambda c: (lambda idx: c[idx]))(c) for c in inputs["codes"]],
        n_levels=inputs["n_levels"], global_shape=x.shape,
        sharding=JaxSharding(*layout))
    state = jax_init_state(jax.random.PRNGKey(0), inputs["n_levels"],
                           x.shape[1], jobs.K)
    ref = jals.optimize(problem, JaxFitConfig(**dict(jobs.BASE, seed=0)),
                        state=state, verbose=False)
    for out in ranks:
        got = out[layout]["fit"]
        assert got["history"][-1][1] == pytest.approx(ref.loss, rel=1e-4)
        np.testing.assert_allclose(got["F"], ref.column_factor, rtol=5e-3,
                                   atol=1e-4)
        for a, b in zip(got["V"], ref.row_matrices):
            np.testing.assert_allclose(a, b, rtol=5e-3, atol=1e-4)


def _boundaries(summary):
    return np.array([h[1:3] for h in summary["history"]])


@pytest.mark.parametrize("layout", jobs.INGEST_LAYOUTS)
def test_distributed_fit_matches_one_process(inputs, ranks, layout):
    """Per-boundary losses and train RMSEs within rel 1e-5 of the port's
    one-process fit of the same arrays."""
    problem = als.build_problem(inputs["data"], inputs["confounder"],
                                inputs["train"], inputs["test"],
                                device="cpu")
    ref = jobs.summary(als.optimize(
        problem, FitConfig(**dict(jobs.BASE, seed=0)),
        state=state_from_numpy(inputs["cfd"], None, inputs["F"], "cpu"),
        verbose=False))
    for out in ranks:
        got = out[layout]["fit"]
        assert [h[0] for h in got["history"]] == [h[0] for h in
                                                  ref["history"]]
        np.testing.assert_allclose(_boundaries(got), _boundaries(ref),
                                   rtol=1e-5)


def test_file_ingest_fit_matches_in_memory(inputs, ranks):
    """tests/test_native_io.py:166: the (2, 2) fit of a problem read from
    a raw f32 file through file_ingest_callbacks against the one-process
    fit of the same file's matrix and the same block split made in memory,
    per boundary within rel 1e-5; the masks are marked as the per-block
    Bernoulli split."""
    N, M = FILE_SHAPE
    tr, te, _ = tnat.split_mask_block(FILE_SHAPE, (0, N), (0, M), 0.1, 77,
                                      data_block=inputs["file_data"])
    problem = als.build_problem(inputs["file_data"],
                                inputs["file_confounder"], tr, te,
                                device="cpu")
    ref = jobs.summary(als.optimize(problem, FitConfig(**jobs.FILE_FIT),
                                    verbose=False))
    for out in ranks:
        assert out["file"]["split_variant"] == "bernoulli_block"
        got = out["file"]["fit"]
        assert len(got["history"]) == len(ref["history"]) == 3
        np.testing.assert_allclose(_boundaries(got), _boundaries(ref),
                                   rtol=1e-5)


@pytest.mark.parametrize("index", [
    (slice(0, 48), slice(0, 256)), (slice(24, 48), slice(128, 256)),
    (slice(5, 17), slice(33, 34))])
def test_file_ingest_callbacks_match_jax(inputs, jax_native, index):
    """The port's callbacks return the JAX package's blocks for the same
    index, bit for bit: the data read from the file, and both masks."""
    ours = tnat.file_ingest_callbacks(inputs["path"], FILE_SHAPE, 0.1, 77)
    theirs = jax_native.file_ingest_callbacks(inputs["path"], FILE_SHAPE,
                                              0.1, 77)
    for a, b in zip(ours, theirs):
        got, want = a(index), b(index)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8))
