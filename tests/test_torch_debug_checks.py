"""Sanitizer mode of the port (FitConfig.debug_checks), the counterpart of
tests/test_debug_checks.py: after each block update the port checks on the
host that every value is finite and raises NonFiniteError naming the block
that produced the first non-finite one, with the JAX package's tags letter
for letter (insider_tpu/train/als.py:588-589, 624-626, 659-660).  The
checks only read: a clean fit with them equals the fit without them bit
for bit, masked and dense, with and without a continuous covariate.
Without them, the same NaN aborts the fit at a boundary (diverged).
Problems from simulate_insider_data (seed 9) at 12 x 30, K=2, as in the
JAX test; the JAX sanitizer's message is checked to hold the port's.
"""

import numpy as np
import pytest
import torch

import insider_tpu as it
import insider_tpu_torch as itt
from insider_tpu_torch.config import FitConfig
from insider_tpu_torch.model.state import init_state
from insider_tpu_torch.train import als


def _problem(masked=True, poison=False, ctns=False):
    """tests/test_debug_checks.py's problem on the CPU; poison: a NaN in a
    train-masked cell, which the first row solve reads."""
    sim = itt.simulate_insider_data(v1_num=6, v2_num=2, gene_num=30,
                                    latent_dim=2, seed=9,
                                    with_interaction=False)
    data = sim.data.copy()
    split = itt.ratio_splitter(data, ratio=0.1, rm_na_col=False)
    d = np.asarray(split.data).copy()
    ti = np.asarray(split.train_indicator).copy()
    if poison:
        d[1, 3] = np.nan
        ti[1, 3] = 1
    c = (np.random.default_rng(9).standard_normal((12, 1)) if ctns
         else None)
    return als.build_problem(d, sim.confounder, ti, split.test_indicator,
                             c, masked=masked, device="cpu")


def _config(checks, masked=True):
    return FitConfig(latent_dim=2, lambda1=1.0, lambda2=1.0, alpha=0.3,
                     masked=masked, max_iter=10, global_tol=0.0,
                     debug_checks=checks)


def _state(problem):
    g = torch.Generator().manual_seed(0)
    n_ctns = 0 if problem.ctns is None else problem.ctns.shape[1]
    return init_state(g, problem.n_levels, problem.shape[1], 2,
                      n_ctns=n_ctns)


def test_debug_checks_config_builds():
    assert FitConfig(debug_checks=True).debug_checks
    assert FitConfig(debug_checks=True, col_solver="cd").debug_checks


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("ctns", [False, True])
def test_clean_run_equals_run_without_checks(masked, ctns):
    problem = _problem(masked, ctns=ctns)
    on = als.optimize(problem, _config(True, masked), verbose=False)
    off = als.optimize(problem, _config(False, masked), verbose=False)
    assert np.isfinite(on.loss)
    assert [h["loss"] for h in on.history] == [h["loss"]
                                               for h in off.history]
    for a, b in zip(on.row_matrices + [on.column_factor],
                    off.row_matrices + [off.column_factor]):
        np.testing.assert_array_equal(a, b)
    if ctns:
        np.testing.assert_array_equal(on.ctns_factor, off.ctns_factor)


@pytest.mark.parametrize("masked", [True, False])
def test_nan_pinned_to_row_update(masked):
    """The fit's init eval would abort first (divergence guard), so one
    iteration is driven directly, as the JAX test drives its checked step
    chunk."""
    problem = _problem(masked, poison=True)
    with pytest.raises(als.NonFiniteError) as ei:
        als._als_iteration(problem, _config(True, masked), _state(problem),
                           1e-5)
    assert str(ei.value) == ("non-finite values produced by row update "
                             "V[0] (optimize_row)")
    # with the checks off the same iteration runs through
    st = als._als_iteration(problem, _config(False, masked),
                            _state(problem), 1e-5)
    assert not bool(torch.isfinite(st.cfd_factors[0]).all())


@pytest.mark.parametrize("masked", [True, False])
def test_nan_pinned_to_covariate_update(masked):
    """A NaN in covariate 0's own constant (c^T (mask .* data) masked,
    c^T data dense), which no row update reads: the first non-finite block
    is W[0]."""
    problem = _problem(masked, ctns=True)
    const = problem.ctns_bc if masked else problem.ctns_dc
    const[0, 3] = float("nan")
    with pytest.raises(als.NonFiniteError) as ei:
        als._als_iteration(problem, _config(True, masked), _state(problem),
                           1e-5)
    assert str(ei.value) == ("non-finite values produced by continuous "
                             "update W[0] (optimize_continuous_v2)")


@pytest.mark.parametrize("masked", [True, False])
def test_nan_pinned_to_column_update(masked):
    """A NaN in the data after the row constants were built: the row
    updates read only the constants, the column update reads the data."""
    problem = _problem(masked)
    problem.data[1, 3] = float("nan")
    if masked:
        problem.train_mask[1, 3] = 1
    with pytest.raises(als.NonFiniteError) as ei:
        als._als_iteration(problem, _config(True, masked), _state(problem),
                           1e-5)
    assert str(ei.value) == ("non-finite values produced by column update "
                             "F (optimize_col)")


@pytest.mark.parametrize("masked", [True, False])
def test_without_debug_checks_nan_aborts_at_boundary(masked):
    problem = _problem(masked, poison=True)
    res = als.optimize(problem, _config(False, masked), verbose=False)
    assert res.diverged
    assert not np.isfinite(res.loss)


def test_fit_with_checks_raises_through_optimize():
    """Through optimize: the poisoned fit raises from the first iteration
    when the init eval does not see the NaN (a NaN-free train set whose
    constants carry it)."""
    problem = _problem(True)
    problem.d[0][0, 3] = float("nan")
    with pytest.raises(als.NonFiniteError, match=r"row update V\[0\]"):
        als.optimize(problem, _config(True), verbose=False)
    res = als.optimize(problem, _config(False), verbose=False)
    assert res.diverged


def test_message_matches_the_jax_sanitizer():
    """The JAX package's checkify error for the same poisoned problem
    carries the port's message letter for letter."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.checkify import JaxRuntimeError

    from insider_tpu.config import FitConfig as JaxFitConfig
    from insider_tpu.model.state import init_state as jax_init_state
    from insider_tpu.train import als as jals

    sim = it.simulate_insider_data(v1_num=6, v2_num=2, gene_num=30,
                                   latent_dim=2, seed=9,
                                   with_interaction=False)
    split = it.ratio_splitter(sim.data.copy(), ratio=0.1, rm_na_col=False)
    d = np.asarray(split.data).copy()
    ti = np.asarray(split.train_indicator).copy()
    d[1, 3] = np.nan
    ti[1, 3] = 1
    problem = jals.build_problem(d, sim.confounder, ti, split.test_indicator,
                                 masked=True)
    cfg = JaxFitConfig(latent_dim=2, lambda1=1.0, lambda2=1.0, alpha=0.3,
                       masked=True, max_iter=10, global_tol=0.0,
                       debug_checks=True, use_pallas=False)
    state = jax_init_state(jax.random.PRNGKey(0), problem.n_levels,
                           problem.shape[1], 2)
    err, _ = jals._run_steps_eval_checked(
        problem.arrays, problem.statics, jals.StepStatics.from_config(cfg),
        jals.Hypers(jnp.float32(1.0), jnp.float32(1.0), jnp.float32(0.3)),
        state, jnp.float32(1e-5), jnp.int32(1))
    with pytest.raises(JaxRuntimeError) as jei:
        err.throw()
    port = _problem(True, poison=True)
    with pytest.raises(als.NonFiniteError) as ei:
        als._als_iteration(port, _config(True), _state(port), 1e-5)
    assert str(ei.value) in str(jei.value)
