"""Rank K = 136, past the narrow CUDA kernels' 128: the port's plain
versions against the JAX package, on the same numpy inputs.

On the card these are the widened kernels (row_xty and masked_eval in tiles
of 128 coordinates, col_gram_xty's Xty blocks of 128 and its and
level_gram's pair tiles, the grouped FSS solve for feature_sign and feature_sign_shared, the
grouped cold-CD loop's instances past 128 for cd_streamed and cd_shared,
ctns_cd's block of 128 threads); here, on CPU
tensors, their wrappers run the plain versions, which tests/
test_torch_cuda.py holds the kernels to on the card.

Past the shared-memory ceilings the gram builds' narrow tiling had on the
card (col_gram_xty K > 664, level_gram K > ~517 with three count planes),
their plain versions and ops/planes' forms of the kernels' arithmetic run
at K = 700 and K = 520 against the JAX package.

Tolerances:
  * col_gram_xty, row_xty, level_gram, masked_eval against their Pallas
    kernels in interpret mode, as tests/test_torch_gram.py, test_torch_row.py
    and test_torch_eval.py hold them at narrow K: atol 3e-5 (col_gram_xty,
    row_xty) or 2e-5 (level_gram, also rtol) of the output's largest
    magnitude; the SSEs 1e-5 relative and the counts exact.  At K = 520
    level_gram_pallas refuses the shape (its (K^2, 128) table block is past
    its VMEM budget from K = 160), so level_gram there is held, at the same
    tolerance, to the JAX package's XLA form, insider_tpu/ops/row_update.
    level_gram_masked (HIGHEST), which its fit takes where the Pallas
    kernel is infeasible;
  * feature_sign and feature_sign_shared (no polish) against the JAX
    package's FSS iteration, insider_tpu/ops/fss.feature_sign_batched (the
    Pallas FSS kernel takes ~50 s in interpret mode at this K): the same
    iteration, whose elimination rounds otherwise, so each column's
    elastic-net objective within 1e-6 relative;
  * cd_streamed's and cd_shared's plain iteration (cold strong-rule CD,
    ops/fss.elastic_net_cd) against the JAX package's elastic_net_cd
    (insider_tpu/ops/col_update.py:155) at a 40-sweep cap, given the
    JAX-drawn per-sweep orders (perms=): rtol 2e-5, atol 1e-5 on beta, as
    tests/test_torch_cd.py holds the CD kernels at narrow K;
  * a whole cold-CD masked fit (48 x 16, col_solver="cd",
    cd_warm_start=False, sub_tol 1e-9: at the default 1e-5 the two
    iterations' tolerance-stopped sub-solves on these rank-48 grams leave
    the losses 9e-5 apart) against the f64 oracle: every boundary's loss
    and RMSEs within rtol 2e-5, as tests/test_torch_cd_fit.py:83 holds the
    narrow cold-CD fit;
  * a whole masked fit with P = 2 continuous covariates (48 x 16, ridge
    columns, the covariates' ctns_cd at K = 136) against the JAX package's
    fit on its CPU path: every boundary's loss and train RMSE within rtol
    1e-5, as tests/test_torch_continuous.py holds the narrow covariate fits;
  * a whole masked and a whole dense fit (48 x 16, two confounders, K =
    136) against the JAX package's fit on its CPU path (use_pallas=False:
    FSS and a randomly permuted plain-CD polish, where the port's polish
    runs in fixed order), FSS run to convergence (max_fss_outer 200), both
    polished to a tight tolerance (sub_tol 1e-9) and run with global_tol
    1e-12, and against the independent f64 oracle
    (tests/oracles.reference_optimize, strong-rule CD, as
    tests/test_torch_dense.py:126 holds the K = 40 fit to it): every
    boundary's loss within 1e-5 relative of both.  The three fits solve the
    same convex column problems by different iterations and in different
    precisions, and after 10 iterations, with the loss still falling fast,
    they lie within a few 1e-6 of each other; a fit whose FSS stops at the
    default 48 steps lies 1.3e-5 from the JAX fit here, which is why the
    steps are raised.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import insider_tpu as it
from insider_tpu.config import FitConfig as JaxFitConfig
from insider_tpu.kernels.eval_pallas import masked_eval_pallas
from insider_tpu.kernels.gram_pallas import col_gram_xty_pallas
from insider_tpu.kernels.row_pallas import level_gram_pallas, row_xty_pallas
from insider_tpu.model.state import init_state as jax_init_state
from insider_tpu.ops import col_update as jax_col_update
from insider_tpu.ops import row_update as jax_row_update
from insider_tpu.ops.fss import feature_sign_batched
from insider_tpu.train import als as jax_als
from insider_tpu_torch.config import FitConfig
from insider_tpu_torch.kernels import eval as ev
from insider_tpu_torch.kernels import ctns, fss, gram, row
from insider_tpu_torch.model.state import state_from_numpy
from insider_tpu_torch.ops.fss import elastic_net_cd
from insider_tpu_torch.ops.planes import (planes_col_gram_xty,
                                          planes_level_gram)
from insider_tpu_torch.train import als

K = 136


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _close(got, want, rtol, atol_frac):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol_frac * float(np.abs(want).max()))


def _masked(N, M, seed, k=K):
    rng = np.random.default_rng(seed)
    R = (0.3 * rng.standard_normal((N, k))).astype(np.float32)
    mask = (rng.random((N, M)) > 0.1).astype(np.float32)
    data = rng.standard_normal((N, M)).astype(np.float32)
    F = (0.3 * rng.standard_normal((k, M))).astype(np.float32)
    return rng, R, mask, data, F


# the module's rank, and one past a multiple of the card kernels' k-chunk
ROW_RANKS = (K, 161)


def test_col_gram_xty_plain_matches_pallas():
    _, R, mask, data, _ = _masked(40, 128, seed=1)
    got = gram.col_gram_xty(*(torch.from_numpy(x) for x in (mask, data, R)))
    want = col_gram_xty_pallas(jnp.asarray(mask), jnp.asarray(data),
                               jnp.asarray(R), interpret=True)
    assert got[0].shape == (K, K, 128) and got[1].shape == (K, 128)
    for g, w in zip(got, want):
        _close(g, w, 0.0, 3e-5)


@pytest.mark.parametrize("k", ROW_RANKS)
def test_row_xty_plain_matches_pallas(k):
    rng, R, mask, data, F = _masked(48, 300, seed=2, k=k)
    L = 5
    codes = rng.integers(0, L, 48).astype(np.int32)
    E = np.eye(L, dtype=np.float32)[codes]
    D = (E.T.astype(np.float64) @ (mask * data)).astype(np.float32)
    want = row_xty_pallas(jnp.asarray(E), jnp.asarray(R), jnp.asarray(mask),
                          jnp.asarray(D), jnp.asarray(F), interpret=True)
    got = row.row_xty(*(torch.from_numpy(x) for x in (codes, R, mask, D, F)))
    assert got.shape == (L, k)
    _close(got, want, 3e-5, 3e-5)


def test_level_gram_plain_matches_pallas():
    rng = np.random.default_rng(3)
    Mw = rng.integers(0, 200, (7, 300)).astype(np.float32)
    F = rng.standard_normal((K, 300)).astype(np.float32)
    want = level_gram_pallas(jnp.asarray(Mw), jnp.asarray(F), interpret=True)
    got = row.level_gram(torch.from_numpy(Mw), torch.from_numpy(F))
    assert got.shape == (7, K, K)
    _close(got, want, 2e-5, 2e-5)


# past the old ceilings: (K, N, M) of col_gram_xty, (K, L, M) of level_gram
CEILING_COL_GRAM = (700, 8, 16)
CEILING_LEVEL_GRAM = (520, 3, 40)


@pytest.fixture(scope="module")
def col_gram_past_ceiling():
    """Inputs at CEILING_COL_GRAM and col_gram_xty_pallas's output on them
    in interpret mode (~5 s, once for both forms)."""
    K, N, M = CEILING_COL_GRAM
    rng = np.random.default_rng(11)
    R = (0.3 * rng.standard_normal((N, K))).astype(np.float32)
    mask = (rng.random((N, M)) > 0.1).astype(np.float32)
    data = rng.standard_normal((N, M)).astype(np.float32)
    want = col_gram_xty_pallas(jnp.asarray(mask), jnp.asarray(data),
                               jnp.asarray(R), interpret=True)
    return (mask, data, R), [np.asarray(w) for w in want]


@pytest.mark.parametrize("form", ["plain", "planes"])
def test_col_gram_xty_past_the_old_ceiling_matches_pallas(
        col_gram_past_ceiling, form):
    (mask, data, R), want = col_gram_past_ceiling
    K, _, M = CEILING_COL_GRAM
    fn = gram.col_gram_xty if form == "plain" else planes_col_gram_xty
    got = fn(*(torch.from_numpy(x) for x in (mask, data, R)))
    assert got[0].shape == (K, K, M) and got[1].shape == (K, M)
    for g, w in zip(got, want):
        _close(g, w, 0.0, 3e-5)
    assert torch.equal(got[0], got[0].transpose(0, 1))


@pytest.mark.parametrize("form", ["plain", "planes"])
def test_level_gram_past_the_old_ceiling_matches_jax(form):
    """Counts up to 70000, so that the planes form takes three count
    planes, as the kernel does there."""
    K, L, M = CEILING_LEVEL_GRAM
    rng = np.random.default_rng(12)
    Mw = rng.integers(0, 70001, (L, M)).astype(np.float32)
    Mw[0, 0] = 70000.0
    F = rng.standard_normal((K, M)).astype(np.float32)
    want = jax_row_update.level_gram_masked(jnp.asarray(Mw), jnp.asarray(F))
    fn = row.level_gram if form == "plain" else planes_level_gram
    got = fn(torch.from_numpy(Mw), torch.from_numpy(F))
    assert got.shape == (L, K, K)
    _close(got, want, 2e-5, 2e-5)


@pytest.mark.parametrize("k", ROW_RANKS)
def test_masked_eval_plain_matches_pallas(k):
    rng, R, train, data, F = _masked(64, 300, seed=4, k=k)
    test = ((rng.random(train.shape) < 0.5) * (1 - train)).astype(np.float32)
    tr, te, nt, ne = masked_eval_pallas(
        jnp.asarray(data), jnp.asarray(train), jnp.asarray(test),
        jnp.asarray(R), jnp.asarray(F), interpret=True)
    got = ev.masked_eval(*(torch.from_numpy(x)
                           for x in (data, train, test, R, F)))
    for g, (hi, lo) in ((got.train_sse, tr), (got.test_sse, te)):
        ref = float(hi) + float(lo)
        assert abs(float(g) - ref) <= 1e-5 * abs(ref)
    assert float(got.n_train) == float(nt)
    assert float(got.n_test) == float(ne)


def _objective(B, G, b, lam, alpha):
    """Every column's elastic-net objective in f64; G (M, K, K), b (K, M)."""
    B = np.asarray(B, np.float64)
    GB = np.einsum("mkl,lm->km", G, B)
    return (0.5 * (B * GB).sum(0) - (b * B).sum(0)
            + lam * (1 - alpha) / 2 * (B * B).sum(0)
            + lam * alpha * np.abs(B).sum(0))


@pytest.mark.parametrize("shared", [False, True])
def test_feature_sign_plain_matches_jax_iteration(shared):
    _, R, mask, data, _ = _masked(60, 24, seed=5 + shared)
    M = data.shape[1]
    beta0 = np.zeros((K, M), np.float32)
    beta0[::3] = 0.01
    lam, alpha, steps_cap = 4.0, 0.5, 256
    if shared:
        G = (R.T @ R).astype(np.float32)
        b = (R.T @ data).astype(np.float32)
        got = fss.feature_sign_shared(torch.from_numpy(G),
                                      torch.from_numpy(b),
                                      torch.from_numpy(beta0), lam, alpha,
                                      max_outer=steps_cap)
        G_jax = G[None]
        Gm = np.broadcast_to(G.astype(np.float64), (M, K, K))
    else:
        Gk, bk = gram.col_gram_xty(*(torch.from_numpy(x)
                                     for x in (mask, data, R)))
        got = fss.feature_sign(Gk, bk, torch.from_numpy(beta0), lam, alpha,
                               max_outer=steps_cap)
        G_jax = Gk.permute(2, 0, 1).numpy()
        b = bk.numpy()
        Gm = G_jax.astype(np.float64)
    want, steps = feature_sign_batched(jnp.asarray(G_jax), jnp.asarray(b),
                                       jnp.asarray(beta0), lam, alpha,
                                       max_outer=steps_cap)
    assert int(steps) < steps_cap             # converged
    fk = _objective(got.numpy(), Gm, b.astype(np.float64), lam, alpha)
    fj = _objective(np.asarray(want), Gm, b.astype(np.float64), lam, alpha)
    np.testing.assert_allclose(fk, fj, rtol=1e-6,
                               atol=1e-6 * float(np.abs(fj).max()))
    assert int((got == 0).sum()) > 0 and int((got != 0).sum()) > 0


@pytest.mark.parametrize("shared", [False, True])
def test_cd_plain_matches_jax_elastic_net_cd(shared):
    """Cold strong-rule CD at K = 136: the port's plain iteration
    (ops/fss.elastic_net_cd, what cd_streamed_plain runs, and on the gram
    broadcast to every column what cd_shared_plain runs), given the
    per-sweep orders the JAX package draws from its key, against the JAX
    package's elastic_net_cd; some coordinates screened, lasso zeros
    exact."""
    _, R, mask, data, _ = _masked(60, 12, seed=20 + shared)
    M = data.shape[1]
    beta0 = (0.01 * np.random.default_rng(21).standard_normal((K, M))
             ).astype(np.float32)
    lam, alpha, tol, sweeps = 6.0, 0.4, 1e-8, 40
    if shared:
        G = (R.T @ R).astype(np.float32)
        b = (R.T @ data).astype(np.float32)
        G_jax = G[None]
    else:
        Gk, bk = gram.col_gram_xty(*(torch.from_numpy(x)
                                     for x in (mask, data, R)))
        G, b = Gk.numpy(), bk.numpy()
        G_jax = np.ascontiguousarray(G.transpose(2, 0, 1))
    key = jax.random.PRNGKey(5)
    want, _, _ = jax_col_update.elastic_net_cd(
        jnp.asarray(G_jax), jnp.asarray(b), jnp.asarray(beta0), lam, alpha,
        jnp.float32(tol), key, max_sweeps=sweeps)
    perms = np.asarray(jax_col_update.make_sweep_perms(
        jax.random.split(key)[1], K, sweeps))
    Gt, bt, b0 = (torch.from_numpy(x) for x in (G, b, beta0))
    if shared:
        Gt = Gt[:, :, None].expand(K, K, M)
    got = elastic_net_cd(Gt, bt, b0, lam, alpha, tol, sweeps, perms=perms)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=1e-5)
    mx = np.abs(b).max(0)
    assert (np.abs(b) < np.float32(alpha) * (2 * lam - mx)).any()  # screened
    assert int((got == 0).sum()) > 0 and int((got != 0).sum()) > 0


@pytest.mark.parametrize("lanes", [0, 16, 32, 128])
@pytest.mark.parametrize("shared", [False, True])
def test_cd_wrappers_take_every_card_width_on_cpu(shared, lanes):
    """cd_streamed and cd_shared on CPU tensors run their plain version,
    bit for bit, whatever group width `lanes` asks for: each width the card
    has past 128 coordinates (0 its first, 32 the grouped CD loop on a gram
    in shared memory, 16 cd_streamed's on grams read through L2, 128 the
    block solve) is a hook of the kernel alone."""
    from insider_tpu_torch.kernels import cd

    _, R, mask, data, _ = _masked(60, 12, seed=30 + shared)
    M = data.shape[1]
    beta0 = torch.from_numpy((0.01 * np.random.default_rng(31)
                              .standard_normal((K, M))).astype(np.float32))
    args = (6.0, 0.4, 1e-8, 20)
    if shared:
        G = torch.from_numpy(R.T @ R)
        b = torch.from_numpy(R.T @ data)
        got = cd.cd_shared(G, b, beta0, *args, lanes=lanes)
        want = cd.cd_shared_plain(G, b, beta0, *args)
    else:
        G, b = gram.col_gram_xty(*(torch.from_numpy(x)
                                   for x in (mask, data, R)))
        got = cd.cd_streamed(G, b, beta0, *args, lanes=lanes)
        want = cd.cd_streamed_plain(G, b, beta0, *args)
    assert torch.equal(got, want)
    assert int((got == 0).sum()) > 0 and int((got != 0).sum()) > 0


@pytest.mark.parametrize("lanes", [0, 16, 32, 128])
@pytest.mark.parametrize("shared", [False, True])
def test_fss_wrappers_take_every_card_width_on_cpu(shared, lanes):
    """feature_sign and feature_sign_shared on CPU tensors run their plain
    version, bit for bit, whatever width `lanes` asks for: each width the
    card has past 128 coordinates (0 its first, 32 the grouped solve, 128
    the block solve; 16, which it lacks, raises there) is a hook of the
    kernel alone."""
    from insider_tpu_torch.kernels import fss

    _, R, mask, data, _ = _masked(60, 12, seed=40 + shared)
    M = data.shape[1]
    beta0 = torch.from_numpy((0.01 * np.random.default_rng(41)
                              .standard_normal((K, M))).astype(np.float32))
    args = (6.0, 0.4)
    kw = dict(max_outer=6, polish_sweeps=2, tol=1e-8)
    if shared:
        G = torch.from_numpy(R.T @ R)
        b = torch.from_numpy(R.T @ data)
        got = fss.feature_sign_shared(G, b, beta0, *args, **kw, lanes=lanes)
        want = fss.feature_sign_shared_plain(G, b, beta0, *args, **kw)
    else:
        G, b = gram.col_gram_xty(*(torch.from_numpy(x)
                                   for x in (mask, data, R)))
        got = fss.feature_sign(G, b, beta0, *args, **kw, lanes=lanes)
        want = fss.feature_sign_plain(G, b, beta0, *args, **kw)
    assert torch.equal(got, want)
    assert int((got == 0).sum()) > 0 and int((got != 0).sum()) > 0


# the fits: 48 samples, 16 genes, two confounders (4 and 6 levels), FSS to
# convergence (max_fss_outer 200: from a warm start a step activates one
# coordinate), 10 iterations (the plain FSS at K = 136 and the JAX fit's
# compile take most of the ~25 s a fit)
N_FIT, M_FIT, LAM, ALPHA, MAX_ITER = 48, 16, 4.0, 0.4, 10


def _fit_problem(masked):
    """Data (1% NaNs and a 10% held-out split where masked), confounder,
    train and test indicators."""
    sim = it.simulate_scale(N_FIT, M_FIT, 8, level_counts=(4, 6),
                            noise_std=0.5, seed=11)
    data = sim.data.astype(np.float64)
    if not masked:
        ones = np.ones_like(data)
        return data, sim.confounder, ones, np.zeros_like(data)
    data[np.random.default_rng(12).random(data.shape) < 0.01] = np.nan
    split = it.ratio_splitter(data, ratio=0.1, seed=13)
    return (split.data, sim.confounder, split.train_indicator,
            split.test_indicator)


@pytest.mark.parametrize("masked", [True, False])
def test_fit_matches_jax_cpu_path_and_f64_oracle(masked):
    import oracles

    data, confounder, train, test = _fit_problem(masked)
    jprob = jax_als.build_problem(data, confounder, train, test,
                                  masked=masked)
    jst = jax_init_state(jax.random.PRNGKey(0), jprob.n_levels, M_FIT, K)
    cfd0 = [np.asarray(f) for f in jst.cfd_factors]
    F0 = np.asarray(jst.column_factor)
    kw = dict(latent_dim=K, lambda1=LAM, lambda2=LAM, alpha=ALPHA,
              max_iter=MAX_ITER, global_tol=1e-12, sub_tol=1e-9,
              max_fss_outer=200, max_fss_polish_sweeps=400)
    jres = jax_als.optimize(jprob, JaxFitConfig(
        **kw, use_pallas=False, boundaries_per_dispatch=1), state=jst,
        verbose=False)
    prob = als.build_problem(data, confounder, train, test, masked=masked,
                             device="cpu")
    res = als.optimize(prob, FitConfig(**kw),
                       state=state_from_numpy(cfd0, None, F0, "cpu"),
                       verbose=False)
    assert [h["iter"] for h in res.history] == [-1, 0, 10]
    assert [h["iter"] for h in jres.history] == [-1, 0, 10]
    losses = [h["loss"] for h in res.history]
    np.testing.assert_allclose(losses, [h["loss"] for h in jres.history],
                               rtol=1e-5)
    assert losses[-1] < 0.5 * losses[0]
    assert int((res.column_factor == 0).sum()) > 0

    oracle = oracles.reference_optimize(
        prob.data.numpy(), prob.train_mask.numpy(),
        prob.test_mask.numpy(), [c.numpy() for c in prob.codes],
        list(prob.n_levels), F0, cfd0, LAM, LAM, ALPHA, max_iter=MAX_ITER,
        global_tol=1e-12, sub_tol=1e-9, masked=masked)
    o_loss = [h["loss"] for h in oracle["history"]]
    assert [h["iter"] for h in oracle["history"]] == [-1, 0, 10]
    np.testing.assert_allclose(losses, o_loss, rtol=1e-5)


def test_cold_cd_masked_fit_matches_f64_oracle():
    """Cold strong-rule CD (col_solver="cd", cd_warm_start=False) through the
    masked fit at K = 136 against the f64 oracle's strong-rule CD, from the
    JAX package's initial state."""
    import oracles

    data, confounder, train, test = _fit_problem(True)
    prob = als.build_problem(data, confounder, train, test, device="cpu")
    st = jax_init_state(jax.random.PRNGKey(0), prob.n_levels, M_FIT, K)
    cfd0 = [np.asarray(f) for f in st.cfd_factors]
    F0 = np.asarray(st.column_factor)
    cfg = FitConfig(latent_dim=K, lambda1=LAM, lambda2=LAM, alpha=ALPHA,
                    max_iter=MAX_ITER, global_tol=1e-12, sub_tol=1e-9,
                    col_solver="cd", cd_warm_start=False)
    res = als.optimize(prob, cfg, state=state_from_numpy(cfd0, None, F0,
                                                         "cpu"),
                       verbose=False)
    oracle = oracles.reference_optimize(
        prob.data.numpy(), prob.train_mask.numpy(), prob.test_mask.numpy(),
        [c.numpy() for c in prob.codes], list(prob.n_levels), F0, cfd0, LAM,
        LAM, ALPHA, max_iter=MAX_ITER, global_tol=1e-12, sub_tol=1e-9)
    assert [h["iter"] for h in res.history] == [-1, 0, 10]
    assert [h["iter"] for h in oracle["history"]] == [-1, 0, 10]
    for fld in ("loss", "train_rmse", "test_rmse"):
        np.testing.assert_allclose([h[fld] for h in res.history],
                                   [h[fld] for h in oracle["history"]],
                                   rtol=2e-5, err_msg=fld)
    assert int((res.column_factor == 0).sum()) > 0


def test_masked_covariate_fit_matches_jax_cpu_path():
    """A masked fit with P = 2 continuous covariates at K = 136 (ctns_cd's
    K-space CD on a (K, K) system a covariate an iteration) against the JAX
    package's fit on its CPU path, from the same initial state; alpha = 0,
    so that the column side is the ridge solves in both packages and the
    comparison rests on the covariates' CD."""
    data, confounder, train, test = _fit_problem(True)
    c = np.random.default_rng(14).standard_normal((N_FIT, 2))
    jprob = jax_als.build_problem(data, confounder, train, test, c,
                                  masked=True)
    jst = jax_init_state(jax.random.PRNGKey(0), jprob.n_levels, M_FIT, K,
                         n_ctns=2)
    cfd0 = [np.asarray(f) for f in jst.cfd_factors]
    W0, F0 = np.asarray(jst.ctns_factor), np.asarray(jst.column_factor)
    kw = dict(latent_dim=K, lambda1=LAM, lambda2=LAM, alpha=0.0,
              max_iter=MAX_ITER, global_tol=1e-12)
    jres = jax_als.optimize(jprob, JaxFitConfig(
        **kw, use_pallas=False, boundaries_per_dispatch=1), state=jst,
        verbose=False)
    prob = als.build_problem(data, confounder, train, test, c, masked=True,
                             device="cpu")
    n0 = ctns.ctns_cd.launches
    res = als.optimize(prob, FitConfig(**kw),
                       state=state_from_numpy(cfd0, W0, F0, "cpu"),
                       verbose=False)
    assert ctns.ctns_cd.launches == n0            # CPU: the plain version
    assert [h["iter"] for h in res.history] == [-1, 0, 10]
    assert [h["iter"] for h in jres.history] == [-1, 0, 10]
    for fld in ("loss", "train_rmse"):
        np.testing.assert_allclose([h[fld] for h in res.history],
                                   [h[fld] for h in jres.history], rtol=1e-5,
                                   err_msg=fld)
    assert res.ctns_factor.shape == (2, K)
