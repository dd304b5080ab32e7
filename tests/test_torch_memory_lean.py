"""The port's memory-lean fit against the JAX package.

uint8 masks (mask_dtype), the segment-sum row route that a confounder
takes past the fast route's memory budgets (_FAST_E_BYTES,
_FAST_LM_BYTES), the column-chunked precompute
(_PRECOMPUTE_TRANSIENT_BYTES), precompute=False, fit_interaction, the two
CD solvers and profile_dir.  Whole fits start from the JAX init_state
carried across with state_from_numpy; the JAX side runs its kernel path
(Pallas in interpret mode) with one host decision per boundary, as the
port does: per-boundary losses and train RMSEs at rtol 1e-5 (f32 on both
sides, sums in other orders), the factors within 1e-3 of their largest
magnitude.  A budget is lowered by patching the constant in both
packages' modules, in the test only.  The row constants: chunked against
unchunked and against the JAX package's at rtol 1e-6 (atol 1e-6 of the
largest magnitude).  fit_interaction against the JAX package at rtol 1e-5
(atol 1e-5 of the largest magnitude); the solvers within 1e-4 of the JAX
ones at tol=1e-10 (the objective is strictly convex for lam (1 - alpha)
> 0, so the sweep orders, which the two packages draw differently, do
not matter at convergence).  uint8 masks give the f32 masks' fit bit for
bit.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import insider_tpu as it
import insider_tpu.api as jax_api
import insider_tpu.kernels.eval_pallas as ep
import insider_tpu.kernels.fss_pallas as fsp
import insider_tpu.kernels.row_pallas as rp
import insider_tpu_torch as itt
from insider_tpu.config import FitConfig as JaxFitConfig
from insider_tpu.model.state import init_state as jax_init_state
from insider_tpu.ops import row_update as jrow
from insider_tpu.train import als as jax_als
from insider_tpu_torch.config import FitConfig
from insider_tpu_torch.model.state import state_from_numpy
from insider_tpu_torch.ops import row_update
from insider_tpu_torch.train import als

N, M, K, P = 40, 300, 6, 2
LAM, ALPHA = 2.0, 0.4
MAX_ITER = 20


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture()
def interpret_kernels(monkeypatch):
    """The JAX package's Pallas kernels in interpret mode on the CPU, and
    its Insider.fit deciding every boundary on the host."""
    for mod, name in ((rp, "row_xty_pallas"), (rp, "row_xty_chunked_pallas"),
                      (rp, "level_gram_pallas"),
                      (fsp, "feature_sign_fused_pallas"),
                      (fsp, "feature_sign_shared_pallas"),
                      (ep, "masked_eval_pallas")):
        def interp(*args, _orig=getattr(mod, name), **kw):
            kw["interpret"] = True
            return _orig(*args, **kw)

        monkeypatch.setattr(mod, name, interp)
    monkeypatch.setattr(jax_api, "FitConfig",
                        functools.partial(JaxFitConfig,
                                          boundaries_per_dispatch=1))
    yield


def _raw_problem(seed=1, m=M, ctns=True):
    """3 confounders (2, 4 and 7 levels) + their first two's interaction,
    ~1% NaNs, and P continuous covariates that the data carries as
    C W_true F (or none)."""
    sim = it.simulate_scale(N, m, K, level_counts=(2, 4, 7), noise_std=0.5,
                            seed=seed)
    data = sim.data.astype(np.float64)
    c = None
    if ctns:
        rng = np.random.default_rng(7)
        c = rng.standard_normal((N, P))
        data = data + (c @ rng.standard_normal((P, K))) @ sim.gene_factor
    data[np.random.default_rng(5).random(data.shape) < 0.01] = np.nan
    return data, sim.confounder, c


def _jax_state(n_levels, n_cols, n_ctns, seed=0):
    st = jax_init_state(jax.random.PRNGKey(seed), tuple(n_levels), n_cols, K,
                        n_ctns=n_ctns)
    return ([np.asarray(f) for f in st.cfd_factors],
            None if st.ctns_factor is None else np.asarray(st.ctns_factor),
            np.asarray(st.column_factor))


def _fit_both(partition, ctns=True, jax_kw=None, **fit_kw):
    data, confounder, c = _raw_problem(ctns=ctns)
    jobj = it.Insider(data, confounder, c, interaction_idx=[0, 1],
                      max_iter=MAX_ITER)
    jobj.fit(K, LAM, ALPHA, partition=partition, verbose=False,
             use_pallas=True, **dict(fit_kw, **(jax_kw or {})))
    tobj = itt.Insider(data, confounder, c, interaction_idx=[0, 1],
                       max_iter=MAX_ITER, device="cpu")
    n_levels = [np.unique(v).size for v in tobj.confounder.T]
    cfd0, W0, F0 = _jax_state(n_levels, tobj.data.shape[1],
                              0 if c is None else P, seed=tobj.seed)
    tobj.fit(K, LAM, ALPHA, partition=partition, verbose=False,
             state=state_from_numpy(cfd0, W0, F0, "cpu"), **fit_kw)
    return tobj, jobj


def _assert_fits_match(tobj, jobj):
    h_port, h_jax = tobj.fit_result.history, jobj.fit_result.history
    assert [h["iter"] for h in h_port] == [h["iter"] for h in h_jax]
    assert [h["iter"] for h in h_port] == [-1, 0, 10, 20]
    for fld in ("loss", "train_rmse"):
        np.testing.assert_allclose([h[fld] for h in h_port],
                                   [h[fld] for h in h_jax], rtol=1e-5)
    assert len(tobj.cfd_matrices) == len(jobj.cfd_matrices)
    for g, w in zip(tobj.cfd_matrices + [tobj.column_factor],
                    jobj.cfd_matrices + [jobj.column_factor]):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=0,
                                   atol=1e-3 * float(np.abs(w).max()))


def _losses(obj):
    return [h["loss"] for h in obj.fit_result.history]


# --- uint8 masks ------------------------------------------------------------

@pytest.mark.parametrize("partition", [1, 0])
def test_uint8_fit_matches_jax(interpret_kernels, partition):
    tobj, jobj = _fit_both(partition, mask_dtype=np.uint8,
                           jax_kw=dict(mask_dtype=jnp.uint8))
    _assert_fits_match(tobj, jobj)
    # the port's f32-mask fit from the same state: the same bits
    ref, _ = _fit_both(partition)
    assert _losses(tobj) == _losses(ref)
    np.testing.assert_array_equal(tobj.column_factor, ref.column_factor)


def test_uint8_problem_stores_uint8():
    data, confounder, c = _raw_problem()
    obj = itt.Insider(data, confounder, c, device="cpu")
    prob = als.build_problem(obj.data, obj.confounder, obj.train_indicator,
                             obj.test_indicator, c, mask_dtype=np.uint8,
                             device="cpu")
    ref = als.build_problem(obj.data, obj.confounder, obj.train_indicator,
                            obj.test_indicator, c, device="cpu")
    assert prob.train_mask.dtype == prob.test_mask.dtype == torch.uint8
    assert prob.train_mask.element_size() * 4 == ref.train_mask.element_size()
    for name in ("mw_cat", "ctns_q", "ctns_bc"):
        assert torch.equal(getattr(prob, name), getattr(ref, name))


# --- the segment-sum route --------------------------------------------------

# A budget that sends the confounders of more than 6 levels (the 8-level
# interaction and the 7-level confounder) to segment sums and keeps the 2-
# and 4-level ones fast.
BUDGETS = {"_FAST_E_BYTES": N * 6 * 4, "_FAST_LM_BYTES": 2 * 6 * M * 4}


def _lower(monkeypatch, name, value):
    monkeypatch.setattr(als, name, value)
    monkeypatch.setattr(jax_als, name, value)


@pytest.mark.parametrize("budget", sorted(BUDGETS))
@pytest.mark.parametrize("partition,ctns", [(1, True), (1, False),
                                            (0, True), (0, False)])
def test_segment_sum_route_matches_jax(interpret_kernels, monkeypatch,
                                       budget, partition, ctns):
    _lower(monkeypatch, budget, BUDGETS[budget])
    tobj, jobj = _fit_both(partition, ctns=ctns)
    prob = als.build_problem(tobj.data, tobj.confounder,
                             tobj.train_indicator, tobj.test_indicator,
                             masked=bool(partition), device="cpu")
    assert list(prob.n_levels) == [2, 8, 4, 7]
    assert prob.fast() == [0, 2]
    if partition:
        assert prob.mw_cat.shape[0] == 2 + 4
        assert prob.row_order[1] is None and prob.row_order[3] is None
    else:
        # every confounder's level sizes, the segment-sum ones' counted at
        # the build so that no iteration counts them
        assert prob.d[1] is None and prob.d[3] is None
        for v, codes in enumerate(prob.codes):
            assert torch.equal(prob.counts[v], torch.bincount(
                codes.long(), minlength=prob.n_levels[v]).float())
    _assert_fits_match(tobj, jobj)


@pytest.mark.parametrize("masked", [True, False])
def test_segment_sum_updates_match_jax(masked):
    """update_row_factor_masked / _dense against the JAX package's on the
    same inputs, with uint8 masks on the port's side."""
    rng = np.random.default_rng(3)
    n, m, k, L = 60, 90, 5, 7
    resid = rng.standard_normal((n, m)).astype(np.float32)
    mask = (rng.random((n, m)) > 0.2).astype(np.float32)
    F = rng.standard_normal((k, m)).astype(np.float32)
    codes = rng.integers(0, L, n).astype(np.int32)
    t = torch.from_numpy
    if masked:
        got = row_update.update_row_factor_masked(
            t(resid), t(mask.astype(np.uint8)), t(F), t(codes), L, 0.7)
        want = jrow.update_row_factor_masked(
            jnp.asarray(resid), jnp.asarray(mask), jnp.asarray(F),
            jnp.asarray(codes), L, 0.7)
    else:
        got = row_update.update_row_factor_dense(
            t(resid), t(F), t(F @ F.T), t(codes), L, 0.7)
        want = jrow.update_row_factor_dense(
            jnp.asarray(resid), jnp.asarray(F), jnp.asarray(F @ F.T),
            jnp.asarray(codes), L, 0.7)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("L", [1, 7, 1700])
def test_segment_sum_is_the_level_sums_in_row_order(L):
    """segment_sum adds each level's rows in row order: the f32 sums equal
    a sequential sum of those rows bit for bit, at a size (300 x 1031)
    where torch's CPU ops split the work across threads; levels with no
    rows (L=1700 over 300 rows) are 0."""
    rng = np.random.default_rng(L)
    x = torch.from_numpy(rng.standard_normal((300, 1031)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, L, 300).astype(np.int32))
    got = row_update.segment_sum(x, codes, L)
    want = torch.zeros((L, 1031))
    for i in range(300):
        want[codes[i]] += x[i]
    assert torch.equal(got, want)


# --- the column-chunked precompute ------------------------------------------

def _constants(prob):
    names = (["mw_cat", "ctns_q", "ctns_bc"] if prob.masked
             else ["ctns_dc", "ctns_cc"])
    out = {n: getattr(prob, n).numpy() for n in names}
    for v in prob.fast():
        out[f"d{v}"] = prob.d[v].numpy()
    return out


def _close6(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("masked", [True, False])
def test_chunked_precompute_matches_unchunked_and_jax(monkeypatch, masked):
    data, confounder, c = _raw_problem(m=2500)
    obj = itt.Insider(data, confounder, c, device="cpu")
    args = (obj.data, obj.confounder, obj.train_indicator,
            obj.test_indicator, c)
    n, m = obj.data.shape
    assert als.precompute_chunk(n, m) == m
    whole = _constants(als.build_problem(*args, masked=masked,
                                         device="cpu"))
    # one chunk's f32 transients (n x 1024 x 4 bytes) fit the budget
    _lower(monkeypatch, "_PRECOMPUTE_TRANSIENT_BYTES", 4 * n * 1024)
    assert als.precompute_chunk(n, m) == 1024 and -(-m // 1024) == 3
    got = _constants(als.build_problem(*args, masked=masked,
                                       mask_dtype=np.uint8, device="cpu"))
    pre = jax_als.build_problem(*args, masked=masked).arrays.pre
    jax_const = ({"mw_cat": np.concatenate([np.asarray(w) for w in pre.mw]),
                  "ctns_q": pre.ctns_q, "ctns_bc": pre.ctns_bc} if masked
                 else {"ctns_dc": pre.ctns_dc, "ctns_cc": pre.ctns_cc})
    jax_const.update({f"d{v}": d for v, d in enumerate(pre.d)})
    assert sorted(got) == sorted(whole) == sorted(jax_const)
    for name in got:
        _close6(got[name], whole[name])
        _close6(got[name], np.asarray(jax_const[name]))


# --- precompute=False ---------------------------------------------------------

@pytest.mark.parametrize("partition", [1, 0])
def test_no_precompute_matches_jax(interpret_kernels, partition):
    tobj, jobj = _fit_both(partition, precompute=False)
    _assert_fits_match(tobj, jobj)


# --- fit_interaction and the solvers ----------------------------------------

@pytest.mark.parametrize("masked", [True, False])
def test_fit_interaction_matches_jax(masked):
    """As tests/test_row_update.py:60 holds the JAX package's; the codes
    from the host, L = max + 1."""
    rng = np.random.default_rng(7)
    n, m, k = 80, 60, 4
    resid = rng.standard_normal((n, m)).astype(np.float32)
    mask = (rng.random((n, m)) > 0.3).astype(np.float32)
    F = rng.standard_normal((k, m)).astype(np.float32)
    codes = rng.permutation(np.arange(n) % 11)
    got = itt.fit_interaction(torch.from_numpy(resid),
                              torch.from_numpy(mask), codes,
                              torch.from_numpy(F), masked=masked)
    want = np.asarray(jrow.fit_interaction(
        jnp.asarray(resid), jnp.asarray(mask), codes, jnp.asarray(F),
        masked=masked))
    assert got.shape == want.shape == (11, k)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    # the codes as a tensor
    again = itt.fit_interaction(torch.from_numpy(resid),
                                torch.from_numpy(mask),
                                torch.from_numpy(codes), torch.from_numpy(F),
                                masked=masked)
    assert torch.equal(again, got)


@pytest.mark.parametrize("name", ["coordinate_descent",
                                  "strong_coordinate_descent"])
@pytest.mark.parametrize("alpha", [0.6, 1.0])
def test_solvers_match_jax(name, alpha):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((50, 7))
    y = 2 * rng.standard_normal(50)
    w0 = np.zeros(7)
    got = getattr(itt, name)(X, y, w0, 1.0, alpha, tol=1e-10, device="cpu")
    want = getattr(it, name)(X, y, w0, 1.0, alpha, tol=1e-10)
    assert isinstance(got, np.ndarray) and got.shape == (7,)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)
    # the seed sets the sweep orders, not the solution
    other = getattr(itt, name)(X, y, w0, 1.0, alpha, tol=1e-10, seed=3,
                               device="cpu")
    np.testing.assert_allclose(other, got, rtol=0, atol=1e-4)


# --- profile_dir --------------------------------------------------------------

def test_profile_dir_traces_the_second_chunk(tmp_path):
    """The memory-lean problem, profiled: a Chrome trace of iterations
    1-10, and the losses of the run without it, bit for bit."""
    data, confounder, c = _raw_problem()
    obj = itt.Insider(data, confounder, c, interaction_idx=[0, 1],
                      device="cpu")
    prob = als.build_problem(obj.data, obj.confounder, obj.train_indicator,
                             obj.test_indicator, c, mask_dtype=np.uint8,
                             precompute=False, device="cpu")
    cfg = FitConfig(latent_dim=K, lambda1=LAM, lambda2=LAM, alpha=ALPHA,
                    max_iter=MAX_ITER)
    ref = als.optimize(prob, cfg, verbose=False)
    got = als.optimize(prob, cfg, verbose=False,
                       profile_dir=str(tmp_path / "trace"))
    assert [h["loss"] for h in got.history] == [h["loss"] for h in ref.history]
    (trace,) = (tmp_path / "trace").iterdir()
    assert trace.name == "trace_iter_1_10.json"
    names = {e.get("name", "") for e in
             json.loads(trace.read_text())["traceEvents"]}
    assert any("index_add" in n for n in names)
