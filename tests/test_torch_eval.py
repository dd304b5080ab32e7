"""The port's masked-eval kernel (insider_tpu_torch/kernels/eval.py) against
the JAX package's Pallas kernel in interpret mode, on the same numpy inputs.

The JAX kernel returns (hi, lo) double-single pairs, compared as hi + lo in
f64; the port returns f64.  Tolerance: 1e-5 relative on the SSEs (the f32
residual is rounded in another order; the JAX package's own kernel test uses
the same bound, tests/test_eval_pallas.py:46-47), counts exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insider_tpu.kernels.eval_pallas import masked_eval_pallas
from insider_tpu_torch.kernels.eval import masked_eval
from insider_tpu_torch.ops import losses


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _mk(N, M, K, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((N, M)).astype(np.float32)
    train = (rng.random((N, M)) < 0.85).astype(np.float32)
    test = ((rng.random((N, M)) < 0.5) * (1.0 - train)).astype(np.float32)
    R = (rng.standard_normal((N, K)) * 0.3).astype(np.float32)
    F = (rng.standard_normal((K, M)) * 0.3).astype(np.float32)
    return data, train, test, R, F


@pytest.mark.parametrize("shape", [(64, 256, 8), (97, 331, 24)])
def test_matches_pallas_eval(shape):
    N, M, K = shape
    data, train, test, R, F = _mk(N, M, K)
    tr, te, nt, ne = masked_eval_pallas(
        jnp.asarray(data), jnp.asarray(train), jnp.asarray(test),
        jnp.asarray(R), jnp.asarray(F), interpret=True)
    ev = masked_eval(*(torch.from_numpy(x) for x in (data, train, test, R, F)))
    assert all(x.dtype == torch.float64 for x in ev)
    ref_tr = float(tr[0]) + float(tr[1])
    ref_te = float(te[0]) + float(te[1])
    assert abs(float(ev.train_sse) - ref_tr) <= 1e-5 * abs(ref_tr)
    assert abs(float(ev.test_sse) - ref_te) <= 1e-5 * abs(ref_te)
    assert float(ev.n_train) == float(nt)
    assert float(ev.n_test) == float(ne)


def test_loss_finalize_matches_jax():
    """finalize_loss on the port's f64 sums gives the JAX package's
    quantities (its (hi, lo) pairs hold the same sums)."""
    from insider_tpu.ops import losses as jlosses

    data, train, test, R, F = _mk(40, 120, 5, seed=2)
    V = [np.random.default_rng(3).standard_normal((4, 5)).astype(np.float32)]
    ev_j = jlosses.evaluate_masked(
        jnp.asarray(data) - jnp.asarray(R) @ jnp.asarray(F),
        jnp.asarray(train), jnp.asarray(test))
    reg_j = jlosses.regularization_sums([jnp.asarray(v) for v in V], None,
                                        jnp.asarray(F))
    want = jlosses.finalize_metrics_vec(jlosses.pack_metrics(ev_j, reg_j),
                                        2.0, 2.0, 0.4, True)
    t = [torch.from_numpy(x) for x in (data, train, test, R, F)]
    ev = masked_eval(*t)
    reg = losses.regularization_sums([torch.from_numpy(v) for v in V], None,
                                     t[4])
    got = losses.finalize_metrics_vec(losses.pack_metrics(ev, reg), 2.0,
                                      2.0, 0.4, True)
    for key in ("loss", "train_rmse", "test_rmse", "row_reg_loss",
                "col_reg_loss", "l1_reg_loss"):
        assert got[key] == pytest.approx(want[key], rel=1e-6), key
