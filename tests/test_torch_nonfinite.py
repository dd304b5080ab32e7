"""The column solvers on inputs that hold non-finite values, against the
JAX package's TPU kernels (in interpret mode) as the witness of what they
give there.

One input, each of its poisoned columns alone: column 1's data a NaN at a
train element, column 2's an Inf, column 3's warm start a NaN.  The FSS
kernels give every such column NaN; the CD kernels those of the Inf and
the NaN warm start (a NaN in Xty fails their screen, and the column
solves to zero).  On CPU tensors the port's wrappers run their plain
versions, which must give non-finite the same columns as the TPU kernels,
and the other columns within the kernel tests' tolerances (rtol 2e-5, atol
1e-5).  The CUDA kernels are held to the plain versions on the same
inputs in tests/test_torch_cuda.py and in chip_smoke.py's phase 5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insider_tpu.kernels import cd_pallas as cdp
from insider_tpu.kernels import fss_pallas as fp
from insider_tpu_torch.kernels import cd, fss
from insider_tpu_torch.ops.col_update import col_gram_masked

N, K, M = 45, 6, 20
LAM, ALPHA, TOL = 2.0, 0.5, 1e-9


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs():
    rng = np.random.default_rng(7)
    R = rng.standard_normal((N, K)).astype(np.float32)
    mask = (rng.random((N, M)) > 0.1).astype(np.float32)
    data = rng.standard_normal((N, M)).astype(np.float32)
    beta0 = (0.01 * rng.standard_normal((K, M))).astype(np.float32)
    for j, v in ((1, np.nan), (2, np.inf)):
        data[np.argmax(mask[:, j] > 0), j] = v
    beta0[0, 3] = np.nan
    return R, mask, data, beta0


def _grams(R, mask, data):
    t = torch.from_numpy
    G = col_gram_masked(t(R), t(mask)).permute(1, 2, 0).contiguous()
    xty = torch.matmul(t(R).T, t(mask) * t(data))
    return G, xty, t(R).T @ t(R), t(R).T @ t(data)


def _run(name):
    """(the TPU kernel's beta, the port's) of kernel `name`."""
    R, mask, data, beta0 = _inputs()
    G, xty, Gs, xtys = _grams(R, mask, data)
    t, J = torch.from_numpy, jnp.asarray
    fkw = dict(polish_sweeps=4, tol=jnp.float32(TOL), interpret=True,
               block=512)
    tkw = dict(max_outer=32, polish_sweeps=4, tol=TOL)
    if name == "feature_sign_fused":
        want = fp.feature_sign_fused_pallas(J(mask), J(mask * data), J(R),
                                            J(beta0), LAM, ALPHA, 32, **fkw)
        got = fss.feature_sign_fused(t(mask), t(data), t(R), t(beta0), LAM,
                                     ALPHA, **tkw)
    elif name == "feature_sign":
        want = fp.feature_sign_pallas(J(G.numpy()), J(xty.numpy()), J(beta0),
                                      LAM, ALPHA, 32, **fkw)
        got = fss.feature_sign(G, xty, t(beta0), LAM, ALPHA, **tkw)
    elif name == "feature_sign_shared":
        want = fp.feature_sign_shared_pallas(J(Gs.numpy()), J(xtys.numpy()),
                                             J(beta0), LAM, ALPHA, 32, **fkw)
        got = fss.feature_sign_shared(Gs, xtys, t(beta0), LAM, ALPHA, **tkw)
    elif name == "cd_fused":
        want = cdp.elastic_net_cd_fused_pallas(
            J(mask), J(mask * data), J(R), J(beta0), LAM, ALPHA, TOL,
            interpret=True, block=512)
        got = cd.cd_fused(t(mask), t(data), t(R), t(beta0), LAM, ALPHA, TOL)
    elif name == "cd_streamed":
        want = cdp.elastic_net_cd_pallas(J(G.numpy()), J(xty.numpy()),
                                         J(beta0), LAM, ALPHA, TOL,
                                         interpret=True, block=512)
        got = cd.cd_streamed(G, xty, t(beta0), LAM, ALPHA, TOL)
    else:
        want = cdp.elastic_net_cd_shared_pallas(
            J(Gs.numpy()), J(xtys.numpy()), J(beta0), LAM, ALPHA, TOL,
            interpret=True, block=512)
        got = cd.cd_shared(Gs, xtys, t(beta0), LAM, ALPHA, TOL)
    want = want[0] if isinstance(want, tuple) else want
    return np.asarray(want), got.numpy()


def _nonfinite_columns(beta):
    return np.flatnonzero(~np.isfinite(beta).all(axis=0)).tolist()


@pytest.mark.parametrize("name,bad", [
    ("feature_sign_fused", [1, 2, 3]), ("feature_sign", [1, 2, 3]),
    ("feature_sign_shared", [1, 2, 3]), ("cd_fused", [2, 3]),
    ("cd_streamed", [2, 3]), ("cd_shared", [2, 3])])
def test_nonfinite_columns_match_the_tpu_kernel(name, bad):
    want, got = _run(name)
    assert _nonfinite_columns(want) == bad
    assert _nonfinite_columns(got) == bad
    if name.startswith("feature_sign"):       # such a column is all NaN
        assert np.isnan(got[:, bad]).all() and np.isnan(want[:, bad]).all()
    keep = np.isfinite(got).all(axis=0)
    np.testing.assert_allclose(got[:, keep], want[:, keep], rtol=2e-5,
                               atol=1e-5)
