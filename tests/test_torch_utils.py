"""The port's copy of the utility helpers (insider_tpu_torch/utils.py)
against insider_tpu.utils, on the cases of tests/test_parity_modules.py
(test_utils_parity) and more: every result equal exactly (the same numpy
code), inputs from seeded generators where they are arrays."""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from insider_tpu import utils as jutils
from insider_tpu_torch import utils

ROOT = Path(__file__).resolve().parent.parent


def _both(name, *args, **kw):
    got = getattr(utils, name)(*args, **kw)
    want = getattr(jutils, name)(*args, **kw)
    return got, want


@pytest.mark.parametrize("idx,num_row", [(1, 5), (5, 5), (6, 5), (12, 5),
                                         (7, 1), (99, 10)])
def test_calculate_idx(idx, num_row):
    got, want = _both("calculate_idx", idx, num_row)
    assert got == want
    assert utils.calculate_idx(6, 5) == (1, 2)


@pytest.mark.parametrize("s", ["AD_x_y_v7_Brain_Cortex", "SCZ_v7_Liver",
                               "BD_a_v7_Brain_Frontal_Cortex_BA9"])
def test_split_str(s):
    got, want = _both("split_str", s)
    assert got == want
    assert utils.split_str("AD_x_y_v7_Brain_Cortex") == ("AD", "Brain_Cortex")


@pytest.mark.parametrize("only_positive", [False, True])
def test_obtain_indication_matrix(only_positive):
    rng = np.random.default_rng(3)
    t = rng.standard_normal((20, 9))
    t[rng.random(t.shape) < 0.2] = np.nan
    got, want = _both("obtain_indication_matrix", t,
                      only_positive=only_positive)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    small = np.array([[1.0, -2.0], [np.nan, 0.5]])
    assert utils.obtain_indication_matrix(
        small, only_positive=only_positive).tolist() == (
        [[1, 1], [0, 1]] if only_positive else [[1, -1], [0, 1]])


def test_rows_helpers():
    m = np.array([[1, 2], [1, 2], [3, 4], [1, 2 + 1e-9]])
    got, want = _both("unique_rows", m)
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [[1, 2], [3, 4]]
    got, want = _both("find_equal_rows", m, np.array([1, 2]))
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [0, 1, 3]
    assert utils.rows_equal(m[0], m[3]) == jutils.rows_equal(m[0], m[3])


@pytest.mark.parametrize("loss,last", [(100.0, 100.0 + 1e-7),
                                       (100.0, 110.0), (1.0, 1.0),
                                       (np.inf, 5.0)])
def test_is_converged(loss, last, capsys):
    got, want = _both("is_converged", loss, last, iter=3, verbose=True)
    assert got == want
    out = capsys.readouterr().out.splitlines()
    assert out[:len(out) // 2] == out[len(out) // 2:]


def test_columns_and_objective():
    rng = np.random.default_rng(7)
    a = rng.standard_normal((4, 3))
    v = rng.standard_normal(3)
    for name in ("add_by_column", "sub_by_column"):
        got, want = _both(name, a, v)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(utils.add_by_column(np.ones((2, 3)),
                                                      [1, 2, 3]),
                                  [[2, 3, 4], [2, 3, 4]])
    X, y, beta = (rng.standard_normal((30, 5)), rng.standard_normal(30),
                  rng.standard_normal(5))
    got, want = _both("objective", X, y, beta, 0.7, 0.4)
    assert got == want
    got, want = _both("init_parameters", 8, 0.5, 0.01, seed=2)
    np.testing.assert_array_equal(got, want)


def test_dump_and_quit_writes_dump(tmp_path):
    p = tmp_path / "dump.pkl"
    code = ("from insider_tpu_torch.utils import dump_and_quit\n"
            f"dump_and_quit({str(p)!r})\n"
            "raise RuntimeError('boom')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       env=env, timeout=120)
    assert r.returncode == 1
    with open(p, "rb") as fh:
        info = pickle.load(fh)
    assert info["type"] == "RuntimeError" and info["message"] == "boom"
