"""The port's native IO binding (insider_tpu_torch/data/native.py) against the
JAX package's (insider_tpu/data/native.py).

Both load a library built from the same native/insider_io.cpp (the port's
under insider_tpu_torch/_build/, the JAX package's with its own make build,
in a private directory: tests/jax_native_private.py), so every
result is held equal bit for bit: parsed arrays (NaN at the same fields),
log2p1, the masks and test counts of both splitters, block reads.  The
splitters' plain numpy versions equal the native ones bit for bit.  A build
that fails, or a missing compiler, raises.  Inputs from seeded numpy
generators.  Skipped only where g++ is absent, as the JAX tests skip where
their library cannot be built.
"""

import os
import shutil
from pathlib import Path

import numpy as np
import pytest

from insider_tpu_torch.data import native as tnat
from jax_native_private import jax_native  # noqa: F401 (fixture)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="g++ not found")


@pytest.fixture()
def jnat(jax_native):
    """The JAX binding, its library built in a private directory
    (tests/jax_native_private.py)."""
    return jax_native


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8) if a.dtype == np.float32
                                  else a,
                                  b.view(np.uint8) if b.dtype == np.float32
                                  else b)


def _table(seed, n=40, m=13, na=0.05):
    rng = np.random.default_rng(seed)
    arr = (rng.standard_normal((n, m)) * 10.0 ** rng.integers(-3, 5, (n, m))
           ).astype(np.float32)
    arr[rng.random(arr.shape) < na] = np.nan
    return arr


def _write(path, arr, delim=",", header=False, quote_every=0, na="NA"):
    with open(path, "w") as fh:
        if header:
            fh.write(delim.join(f"c{i}" for i in range(arr.shape[1])) + "\n")
        k = 0
        for row in arr:
            fields = []
            for v in row:
                s = na if np.isnan(v) else "%.9g" % v
                k += 1
                if quote_every and k % quote_every == 0:
                    s = f'"{s}"'
                fields.append(s)
            fh.write(delim.join(fields) + "\n")


@pytest.mark.parametrize("delim,header,quote_every,na", [
    (",", True, 0, "NA"), (",", False, 7, "NaN"), ("\t", True, 5, "N/A"),
    ("\t", False, 0, ""), (",", True, 3, "na")])
def test_load_csv_matches_jax(jnat, tmp_path, delim, header, quote_every,
                              na):
    """CSV and TSV, with and without a header, quoted fields and each NA
    spelling: the same f32 array bit for bit, and %.9g reads back exactly."""
    arr = _table(1)
    p = str(tmp_path / ("t.tsv" if delim == "\t" else "t.csv"))
    _write(p, arr, delim, header, quote_every, na)
    got = tnat.load_csv(p, delim, skip_header=header)
    _same(got, jnat.load_csv(p, delim, skip_header=header))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(arr))
    _same(np.nan_to_num(got), np.nan_to_num(arr))


def test_load_csv_strict_matches_jax(jnat, tmp_path):
    """Fields that are neither numeric nor an NA token raise in both, with
    the same count; strict=False reads them as NaN in both."""
    p = str(tmp_path / "bad.csv")
    with open(p, "w") as fh:
        fh.write('1.0,N5,3.0\n4.0,null,"6"\n 7 ,NA,x9\n')
    for nat in (tnat, jnat):
        with pytest.raises(ValueError, match="3 field"):
            nat.load_csv(p, ",")
    _same(tnat.load_csv(p, ",", strict=False),
          jnat.load_csv(p, ",", strict=False))


def test_load_csv_missing_file_raises(tmp_path):
    with pytest.raises(IOError):
        tnat.load_csv(str(tmp_path / "none.csv"))


def test_log2p1_matches_jax(jnat):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((60, 17)) * 50).astype(np.float32)
    _same(tnat.log2p1(x.copy()), jnat.log2p1(x.copy()))
    y = x.copy()
    assert tnat.log2p1(y) is y                      # in place on f32
    # a non-f32 input is converted, as in the JAX binding
    _same(tnat.log2p1(x.astype(np.float64)),
          jnat.log2p1(x.astype(np.float64)))


@pytest.mark.parametrize("shape,ratio,seed,na", [
    ((200, 100), 0.1, 123, 0.05), ((37, 53), 0.25, 7, 0.0),
    ((10, 10), 0.001, 1, 0.2), ((64, 300), 0.5, 99, 0.3)])
def test_split_mask_matches_jax_and_plain(jnat, shape, ratio, seed, na):
    """The native exact-k splitter: the same masks and count as the JAX
    binding's, and its plain numpy version equals it bit for bit."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal(shape).astype(np.float32)
    data[rng.random(shape) < na] = np.nan
    got = tnat.split_mask(data, ratio, seed)
    want = jnat.split_mask(data, ratio, seed)
    plain = tnat.split_mask_plain(data, ratio, seed)
    for g, w, p in zip(got[:3], want[:3], plain[:3]):
        _same(g, w)
        _same(g, p)
    n_obs = int((~np.isnan(data)).sum())
    assert got[3] == want[3] == plain[3] == int(n_obs * ratio)
    assert int(got[1].sum()) == got[3]
    np.testing.assert_array_equal(got[0] + got[1] + got[2],
                                  np.ones(shape, np.uint8))


def test_read_block_matches_jax(jnat, tmp_path):
    rng = np.random.default_rng(5)
    N, M = 37, 53
    x = rng.standard_normal((N, M)).astype(np.float32)
    path = str(tmp_path / "mat.f32")
    x.tofile(path)
    for rows, cols in (((5, 21), (7, 40)), ((0, N), (0, M)), ((36, 37),
                                                              (0, 1))):
        got = tnat.read_block(path, (N, M), rows, cols)
        _same(got, jnat.read_block(path, (N, M), rows, cols))
        _same(got, x[rows[0]:rows[1], cols[0]:cols[1]])
    with pytest.raises(IOError):
        tnat.read_block(path, (N + 5, M), (N, N + 5), (0, M))


@pytest.mark.parametrize("with_data", [False, True])
@pytest.mark.parametrize("rows,cols,ratio,seed", [
    ((3, 20), (5, 33), 0.2, 99), ((0, 40), (0, 64), 0.1, 123),
    ((0, 6), (0, 8), 1.0, 7)])
def test_split_mask_block_matches_jax_and_plain(jnat, with_data, rows, cols,
                                                ratio, seed):
    """The block splitter: the JAX binding's masks bit for bit, and the
    plain numpy version the native one's (tests/test_native_io.py:140 holds
    the JAX package's numpy fallback to its native one the same way)."""
    N, M = 40, 64
    rng = np.random.default_rng(seed)
    full = rng.standard_normal((N, M)).astype(np.float32)
    full[rng.random(full.shape) < 0.1] = np.nan
    blk = full[rows[0]:rows[1], cols[0]:cols[1]] if with_data else None
    got = tnat.split_mask_block((N, M), rows, cols, ratio, seed,
                                data_block=blk)
    want = jnat.split_mask_block((N, M), rows, cols, ratio, seed,
                                 data_block=blk)
    plain = tnat.split_mask_block_plain((N, M), rows, cols, ratio, seed,
                                        data_block=blk)
    for g, w, p in zip(got, want, plain):
        _same(g, w)
        _same(g, p)


def test_split_mask_block_tiles_consistently():
    """Blocks made alone tile into the whole matrix's split."""
    N, M, ratio, seed = 40, 64, 0.1, 123
    full = tnat.split_mask_block((N, M), (0, N), (0, M), ratio, seed)
    for rows in ((0, 17), (17, 40)):
        for cols in ((0, 31), (31, 64)):
            blk = tnat.split_mask_block((N, M), rows, cols, ratio, seed)
            for b, f in zip(blk, full):
                _same(b, f[rows[0]:rows[1], cols[0]:cols[1]])


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    """No fallback: a source that does not compile raises, with g++'s
    stderr, and leaves no library behind."""
    src = tmp_path / "insider_io.cpp"
    src.write_text('extern "C" int insider_csv_shape( { }\n')
    monkeypatch.setattr(tnat, "SOURCE", src)
    monkeypatch.setattr(tnat, "BUILD_ROOT", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as ei:
        tnat.build()
    assert "error" in str(ei.value)
    assert not list((tmp_path / "_build").rglob("*.so"))


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(tnat, "BUILD_ROOT", tmp_path / "_build")
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(tnat.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tnat.build()


def test_build_is_cached_per_source(tmp_path, monkeypatch):
    """The library is built once a source, compiler, flags and host into
    its own hashed directory, never into native/; another compiler gets
    another directory."""
    monkeypatch.setattr(tnat, "BUILD_ROOT", tmp_path / "_build")
    cxx = os.environ.get("CXX") or shutil.which("g++")
    first = tnat.build()
    assert first.parent.parent == tmp_path / "_build"
    assert first.parent.name == tnat.source_hash(cxx, tnat.CXX_FLAGS)
    mtime = first.stat().st_mtime_ns
    assert tnat.build() == first and first.stat().st_mtime_ns == mtime
    assert tnat.source_hash(cxx + "x", tnat.CXX_FLAGS) != first.parent.name


@pytest.fixture()
def fresh_lib(tmp_path, monkeypatch):
    """native.lib() loading from an empty build directory."""
    monkeypatch.setattr(tnat, "BUILD_ROOT", tmp_path / "_build")
    tnat.lib.cache_clear()
    yield tmp_path / "_build"
    tnat.lib.cache_clear()


def test_compiler_without_openmp_builds_the_serial_form(jnat, tmp_path,
                                                        monkeypatch,
                                                        fresh_lib):
    """A g++ that cannot link OpenMP (its libgomp spec file missing, as on
    a toolchain without libgomp) builds without -fopenmp, warns, and the
    serial library parses and splits bit for bit as the JAX binding's."""
    fake = tmp_path / "cxx"
    fake.write_text(
        "#!/bin/sh\n"
        'for a in "$@"; do [ "$a" = -fopenmp ] && { echo "g++: fatal '
        "error: cannot read spec file 'libgomp.spec': No such file or "
        'directory" >&2; exit 1; }; done\n'
        f'exec {shutil.which("g++")} "$@"\n')
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    arr = _table(3)
    p = str(tmp_path / "t.csv")
    _write(p, arr, ",", True, 4, "NA")
    with pytest.warns(UserWarning, match="no OpenMP runtime"):
        got = tnat.load_csv(p, ",", skip_header=True)
    openmp = fresh_lib / tnat.source_hash(str(fake), tnat.CXX_FLAGS)
    assert "libgomp.spec" in (openmp / "native_build.log").read_text()
    assert not (openmp / tnat.LIB_NAME).exists()
    # a later process loads the serial build without compiling, and warns
    tnat.lib.cache_clear()
    with pytest.warns(UserWarning, match="no OpenMP runtime"):
        serial = Path(tnat.lib()._name)
    assert serial.parent.name == tnat.source_hash(
        str(fake), [f for f in tnat.CXX_FLAGS if f != "-fopenmp"])
    log = (serial.parent / "native_build.log").read_text()
    assert log.count("$ ") == 1 and "-fopenmp" not in log
    _same(got, jnat.load_csv(p, ",", skip_header=True))
    data = np.where(np.isnan(arr), np.nan, arr)
    for g, w in zip(tnat.split_mask(data, 0.2, 5)[:3],
                    jnat.split_mask(data, 0.2, 5)[:3]):
        _same(g, w)
