"""ctypes binding to the repo's native host-side data pipeline
(native/insider_io.cpp): numeric CSV/TSV parsing, log2(x+1), the masked
element splitters and raw f32 block reads.

Counterpart of insider_tpu/data/native.py, with the same functions,
signatures, argtypes and results.  The library is built from the repo's own
native/insider_io.cpp with g++ and native/Makefile's flags, at first use,
into insider_tpu_torch/_build/<hash of the source, the compiler, the
flags and the host's CPU>/ (never into native/, which the JAX package's
binding builds with make): the compiler writes a temporary name that is renamed into
place, so concurrent processes never load a half-written file.  Nothing
falls back: where g++ is missing or the build fails, the first call raises
with the compiler's output (a compiler without an OpenMP runtime builds
the source's serial form, the same results on one thread, and warns).
The JAX binding instead reads the file with np.genfromtxt and splits with
numpy's RNG there, which drops the strict check of non-numeric fields and
draws another split.

split_mask_plain and split_mask_block_plain are the splitters' plain numpy
versions: the same splitmix64 stream and selection, equal to the native
results bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import time
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "insider_io.cpp"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libinsider_io.so"
# native/Makefile's CXXFLAGS, and -shared as its rule adds
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-fopenmp", "-std=c++17",
             "-Wall", "-shared"]
# what g++ says with -fopenmp when it has no OpenMP runtime
NO_OPENMP = ("libgomp", "omp.h")

_FP = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I64P = ctypes.POINTER(ctypes.c_int64)

# C signatures: name -> (restype, argtypes), as insider_tpu/data/native.py
# declares them
_SIGNATURES = {
    "insider_csv_shape": (ctypes.c_int, [
        ctypes.c_char_p, ctypes.c_char, ctypes.c_int, _I64P, _I64P]),
    "insider_csv_parse": (ctypes.c_int64, [
        ctypes.c_char_p, ctypes.c_char, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int64, _FP, _I64P]),
    "insider_log2p1": (None, [_FP, ctypes.c_int64]),
    "insider_split_mask": (ctypes.c_int64, [
        _FP, ctypes.c_int64, ctypes.c_double, ctypes.c_uint64,
        _U8P, _U8P, _U8P]),
    "insider_block_read_f32": (ctypes.c_int, [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, _FP]),
    "insider_split_mask_block": (ctypes.c_int64, [
        _FP, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_double, ctypes.c_uint64,
        _U8P, _U8P, _U8P]),
}


def _host_cpu() -> bytes:
    """The host's CPU model and feature flags: -march=native builds for
    them, so a library built on one host is never loaded on another."""
    try:
        with open("/proc/cpuinfo", "rb") as fh:
            return b"".join(line for line in fh
                            if line.startswith((b"model name", b"flags")))
    except OSError:
        return platform.processor().encode()


def source_hash(cxx: str = "", flags=tuple(CXX_FLAGS)) -> str:
    """The build directory's name: a hash of the source, the compiler's
    path, the flags it builds with and the host's CPU."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(cxx.encode() + b"\0" + " ".join(flags).encode())
    h.update(_host_cpu())
    return h.hexdigest()[:16]


def _compile(cxx: str, flags, out_dir: Path):
    """Build the library with `flags` into out_dir (a temporary name
    renamed into place); native_build.log there keeps the command and its
    output.  Returns the finished CompletedProcess."""
    out_dir.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(dir=out_dir)
    tmp = os.path.join(work, LIB_NAME)
    cmd = [cxx, *flags, "-o", tmp, str(SOURCE)]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    (out_dir / "native_build.log").write_text(
        f"# {time.time() - t0:.1f} s\n$ {' '.join(cmd)}\n# rc "
        f"{proc.returncode}\n{proc.stdout}{proc.stderr}")
    if proc.returncode == 0:
        os.replace(tmp, out_dir / LIB_NAME)
    shutil.rmtree(work, ignore_errors=True)
    return proc


def build() -> Path:
    """Compile native/insider_io.cpp unless a library for this source,
    compiler and host exists; returns its path.  Raises RuntimeError with
    the compiler's output when g++ is missing or fails.  A compiler without
    an OpenMP runtime (its libgomp or omp.h missing) builds the source's
    serial form (insider_io.cpp's `#if defined(_OPENMP)`), which computes
    the same results on one thread, into a directory of its own, and every
    process that loads it warns; the -fopenmp build's directory then keeps
    the compiler's refusal in its native_build.log, so it is not tried
    again."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native IO library of "
                           "insider_tpu_torch is built from "
                           f"{SOURCE} at first use (set CXX or PATH)")
    openmp = BUILD_ROOT / source_hash(cxx, CXX_FLAGS)
    if (openmp / LIB_NAME).exists():
        return openmp / LIB_NAME
    log = openmp / "native_build.log"
    if not (log.exists() and any(s in log.read_text() for s in NO_OPENMP)):
        proc = _compile(cxx, CXX_FLAGS, openmp)
        if proc.returncode == 0:
            return openmp / LIB_NAME
        if not any(s in proc.stderr for s in NO_OPENMP):
            raise RuntimeError(f"g++ failed building {SOURCE} (rc "
                               f"{proc.returncode}):\n{proc.stderr}")
    warnings.warn(f"{cxx} has no OpenMP runtime; the native IO library is "
                  "built without -fopenmp and runs on one thread")
    flags = [f for f in CXX_FLAGS if f != "-fopenmp"]
    serial = BUILD_ROOT / source_hash(cxx, flags)
    if not (serial / LIB_NAME).exists():
        proc = _compile(cxx, flags, serial)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed building {SOURCE} without "
                               f"-fopenmp (rc {proc.returncode}):\n"
                               f"{proc.stderr}")
    return serial / LIB_NAME


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The loaded native library (built on first call)."""
    handle = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return handle


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def load_csv(path: str, delim: str = ",", skip_header: bool = False,
             strict: bool = True) -> np.ndarray:
    """Parse a numeric CSV/TSV into float32 (NaN for NA/NaN/N/A/empty
    fields; double-quoted fields unwrapped).

    strict: raise ValueError when any field is neither numeric nor a
    recognized NA token (e.g. "N5", "null") instead of reading it as
    missing data.
    """
    handle = lib()
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    rc = handle.insider_csv_shape(path.encode(), delim.encode(),
                                  int(skip_header), ctypes.byref(rows),
                                  ctypes.byref(cols))
    if rc != 0:
        raise IOError(f"insider_csv_shape({path}) failed: {rc}")
    out = np.empty((rows.value, cols.value), np.float32)
    bad = ctypes.c_int64()
    done = handle.insider_csv_parse(
        path.encode(), delim.encode(), int(skip_header), rows.value,
        cols.value, _ptr(out, _FP), ctypes.byref(bad))
    if done != rows.value:
        raise IOError(f"insider_csv_parse parsed {done}/{rows.value} rows")
    if strict and bad.value:
        raise ValueError(
            f"{path}: {bad.value} field(s) are neither numeric nor NA/NaN "
            f"(pass strict=False to read them as missing)")
    return out


def log2p1(data: np.ndarray) -> np.ndarray:
    """In-place log2(x+1) (README.md:47) on a float32 array (a copy when
    `data` is not C-contiguous float32), negatives read as 0."""
    data = np.ascontiguousarray(data, np.float32)
    lib().insider_log2p1(_ptr(data, _FP), data.size)
    return data


def split_mask(data: np.ndarray, ratio: float, seed: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """(train, test, na) uint8 masks + n_test, ratio_splitter semantics:
    the floor(ratio * observed) observed elements with the smallest
    splitmix64(seed ^ index) hashes are the test set."""
    data32 = np.ascontiguousarray(data, np.float32)
    train = np.empty(data.shape, np.uint8)
    test = np.empty(data.shape, np.uint8)
    na = np.empty(data.shape, np.uint8)
    picked = lib().insider_split_mask(
        _ptr(data32, _FP), data32.size, float(ratio), int(seed),
        _ptr(train, _U8P), _ptr(test, _U8P), _ptr(na, _U8P))
    return train, test, na, int(picked)


def read_block(path: str, global_shape: Tuple[int, int],
               rows: Tuple[int, int], cols: Tuple[int, int]) -> np.ndarray:
    """Read block [r0,r1) x [c0,c1) of a raw row-major float32 matrix file
    (pread per row, OpenMP over rows): a process touches only its own
    block's bytes."""
    _, M = global_shape
    (r0, r1), (c0, c1) = rows, cols
    out = np.empty((r1 - r0, c1 - c0), np.float32)
    rc = lib().insider_block_read_f32(path.encode(), M, r0, r1, c0, c1,
                                      _ptr(out, _FP))
    if rc != 0:
        raise IOError(f"insider_block_read_f32({path}, rows={rows}, "
                      f"cols={cols}) failed: {rc}")
    return out


def split_mask_block(global_shape: Tuple[int, int],
                     rows: Tuple[int, int], cols: Tuple[int, int],
                     ratio: float, seed: int,
                     data_block: Optional[np.ndarray] = None,
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(train, test, na) uint8 masks for ONE block of a global split,
    deterministic in (seed, global element index), so independently made
    blocks tile into one global split.

    Element-wise Bernoulli(ratio) on the splitmix64 stream, NOT split_mask's
    exact floor(n * ratio) selection (that needs a global pass): the same
    (data, seed) gives another partition through the two splitters.
    data_block: the block's values, whose NaNs join neither set.
    """
    _, M = global_shape
    (r0, r1), (c0, c1) = rows, cols
    shape = (r1 - r0, c1 - c0)
    train = np.empty(shape, np.uint8)
    test = np.empty(shape, np.uint8)
    na = np.empty(shape, np.uint8)
    block = (None if data_block is None else
             np.ascontiguousarray(data_block, np.float32))
    dptr = None if block is None else _ptr(block, _FP)
    lib().insider_split_mask_block(
        dptr, M, r0, r1, c0, c1, float(ratio), int(seed),
        _ptr(train, _U8P), _ptr(test, _U8P), _ptr(na, _U8P))
    return train, test, na


def splitmix64(x: np.ndarray) -> np.ndarray:
    """The native splitters' hash of uint64 keys (insider_io.cpp)."""
    x = np.asarray(x, np.uint64)
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def split_mask_plain(data: np.ndarray, ratio: float, seed: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """split_mask's plain numpy version: the same hashes, and the test set
    the observed elements at or below the k-th smallest of them."""
    nan = np.isnan(np.asarray(data, np.float32))
    na = nan.astype(np.uint8)
    train = (~nan).astype(np.uint8)
    test = np.zeros(nan.shape, np.uint8)
    obs = np.flatnonzero(~nan.ravel())
    k = int(obs.size * ratio)
    if k <= 0:
        return train, test, na, 0
    h = splitmix64(obs.astype(np.uint64) ^ np.uint64(seed))
    pick = obs[h <= np.partition(h, k - 1)[k - 1]]
    test.ravel()[pick] = 1
    train.ravel()[pick] = 0
    return train, test, na, int(pick.size)


def split_mask_block_plain(global_shape: Tuple[int, int],
                           rows: Tuple[int, int], cols: Tuple[int, int],
                           ratio: float, seed: int,
                           data_block: Optional[np.ndarray] = None,
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """split_mask_block's plain numpy version (the same splitmix64 stream
    and cut)."""
    _, M = global_shape
    (r0, r1), (c0, c1) = rows, cols
    shape = (r1 - r0, c1 - c0)
    gi = (np.arange(r0, r1, dtype=np.uint64)[:, None] * np.uint64(M)
          + np.arange(c0, c1, dtype=np.uint64)[None, :])
    x = splitmix64(gi ^ np.uint64(seed))
    cut = (np.uint64(0xFFFFFFFFFFFFFFFF) if ratio >= 1.0
           else np.uint64(ratio * 18446744073709551616.0))
    test = (x < cut).astype(np.uint8)
    na = (np.zeros(shape, np.uint8) if data_block is None
          else np.isnan(data_block).astype(np.uint8))
    test[na == 1] = 0
    train = ((test == 0) & (na == 0)).astype(np.uint8)
    return train, test, na


def file_ingest_callbacks(path: str, global_shape: Tuple[int, int],
                          ratio: float, seed: int):
    """(data_cb, train_cb, test_cb) for train/als.build_problem_distributed
    (insider_tpu/data/native.py:251-289): each takes the tuple of slices
    of a rank's block and returns that block, the data read from the raw
    row-major f32 file at `path` (read_block) and the masks made by the
    block splitter (split_mask_block, its NaNs in neither), so no process
    holds more than its own block and every rank sees one global split.

    The split is Bernoulli(ratio) per element, not ratio_splitter's exact
    count: the same (data, seed) in memory holds out other elements.
    """
    N, M = global_shape

    def bounds(index):
        rs, cs = index[0].indices(N), index[1].indices(M)
        return (rs[0], rs[1]), (cs[0], cs[1])

    def data_cb(index):
        return read_block(path, global_shape, *bounds(index))

    def masks(index):
        rows, cols = bounds(index)
        return split_mask_block(global_shape, rows, cols, ratio, seed,
                                data_block=read_block(path, global_shape,
                                                      rows, cols))

    return data_cb, (lambda index: masks(index)[0]), (
        lambda index: masks(index)[1])
