"""Build and load the port's CUDA kernels.

The kernels under insider_tpu_torch/csrc/ have a plain C interface.  At
first use they are compiled by nvcc, from the package's own sources (one
nvcc process per source file, all at once), and linked into one shared
library under insider_tpu_torch/_build/<hash of the sources>/, which is
loaded with ctypes.  Nothing here runs when the module is imported:
the CPU tests import every module of the package on machines with no CUDA
toolkit.

Every C entry point launches on the stream it is given, allocates nothing
and returns cudaGetLastError(); `check` turns a nonzero code into an
exception, so a launch that was refused never passes silently.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libinsider_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
_F = ctypes.c_float

# C signatures: name -> (restype, argtypes).  Pointers and the stream are
# c_void_p: a bare Python int would be passed as a 32-bit int.
_SIGNATURES = {
    "insider_error_string": (ctypes.c_char_p, [_I]),
    "insider_level_gram_scratch": (_L, [_I, _I, _I, _I]),
    "insider_level_gram": (_I, [_P, _P, _P, _P, _L, _I, _I, _I, _I, _P]),
    "insider_row_xty_scratch": (_L, [_I, _I, _I]),
    "insider_row_xty": (_I, [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _L,
                             _I, _I, _I, _I, _P]),
    "insider_fss_fused": (_I, [_P, _I, _P, _P, _P, _P, _F, _F, _F,
                               _I, _I, _I, _I, _I, _P]),
    "insider_col_gram_xty": (_I, [_P, _I, _P, _P, _P, _P, _I, _I, _I, _P]),
    "insider_fss_streamed": (_I, [_P, _P, _P, _P, _P, _F, _F, _F,
                                  _I, _I, _I, _I, _P]),
    "insider_fss_shared": (_I, [_P, _P, _P, _P, _F, _F, _F,
                                _I, _I, _I, _I, _I, _P]),
    "insider_fss_shared_widths": (_I, [_I, ctypes.POINTER(_I),
                                       ctypes.POINTER(_I),
                                       ctypes.POINTER(_I)]),
    "insider_cd_fused": (_I, [_P, _I, _P, _P, _P, _P, _F, _F, _F,
                              _I, _I, _I, _I, _I, _P]),
    "insider_cd_fused_widths": (_I, [_I, ctypes.POINTER(_I),
                                     ctypes.POINTER(_I), ctypes.POINTER(_I)]),
    "insider_cd_streamed": (_I, [_P, _P, _P, _P, _P, _F, _F, _F,
                                 _I, _I, _I, _I, _P]),
    "insider_cd_streamed_widths": (_I, [_I, ctypes.POINTER(_I),
                                        ctypes.POINTER(_I),
                                        ctypes.POINTER(_I)]),
    "insider_cd_shared": (_I, [_P, _P, _P, _P, _F, _F, _F,
                               _I, _I, _I, _P]),
    "insider_ctns_cd": (_I, [_P, _P, _P, _P, _P, _F, _F, _I, _I, _I, _P]),
    "insider_masked_eval_scratch": (_L, [_I, _I, _I]),
    "insider_masked_eval": (_I, [_P, _P, _P, _I, _P, _P, _P, _P, _L,
                                 _I, _I, _I, _P]),
}


def sources():
    """The kernel sources, in a fixed order."""
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of insider_tpu_torch "
                       "need the CUDA toolkit (set CUDA_HOME or PATH)")


def build() -> Path:
    """Compile the kernels unless a library for these sources exists.

    Returns the library's path.  Every source compiles to an object in its
    own nvcc process, all started together; the objects link into a library
    written to a temporary name and renamed into place, so a concurrent
    build never loads a half-written file.  nvcc's output (including
    -Xptxas -v register and spill counts) is kept beside it as build.log.
    """
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(dir=out_dir)
    nvcc = _nvcc()
    t0 = time.time()
    cmds = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
             os.path.join(work, src.stem + ".o")]
            for src in sorted(CSRC.glob("*.cu"))]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    tmp = os.path.join(work, LIB_NAME)
    link = [nvcc, "-shared", "-o", tmp, *[c[-1] for c in cmds]]
    rcs = [p.returncode for p in procs]
    if not any(rcs):
        proc = subprocess.run(link, capture_output=True, text=True)
        cmds.append(link)
        outs.append(proc.stdout + proc.stderr)
        rcs.append(proc.returncode)
    log = f"# {time.time() - t0:.1f} s\n" + "".join(
        f"$ {' '.join(c)}\n# rc {rc}\n{out}"
        for c, rc, out in zip(cmds, rcs, outs))
    (out_dir / "build.log").write_text(log)
    if any(rcs):
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError(f"nvcc failed building insider_tpu_torch "
                           f"kernels:\n{log}")
    os.replace(tmp, lib_path)
    shutil.rmtree(work, ignore_errors=True)
    return lib_path


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    handle = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return handle


def column_counter(t: torch.Tensor) -> torch.Tensor:
    """One int32 of scratch on t's device for a kernel's column counter
    (the kernel's entry point zeroes it on the stream)."""
    return torch.empty(1, dtype=torch.int32, device=t.device)


def widths(entry: str, K: int, device) -> list:
    """[(L, columns an SM holds)] of a column kernel's instances at this K
    on the CUDA device (the current one by default), the one it runs first,
    from its C entry point `entry`."""
    n, ls, columns = ctypes.c_int(0), (ctypes.c_int * 4)(), \
        (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        err = getattr(lib(), entry)(int(K), ctypes.byref(n), ls, columns)
    check(err, entry)
    return [(ls[i], columns[i]) for i in range(n.value)]


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib().insider_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream(t: torch.Tensor):
    """PyTorch's current stream on t's device, as a C pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(what: str, *tensors: torch.Tensor,
                 dtypes=(torch.float32,)) -> None:
    """Validate kernel operands: one CUDA device, expected dtypes,
    contiguous.  The kernels index row-major memory directly."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: operands on {t.device} and {dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"{what}: expected {dtypes}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")


MASK_DTYPES = (torch.float32, torch.uint8)


def require_mask(what: str, like: torch.Tensor, *masks: torch.Tensor) -> int:
    """Validate 0/1 mask operands, f32 or uint8 (one dtype for all), on
    `like`'s device, as require_cuda does; returns the C entry points'
    mask_is_u8 flag."""
    require_cuda(what, like, *masks, dtypes=MASK_DTYPES)
    if len({m.dtype for m in masks}) > 1:
        raise TypeError(f"{what}: masks of dtypes "
                        f"{sorted(str(m.dtype) for m in masks)}; expected one")
    return int(masks[0].dtype == torch.uint8)


def on_cpu(what: str, *tensors: torch.Tensor) -> bool:
    """True when every operand lies on the CPU (the plain version runs);
    False when all lie on a CUDA device (the kernel runs).  Anything else
    raises: no operand on a CUDA device ever reaches the plain version."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"{what}: operands on devices {sorted(kinds)}; "
                     "expected all on the CPU or all on one CUDA device")
