"""A fixture that points the JAX package's native binding
(insider_tpu/data/native.py) at a private build directory.

The JAX binding runs `make` in native/ at first use, which writes
native/libinsider_io.so in place; tests/test_native_io.py does so in its
own worker, and a second process running make on the same file at the same
time could load a half-written library.  This fixture copies native/'s
Makefile and source to a temporary directory, once a test process, and
lets the binding build and load its library there: the binding's own code
(its make build, its ctypes declarations) runs unchanged, on the same
source.
"""

import shutil
from pathlib import Path

import pytest

NATIVE = Path(__file__).resolve().parent.parent / "native"


_WORK = []     # the copy of this test process, made at its first use


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """insider_tpu.data.native with its library built privately: one copy
    of native/'s Makefile and source for each test process, where the
    binding's make builds the library once and is a no-op for every later
    module."""
    from insider_tpu.data import native as jnat

    if shutil.which("g++") is None or shutil.which("make") is None:
        pytest.skip("g++ or make not found")
    if not _WORK:
        work = tmp_path_factory.mktemp("native")
        for name in ("Makefile", "insider_io.cpp"):
            shutil.copy(NATIVE / name, work / name)
        _WORK.append(work)
    work = _WORK[0]
    mp = pytest.MonkeyPatch()
    mp.setattr(jnat, "_NATIVE_DIR", str(work))
    mp.setattr(jnat, "_SO", str(work / "libinsider_io.so"))
    mp.setattr(jnat, "_lib", None)
    mp.setattr(jnat, "_tried", False)
    assert jnat.native_available(), "the JAX binding's build failed"
    yield jnat
    mp.undo()
