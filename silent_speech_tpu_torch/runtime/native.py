"""Build and bind the port's native ring buffer (csrc/ringbuf.cpp).

The JAX package's loader (runtime/native.py there) builds its library into
one fixed path and, once a build or a load fails, returns None for the
rest of the process; its ring then becomes a Python deque. The port has no
such path: :func:`load` builds the ring with ``g++`` into
``build/torch_runtime/<hash of the source and flags>/``, writing to a
temporary name in that directory and renaming it into place
(``os.replace``, as ``ops/_kernels.build`` does), so processes that build
at once each finish with a whole library; a failed build raises with the
compiler's stderr, and nothing is remembered as tried. Importing this
module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "ringbuf.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_runtime"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_LIB_NAME = "libsst_ring.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / _LIB_NAME


def build() -> Path:
    """Compile csrc/ringbuf.cpp unless a library of the same source and
    flags exists. Raises RuntimeError with the compiler's output if g++ is
    missing or fails."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native frame ring "
                           f"is built from {SOURCE} at first use")
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=lib.parent, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE),
                               "-lpthread"], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) on "
                               f"{SOURCE}:\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def load() -> ctypes.CDLL:
    """The loaded ring library, built at first use; raises if it cannot
    be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
        return _lib


def _declare(lib: ctypes.CDLL) -> None:
    u64 = ctypes.c_uint64
    p8 = ctypes.POINTER(ctypes.c_uint8)
    lib.rb_create.restype = ctypes.c_void_p
    lib.rb_create.argtypes = [u64, u64]
    lib.rb_destroy.argtypes = [ctypes.c_void_p]
    lib.rb_capacity.restype = u64
    lib.rb_capacity.argtypes = [ctypes.c_void_p]
    lib.rb_slot_bytes.restype = u64
    lib.rb_slot_bytes.argtypes = [ctypes.c_void_p]
    lib.rb_size.restype = u64
    lib.rb_size.argtypes = [ctypes.c_void_p]
    lib.rb_dropped.restype = u64
    lib.rb_dropped.argtypes = [ctypes.c_void_p]
    lib.rb_push.restype = ctypes.c_int
    lib.rb_push.argtypes = [ctypes.c_void_p, p8, u64, u64]
    lib.rb_pop.restype = ctypes.c_int
    lib.rb_pop.argtypes = [ctypes.c_void_p, p8, u64, ctypes.POINTER(u64)]
    lib.rb_pop_batch.restype = u64
    lib.rb_pop_batch.argtypes = [ctypes.c_void_p, p8, u64,
                                 ctypes.POINTER(u64)]
