"""Routing, build and launch counts for the port's hand-written CUDA kernels.

Takes over the role of the JAX package's ``ops/pallas_gru.default_interpret``.

- **Routing.** Every kernel wrapper takes ``impl``: ``'auto'`` launches the
  kernel for a CUDA tensor and runs the plain PyTorch version for a CPU
  tensor; ``'kernel'`` on a CPU tensor raises; ``'plain'`` runs the plain
  version on any device. For a CUDA tensor a wrapper launches the kernel or
  raises: nothing falls back.
- **Build.** ``csrc/*.cu`` compile with ``nvcc`` for ``sm_90a`` into one
  shared library with a plain C interface, at first use, under
  ``build/torch_kernels/<hash of sources and flags>/``, and load with
  ``ctypes``. Importing this module builds nothing and needs no CUDA.
- **Counting.** Each :class:`Kernel` counts its successful launches in a
  plain integer, so a run can show that the main path went through it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import NamedTuple, Optional, Sequence

import torch

IMPLS = ("auto", "kernel", "plain")

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
_LIB_NAME = "libsst_kernels.so"


def use_kernel(impl: str, t: torch.Tensor) -> bool:
    """True when ``impl`` sends tensor ``t`` to the CUDA kernel.

    The plain version runs only for ``impl='plain'`` or for a tensor that
    lies on the CPU under ``impl='auto'``."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; the port takes one of "
                         f"{IMPLS}")
    if impl == "plain":
        return False
    if t.is_cuda:
        return True
    if impl == "kernel":
        raise ValueError(f"impl='kernel' needs a CUDA tensor, got one on "
                         f"{t.device}")
    return False


def find_nvcc() -> str:
    """nvcc from PATH, else from $CUDA_HOME/bin or /usr/local/cuda/bin."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from csrc/*.cu at first use; use "
        "impl='plain' or a CPU device to run without them")


def _sources() -> list[Path]:
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def _source_hash(srcs: Sequence[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(srcs) + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


class BuildInfo(NamedTuple):
    """What :func:`build` did: the library path, whether it compiled (or
    found a build of the same sources), the seconds it took and nvcc's
    output (the ``-Xptxas -v`` register and shared-memory report)."""

    path: Path
    compiled: bool
    seconds: float
    log: str


def build() -> BuildInfo:
    """Compile csrc/*.cu into one shared library, unless a build of the same
    sources and flags exists. Raises with nvcc's output if it fails."""
    srcs = _sources()
    out_dir = BUILD_ROOT / _source_hash(srcs)
    lib = out_dir / _LIB_NAME
    log_path = out_dir / "nvcc.log"
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuildInfo(lib, False, 0.0, log)
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)
    return BuildInfo(lib, True, seconds, log)


_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build().path))
            lib.sst_cuda_error_string.argtypes = [ctypes.c_int]
            lib.sst_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


class Kernel:
    """One exported C launch function of the kernel library.

    ``argtypes`` must give ``ctypes.c_void_p`` for every pointer and the
    stream, or ctypes passes them as 32-bit ints. The C function returns
    the ``cudaError_t`` of its launch; :meth:`launch` raises if it is not 0
    and otherwise adds one to :attr:`launches`."""

    registry: dict[str, "Kernel"] = {}

    def __init__(self, name: str, symbol: str, argtypes: list):
        self.name, self.symbol, self.argtypes = name, symbol, argtypes
        self.launches = 0
        Kernel.registry[name] = self

    def launch(self, *args) -> None:
        lib = library()
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = fn(*args)
        if err != 0:
            msg = lib.sst_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err}: {msg}")
        self.launches += 1


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in Kernel.registry.items()}


def reset_launch_counts() -> None:
    for k in Kernel.registry.values():
        k.launches = 0
