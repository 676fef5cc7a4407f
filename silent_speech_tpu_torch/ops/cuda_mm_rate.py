"""The matmul-rate probe's kernel (csrc/mm_rate.cu) and its plain PyTorch
version: the port of the Pallas kernel of scripts/bench_fused_cnn.py
(``_mm_kernel``, called by ``mxu_rate``).

The function: ``out = sum over r < reps of roll(a, r % 8, lanes) @ b``, a
(M, K) and b (K, N) f32, f32 sums, where ``roll`` is ``jnp.roll`` along the
columns (``out[:, k] = a[:, (k - s) mod K]``, which is what ``pltpu.roll``
computes in interpret mode). The TPU kernel computes it anew in each of
``grid`` steps, each overwriting the one (M, N) block; the port's kernel
does all ``reps x grid`` products too (the steps in parallel, one of them
storing), and so does the plain version (the steps in turn).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _kernels
from .tf32_bars import BAR_DEPTH, shares

REPS, GRID = 64, 64  # bench_fused_cnn.py:73
ROLLS = 8            # r % 8
# probe_mxu's shapes (bench_fused_cnn.py:100-107): (M, K, N, tag)
SHAPES = ((192, 104, 128, "stage1 tile"),
          (192, 1152, 384, "stage2 full-width"),
          (192, 512, 128, "stage2 tiled alt"),
          (192, 1152, 576, "stage3 full-width"), (512, 512, 512, "square 512"),
          (1024, 1024, 1024, "square 1024"))
_P, _I = ctypes.c_void_p, ctypes.c_int

KERNEL = _kernels.Kernel(
    "mm_rate", "mm_rate",
    [_P, _P, _P,                  # a, b, out
     _I, _I, _I, _I, _I, _I,      # M, K, N, reps, grid, store_step
     _P])                         # stream


def make_problem(M: int, K: int, N: int, device: torch.device):
    """mxu_rate's draws: a from ``default_rng(0)``, b from
    ``default_rng(1)``, standard normal, f32."""
    a = np.random.default_rng(0).standard_normal((M, K)).astype(np.float32)
    b = np.random.default_rng(1).standard_normal((K, N)).astype(np.float32)
    return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


def _check(a: torch.Tensor, b: torch.Tensor, reps: int, grid: int) -> None:
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0] or \
            a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"a (M, K) and b (K, N) must be f32, got "
                         f"{tuple(a.shape)} {a.dtype}, {tuple(b.shape)} "
                         f"{b.dtype}")
    if reps < 0 or grid < 1:
        raise ValueError(f"reps >= 0 and grid >= 1, got {reps}, {grid}")


def mm_rate_plain(a: torch.Tensor, b: torch.Tensor, reps: int = REPS,
                  grid: int = GRID) -> torch.Tensor:
    """The plain version: the sum of the reps rolled products, computed in
    each of the grid steps in turn (the last one returned), as the TPU
    kernel does; matmuls with the caller's TF32 setting."""
    _check(a, b, reps, grid)
    out = None
    for _ in range(grid):
        acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                          device=a.device)
        for r in range(reps):
            acc = acc + torch.roll(a, r % ROLLS, dims=1) @ b
        out = acc
    return out


def mm_rate(a: torch.Tensor, b: torch.Tensor, reps: int = REPS,
            grid: int = GRID, *, impl: str = "auto") -> torch.Tensor:
    """bench_fused_cnn's ``_mm_kernel`` over ``grid`` steps: (M, N) f32.
    ``impl`` as in ``ops._kernels``."""
    _check(a, b, reps, grid)
    if not _kernels.use_kernel(impl, a):
        return mm_rate_plain(a, b, reps, grid)
    if b.device != a.device or not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous and on one device")
    if grid > 65535:
        raise ValueError(f"the kernel takes grid <= 65535, got {grid}")
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    KERNEL.launch(_kernels.ptr(a), _kernels.ptr(b), _kernels.ptr(out), M, K,
                  N, reps, grid, grid - 1, _kernels.stream_ptr(a.device))
    return out


def macs(M: int, K: int, N: int, reps: int = REPS, grid: int = GRID) -> int:
    """mxu_rate's count: M K N reps grid multiply-adds."""
    return M * K * N * reps * grid


# kernel vs plain: each output element sums n = reps * K products in f32,
# in another order in the two: within tf32_bars.BAR_DEPTH sqrt(n) 2^-24 of
# its sum of |terms|. (A roll the wrong way moves an element by about
# 2 / sqrt(n) of its sum of |terms|: 100 to 1,400 times the bar at the
# probe's shapes.)


def compare(got: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            reps: int) -> dict:
    """A kernel's (M, N) result against the plain version's sum of reps
    rolled products: the largest difference and share of the bar; raises
    over it."""
    want = mm_rate_plain(a, b, reps, 1)
    absolute = mm_rate_plain(a.abs(), b.abs(), reps, 1)
    bar = BAR_DEPTH * (reps * a.shape[1]) ** 0.5 * 2.0 ** -24 * absolute
    if got.shape != want.shape:
        raise RuntimeError(f"mm_rate: shape {tuple(got.shape)}, want "
                           f"{tuple(want.shape)}")
    r = shares(got, want, bar)
    if not r["share_of_bar"] <= 1.0:
        raise RuntimeError(f"mm_rate {tuple(a.shape)}x{tuple(b.shape)} reps="
                           f"{reps}: off the plain version "
                           f"({r['share_of_bar']:.3f} of the bar)")
    return r


def check(a: torch.Tensor, b: torch.Tensor, reps: int = REPS,
          grid: int = GRID) -> dict:
    """The kernel against the plain version on a's device (TF32 off is the
    caller's), through :func:`compare`."""
    return compare(mm_rate(a, b, reps, grid, impl="kernel"), a, b, reps)
