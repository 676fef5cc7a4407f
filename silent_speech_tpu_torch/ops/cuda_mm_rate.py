"""The matmul-rate probe's kernel (csrc/mm_rate.cu) and its plain PyTorch
version: the port of the Pallas kernel of scripts/bench_fused_cnn.py
(``_mm_kernel``, called by ``mxu_rate``).

The function: ``out = sum over r < reps of roll(a, r % 8, lanes) @ b``, a
(M, K) and b (K, N) f32, f32 sums, where ``roll`` is ``jnp.roll`` along the
columns (``out[:, k] = a[:, (k - s) mod K]``, which is what ``pltpu.roll``
computes in interpret mode). The TPU kernel computes it anew in each of
``grid`` steps, each overwriting the one (M, N) block; the port's kernel
does all ``reps x grid`` products too (every step a work item, one of them
storing), and so does the plain version (the steps in turn).

The kernel runs the products as 3xTF32 on wgmma (x = hi + lo, TF32 each;
lo*hi, hi*lo, hi*hi): b^T split into hi / lo planes once a call (a prep
launch into scratch the wrapper allocates), a's rolled fragments split in
registers, persistent one-warpgroup blocks over (step, 64-row tile,
BN-column tile) items (:func:`geometry` mirrors the kernel's choice of BN,
:func:`plan` reads it on the card); for each 32-k chunk and rep, the 12
wgmmas of the chunk sum from zero and are added into the item's f32 total
(chunks outer, reps inner; ``tests/test_torch_mr_dc_tc.py`` emulates that
order on the CPU).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

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

_ARGS = [_P, _P, _P, _P,              # a, b, out, bt (scratch)
         _I, _I, _I, _I, _I, _I,      # M, K, N, reps, grid, store_step
         _I, _I, _P]                  # stop, bn, stream
KERNEL = _kernels.Kernel("mm_rate", "mm_rate", _ARGS)
# the timing stops (:func:`mm_rate_stop`), counted apart
KERNEL_STOP = _kernels.Kernel("mm_rate_stop", "mm_rate", _ARGS)

# csrc/mm_rate.cu's geometry, which :func:`geometry` mirrors: a block is one
# warpgroup (THREADS) on a 64-row tile (BM) of one step; the column tile BN
# is one of BNS, whichever's items take an SM the least time on SMS SMs,
# ceil(items / SMS) BN columns, a column weighed BN_WEIGHT[BN] (BN 64 took
# 5/4 of BN 128's time a column on an H100, chip_smoke.time_mr_dc_f32; the
# wider at a tie); chunks of BK k in STAGES cp.async stages, each both of
# b^T's planes (BN rows of 128 bytes) and a's rows with an 8-column halo
# (A_LD floats a row), ALIGN bytes to start them on the swizzle's period
BM, BK, THREADS, STAGES, SMS = 64, 32, 128, 2, 132
BNS = (128, 64)
BN_WEIGHT = {128: 4, 64: 5}
A_LD, ALIGN = BK + ROLLS + 4, 1024
STOPS = {"all": 0, "one_pass": 1, "feed": 2}


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


class Geometry(NamedTuple):
    """The kernel's tile at (M, K, N, grid) (:func:`geometry`): ``bn``,
    the work ``items`` ((step, 64-row tile, BN-column tile)), dynamic
    ``smem`` bytes a block, cp.async ``stages``, ``threads`` a block and
    ``kp``, K rounded up to the chunks (the prep's planes, (2, N, kp))."""

    bn: int
    items: int
    smem: int
    stages: int
    threads: int
    kp: int


def geometry(M: int, K: int, N: int, grid: int = GRID) -> Geometry:
    """csrc/mm_rate.cu's ``tile_bn`` and ``Geo<BN>``."""
    if min(M, K, N, grid) < 1:
        raise ValueError(f"M, K, N, grid must be positive, got {M}, {K}, "
                         f"{N}, {grid}")
    items = {bn: _ceil(M, BM) * _ceil(N, bn) * grid for bn in BNS}
    bn = min(BNS, key=lambda b: (_ceil(items[b], SMS) * b * BN_WEIGHT[b],
                                 BNS.index(b)))
    stage = 2 * bn * 4 * BK + BM * A_LD * 4
    return Geometry(bn, items[bn], ALIGN + STAGES * stage, STAGES, THREADS,
                    _ceil(K, BK) * BK)


class Plan(NamedTuple):
    """The kernel's launch on the card (csrc/mm_rate.cu's mm_rate_plan):
    ``bn``, ``items``, the persistent ``blocks`` launched (at most the
    ``slots``, the blocks the card holds at once), dynamic ``smem`` bytes
    a block, ``stages``, ``threads``."""

    bn: int
    items: int
    blocks: int
    slots: int
    smem: int
    stages: int
    threads: int


@functools.lru_cache(maxsize=64)
def _plan(device: int, M: int, K: int, N: int, grid: int) -> Plan:
    lib = _kernels.library()
    fn = lib.mm_rate_plan
    fn.argtypes = [_I, _I, _I, _I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 7)()
    with torch.cuda.device(device):
        err = fn(M, K, N, grid, out)
    if err:
        raise RuntimeError(f"mm_rate_plan({M}, {K}, {N}, {grid}): CUDA "
                           f"error {err}: "
                           f"{lib.sst_cuda_error_string(err).decode()}")
    return Plan(*out)


def plan(M: int, K: int, N: int, grid: int = GRID, device=None) -> Plan:
    """The kernel's launch at (M, K, N, grid) on a card (the current one
    by default)."""
    geometry(M, K, N, grid)  # the arguments' checks
    device = torch.device("cuda" if device is None else device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return _plan(index, M, K, N, grid)


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


def _launch(a: torch.Tensor, b: torch.Tensor, reps: int, grid: int,
            stop: str, bn: int) -> torch.Tensor:
    if b.device != a.device or not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous and on one device")
    M, K = a.shape
    N = b.shape[1]
    geo = geometry(M, K, N, grid)
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    bt = torch.empty((2, N, geo.kp), dtype=torch.float32, device=a.device)
    kernel = KERNEL if stop == "all" else KERNEL_STOP
    kernel.launch(_kernels.ptr(a), _kernels.ptr(b), _kernels.ptr(out),
                  _kernels.ptr(bt), M, K, N, reps, grid, grid - 1,
                  STOPS[stop], bn, _kernels.stream_ptr(a.device))
    return out


def mm_rate(a: torch.Tensor, b: torch.Tensor, reps: int = REPS,
            grid: int = GRID, *, impl: str = "auto", bn: int = 0
            ) -> torch.Tensor:
    """bench_fused_cnn's ``_mm_kernel`` over ``grid`` steps: (M, N) f32.
    ``impl`` as in ``ops._kernels``; ``bn``: the kernel's column tile, one
    of BNS, 0 for the plan's (:func:`geometry`); every tile gives the same
    bits."""
    _check(a, b, reps, grid)
    if bn not in (0,) + BNS:
        raise ValueError(f"bn must be 0 or one of {BNS}, got {bn}")
    if not _kernels.use_kernel(impl, a):
        return mm_rate_plain(a, b, reps, grid)
    return _launch(a, b, reps, grid, "all", bn)


def mm_rate_stop(a: torch.Tensor, b: torch.Tensor, reps: int = REPS,
                 grid: int = GRID, *, stop: str = "one_pass"
                 ) -> torch.Tensor:
    """The kernel with part of its work left out, to time where its time
    goes (card only; another function): ``one_pass``, hi*hi alone (one
    TF32 pass); ``feed``, the copies, fragment loads, splits and adds
    without the wgmmas."""
    _check(a, b, reps, grid)
    if stop not in STOPS or stop == "all":
        raise ValueError(f"stop must be one of {sorted(set(STOPS) - {'all'})}"
                         f", got {stop!r}")
    if not a.is_cuda:
        raise ValueError("mm_rate_stop times the kernel: a CUDA tensor")
    return _launch(a, b, reps, grid, stop, 0)


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
