"""Micro-kernels of the ROI CNN's input front (csrc/roi_front_probe.cu) and
their plain versions: the port of the Pallas probe kernels of
scripts/probe_front.py (``_probe_kernel``, built by ``build``), not at the
TPU's block geometry. The ladder (:data:`LADDER`: ``dma_ring``, ``widen``,
``front``, ``front_std``) runs on K1's persistent geometry, one for every
rung (:func:`ring_geometry`): one wave of 288-thread blocks (:func:`plan`
on the card), block b walking frames b, b + blocks, ...
(:func:`frame_walk`), each frame brought by a TMA bulk copy into a ring of
:data:`RING_SLOTS` shared-memory slots, a warp's 512 pixels one byte a lane
and step, a (50 x 98) zero-haloed image double-buffered, its halo zeroed
once. The /255 is a product and one FMA of its residual, bitwise ``b /
255.0f``, and so is the standardization's division by the frame's std (a
correctly rounded quotient). tests/test_torch_front_probe_tc.py models the
thread maps, the frame walk and the /255 in numpy. ``dma`` (1, 2 or 4
frames a block) and the overlap pair keep K1's first design (one 288-thread
block a frame, one 16-byte load a thread).

``front_widen`` and ``front_classes`` are the port's copies of the JAX
package's ``ops/pallas_cnn2._front_widen`` and ``_front_classes`` (:348,
:359), the front of the Pallas K1. The port's standardization takes K1's
two passes (the mean, then the variance about it), where the Pallas kernel
takes E[x^2] - E[x]^2 in one: on a constant frame the two-pass form gives
exact zeros.

Each probe stage writes checkable values a block (:data:`STAGES`): dma the
uint32 sum of its words, overlap_b the sum of its chains, the others the
three moments of the values they built (``ops.cuda_cnn.stage_moments``:
sum, sum of squares, index-weighted sum), so that a wrong scale or a
misplaced store shows; :func:`probe_plain` gives the same values from the
plain versions, so each stage can be held against it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _kernels
from .cuda_cnn import stage_moments

H0, W0, HQ = 48, 96, 12
FRAME_BYTES = H0 * W0
THREADS = 288
CHAIN_ACC, CHAIN_LEN = 8, 1152  # csrc/roi_front_probe.cu: K1's 2,654,208 FMAs
# stage -> the kernel's code; dma takes 1, 2 or 4 frames a block, the others 1
STAGES = {"dma": 0, "widen": 1, "front": 2, "front_std": 3, "overlap_a": 4,
          "overlap_b": 5, "dma_ring": 6}
DMA_FRAMES = (1, 2, 4)  # the counterparts of F_TILE 16, 32, 64
# the cumulative rungs, on the persistent geometry
LADDER = ("dma_ring", "widen", "front", "front_std")
SCALAR = ("dma", "dma_ring", "overlap_b")  # one value a block; else moments
# the ladder's ring, every rung's: frames in flight a block, beside two
# images (three blocks an SM)
RING_SLOTS = 7
XP_W, XP_SIZE = W0 + 2, (H0 + 2) * (W0 + 2)  # K1's haloed image

PROBE = _kernels.Kernel(
    "roi_front_probe", "roi_front_probe",
    [ctypes.c_void_p, ctypes.c_void_p,   # x, out
     ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n, stage, frames a block
     ctypes.c_float, ctypes.c_float,     # the chain's runtime 1 and 0
     ctypes.c_void_p])                   # stream


class RingGeometry(NamedTuple):
    """The ladder's block (:func:`ring_geometry`): ring ``slots``,
    dynamic ``smem`` bytes, ``threads``."""

    slots: int
    smem: int
    threads: int


class RingPlan(NamedTuple):
    """The ladder's launch on the card (:func:`plan`), every rung's: the ``blocks``
    of one wave, the block's ring ``slots``, dynamic ``smem`` bytes and
    ``threads``, the card's ``sms``."""

    blocks: int
    slots: int
    smem: int
    threads: int
    sms: int


def ring_geometry() -> RingGeometry:
    """csrc/roi_front_probe.cu's ring, every rung's: RING_SLOTS frames,
    then two 16-byte aligned images (which dma_ring and widen reserve
    unused, so that each rung's delta is its work alone)."""
    image = 16 * -(-XP_SIZE // 4)
    return RingGeometry(RING_SLOTS, RING_SLOTS * FRAME_BYTES + 2 * image,
                        THREADS)


def frame_walk(n: int, blocks: int) -> list[range]:
    """The frames each block of the ladder's launch takes, in order, at N=n
    on a card whose wave is ``blocks``: min(blocks, n) blocks, block b the
    ``count`` frames b, b + grid, ... (csrc/roi_front_probe.cu's launch
    and ring_kernel)."""
    grid = min(blocks, n)
    return [range(b, b + grid * ((n - b + grid - 1) // grid), grid)
            for b in range(grid)]


@functools.lru_cache(maxsize=64)
def _plan(device: int) -> RingPlan:
    lib = _kernels.library()
    fn = lib.roi_front_probe_plan
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        err = fn(out)
    if err:
        raise RuntimeError(f"roi_front_probe_plan: CUDA error {err}: "
                           f"{lib.sst_cuda_error_string(err).decode()}")
    return RingPlan(*out)


def plan(device=None) -> RingPlan:
    """The ladder's launch, every rung's, on a card (the current one by
    default): one wave of blocks, the fewest an SM that any rung fits."""
    device = torch.device("cuda" if device is None else device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return _plan(index)


def front_widen(x: torch.Tensor, front: str = "u8") -> torch.Tensor:
    """u8 (or pre-widened bf16 / f32) rows -> f32 scaled by the f32 1/255
    (ops/pallas_cnn2.py:348)."""
    if front == "u8":
        x = x.to(torch.int32)
    return x.to(torch.float32) * (1.0 / 255.0)


def front_classes(xw: torch.Tensor, standardize: bool, F: int
                  ) -> list[torch.Tensor]:
    """(F*12, 384) scaled rows -> the four 96-lane h-mod-4 class buffers,
    optionally per-frame standardized in two passes (ddof=1, std >= 1e-6;
    ops/pallas_cnn2.py:359 with K1's standardization)."""
    M = xw.shape[0]
    if M != F * HQ or xw.shape[1] != 4 * W0:
        raise ValueError(f"xw must be ({F * HQ}, {4 * W0}) for F={F}, got "
                         f"{tuple(xw.shape)}")
    if standardize:
        fr = xw.reshape(F, HQ * 4 * W0)
        mu = fr.mean(dim=1, keepdim=True)
        var = (fr - mu).square().sum(dim=1, keepdim=True) / (FRAME_BYTES - 1)
        sd = torch.clamp(torch.sqrt(var), min=1e-6)
        xw = ((fr - mu) / sd).reshape(M, 4 * W0)
    return [xw[:, W0 * c: W0 * (c + 1)] for c in range(4)]


def _check(stage: str, x: torch.Tensor, F: int) -> int:
    """Raises on what the probe does not take; returns the block count."""
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}; the probe has "
                         f"{tuple(STAGES)}")
    if F not in (DMA_FRAMES if stage == "dma" else (1,)):
        raise ValueError(f"stage {stage!r} takes frames_per_block in "
                         f"{DMA_FRAMES if stage == 'dma' else (1,)}, got {F}")
    if x.dtype != torch.uint8:
        raise ValueError(f"x must be uint8, got {x.dtype}")
    if stage == "overlap_b":
        if x.ndim != 2 or x.shape[1] != 4:
            raise ValueError(f"overlap_b takes (blocks, 4) uint8 (one word a "
                             f"block), got {tuple(x.shape)}")
        return x.shape[0]
    if x.ndim != 2 or x.shape[1] != 4 * W0 or x.shape[0] % HQ:
        raise ValueError(f"x must be (N*12, 384) uint8 rows, got "
                         f"{tuple(x.shape)}")
    n = x.shape[0] // HQ
    if n % F:
        raise ValueError(f"N={n} frames is not a multiple of F={F}")
    return n // F


def _image(stage: str, x: torch.Tensor, blocks: int) -> torch.Tensor:
    """The values an image stage built, (blocks, K) in the kernel's order:
    the frame's pixels (widen) or its (50 x 98) haloed image."""
    xw = front_widen(x)
    if stage == "front_std":
        xw = torch.cat(front_classes(xw, True, blocks), dim=1)
    if stage == "widen":
        return xw.reshape(blocks, -1)
    return torch.nn.functional.pad(xw.reshape(blocks, H0, W0),
                                   (1, 1, 1, 1)).flatten(1)


def probe_plain(stage: str, x: torch.Tensor, F: int = 1) -> torch.Tensor:
    """The plain version of each stage's per-block values: (blocks,) int32
    for dma and dma_ring (the bits of the wrapping uint32 sum of the
    block's 32-bit words), (blocks,) f32 for overlap_b (the sum of its
    chains), else (blocks, 3) f32, the moments of the values the stage
    built (overlap_a: the chains' sum, equal to the image's, added to the
    first)."""
    blocks = _check(stage, x, F)
    if stage == "overlap_b":  # byte i % 4 + i seeds accumulator i
        return (x.to(torch.float32).sum(dim=1) * (THREADS * CHAIN_ACC // 4)
                + THREADS * sum(range(CHAIN_ACC)))
    if stage in ("dma", "dma_ring"):
        words = x.reshape(blocks, -1).view(torch.int32).to(torch.int64)
        s = words.sum(dim=1) & 0xFFFFFFFF
        return (s - ((s >> 31) << 32)).to(torch.int32)  # the uint32 bits
    m = stage_moments(_image(stage, x, blocks))
    if stage == "overlap_a":
        m[:, 0] *= 2
    return m


def probe(stage: str, x: torch.Tensor, F: int = 1, *,
          impl: str = "auto") -> torch.Tensor:
    """One probe stage (probe_front.py:74, ``build(stage, F)``): x (N*12,
    384) uint8, the frames' rows as K1 reads them (overlap_b: (N, 4) uint8,
    one word a block). Returns the per-block values as
    :func:`probe_plain` does."""
    blocks = _check(stage, x, F)
    if not _kernels.use_kernel(impl, x):
        return probe_plain(stage, x, F)
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    shape = (blocks,) if stage in SCALAR else (blocks, 3)
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    if blocks:
        PROBE.launch(_kernels.ptr(x), _kernels.ptr(out), blocks * F,
                     STAGES[stage], F, 1.0, 0.0,
                     _kernels.stream_ptr(x.device))
    return out.view(torch.int32) if stage in ("dma", "dma_ring") else out


def bar(stage: str, x: torch.Tensor, F: int = 1) -> torch.Tensor:
    """The bar of a stage's values against the plain version, shaped as
    they are: 0 for the integer sums (dma, dma_ring, overlap_b), else 1e-5
    of each moment's sum of absolute terms (f32 sums of 4,608 to 4,900
    terms in another order than the plain version's float64)."""
    blocks = _check(stage, x, F)
    if stage in SCALAR:
        return torch.zeros(blocks)
    m = stage_moments(_image(stage, x, blocks), absolute=True)
    if stage == "overlap_a":
        m[:, 0] *= 2
    return 1e-5 * m

