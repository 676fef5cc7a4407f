"""The layout micro-kernels (csrc/layout_micro.cu) and their plain PyTorch
versions: the port of the Pallas kernels of scripts/mosaic_micro.py
(``_mk`` and the nine bodies of ``main``), with the JAX names.

Each body maps x ((steps * 768, 768) f32, ``steps`` (768, 768) blocks) to
one output block a step (:data:`BODIES`; :data:`HALF` take (384, 768)).
``unaligned_18lane_x6`` writes zeros in the lanes the JAX body leaves
unwritten (NaN in interpret mode, undefined on the TPU); :data:`WRITTEN`
are the lanes it writes. ``library`` names the one torch call that
computes a body, where there is one.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import _kernels

R = L = 768
STEPS = 512  # mosaic_micro.py:22
BODIES = ("copy", "rows_reshape_max", "lanes_roll_max", "rows_roll_max",
          "rows_strided_slice", "transpose", "unaligned_18lane_x6",
          "aligned_128lane_x6", "matmul_768x512x128")
_CODE = {b: i for i, b in enumerate(BODIES)}
HALF = ("rows_reshape_max", "rows_strided_slice")
# the lanes unaligned_18lane_x6 writes: 128 j + c, j < 6, c < 18
WRITTEN = np.concatenate([np.arange(128 * j, 128 * j + 18) for j in range(6)])
MM_K, MM_N = 512, 128

KERNEL = _kernels.Kernel(
    "layout_micro", "layout_micro",
    [ctypes.c_void_p, ctypes.c_void_p,      # x, out
     ctypes.c_int, ctypes.c_int,            # steps, body
     ctypes.c_void_p])                      # stream


def out_rows(body: str) -> int:
    return R // 2 if body in HALF else R


def _steps(body: str, x: torch.Tensor) -> int:
    if body not in _CODE:
        raise ValueError(f"unknown body {body!r}; the probe has {BODIES}")
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != L or \
            x.shape[0] % R:
        raise ValueError(f"x must be (steps * {R}, {L}) f32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    return x.shape[0] // R


def layout_plain(body: str, x: torch.Tensor) -> torch.Tensor:
    """The plain version of ``body`` (matmul with the caller's TF32
    setting)."""
    S = _steps(body, x)
    v = x.reshape(S, R, L)
    if body in ("copy", "aligned_128lane_x6"):
        o = v.clone()
    elif body == "rows_reshape_max":
        o = torch.maximum(v[:, 0::2], v[:, 1::2])
    elif body == "lanes_roll_max":
        o = torch.maximum(v, torch.roll(v, L - 8, dims=2))
    elif body == "rows_roll_max":
        o = torch.maximum(v, torch.roll(v, R - 1, dims=1))
    elif body == "rows_strided_slice":
        o = v[:, ::2].clone()
    elif body == "transpose":
        o = v.transpose(1, 2).clone()
    elif body == "unaligned_18lane_x6":
        o = torch.zeros_like(v)
        for j in range(6):
            o[:, :, 128 * j:128 * j + 18] = v[:, :, 16 * j:16 * j + 18]
    else:
        o = v.clone()
        o[:, :, :MM_N] = torch.matmul(v[:, :, :MM_K], v[:, :MM_K, :MM_N])
    return o.reshape(S * out_rows(body), L).contiguous()


def layout(body: str, x: torch.Tensor, *, impl: str = "auto"
           ) -> torch.Tensor:
    """mosaic_micro's ``_mk(body)`` run on x: (steps * out_rows(body), 768)
    f32. ``impl`` as in ``ops._kernels``."""
    S = _steps(body, x)
    if not _kernels.use_kernel(impl, x):
        return layout_plain(body, x)
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    if S > 65535:
        raise ValueError(f"the kernel takes at most 65535 steps, got {S}")
    out = torch.empty((S * out_rows(body), L), dtype=torch.float32,
                      device=x.device)
    if S:
        KERNEL.launch(_kernels.ptr(x), _kernels.ptr(out), S, _CODE[body],
                      _kernels.stream_ptr(x.device))
    return out


def library(body: str, x: torch.Tensor) -> Optional[torch.Tensor]:
    """One torch call that computes ``body`` where there is one (the
    product: only its (768, 512) x (512, 128) part), else None. A
    yardstick timed beside the kernel on the card; the port's path does
    not call it."""
    S = _steps(body, x)
    v = x.reshape(S, R, L)
    if body in ("copy", "aligned_128lane_x6"):
        return x.clone()
    if body == "rows_reshape_max":
        return v.reshape(S, R // 2, 2, L).amax(dim=2)
    if body == "rows_strided_slice":
        return v[:, ::2].contiguous()
    if body == "transpose":
        return v.transpose(1, 2).contiguous()
    if body == "matmul_768x512x128":
        return torch.matmul(v[:, :, :MM_K], v[:, :MM_K, :MM_N])
    return None


def bytes_moved(body: str, steps: int = STEPS) -> int:
    """The bytes the body's function must move: each input byte it needs
    read once, each output byte written once (f32)."""
    _steps(body, torch.empty((0, L)))
    rows = steps * R
    if body == "rows_strided_slice":  # the odd rows are never needed
        return 4 * L * (rows // 2) * 2
    if body == "unaligned_18lane_x6":  # input lanes 0..97, every output lane
        return 4 * rows * (16 * 5 + 18 + L)
    return 4 * L * (rows + steps * out_rows(body))


def macs(body: str, steps: int = STEPS) -> int:
    return steps * R * MM_K * MM_N if body == "matmul_768x512x128" else 0
