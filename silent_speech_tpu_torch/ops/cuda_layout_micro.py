"""The layout micro-kernels (csrc/layout_micro.cu) and their plain PyTorch
versions: the port of the Pallas kernels of scripts/mosaic_micro.py
(``_mk`` and the nine bodies of ``main``), with the JAX names.

Each body maps x ((steps * 768, 768) f32, ``steps`` (768, 768) blocks) to
one output block a step (:data:`BODIES`; :data:`HALF` take (384, 768)).
``unaligned_18lane_x6`` writes zeros in the lanes the JAX body leaves
unwritten (NaN in interpret mode, undefined on the TPU); :data:`WRITTEN`
are the lanes it writes. ``library`` names the one torch call that
computes a body, where there is one.

Each element-moving body (all but the transpose and the product) runs on
one route (:data:`MOVE_ROUTES`; :func:`move_plan` reads its launch on the
card): ``bulk`` (copy, aligned_128lane_x6, rows_strided_slice,
rows_reshape_max: TMA bulk copies through a ring of shared-memory stages),
``registers`` (lanes_roll_max, unaligned_18lane_x6: persistent blocks over
units of 8 x 256 output float4s, a thread's loads of the next unit issued
before its stores of this one) or ``walk`` (rows_roll_max down its
columns, each row loaded once).

On the card ``matmul_768x512x128`` forms its product as 3xTF32 on the
tensor cores (bwd_dots.cu's nn mainloop: 128 x 128 tiles over K = 512, each
chunk of 32 from zero and the chunks added in f32) and copies lanes
128..767 bitwise; :func:`compare_product` holds the product to the f32
plain version's bar and to a float64 bar of ``cuda_bwd_dots.compare``'s
form, which one TF32 pass (:func:`one_pass`) misses.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _kernels
from .tf32_bars import BAR_DEPTH, bar64, shares, tf32_round

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
MATMUL = "matmul_768x512x128"

KERNEL = _kernels.Kernel(
    "layout_micro", "layout_micro",
    [ctypes.c_void_p, ctypes.c_void_p,      # x, out
     ctypes.c_int, ctypes.c_int,            # steps, body
     ctypes.c_void_p])                      # stream
MOVING = tuple(b for b in BODIES if b not in ("transpose", MATMUL))
# csrc/layout_micro.cu's Route, in its order
MOVE_ROUTES = ("bulk", "registers", "walk")


class MovePlan(NamedTuple):
    """A moving body's launch: persistent blocks of ``threads``, the units
    they walk and the route they take."""
    blocks: int
    units: int
    threads: int
    route: str


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


def move_plan(body: str, steps: int) -> MovePlan:
    """The kernel's launch of a moving body at ``steps`` (card only: the
    block count comes from the card's SMs and the kernel's occupancy)."""
    if body not in MOVING:
        raise ValueError(f"{body} is not a moving body: {MOVING}")
    lib = _kernels.library()
    fn = lib.layout_micro_plan
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    err = fn(steps, _CODE[body], out)
    if err:
        raise RuntimeError(f"layout_micro_plan: CUDA error {err}: "
                           f"{lib.sst_cuda_error_string(err).decode()}")
    return MovePlan(out[0], out[1], out[2], MOVE_ROUTES[out[3]])


def _product64(x: torch.Tensor) -> torch.Tensor:
    v = x.double().reshape(-1, R, L)
    return torch.matmul(v[:, :, :MM_K], v[:, :MM_K, :MM_N])


def reference64(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The product body's product part (steps, 768, 128) in float64, and
    each element's sum of |terms| (the same on |x|)."""
    _steps(MATMUL, x)
    return _product64(x), _product64(x.abs())


def one_pass(x: torch.Tensor) -> torch.Tensor:
    """The product body's output with its product as one TF32 pass forms
    it (x rounded to TF32, the products exact and summed in float64, then
    f32): the control that :func:`compare_product`'s float64 bar
    refuses."""
    o = layout_plain(MATMUL, x).reshape(-1, R, L)
    o[:, :, :MM_N] = _product64(tf32_round(x)).float()
    return o.reshape(x.shape)


def measure_product(got: torch.Tensor, x: torch.Tensor) -> dict:
    """The product body's output against its plain version: lanes 128..767
    must be x's, bitwise (raises otherwise, and on a wrong shape); the
    product's largest difference from the f32 plain version and its share
    of BAR_DEPTH sqrt(512) 2^-24 A (A: each element's sum of |terms|;
    ``max_abs_err``, ``share_of_bar``), and from the float64 product ref
    and its share of ``tf32_bars.bar64`` (``max_abs_err64``,
    ``share_of_bar64``): ``cuda_bwd_dots.compare``'s bar for one 512-deep
    step, 3xTF32's split and the MMAs' sums of 32-row chunks within 32 A,
    the output's rounding |ref| / 2. One TF32 pass lies about 2.9e-4
    sqrt(512) off (rms) against 32 A = 32 x 0.64 x 512 2^-24: 10.5 standard
    deviations a product element."""
    S = _steps(MATMUL, x)
    if got.shape != x.shape:
        raise RuntimeError(f"{MATMUL}: shape {tuple(got.shape)}, want "
                           f"{tuple(x.shape)}")
    g, v = got.reshape(S, R, L), x.reshape(S, R, L)
    if not torch.equal(g[:, :, MM_N:], v[:, :, MM_N:]):
        raise RuntimeError(f"{MATMUL}: lanes {MM_N}..{L - 1} are not the "
                           "input's, bitwise")
    prod = g[:, :, :MM_N].double()
    ref, absolute = reference64(x)
    want = layout_plain(MATMUL, x).reshape(S, R, L)[:, :, :MM_N].double()
    return {**shares(prod, want,
                     BAR_DEPTH * MM_K ** 0.5 * 2.0 ** -24 * absolute),
            **shares(prod, ref, bar64(ref, absolute), "64")}


def compare_product(got: torch.Tensor, x: torch.Tensor) -> dict:
    """:func:`measure_product`'s figures; raises over either bar."""
    r = measure_product(got, x)
    for tag, what in (("", "plain"), ("64", "float64")):
        if not r["share_of_bar" + tag] <= 1.0:
            raise RuntimeError(
                f"{MATMUL}: the product is off the {what} version "
                f"({r['share_of_bar' + tag]:.3f} of the bar)")
    return r


def library(body: str, x: torch.Tensor) -> Optional[torch.Tensor]:
    """One torch call that computes ``body`` where there is one (the
    product: only its (768, 512) x (512, 128) part; :func:`library_same_work`
    adds the copy), else None. A yardstick timed beside the kernel on the
    card; the port's path does not call it."""
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
    if body == MATMUL:
        return torch.matmul(v[:, :, :MM_K], v[:, :MM_K, :MM_N])
    return None


def library_same_work(x: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The product body's work in two torch calls: ``matmul`` of the
    product part and ``[:, :, 128:].clone()`` of the other lanes (two
    outputs, not the body's one array). A yardstick, as :func:`library`."""
    v = x.reshape(_steps(MATMUL, x), R, L)
    return (torch.matmul(v[:, :, :MM_K], v[:, :MM_K, :MM_N]),
            v[:, :, MM_N:].clone())


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
    return steps * R * MM_K * MM_N if body == MATMUL else 0


def rate(body: str) -> str:
    """The peak a body's multiply-adds are bound at (a key of
    ``scripts.proto_parity_cnn.PEAK_OPS``): the product's, the f32 FMAs
    and 3xTF32 together, as its kernel forms it on the tensor cores."""
    return "f32_3xtf32" if body == MATMUL else "f32"
