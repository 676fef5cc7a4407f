"""Int8 TinyROICNN, the serving-only quantized mode: the CUDA kernel
(csrc/roi_cnn_q8.cu) and its plain PyTorch version (port of the JAX
ops/pallas_cnn2.py ``roi_cnn_fused(variant='tiled3_q8')`` and its weight
quantization ``_quantize_pack``).

- Weights: per-output-channel symmetric s8, ``s = max|w| / 127`` over the
  channel's 3x3xC_in taps (each packed column of the JAX pack holds one
  output channel's whole kernel, so its per-column scale is this one).
- Stage 1 is integer-exact against the s8 weights: the input centered to
  s8 (x - 128, the SAME-pad halo -128), then ``y * d1 + cf1`` with
  ``d1 = s1 / 255`` and ``cf1 = 128 * colsum(w1q) * d1``.
- Stages 2 and 3 requantize their ReLU outputs per frame:
  ``a = max(frame max, 1e-12) * (1/255)``, ``rv = 1 / a``,
  ``q = int(v * rv + 0.5) - 128`` (-128 encodes 0, so the halo is -128),
  and dequantize right after each dot: ``(dot + 128 * colsum(wq)) * sw * a``.
- Pools, biases, ReLU, the mean and the fc stay f32.

The plain version takes every f32 step in the Pallas kernel's order (one
division for 1 / a, then multiplies; no fused multiply-add), so up to the
last ReLU it is bitwise the kernel; only the mean and the fc sum in another order. Its
integer dots run as float64 convolutions rounded back to integers (exact:
every |dot| < 2^24). The standardized (training-path) input has no int8
contract and raises, as in the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _kernels
from .cuda_cnn import CHANNELS, ROI_H, ROI_W, _check_frames, _check_params
from .nn import dense, max_pool_2x2

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = _kernels.Kernel(
    "roi_cnn_q8", "roi_cnn_q8_forward",
    [_P, _P, _P, _P,  # roi, int32 weights, f32 weights, out
     _I, _I,          # n, emb
     _P])             # stream
INV255 = 1.0 / 255.0
# csrc/roi_cnn_q8.cu QI_SIZE and QF_FC
QI_SIZE = CHANNELS[0] * 9 + 9 * CHANNELS[0] * CHANNELS[1] // 4 \
    + 9 * CHANNELS[1] * CHANNELS[2] // 4 + CHANNELS[1] + CHANNELS[2]
QF_FC = 3 * CHANNELS[0] + 2 * CHANNELS[1] + 2 * CHANNELS[2]


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, shaped as ``like``: an operand of an elementwise
    division that PyTorch does not turn into a multiply by the reciprocal
    (it does so for a scalar divisor on CUDA)."""
    return torch.full_like(like, x, dtype=torch.float32)


def quantize_weight(w: torch.Tensor, by_reciprocal: bool):
    """HWIO f32 conv weight -> (s8 weights HWIO, per-output-channel scale
    max|w| / 127). ``by_reciprocal`` rounds ``w * (127 / max|w|)`` (the JAX
    pack's stages 2 and 3) instead of ``w / (max|w| / 127)`` (stage 1)."""
    colmax = torch.clamp(w.abs().amax(dim=(0, 1, 2)), min=1e-30)
    scale = colmax / _f32(127.0, colmax)
    q = torch.round(w * (_f32(127.0, colmax) / colmax)) if by_reciprocal \
        else torch.round(w / scale)
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def quantize_roi_cnn(params: dict) -> dict:
    """TinyROICNN parameters (JAX layout, f32) -> the int8 mode's operands,
    on the parameters' device: the s8 weights (HWIO), the per-channel
    ``d1``, ``cf1``, ``sw2``, ``sw3`` (f32) and ``cq2``, ``cq3`` (int32,
    128 * colsum), the f32 biases and fc, and the kernel's two flat buffers
    ``qi`` (int32) and ``qf`` (f32) in csrc/roi_cnn_q8.cu's layout. Counterpart
    of ``_quantize_pack`` (ops/pallas_cnn2.py:184-225), with the same
    values per output channel."""
    g = lambda k, n: params[k][n].detach().to(torch.float32)
    w1q, s1 = quantize_weight(g("conv0", "w"), by_reciprocal=False)
    w2q, sw2 = quantize_weight(g("conv1", "w"), by_reciprocal=True)
    w3q, sw3 = quantize_weight(g("conv2", "w"), by_reciprocal=True)
    colsum = lambda q: q.to(torch.float32).sum(dim=(0, 1, 2))
    d1 = s1 * _f32(INV255, s1)
    q = {"w1q": w1q, "w2q": w2q, "w3q": w3q,
         "d1": d1, "cf1": 128.0 * colsum(w1q) * d1,
         "sw2": sw2, "cq2": 128 * colsum(w2q).to(torch.int32),
         "sw3": sw3, "cq3": 128 * colsum(w3q).to(torch.int32),
         "b1": g("conv0", "b"), "b2": g("conv1", "b"), "b3": g("conv2", "b"),
         "fc": {"w": g("fc", "w"), "b": g("fc", "b")}}
    # kernel layout: stage-1 taps one per word [co][ky][kx]; stages 2 and 3
    # four input channels per word [co][ky][kx][ci / 4] (little-endian)
    words = lambda wq: wq.permute(3, 0, 1, 2).contiguous().view(torch.int32)
    q["qi"] = torch.cat([
        w1q.permute(3, 0, 1, 2).reshape(-1).to(torch.int32),
        words(w2q).reshape(-1), words(w3q).reshape(-1), q["cq2"], q["cq3"]])
    q["qf"] = torch.cat([
        d1, q["cf1"], q["b1"], sw2, q["b2"], sw3, q["b3"],
        q["fc"]["w"].t().reshape(-1), q["fc"]["b"]]).contiguous()
    return q


def _int_conv(x: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact integer SAME conv of centered s8 activations (N, H, W, C) with
    s8 HWIO weights, the halo -128: float64, rounded to integers."""
    xp = F.pad(x.to(torch.float64).permute(0, 3, 1, 2), (1, 1, 1, 1),
               value=-128.0)
    y = F.conv2d(xp, wq.to(torch.float64).permute(3, 2, 0, 1))
    return torch.round(y).permute(0, 2, 3, 1)


def _requant(v: torch.Tensor):
    """Per-frame requantization of a ReLU output (N, H, W, C): the centered
    s8 values and the frame scale ``a`` (N, 1, 1, 1)."""
    fm = v.amax(dim=(1, 2, 3), keepdim=True)
    a = torch.clamp(fm, min=1e-12) * _f32(INV255, fm)
    rv = _f32(1.0, a) / a
    return (v * rv + 0.5).to(torch.int32) - 128, a


def roi_cnn_q8_plain(roi_u8: torch.Tensor, q: dict) -> torch.Tensor:
    """Plain version of the int8 mode: (N, 48, 96) uint8 -> (N, emb) f32,
    on the operands of :func:`quantize_roi_cnn`, in the kernel's order of
    f32 operations."""
    x = roi_u8.to(torch.int32).unsqueeze(-1) - 128
    y = _int_conv(x, q["w1q"]).to(torch.float32) * q["d1"] + q["cf1"]
    c1 = torch.relu(max_pool_2x2(y) + q["b1"])
    x, a2 = _requant(c1)
    y = (_int_conv(x, q["w2q"]) + q["cq2"]).to(torch.float32) * q["sw2"] * a2
    c2 = torch.relu(max_pool_2x2(y) + q["b2"])
    x, a3 = _requant(c2)
    y = (_int_conv(x, q["w3q"]) + q["cq3"]).to(torch.float32) * q["sw3"] * a3
    c3 = torch.relu(y + q["b3"])
    return dense(c3.mean(dim=(1, 2)), q["fc"])


def roi_cnn_q8(roi_u8: torch.Tensor, params: dict, *,
               standardize: bool = False, impl: str = "auto",
               packed: Optional[dict] = None) -> torch.Tensor:
    """The int8 mode: roi_u8 (N, 48, 96) uint8 -> (N, emb) f32, through the
    kernel ('auto' on a CUDA tensor, or 'kernel') or
    :func:`roi_cnn_q8_plain`. ``packed`` is :func:`quantize_roi_cnn` of
    ``params``, built once by the caller; without it every call builds it."""
    _check_frames(roi_u8)
    if standardize:
        raise ValueError(
            "the int8 ROI CNN (roi_variant='tiled3_q8') is a serving-only "
            "quantized mode: the standardized training-path input has no "
            "int8 contract; use roi_variant='tiled3'")
    if tuple(roi_u8.shape[1:]) != (ROI_H, ROI_W):
        raise ValueError(f"the int8 ROI CNN takes {ROI_H}x{ROI_W} frames, got "
                         f"{tuple(roi_u8.shape[1:])}")
    use = _kernels.use_kernel(impl, roi_u8)
    if packed is None:
        with torch.no_grad():
            packed = quantize_roi_cnn(params)
    if not use:
        return roi_cnn_q8_plain(roi_u8, packed)
    emb = _check_params(roi_u8, params)
    qi, qf = packed["qi"], packed["qf"]
    if not roi_u8.is_contiguous() or roi_u8.data_ptr() % 16:
        raise ValueError("roi_u8 must be contiguous and 16-byte aligned")
    if qi.dtype != torch.int32 or qi.numel() != QI_SIZE or \
            qf.dtype != torch.float32 or qf.numel() != QF_FC + 25 * emb or \
            qi.device != roi_u8.device or qf.device != roi_u8.device or \
            not (qi.is_contiguous() and qf.is_contiguous()):
        raise ValueError(f"packed must be quantize_roi_cnn of emb={emb} "
                         f"weights on {roi_u8.device}")
    N = roi_u8.shape[0]
    out = torch.empty((N, emb), dtype=torch.float32, device=roi_u8.device)
    if N:
        KERNEL.launch(_kernels.ptr(roi_u8), _kernels.ptr(qi), _kernels.ptr(qf),
                      _kernels.ptr(out), N, emb,
                      _kernels.stream_ptr(roi_u8.device))
    return out
