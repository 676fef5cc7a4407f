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

The kernel runs the three dots on s8 tensor-core MMAs (m16n8k32) in
persistent blocks (:func:`plan`), its weights packed into shared memory in
fragment order once a block (:func:`fragment_weights` is a test model of
that layout, with its K pad). Its check entry (:func:`roi_cnn_q8_entry`)
ends each frame after a stage (:data:`STOPS`; :func:`roi_cnn_q8_debug_plain`
gives the plain moments).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _kernels
from .cuda_cnn import (CHANNELS, ROI_H, ROI_W, Plan, _ask_plan, _check_frames,
                       _check_params, stage_moments)
from .nn import dense, max_pool_2x2

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = _kernels.Kernel(
    "roi_cnn_q8", "roi_cnn_q8_forward",
    [_P, _P, _P, _P,  # roi, int32 weights, f32 weights, out
     _I, _I,          # n, emb
     _P])             # stream
CHECK_KERNEL = _kernels.Kernel(
    "roi_cnn_q8_check", "roi_cnn_q8_check_forward",
    [_P, _P, _P, _P, _I, _I,  # as KERNEL, then
     _I, _P])                 # stop, stream
# the check entry's stops (csrc/roi_cnn_q8.cu Stop): each frame ends after
# that stage's ReLU output
STOPS = {"stage1": 1, "stage2": 2, "stage3": 3}
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


def plan(device=None) -> Plan:
    """The kernel's launch on a card, the current one by default, as
    ``roi_cnn_q8_plan`` in csrc/roi_cnn_q8.cu sizes it (card only; it asks
    the card once per device)."""
    return Plan(*_ask_plan("roi_cnn_q8_plan", (), 5, device))


def fragment_weights(q: dict) -> dict:
    """The kernel's s8 weights as it packs them into shared memory: m16n8k32
    B fragments, (k32 blocks, n8 tiles, 32 lanes, 2 registers, 4 bytes)
    int8; lane 4g + t, register r, byte b holds k slot 16 r + 4 t + b of N
    column g. Stage 1, one block: column g of tile nt is channel
    2 (g // 2) + nt at pool-window column p = g % 2, and slot 4 ky + c
    holds tap (ky, c - p) where 0 <= c - p < 3, else zero (register 1
    zero). Stages 2 and 3: column g is channel 8 nt + g; stage 2 block kb,
    register r, slots 4t.. are tap 4 kb + 2 r + t // 2, channels
    4 (t % 2) + b; stage 3 tap 2 kb + r, channels 4 t + b. Taps from 9 on
    (the K pad) are zero. Built from ``qi`` (the kernel's input) alone.

    A test model of the layout: the kernel does not read it, it packs the
    same bytes itself (``pack_weights_q8`` in csrc/roi_cnn_q8.cu), so a
    change there must be made here too; the CPU tests hold this model to
    ``quantize_roi_cnn``, and the card tests hold the kernel to its plain
    version."""
    qi = q["qi"].cpu()
    c1, c2, c3 = CHANNELS
    w1 = qi[:9 * c1].to(torch.int8).reshape(c1, 3, 3)  # [co][ky][kx]
    o = 9 * c1
    w2 = qi[o:o + 9 * c2 * c1 // 4].view(torch.int8).reshape(c2, 9, c1)
    o += w2.numel() // 4
    w3 = qi[o:o + 9 * c3 * c2 // 4].view(torch.int8).reshape(c3, 9, c2)
    f1 = torch.zeros((1, 2, 32, 2, 4), dtype=torch.int8)
    for nt in range(2):
        for lane in range(32):
            g, t = divmod(lane, 4)
            if t < 3:
                p = g % 2
                f1[0, nt, lane, 0, p:p + 3] = w1[2 * (g // 2) + nt, t]
    out = {"stage1": f1}
    for name, w, kb_n, ci in (("stage2", w2, 3, c1), ("stage3", w3, 5, c2)):
        co = w.shape[0]
        f = torch.zeros((kb_n, co // 8, 32, 2, 4), dtype=torch.int8)
        for kb in range(kb_n):
            for nt in range(co // 8):
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    for r in range(2):
                        if ci == 8:  # 8 channels: two taps a register
                            tap, c0 = 4 * kb + 2 * r + t // 2, 4 * (t % 2)
                        else:
                            tap, c0 = 2 * kb + r, 4 * t
                        if tap < 9:
                            f[kb, nt, lane, r] = w[8 * nt + g, tap,
                                                   c0:c0 + 4]
        out[name] = f
    return out


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


def _stages(roi_u8: torch.Tensor, q: dict) -> list[torch.Tensor]:
    """The three stages' ReLU outputs (N, H, W, C), in the kernel's order
    of f32 operations."""
    x = roi_u8.to(torch.int32).unsqueeze(-1) - 128
    y = _int_conv(x, q["w1q"]).to(torch.float32) * q["d1"] + q["cf1"]
    c1 = torch.relu(max_pool_2x2(y) + q["b1"])
    x, a2 = _requant(c1)
    y = (_int_conv(x, q["w2q"]) + q["cq2"]).to(torch.float32) * q["sw2"] * a2
    c2 = torch.relu(max_pool_2x2(y) + q["b2"])
    x, a3 = _requant(c2)
    y = (_int_conv(x, q["w3q"]) + q["cq3"]).to(torch.float32) * q["sw3"] * a3
    return [c1, c2, torch.relu(y + q["b3"])]


def roi_cnn_q8_plain(roi_u8: torch.Tensor, q: dict) -> torch.Tensor:
    """Plain version of the int8 mode: (N, 48, 96) uint8 -> (N, emb) f32,
    on the operands of :func:`quantize_roi_cnn`, in the kernel's order of
    f32 operations."""
    return dense(_stages(roi_u8, q)[2].mean(dim=(1, 2)), q["fc"])


def roi_cnn_q8_debug_plain(roi_u8: torch.Tensor, q: dict, stop: str,
                           absolute: bool = False) -> torch.Tensor:
    """What the check entry's stop ``stop`` writes: (N, emb), entry j of a
    row the frame's ``cuda_cnn.stage_moments`` j % 3 of that stage's ReLU
    output in CHW order; ``absolute`` as there."""
    if stop not in STOPS:
        raise ValueError(f"unknown stop {stop!r}; the kernel takes "
                         f"{tuple(STOPS)}")
    c = _stages(roi_u8, q)[STOPS[stop] - 1]
    m = stage_moments(c.permute(0, 3, 1, 2).flatten(1), absolute)
    emb = q["fc"]["b"].shape[0]
    return m[:, torch.arange(emb, device=m.device) % 3].contiguous()


def _check_kernel_inputs(roi_u8: torch.Tensor, params: dict,
                         packed: dict) -> int:
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
    return emb


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
    emb = _check_kernel_inputs(roi_u8, params, packed)
    N = roi_u8.shape[0]
    out = torch.empty((N, emb), dtype=torch.float32, device=roi_u8.device)
    if N:
        KERNEL.launch(_kernels.ptr(roi_u8), _kernels.ptr(packed["qi"]),
                      _kernels.ptr(packed["qf"]), _kernels.ptr(out), N, emb,
                      _kernels.stream_ptr(roi_u8.device))
    return out


def roi_cnn_q8_entry(roi_u8: torch.Tensor, params: dict, packed: dict, *,
                     stop: Optional[str] = None) -> torch.Tensor:
    """The kernel through its check entry (card only): with ``stop``
    (:data:`STOPS`) each frame ends after that stage and its row holds the
    moments :func:`roi_cnn_q8_debug_plain` gives."""
    _check_frames(roi_u8)
    if stop is not None and stop not in STOPS:
        raise ValueError(f"unknown stop {stop!r}; the kernel takes "
                         f"{tuple(STOPS)}")
    if not roi_u8.is_cuda or tuple(roi_u8.shape[1:]) != (ROI_H, ROI_W):
        raise ValueError(f"the check entry takes {ROI_H}x{ROI_W} frames on a "
                         f"CUDA device, got {tuple(roi_u8.shape)} on "
                         f"{roi_u8.device}")
    emb = _check_kernel_inputs(roi_u8, params, packed)
    N = roi_u8.shape[0]
    out = torch.empty((N, emb), dtype=torch.float32, device=roi_u8.device)
    if N:
        CHECK_KERNEL.launch(_kernels.ptr(roi_u8), _kernels.ptr(packed["qi"]),
                            _kernels.ptr(packed["qf"]), _kernels.ptr(out), N,
                            emb, STOPS.get(stop, 0),
                            _kernels.stream_ptr(roi_u8.device))
    return out
