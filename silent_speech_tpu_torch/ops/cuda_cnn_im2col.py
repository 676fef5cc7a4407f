"""TinyROICNN as output-packed im2col GEMMs: the CUDA kernel
(csrc/roi_cnn_im2col.cu) and its weight packing (port of the JAX
ops/pallas_cnn.py ``roi_cnn_pallas``, ``roi_impl='pallas'``, and its
``pack_roi_cnn_params``).

It computes the function of ``cuda_cnn.roi_cnn_fused``, whose plain version
:func:`cuda_cnn.roi_cnn_plain` is this kernel's plain version too. Each conv
is a GEMM of patch rows against a packed weight matrix
``Kpacked[(dy, wx, ci), (w_off, co)] = k[dy, wx - w_off, ci, co]`` (zero
where the tap falls outside the 3x3 window), one w tile at a time: 16
outputs for conv1, 8 for conv2 and conv3. The JAX kernel's half-pooled
packing of conv2 and conv3 (``_pack_conv_halfpooled``, a Mosaic lowering
workaround) is not carried over: the kernel pools exactly, so every
matrix packs as ``_pack_conv`` does.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _kernels
from .cuda_cnn import (CHANNELS, ROI_H, ROI_W, _check_frames, _check_params,
                       roi_cnn_plain)

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = _kernels.Kernel(
    "roi_cnn_im2col", "roi_cnn_im2col_forward",
    [_P, _P, _P,      # roi, packed weights, out
     _I, _I, _I,      # n, emb, standardize
     _P])             # stream
# (w tile, input window width) per conv: csrc/roi_cnn_im2col.cu
TILES = ((16, 18), (8, 10), (8, 10))


def pack_conv(k: torch.Tensor, w_tile: int, wx_len: int) -> torch.Tensor:
    """k: (3, 3, Ci, Co) HWIO -> (3 * wx_len * Ci, w_tile * Co): row
    dy * (wx_len * Ci) + wx * Ci + ci, column w_off * Co + co, nonzero iff
    dx = wx - w_off is in [0, 3) (ops/pallas_cnn.py ``_pack_conv``)."""
    _, _, ci, co = k.shape
    out = k.new_zeros((3, wx_len, ci, w_tile, co))
    for dx in range(3):
        for w_off in range(min(w_tile, wx_len - dx)):
            out[:, w_off + dx, :, w_off, :] = k[:, dx]
    return out.reshape(3 * wx_len * ci, w_tile * co)


def pack_im2col(params: dict) -> torch.Tensor:
    """TinyROICNN parameters (JAX layout) -> the kernel's one f32 buffer on
    the parameters' device: the three packed conv matrices, each followed by
    its bias tiled over the w tile, then fc w (24, emb) and fc b."""
    parts = []
    for key, (w_tile, wx_len) in zip(("conv0", "conv1", "conv2"), TILES):
        k = params[key]["w"].detach().to(torch.float32)
        parts += [pack_conv(k, w_tile, wx_len).reshape(-1),
                  params[key]["b"].detach().to(torch.float32).repeat(w_tile)]
    parts += [params["fc"]["w"].detach().to(torch.float32).reshape(-1),
              params["fc"]["b"].detach().to(torch.float32)]
    return torch.cat(parts).contiguous()


def n_packed(emb: int) -> int:
    """Length of :func:`pack_im2col`'s buffer for a given embedding."""
    n, c_in = 0, 1
    for c_out, (w_tile, wx_len) in zip(CHANNELS, TILES):
        n += 3 * wx_len * c_in * w_tile * c_out + w_tile * c_out
        c_in = c_out
    return n + 25 * emb


def roi_cnn_im2col(roi_u8: torch.Tensor, params: dict, *,
                   standardize: bool = False, impl: str = "auto",
                   packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """roi_u8: (N, 48, 96) uint8 -> (N, emb) f32 through the im2col kernel
    ('auto' on a CUDA tensor, or 'kernel'), or :func:`roi_cnn_plain`.
    ``packed`` is :func:`pack_im2col` of ``params``, built once by the
    caller; without it every launch builds it."""
    _check_frames(roi_u8)
    if not _kernels.use_kernel(impl, roi_u8):
        return roi_cnn_plain(roi_u8, params, standardize)
    if tuple(roi_u8.shape[1:]) != (ROI_H, ROI_W):
        raise ValueError(f"the im2col ROI CNN kernel takes {ROI_H}x{ROI_W} "
                         f"frames, got {tuple(roi_u8.shape[1:])}")
    if not roi_u8.is_contiguous():
        raise ValueError("roi_u8 must be contiguous")
    emb = _check_params(roi_u8, params)
    if packed is None:
        packed = pack_im2col(params)
    if packed.dtype != torch.float32 or packed.device != roi_u8.device or \
            not packed.is_contiguous() or packed.numel() != n_packed(emb):
        raise ValueError(f"packed must be pack_im2col of emb={emb} weights "
                         f"({n_packed(emb)} f32 on {roi_u8.device})")
    N = roi_u8.shape[0]
    out = torch.empty((N, emb), dtype=torch.float32, device=roi_u8.device)
    if N:
        KERNEL.launch(_kernels.ptr(roi_u8), _kernels.ptr(packed),
                      _kernels.ptr(out), N, emb, int(standardize),
                      _kernels.stream_ptr(roi_u8.device))
    return out
