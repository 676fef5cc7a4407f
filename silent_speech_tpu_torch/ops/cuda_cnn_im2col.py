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

The kernel issues tensor-core products only for the packed matrices'
nonzero fragments, reading each (dy, dx) fragment's values once a block, as
3xTF32 in persistent blocks (:func:`plan`). :func:`nonzero_fragments` and
:func:`tap_blocks` are test models of that walk and that copy: the kernel
reads neither, it has its own (the dx loops of ``conv2_im2col`` and
``conv3_im2col``, and ``pack_weights5``, in csrc/roi_cnn_im2col.cu), so a
change there must be made here too. ``debug_stop`` ends each frame
after a stage, as K1's (``cuda_cnn.DEBUG_STOPS``, checked against
``cuda_cnn.roi_cnn_debug_plain``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _kernels
from .cuda_cnn import (CHANNELS, DEBUG_STOPS, ROI_H, ROI_W, Plan, _ask_plan,
                       _check_debug_stop, _check_frames, _check_params,
                       roi_cnn_plain)

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = _kernels.Kernel(
    "roi_cnn_im2col", "roi_cnn_im2col_forward",
    [_P, _P, _P,      # roi, packed weights, out
     _I, _I, _I,      # n, emb, standardize
     _P])             # stream
DEBUG_KERNEL = _kernels.Kernel(
    "roi_cnn_im2col_debug", "roi_cnn_im2col_debug_forward",
    [_P, _P, _P, _I, _I, _I,  # as KERNEL, then
     _I, _P])                 # stop, stream
# (w tile, input window width) per conv: csrc/roi_cnn_im2col.cu
TILES = ((16, 18), (8, 10), (8, 10))
# a fragment of the packed matrices: rows of one (dy, wx) (k8: 8 input
# channels; conv1 has one) by columns of one w_off (n8: 8 output channels)
FRAG_K, FRAG_N = (1, 8, 8), (8, 8, 8)


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


def nonzero_fragments(conv: int) -> list[tuple[int, int, int, int]]:
    """The nonzero fragments of packed conv ``conv`` (0, 1, 2):
    ``(row, col, dy, dx)``, the fragment's first row and column in
    :func:`pack_conv`'s matrix (``FRAG_K[conv]`` rows of one (dy, wx),
    ``FRAG_N[conv]`` columns of one w_off) and the tap it holds,
    dx = wx - w_off. A fragment is listed iff dx is 0, 1 or 2; every other
    fragment of the matrix is zero.

    For conv 1 and 2 the kernel runs one 3xTF32 product for each listed
    fragment (and each M tile). For conv 0 the list describes the packing
    only: its fragments are single rows (one input channel), and the
    kernel runs no products for them, since conv1 runs on the CUDA
    cores. A test model of the kernel's walk (see the module's docstring),
    held by the CPU tests to :func:`pack_conv` and the Pallas packing."""
    w_tile, wx_len = TILES[conv]
    ci = (1,) + CHANNELS[:-1]
    ci, co = ci[conv], CHANNELS[conv]
    fk, fn = FRAG_K[conv], FRAG_N[conv]
    out = []
    for w_off in range(w_tile):
        for nf in range(co // fn):
            for dy in range(3):
                for dx in range(3):
                    wx = w_off + dx
                    if wx >= wx_len:
                        continue
                    for kf in range(ci // fk):
                        out.append(((dy * wx_len + wx) * ci + kf * fk,
                                    w_off * co + nf * fn, dy, dx))
    return out


def tap_blocks(packed: torch.Tensor, emb: int) -> list[torch.Tensor]:
    """What the kernel copies from :func:`pack_im2col`'s buffer into shared
    memory: each conv's (dy, dx) fragments at w_off 0, as (3, 3, Ci, Co)
    HWIO weights (every nonzero fragment of a (dy, dx) holds these
    values). A test model of ``pack_weights5``'s reads (conv1's taps too,
    which it lays out for K1's conv1 stage), not code the kernel runs."""
    out, o, c_in = [], 0, 1
    for c_out, (w_tile, wx_len) in zip(CHANNELS, TILES):
        m = packed[o:o + 3 * wx_len * c_in * w_tile * c_out].reshape(
            3, wx_len, c_in, w_tile * c_out)
        out.append(m[:, :3, :, :c_out].clone())
        o += m.numel() + w_tile * c_out
        c_in = c_out
    if packed.numel() != n_packed(emb):
        raise ValueError(f"packed holds {packed.numel()} values, not "
                         f"pack_im2col's {n_packed(emb)} for emb={emb}")
    return out


def plan(device=None) -> Plan:
    """The kernel's launch on a card, the current one by default, as
    ``roi_cnn_im2col_plan`` in csrc/roi_cnn_im2col.cu sizes it (card only;
    it asks the card once per device)."""
    return Plan(*_ask_plan("roi_cnn_im2col_plan", (), 5, device))


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
                   packed: Optional[torch.Tensor] = None,
                   debug_stop: Optional[str] = None) -> torch.Tensor:
    """roi_u8: (N, 48, 96) uint8 -> (N, emb) f32 through the im2col kernel
    ('auto' on a CUDA tensor, or 'kernel'), or :func:`roi_cnn_plain`.
    ``packed`` is :func:`pack_im2col` of ``params``, built once by the
    caller; without it every launch builds it. ``debug_stop``
    (``cuda_cnn.DEBUG_STOPS``) runs the kernel truncated after that stage,
    each row three moments of what it computed
    (``cuda_cnn.roi_cnn_debug_plain``); it has no plain route."""
    _check_frames(roi_u8)
    _check_debug_stop(debug_stop)
    if not _kernels.use_kernel(impl, roi_u8):
        if debug_stop is not None:
            raise ValueError(
                f"debug_stop={debug_stop!r} is a stop of the CUDA kernel: it "
                f"needs a CUDA tensor and impl 'auto' or 'kernel', got "
                f"impl={impl!r} on {roi_u8.device}")
        return roi_cnn_plain(roi_u8, params, standardize)
    if tuple(roi_u8.shape[1:]) != (ROI_H, ROI_W):
        raise ValueError(f"the im2col ROI CNN kernel takes {ROI_H}x{ROI_W} "
                         f"frames, got {tuple(roi_u8.shape[1:])}")
    if not roi_u8.is_contiguous() or roi_u8.data_ptr() % 16:
        raise ValueError("roi_u8 must be contiguous and 16-byte aligned")
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
        args = (_kernels.ptr(roi_u8), _kernels.ptr(packed), _kernels.ptr(out),
                N, emb, int(standardize))
        if debug_stop is None:
            KERNEL.launch(*args, _kernels.stream_ptr(roi_u8.device))
        else:
            DEBUG_KERNEL.launch(*args, DEBUG_STOPS[debug_stop],
                                _kernels.stream_ptr(roi_u8.device))
    return out
