"""Fused TinyROICNN: the CUDA kernels (csrc/roi_cnn.cu, the forward;
csrc/roi_cnn_bwd.cu, its weight gradients) and their plain PyTorch versions
(port of the JAX ops/pallas_cnn2.py ``roi_cnn_fused`` and
ops/pallas_cnn2_grad.py ``roi_cnn_fused_train``).

Both compute, per frame, (48, 96) uint8 -> /255 -> optional per-frame
standardize (ddof=1, std >= 1e-6; the training-path normalization of
train_model_official.py:286-291) -> conv 1->8, ReLU, pool -> conv 8->16,
ReLU, pool -> conv 16->24, ReLU -> mean -> fc -> (emb,) f32.

``params`` is the TinyROICNN parameter dict in the JAX package's layout:
``{'conv0' | 'conv1' | 'conv2': {'w': HWIO, 'b'}, 'fc': {'w': (24, emb),
'b'}}`` (``TinyROICNN.params_tree()`` gives it as views of the module's
parameters). The kernels read the weights from one flat f32 buffer on the
device (:func:`flat_weights`). For inference build it once per set of
weights and pass it as ``flat``, as ``BiGRUClassifier.kernel_weights()``
does; in training :func:`roi_cnn_fused_train` builds it each step from the
parameters, differentiably, so that the backward kernel's flat gradient
reaches the module's parameters through autograd.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _kernels
from .nn import conv2d_nhwc, dense, max_pool_2x2

ROI_H, ROI_W = 48, 96  # the geometry the kernel is written for
CHANNELS = (8, 16, 24)
MAX_EMB = 64  # csrc/roi_cnn.cu MAX_EMB

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = _kernels.Kernel(
    "roi_cnn", "roi_cnn_forward",
    [_P, _P, _P,      # roi, flat, out
     _I, _I, _I,      # n, emb, standardize
     _P])             # stream
BWD_KERNEL = _kernels.Kernel(
    "roi_cnn_bwd", "roi_cnn_backward",
    [_P, _P, _P,      # roi, dE, flat
     _P, _P,          # partial sums, out
     _I, _I, _I, _I,  # n, emb, standardize, blocks
     _P])             # stream


def standardize_frames(r: torch.Tensor) -> torch.Tensor:
    """Per-frame mean/std standardization over the trailing (H, W) axes
    (torch-std ddof=1, std clamped at 1e-6)."""
    n = r.shape[-1] * r.shape[-2]
    mu = r.mean(dim=(-1, -2), keepdim=True)
    var = (r - mu).square().sum(dim=(-1, -2), keepdim=True) / (n - 1)
    std = torch.clamp(torch.sqrt(var), min=1e-6)
    return (r - mu) / std


def preprocess_roi(roi_u8: torch.Tensor, standardize: bool,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 (..., H, W) -> ``dtype`` /255, optionally per-frame standardized
    (``standardize=False`` is the live path, live_infer_official.py:126)."""
    r = roi_u8.to(dtype) / 255.0
    return standardize_frames(r) if standardize else r


def roi_cnn_plain(roi_u8: torch.Tensor, params: dict,
                  standardize: bool = False) -> torch.Tensor:
    """Plain PyTorch version: (N, H, W) uint8 -> (N, emb), in the
    parameters' dtype (f32; float64 gives a reference for the kernels'
    sums)."""
    x = preprocess_roi(roi_u8, standardize,
                       params["fc"]["w"].dtype).unsqueeze(-1)  # (N, H, W, 1)
    x = max_pool_2x2(torch.relu(conv2d_nhwc(x, params["conv0"])))
    x = max_pool_2x2(torch.relu(conv2d_nhwc(x, params["conv1"])))
    x = torch.relu(conv2d_nhwc(x, params["conv2"]))
    return dense(x.mean(dim=(1, 2)), params["fc"])


def roi_cnn_train_plain(roi_u8: torch.Tensor, params: dict,
                        standardize: bool = True) -> torch.Tensor:
    """Plain version of the training CNN: :func:`roi_cnn_plain`, which
    autograd differentiates with respect to the parameters only (the uint8
    frames are data)."""
    return roi_cnn_plain(roi_u8, params, standardize)


def n_weights(emb: int) -> int:
    """Length of the kernels' flat weight buffer for a given embedding."""
    return sum(9 * i * o + o for i, o in zip((1,) + CHANNELS[:-1],
                                             CHANNELS)) + 25 * emb


def flat_weights(params: dict) -> torch.Tensor:
    """The kernels' weight buffer: conv w (OIHW) and b for the three convs,
    then fc w (emb, 24) and b, as one contiguous f32 vector on the
    parameters' device. It is a ``torch.cat`` of views of ``params``, so
    autograd carries a gradient of the buffer back to them; build it under
    ``torch.no_grad()`` where none is wanted."""
    parts = []
    for key, c_in, c_out in zip(("conv0", "conv1", "conv2"),
                                (1,) + CHANNELS[:-1], CHANNELS):
        w, b = params[key]["w"], params[key]["b"]
        if tuple(w.shape) != (3, 3, c_in, c_out):
            raise ValueError(f"{key}: expected HWIO {(3, 3, c_in, c_out)}, "
                             f"got {tuple(w.shape)}")
        parts += [w.permute(3, 2, 0, 1).reshape(-1), b.reshape(-1)]
    fc_w = params["fc"]["w"]
    if fc_w.ndim != 2 or fc_w.shape[0] != CHANNELS[-1]:
        raise ValueError(f"fc: expected ({CHANNELS[-1]}, emb), got "
                         f"{tuple(fc_w.shape)}")
    parts += [fc_w.t().reshape(-1), params["fc"]["b"].reshape(-1)]
    return torch.cat(parts).to(torch.float32)


def _check_frames(roi_u8: torch.Tensor) -> None:
    if roi_u8.dtype != torch.uint8 or roi_u8.ndim != 3:
        raise ValueError(f"roi_u8 must be (N, H, W) uint8, got "
                         f"{tuple(roi_u8.shape)} {roi_u8.dtype}")


def _check_kernel_inputs(roi_u8: torch.Tensor, flat: torch.Tensor,
                         emb: int) -> None:
    if tuple(roi_u8.shape[1:]) != (ROI_H, ROI_W):
        raise ValueError(f"the ROI CNN kernel takes {ROI_H}x{ROI_W} frames, "
                         f"got {tuple(roi_u8.shape[1:])}; use impl='plain'")
    if not roi_u8.is_contiguous() or roi_u8.data_ptr() % 16:
        raise ValueError("roi_u8 must be contiguous and 16-byte aligned")
    if not 1 <= emb <= MAX_EMB:
        raise ValueError(f"emb must be in [1, {MAX_EMB}], got {emb}")
    nw = n_weights(emb)
    if flat.device != roi_u8.device or flat.dtype != torch.float32 or \
            not flat.is_contiguous() or flat.numel() != nw:
        raise ValueError(f"flat must be {nw} contiguous f32 on "
                         f"{roi_u8.device} (flat_weights), got "
                         f"{flat.numel()} {flat.dtype} on {flat.device}")


def _forward_kernel(roi_u8: torch.Tensor, flat: torch.Tensor, emb: int,
                    standardize: bool) -> torch.Tensor:
    _check_kernel_inputs(roi_u8, flat, emb)
    N = roi_u8.shape[0]
    out = torch.empty((N, emb), dtype=torch.float32, device=roi_u8.device)
    if N:
        KERNEL.launch(_kernels.ptr(roi_u8), _kernels.ptr(flat),
                      _kernels.ptr(out), N, emb, int(standardize),
                      _kernels.stream_ptr(roi_u8.device))
    return out


def _check_params(roi_u8: torch.Tensor, params: dict) -> int:
    fc_b = params["fc"]["b"]
    if fc_b.dtype != torch.float32 or fc_b.device != roi_u8.device:
        raise ValueError(f"params must be f32 on {roi_u8.device}, got "
                         f"{fc_b.dtype} on {fc_b.device}")
    return fc_b.shape[0]


def roi_cnn_fused(roi_u8: torch.Tensor, params: dict, *,
                  standardize: bool = False, impl: str = "auto",
                  flat: Optional[torch.Tensor] = None) -> torch.Tensor:
    """roi_u8: (N, 48, 96) uint8 -> embeddings (N, emb) f32 (inference: no
    gradient reaches ``params`` through the kernel).

    ``impl`` as in ``ops._kernels``: 'auto' launches the kernel for a CUDA
    tensor and runs :func:`roi_cnn_plain` for a CPU tensor. ``flat`` is
    :func:`flat_weights` of ``params``, built once by the caller; without
    it every launch builds it anew."""
    _check_frames(roi_u8)
    if not _kernels.use_kernel(impl, roi_u8):
        return roi_cnn_plain(roi_u8, params, standardize)
    emb = _check_params(roi_u8, params)
    if flat is None:
        with torch.no_grad():
            flat = flat_weights(params)
    return _forward_kernel(roi_u8, flat, emb, standardize)


def roi_cnn_weight_grads(roi_u8: torch.Tensor, dE: torch.Tensor,
                         flat: torch.Tensor, *,
                         standardize: bool) -> torch.Tensor:
    """The backward kernel: the gradient of sum(out * dE) with respect to
    the flat weight buffer, where out is the forward of ``roi_u8`` with
    ``flat``. roi_u8: (N, 48, 96) uint8 on a CUDA device; dE: (N, emb) f32.
    Returns a vector shaped as ``flat``."""
    _check_frames(roi_u8)
    if not roi_u8.is_cuda:
        raise ValueError(f"the ROI CNN backward kernel needs a CUDA tensor, "
                         f"got one on {roi_u8.device}")
    N, emb = roi_u8.shape[0], dE.shape[-1]
    _check_kernel_inputs(roi_u8, flat, emb)
    if dE.shape != (N, emb) or dE.dtype != torch.float32 or \
            dE.device != roi_u8.device:
        raise ValueError(f"dE must be ({N}, {emb}) f32 on {roi_u8.device}, "
                         f"got {tuple(dE.shape)} {dE.dtype} on {dE.device}")
    dE = dE.contiguous()
    blocks = max(1, min(N, torch.cuda.get_device_properties(
        roi_u8.device).multi_processor_count))  # one block fits an SM
    partial = torch.empty((blocks, flat.numel()), dtype=torch.float32,
                          device=roi_u8.device)
    out = torch.empty_like(flat)
    BWD_KERNEL.launch(_kernels.ptr(roi_u8), _kernels.ptr(dE),
                      _kernels.ptr(flat), _kernels.ptr(partial),
                      _kernels.ptr(out), N, emb, int(standardize), blocks,
                      _kernels.stream_ptr(roi_u8.device))
    return out


class _FusedTrain(torch.autograd.Function):
    """Forward: the forward kernel; backward: the weight-gradient kernel.
    The frames get no gradient."""

    @staticmethod
    def forward(ctx, roi_u8, flat, emb, standardize):
        ctx.standardize = standardize
        ctx.save_for_backward(roi_u8, flat)
        return _forward_kernel(roi_u8, flat, emb, standardize)

    @staticmethod
    def backward(ctx, dE):
        roi_u8, flat = ctx.saved_tensors
        dflat = None
        if ctx.needs_input_grad[1]:
            dflat = roi_cnn_weight_grads(roi_u8, dE.to(torch.float32), flat,
                                         standardize=ctx.standardize)
        return None, dflat, None, None


def roi_cnn_fused_train(roi_u8: torch.Tensor, params: dict, *,
                        standardize: bool = True,
                        impl: str = "auto") -> torch.Tensor:
    """Differentiable fused TinyROICNN: (N, 48, 96) uint8 -> (N, emb) f32.

    On a CUDA tensor ('auto' or 'kernel') the forward is the forward kernel
    and the backward the weight-gradient kernel, on a flat weight buffer
    built from ``params`` by ``torch.cat`` (autograd maps its gradient back
    to the parameters); on a CPU tensor, or with 'plain', it is
    :func:`roi_cnn_train_plain`. Only the reference 48x96 ROI is taken."""
    _check_frames(roi_u8)
    if tuple(roi_u8.shape[1:]) != (ROI_H, ROI_W):
        raise ValueError(
            f"the training ROI CNN takes only the reference {ROI_H}x{ROI_W} "
            f"ROI, got {tuple(roi_u8.shape[1:])}")
    if not _kernels.use_kernel(impl, roi_u8):
        return roi_cnn_train_plain(roi_u8, params, standardize)
    emb = _check_params(roi_u8, params)
    return _FusedTrain.apply(roi_u8, flat_weights(params), emb, standardize)
