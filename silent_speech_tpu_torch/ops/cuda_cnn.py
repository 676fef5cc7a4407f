"""Fused TinyROICNN: the CUDA kernel (csrc/roi_cnn.cu) and its plain
PyTorch version (port of the JAX ops/pallas_cnn2.py ``roi_cnn_fused``).

Both compute, per frame, (48, 96) uint8 -> /255 -> optional per-frame
standardize (ddof=1, std >= 1e-6; the training-path normalization of
train_model_official.py:286-291) -> conv 1->8, ReLU, pool -> conv 8->16,
ReLU, pool -> conv 16->24, ReLU -> mean -> fc -> (emb,) f32.

``params`` is the TinyROICNN parameter dict in the JAX package's layout:
``{'conv0' | 'conv1' | 'conv2': {'w': HWIO, 'b'}, 'fc': {'w': (24, emb),
'b'}}`` (``TinyROICNN.params_tree()`` gives it as views of the module's
parameters). The kernel reads its weights from one flat f32 buffer on the
device (:func:`flat_weights`), which it copies into the constant bank
before each launch: build the buffer once per set of weights and pass it
as ``flat``, as ``BiGRUClassifier.kernel_weights()`` does.
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

KERNEL = _kernels.Kernel(
    "roi_cnn", "roi_cnn_forward",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # roi, flat, out
     ctypes.c_int, ctypes.c_int, ctypes.c_int,            # n, emb, standardize
     ctypes.c_void_p])                                    # stream


def standardize_frames(r: torch.Tensor) -> torch.Tensor:
    """Per-frame mean/std standardization over the trailing (H, W) axes
    (torch-std ddof=1, std clamped at 1e-6)."""
    n = r.shape[-1] * r.shape[-2]
    mu = r.mean(dim=(-1, -2), keepdim=True)
    var = (r - mu).square().sum(dim=(-1, -2), keepdim=True) / (n - 1)
    std = torch.clamp(torch.sqrt(var), min=1e-6)
    return (r - mu) / std


def preprocess_roi(roi_u8: torch.Tensor, standardize: bool) -> torch.Tensor:
    """uint8 (..., H, W) -> f32 /255, optionally per-frame standardized
    (``standardize=False`` is the live path, live_infer_official.py:126)."""
    r = roi_u8.to(torch.float32) / 255.0
    return standardize_frames(r) if standardize else r


def roi_cnn_plain(roi_u8: torch.Tensor, params: dict,
                  standardize: bool = False) -> torch.Tensor:
    """Plain PyTorch version: (N, H, W) uint8 -> (N, emb) f32."""
    x = preprocess_roi(roi_u8, standardize).unsqueeze(-1)  # (N, H, W, 1)
    x = max_pool_2x2(torch.relu(conv2d_nhwc(x, params["conv0"])))
    x = max_pool_2x2(torch.relu(conv2d_nhwc(x, params["conv1"])))
    x = torch.relu(conv2d_nhwc(x, params["conv2"]))
    return dense(x.mean(dim=(1, 2)), params["fc"])


def flat_weights(params: dict) -> torch.Tensor:
    """The kernel's weight buffer: conv w (OIHW) and b for the three convs,
    then fc w (emb, 24) and b, as one contiguous f32 vector on the
    parameters' device."""
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
    return torch.cat(parts).detach().to(torch.float32)


def roi_cnn_fused(roi_u8: torch.Tensor, params: dict, *,
                  standardize: bool = False, impl: str = "auto",
                  flat: Optional[torch.Tensor] = None) -> torch.Tensor:
    """roi_u8: (N, 48, 96) uint8 -> embeddings (N, emb) f32.

    ``impl`` as in ``ops._kernels``: 'auto' launches the kernel for a CUDA
    tensor and runs :func:`roi_cnn_plain` for a CPU tensor. ``flat`` is
    :func:`flat_weights` of ``params``, built once by the caller; without
    it every launch builds it anew."""
    if roi_u8.dtype != torch.uint8 or roi_u8.ndim != 3:
        raise ValueError(f"roi_u8 must be (N, H, W) uint8, got "
                         f"{tuple(roi_u8.shape)} {roi_u8.dtype}")
    if not _kernels.use_kernel(impl, roi_u8):
        return roi_cnn_plain(roi_u8, params, standardize)
    N = roi_u8.shape[0]
    if tuple(roi_u8.shape[1:]) != (ROI_H, ROI_W):
        raise ValueError(f"the ROI CNN kernel takes {ROI_H}x{ROI_W} frames, "
                         f"got {tuple(roi_u8.shape[1:])}; use impl='plain'")
    if not roi_u8.is_contiguous() or roi_u8.data_ptr() % 16:
        raise ValueError("roi_u8 must be contiguous and 16-byte aligned")
    fc_b = params["fc"]["b"]
    emb = fc_b.shape[0]
    if fc_b.dtype != torch.float32 or fc_b.device != roi_u8.device:
        raise ValueError(f"params must be f32 on {roi_u8.device}, got "
                         f"{fc_b.dtype} on {fc_b.device}")
    if not 1 <= emb <= MAX_EMB:
        raise ValueError(f"emb must be in [1, {MAX_EMB}], got {emb}")
    if flat is None:
        flat = flat_weights(params)
    n_weights = sum(9 * i * o + o for i, o in zip((1,) + CHANNELS[:-1],
                                                  CHANNELS)) + 25 * emb
    if flat.device != roi_u8.device or flat.dtype != torch.float32 or \
            not flat.is_contiguous() or flat.numel() != n_weights:
        raise ValueError(f"flat must be {n_weights} contiguous f32 on "
                         f"{roi_u8.device} (flat_weights), got "
                         f"{flat.numel()} {flat.dtype} on {flat.device}")
    out = torch.empty((N, emb), dtype=torch.float32, device=roi_u8.device)
    if N:
        KERNEL.launch(_kernels.ptr(roi_u8), _kernels.ptr(flat),
                      _kernels.ptr(out), N, emb, int(standardize),
                      _kernels.stream_ptr(roi_u8.device))
    return out
