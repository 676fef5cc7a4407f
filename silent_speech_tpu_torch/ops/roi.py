"""Mouth ROI: gray + crop + resample (port of the JAX ops/roi.py).

Replaces the reference's per-frame OpenCV calls
(record_landmarks_official.py:102-118 ``crop_roi``, INTER_LINEAR;
live_infer_official.py:171-187 ``crop_roi_gray``, INTER_AREA) with two
dense products a frame, as the JAX package does outside any Pallas kernel:

    roi = round( Wy(y1, y2) @ gray @ Wx(x1, x2)^T )

``Wy: (out_h, frame_h)`` and ``Wx: (out_w, frame_w)`` hold the resampling
weights of the crop box: cv2's INTER_AREA (the fractional-coverage area
average; mouth crops always shrink) or INTER_LINEAR (half-pixel centers,
edges clamped). The host path (:func:`crop_resize_gray_frame_host`) is
numpy, for the capture loop; the batched path
(:func:`crop_resize_gray_batched`) computes on the frames' device with
TF32 off: the result rounds to uint8, and one TF32 pass would move values
across the .5 boundaries.
"""

from __future__ import annotations

import numpy as np
import torch

# BT.601 luma, as cv2.COLOR_RGB2GRAY
_LUMA_RGB = np.asarray([0.299, 0.587, 0.114], np.float32)


def _luma(input_layout: str) -> np.ndarray:
    # BGR reverses the weights as a view, as the JAX package does: numpy's
    # product takes another summation path through a reversed view, and
    # the host crop stays bitwise the JAX package's
    return _LUMA_RGB if input_layout == "rgb" else _LUMA_RGB[::-1]


def make_resize_matrix(out_size: int, a, b, in_size: int,
                       mode: str = "area") -> torch.Tensor:
    """Weights mapping source pixels [a, b) to ``out_size`` pixels.

    a, b: integer crop bounds, Python ints or tensors of any batch shape
    (...). Returns (..., out_size, in_size) float32, rows summing to 1, on
    the bounds' device."""
    a = torch.as_tensor(a).to(torch.float32)[..., None, None]
    b = torch.as_tensor(b).to(torch.float32)[..., None, None]
    # source pixels per output pixel. A tensor divisor: CUDA divides by a
    # Python scalar as a product with its reciprocal, which rounds apart
    # from the host path's IEEE division (about 1e-5 of a weight)
    scale = (b - a) / torch.full_like(a, float(out_size))
    i = torch.arange(out_size, dtype=torch.float32, device=a.device)[:, None]
    s = torch.arange(in_size, dtype=torch.float32, device=a.device)[None, :]
    if mode == "area":
        lo = a + i * scale
        hi = a + (i + 1.0) * scale
        overlap = (torch.minimum(s + 1.0, hi) - torch.maximum(s, lo)).clamp(
            0.0, 1.0)
        return overlap / scale
    if mode == "linear":
        src = a + (i + 0.5) * scale - 0.5  # half-pixel centers
        f = torch.floor(src)
        frac = src - f
        # replicate-border clamping inside the crop window
        f0 = torch.minimum(torch.maximum(f, a), b - 1.0)
        f1 = torch.minimum(torch.maximum(f + 1.0, a), b - 1.0)
        return (1.0 - frac) * (s == f0) + frac * (s == f1)
    raise ValueError(f"unknown resize mode {mode!r}")


def resize_matrices(out_hw, y1, y2, x1, x2, in_hw, mode):
    """(Wy (..., out_h, in_h), Wx (..., out_w, in_w)) of crop boxes."""
    oh, ow = out_hw
    ih, iw = in_hw
    return (make_resize_matrix(oh, y1, y2, ih, mode),
            make_resize_matrix(ow, x1, x2, iw, mode))


def _make_resize_matrix_np(out_size, a, b, in_size, mode):
    """Numpy mirror of :func:`make_resize_matrix` for the host path."""
    a = float(a)
    b = float(b)
    scale = (b - a) / float(out_size)
    i = np.arange(out_size, dtype=np.float32)[:, None]
    s = np.arange(in_size, dtype=np.float32)[None, :]
    if mode == "area":
        lo = a + i * scale
        hi = a + (i + 1.0) * scale
        overlap = np.clip(np.minimum(s + 1.0, hi) - np.maximum(s, lo), 0.0,
                          1.0)
        return (overlap / scale).astype(np.float32)
    if mode == "linear":
        src = a + (i + 0.5) * scale - 0.5
        f = np.floor(src)
        frac = src - f
        f0 = np.clip(f, a, b - 1.0)
        f1 = np.clip(f + 1.0, a, b - 1.0)
        return ((1.0 - frac) * (s == f0) + frac * (s == f1)).astype(
            np.float32)
    raise ValueError(f"unknown resize mode {mode!r}")


def crop_resize_gray_frame_host(frame: np.ndarray, center, scale: float, *,
                                out_h: int = 48, out_w: int = 96,
                                mode: str = "area",
                                input_layout: str = "bgr",
                                half_w_mul: float = 1.2,
                                half_h_mul: float = 1.0, min_side: int = 2):
    """One frame's gray + crop + resize in numpy: the capture loop's path,
    which never touches the device. Returns (out_h, out_w) uint8, or None
    where the crop box degenerates (the reference's skip condition,
    live_infer_official.py:181-182)."""
    H, W = frame.shape[:2]
    cx, cy = float(center[0]), float(center[1])
    hw = half_w_mul * float(scale)
    hh = half_h_mul * float(scale)
    x1 = int(max(0.0, cx - hw))
    x2 = int(min(float(W), cx + hw))
    y1 = int(max(0.0, cy - hh))
    y2 = int(min(float(H), cy + hh))
    if not (x2 > x1 + min_side and y2 > y1 + min_side):
        return None
    gray = frame.astype(np.float32) @ _luma(input_layout)  # (H, W)
    Wy = _make_resize_matrix_np(out_h, y1, y2, H, mode)
    Wx = _make_resize_matrix_np(out_w, x1, x2, W, mode)
    r = Wy @ gray @ Wx.T
    return np.clip(np.round(r), 0.0, 255.0).astype(np.uint8)


def _crop_bounds(center, scale, frame_w, frame_h, half_w_mul, half_h_mul):
    """Crop box ints in f32, truncating clamped floats as the reference
    does (record_landmarks_official.py:109-113)."""
    cx, cy = center[..., 0], center[..., 1]
    hw = half_w_mul * scale
    hh = half_h_mul * scale
    x1 = torch.clamp(cx - hw, min=0.0).to(torch.int32)
    x2 = torch.clamp(cx + hw, max=float(frame_w)).to(torch.int32)
    y1 = torch.clamp(cy - hh, min=0.0).to(torch.int32)
    y2 = torch.clamp(cy + hh, max=float(frame_h)).to(torch.int32)
    return x1, x2, y1, y2


def gray_from_uint8(frames: torch.Tensor,
                    input_layout: str = "rgb") -> torch.Tensor:
    """(..., H, W, 3) uint8 -> (..., H, W) float32 luma (BT.601)."""
    from ..infer.predictor import full_f32

    lum = torch.from_numpy(_luma(input_layout).copy()).to(frames.device)
    with full_f32():
        return frames.to(torch.float32) @ lum


def crop_resize_gray_values(frames: torch.Tensor, centers, scales, *,
                            out_h: int = 48, out_w: int = 96,
                            mode: str = "area", input_layout: str = "rgb",
                            half_w_mul: float = 1.2, half_h_mul: float = 1.0,
                            min_side: int = 2):
    """:func:`crop_resize_gray_batched` before its rounding: (the f32
    resampled values (B, T, out_h, out_w), ok (B, T)). A check reads here
    which pixels lie near a rounding boundary."""
    B, T, H, W, _ = frames.shape
    dev = frames.device
    centers = torch.as_tensor(centers, dtype=torch.float32, device=dev)
    scales = torch.as_tensor(scales, dtype=torch.float32, device=dev)
    x1, x2, y1, y2 = _crop_bounds(centers, scales, W, H, half_w_mul,
                                  half_h_mul)
    ok = (x2 > x1 + min_side) & (y2 > y1 + min_side)
    gray = gray_from_uint8(frames, input_layout)  # (B, T, H, W)
    # degenerate boxes keep finite weights (crop_resize_gray_batched zeroes
    # their ROIs)
    Wy, Wx = resize_matrices((out_h, out_w), y1, torch.maximum(y2, y1 + 1),
                             x1, torch.maximum(x2, x1 + 1), (H, W), mode)
    from ..infer.predictor import full_f32

    with full_f32():
        return (Wy @ gray) @ Wx.transpose(-1, -2), ok


def crop_resize_gray_batched(frames: torch.Tensor, centers, scales, *,
                             out_h: int = 48, out_w: int = 96,
                             mode: str = "area", input_layout: str = "rgb",
                             half_w_mul: float = 1.2,
                             half_h_mul: float = 1.0, min_side: int = 2):
    """Gray + crop + resize of a batch of frames on their device.

    frames: (B, T, H, W, 3) uint8; centers: (B, T, 2) pixel crop centers
    (cx, cy); scales: (B, T) pixel mouth widths. Returns (roi (B, T,
    out_h, out_w) uint8, ok (B, T) bool): ``ok`` is False where the crop
    box degenerated (the reference's skip condition,
    live_infer_official.py:181-182), and those ROIs are zero (the live
    zero-ROI substitution, live_infer_official.py:288-293)."""
    r, ok = crop_resize_gray_values(
        frames, centers, scales, out_h=out_h, out_w=out_w, mode=mode,
        input_layout=input_layout, half_w_mul=half_w_mul,
        half_h_mul=half_h_mul, min_side=min_side)
    r = torch.round(r).clamp(0.0, 255.0)
    r = torch.where(ok[..., None, None], r, torch.zeros_like(r))
    return r.to(torch.uint8), ok
