"""Landmark stream -> feature vectors (port of the JAX ops/features.py).

Two halves, as in the JAX package:

- the host per-frame functions (``extract_features_frame``,
  ``lip83_features_frame_host``, ``span_norm_feature_frame``) are numpy:
  they run in the capture loop, which must never wait on the device;
- the batched functions take a (B, T, 468, 2+) tensor and compute on its
  device: the official 180-D features with their gate-aware velocity, and
  the lip83, mouth83, span-norm and v3 families.

Velocity semantics (the sequential reference's, SURVEY.md section 2.5 item
8): the reference resets ``prev_xy = None`` on the first frame and whenever
the mouth-width band is left (record_landmarks_official.py:85-88,199-201).
Batched: ``vel[t] = mean_k ||xy_n[t,k] - xy_n[t-1,k]||`` where frames t and
t-1 are both valid and t > 0, else 0.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.landmarks import (FIXED_IDXS, LEFT_CORNER, LIP_ORDER,
                              LOWER_INNER, MOUTH_LOWER, MOUTH_UPPER,
                              RIGHT_CORNER, UPPER_INNER)

_FIXED = np.asarray(FIXED_IDXS, dtype=np.int64)
_LIP = np.asarray(LIP_ORDER, dtype=np.int64)
_MOUTH_SET = np.asarray(sorted(set(MOUTH_UPPER + MOUTH_LOWER)), np.int64)
_LOOP = np.asarray(MOUTH_UPPER + MOUTH_LOWER[::-1], np.int64)
_EPS = 1e-6


def _take(x: torch.Tensor, idxs) -> torch.Tensor:
    """x[..., idxs, :] for a numpy or tensor index list."""
    return x[..., torch.as_tensor(np.asarray(idxs), device=x.device), :]


def _to_px(landmarks: torch.Tensor, frame_w: int, frame_h: int):
    scale = torch.tensor([frame_w, frame_h], dtype=landmarks.dtype,
                         device=landmarks.device)
    return landmarks[..., :2] * scale


def mouth_width(lm_px: torch.Tensor) -> torch.Tensor:
    """Mouth width in pixels from pixel-space landmarks (..., 468, 2)
    (record_landmarks_official.py:52-59)."""
    return torch.linalg.norm(lm_px[..., LEFT_CORNER, :]
                             - lm_px[..., RIGHT_CORNER, :], dim=-1)


def _masked_step_velocity(xy_n: torch.Tensor,
                          valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Gate-aware one-step mean landmark velocity (B, T): vel[0] = 0, and a
    frame pair across an out-of-range or face-lost gap gives 0. One
    definition for every feature family."""
    d = xy_n[:, 1:] - xy_n[:, :-1]  # (B, T-1, K, 2)
    vel = torch.linalg.norm(d, dim=-1).mean(dim=-1)
    vel = torch.nn.functional.pad(vel, (1, 0))  # vel[0] = 0
    if valid is not None:
        valid = torch.as_tensor(valid, device=xy_n.device).bool()
        pair_ok = torch.nn.functional.pad(valid[:, 1:] & valid[:, :-1],
                                          (1, 0))
        vel = torch.where(pair_ok, vel, torch.zeros_like(vel))
    return vel


def extract_features_batched(landmarks: torch.Tensor, frame_w: int,
                             frame_h: int,
                             valid: Optional[torch.Tensor] = None):
    """The official 180-D features of a (B, T) window.

    landmarks: (B, T, 468, 2+) normalized MediaPipe coordinates (x, y
    used); ``valid``: optional (B, T) bool in-range gate, where the
    velocity resets. Returns (feats (B, T, 180) f32, centers (B, T, 2) px,
    mouth_w (B, T) px), on landmarks' device."""
    lm_px = _to_px(landmarks, frame_w, frame_h)
    xy = _take(lm_px, _FIXED)  # (B, T, 88, 2)
    center = xy.mean(dim=-2)
    mw = mouth_width(lm_px)
    xy_n = (xy - center[..., None, :]) / (mw + _EPS)[..., None, None]
    mouth_open = torch.linalg.norm(lm_px[..., UPPER_INNER, :]
                                   - lm_px[..., LOWER_INNER, :], dim=-1)
    aspect = mouth_open / (mw + _EPS)
    vel = _masked_step_velocity(xy_n, valid)
    B, T = xy_n.shape[:2]
    scalars = torch.stack([vel, mouth_open, mw, aspect], dim=-1)
    feats = torch.cat([xy_n.reshape(B, T, -1), scalars], dim=-1)
    return feats.to(torch.float32), center, mw


def extract_features_frame(landmarks: np.ndarray, frame_w: int, frame_h: int,
                           prev_xy: Optional[np.ndarray]):
    """One frame on the host, for the capture loops (the reference's
    signature, record_landmarks_official.py:62-100): returns (feat (180,)
    f32, xy_n (88, 2), center px, mouth_w px)."""
    lm = np.asarray(landmarks, dtype=np.float32)[..., :2] * np.asarray(
        [frame_w, frame_h], np.float32)
    xy = lm[_FIXED]
    center = xy.mean(0)
    mw = float(np.linalg.norm(lm[LEFT_CORNER] - lm[RIGHT_CORNER]))
    xy_n = (xy - center) / (mw + _EPS)
    if prev_xy is None:
        vel = 0.0
    else:
        vel = float(np.mean(np.linalg.norm(xy_n - prev_xy, axis=1)))
    mouth_open = float(np.linalg.norm(lm[UPPER_INNER] - lm[LOWER_INNER]))
    aspect = mouth_open / (mw + _EPS)
    feat = np.concatenate(
        [xy_n.reshape(-1), np.asarray([vel, mouth_open, mw, aspect],
                                      np.float32)]).astype(np.float32)
    return feat, xy_n, center, mw


def lip83_features_frame_host(face) -> tuple[np.ndarray, float]:
    """One frame of :func:`lip83_features_batched` on the host, for the
    capture (producer) thread: the 83-D math is about 100 FLOPs, a device
    dispatch a frame would cost far more. Returns (feat (83,) f32,
    openness)."""
    xy = np.asarray(face, np.float32)[:, :2]
    pts = xy[_LIP]  # (40, 2)
    center = pts.mean(axis=0, keepdims=True)
    mw = float(np.linalg.norm(xy[RIGHT_CORNER] - xy[LEFT_CORNER])) + _EPS
    pts_n = (pts - center) / np.float32(mw)
    openness = float(np.linalg.norm(xy[13] - xy[14])) / mw
    height = float(np.linalg.norm(xy[0] - xy[17])) / mw
    corner = float(np.linalg.norm(xy[61] - xy[291])) / mw - 1.0
    feat = np.concatenate(
        [pts_n.reshape(-1),
         np.asarray([openness, height, corner], np.float32)]
    ).astype(np.float32)
    return feat, openness


def lip83_features_batched(landmarks: torch.Tensor):
    """The 83-D streaming features (inactive/live_feed.py:57-86) of
    (B, T, 468, 2+) *normalized* coordinates (this family never scales to
    pixels): 40 ordered lip points x 2, then [openness, height, corner].
    Returns (feats (B, T, 83) f32, openness (B, T))."""
    xy = landmarks[..., :2]
    pts = _take(xy, _LIP)  # (B, T, 40, 2)
    center = pts.mean(dim=-2, keepdim=True)
    mw = torch.linalg.norm(xy[..., RIGHT_CORNER, :] - xy[..., LEFT_CORNER, :],
                           dim=-1) + _EPS
    pts_n = (pts - center) / mw[..., None, None]
    B, T = pts_n.shape[:2]
    dist = lambda i, j: torch.linalg.norm(xy[..., i, :] - xy[..., j, :],
                                          dim=-1)
    openness = dist(13, 14) / mw
    height = dist(0, 17) / mw
    corner = dist(61, 291) / mw - 1.0
    feats = torch.cat([pts_n.reshape(B, T, -1), openness[..., None],
                       height[..., None], corner[..., None]], dim=-1)
    return feats.to(torch.float32), openness


def polygon_area(pts: torch.Tensor) -> torch.Tensor:
    """Shoelace area over the last two dims (..., K, 2)
    (inactive/record_landmarks.py:76-79)."""
    x, y = pts[..., 0], pts[..., 1]
    xr = torch.roll(x, -1, dims=-1)
    yr = torch.roll(y, -1, dims=-1)
    return 0.5 * torch.abs((x * yr - y * xr).sum(dim=-1))


def mouth83_features_batched(landmarks: torch.Tensor, frame_w: int,
                             frame_h: int,
                             valid: Optional[torch.Tensor] = None):
    """Recorder-v1 mouth-only 83-D features
    (inactive/record_landmarks.py:82-116): 40 lip points x 2 (centered,
    mouth-width normalized), then [openness, the lip loop's normalized
    shoelace area, velocity]. Returns (B, T, 83) f32."""
    lm_px = _to_px(landmarks, frame_w, frame_h)
    xy = _take(lm_px, _MOUTH_SET)  # (B, T, 40, 2)
    center = xy.mean(dim=-2)
    width = mouth_width(lm_px) + _EPS
    xy_n = (xy - center[..., None, :]) / width[..., None, None]
    openness = torch.linalg.norm(lm_px[..., UPPER_INNER, :]
                                 - lm_px[..., LOWER_INNER, :],
                                 dim=-1) / width
    loop = _take(lm_px, _LOOP)
    area = polygon_area((loop - center[..., None, :])
                        / width[..., None, None])
    vel = _masked_step_velocity(xy_n, valid)
    B, T = xy_n.shape[:2]
    return torch.cat([xy_n.reshape(B, T, -1), openness[..., None],
                      area[..., None], vel[..., None]],
                     dim=-1).to(torch.float32)


def span_norm_features_batched(landmarks: torch.Tensor, idxs,
                               frame_w: int, frame_h: int,
                               valid: Optional[torch.Tensor] = None):
    """Span-normalized features over any landmark selection, the formula
    of recorder v3 (the fixed 88 points, inactive/record_landmarks_v3.py:
    56-68) and of the dynamic lower-face recorders (per-clip selections,
    inactive/lower_face_record.py:86-108): centered xy / x-span, then one
    velocity scalar. Returns (B, T, 2K+1) f32."""
    lm_px = _to_px(landmarks, frame_w, frame_h)
    xy = _take(lm_px, idxs)
    center = xy.mean(dim=-2)
    span = xy[..., 0].amax(dim=-1) - xy[..., 0].amin(dim=-1) + _EPS
    xy_n = (xy - center[..., None, :]) / span[..., None, None]
    vel = _masked_step_velocity(xy_n, valid)
    B, T = xy_n.shape[:2]
    return torch.cat([xy_n.reshape(B, T, -1), vel[..., None]],
                     dim=-1).to(torch.float32)


def v3_features_batched(landmarks: torch.Tensor, frame_w: int, frame_h: int,
                        valid: Optional[torch.Tensor] = None):
    """Recorder-v3 177-D features: the 88 fixed points through the
    span-norm formula. Returns (B, T, 177)."""
    return span_norm_features_batched(landmarks, _FIXED, frame_w, frame_h,
                                      valid)


def span_norm_feature_frame(landmarks: np.ndarray, frame_w: int,
                            frame_h: int, idxs: np.ndarray,
                            prev_xy: Optional[np.ndarray]):
    """One frame of the span-norm features on the host (the dynamic
    recorders' per-frame path, inactive/lower_face_record.py:86-108).
    Returns (feat (2K+1,), xy_n, center px, span px)."""
    lm = np.asarray(landmarks, np.float32)[..., :2] * np.asarray(
        [frame_w, frame_h], np.float32)
    xy = lm[np.asarray(idxs)]
    center = xy.mean(0)
    span = float(xy[:, 0].max() - xy[:, 0].min()) + _EPS
    xy_n = (xy - center) / span
    if prev_xy is None:
        vel = 0.0
    else:
        vel = float(np.mean(np.linalg.norm(xy_n - prev_xy, axis=1)))
    feat = np.concatenate(
        [xy_n.reshape(-1), np.asarray([vel], np.float32)]).astype(np.float32)
    return feat, xy_n, center, span
