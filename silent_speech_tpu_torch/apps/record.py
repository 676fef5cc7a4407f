"""Official recorder app (port of the JAX apps/record.py, which mirrors
record_landmarks_official.py).

Keys: 1-0 select the word, 'r' toggles clip recording, 'q'/ESC quits. Clips
save in the reference `.npz` schema through ``core.schema.save_clip``. The
per-frame features and ROI are the ops' host paths (numpy): the recorder
never dispatches to the device.
"""

from __future__ import annotations

import os
import time

import numpy as np

from ..core.config import RecorderConfig
from ..core.landmark_select import EMA, compute_selected_indices
from ..core.landmarks import FIXED_IDXS, WORDS
from ..core.schema import Clip, clip_filename, save_clip
from ..ops.features import extract_features_frame, span_norm_feature_frame
from ..ops.roi import crop_resize_gray_frame_host
from ..runtime.capture import (
    CameraSource,
    FaceLandmarkerSession,
    draw_landmark_points,
)


def _crop_roi_host(frame_bgr, center, scale, cfg: RecorderConfig, mode: str):
    """Single-frame ROI on the host CPU (pure numpy — the capture loop must
    never wait on a device compile/dispatch; same math as the batched device
    function, within its rounding: tests/test_torch_roi.py)."""
    return crop_resize_gray_frame_host(
        frame_bgr, center, scale,
        out_h=cfg.roi_h, out_w=cfg.roi_w, mode=mode, input_layout="bgr",
        # the RECORDER's skip rule is x2 <= x1 / y2 <= y1
        # (record_landmarks_official.py:114), not live inference's stricter
        # min-2px box (live_infer_official.py:181-182, the default)
        min_side=0,
    )


def main(cfg: RecorderConfig = RecorderConfig(),
         model_path: str = "models/face_landmarker.task",
         device: str = "cuda"):
    """Record clips until 'q'. ``device``: checked as every command of the
    port checks it ('cuda' needs a card), though the recorder runs on the
    host."""
    import cv2
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch sees no CUDA device; "
                           "pass device=cpu to record without a card")

    os.makedirs(cfg.out_dir, exist_ok=True)
    keys = list("1234567890")
    key_to_word = dict(zip(keys, WORDS))

    lm = FaceLandmarkerSession(model_path, video_mode=True)
    try:
        cam = CameraSource(cfg.cam_index)
    except Exception:
        lm.close()
        raise

    recording = False
    label = WORDS[0]
    bufX, bufT, bufR = [], [], []
    prev_xy = None
    clip_id = 0
    roi_ema = EMA(cfg.roi_ema_alpha) if cfg.roi_ema_alpha > 0 else None
    dynamic = cfg.idxs_mode == "dynamic"
    sel_idxs = None  # dynamic selection locks on the first in-range frame

    sm_center = sm_mw = None  # EMA-stabilized ROI center/scale (v2 mode)
    try:
        for frame, ts in cam.frames():
            face = lm.detect(frame, ts)
            out = frame.copy()
            if face is None and roi_ema is not None:
                # v2 semantics: the stabilizer resets on face loss
                # (record_landmarks_v2.py:245-247)
                roi_ema.state = None
                sm_center = sm_mw = None
            if face is not None:
                h, w = frame.shape[:2]
                if dynamic:
                    # per-clip lower-face selection + span-norm features
                    # (inactive/lower_face_record.py semantics)
                    mw = float(np.linalg.norm(
                        (face[291, :2] - face[61, :2]) * [w, h]))
                    in_range = cfg.mouth_w_min_px <= mw <= cfg.mouth_w_max_px
                    if in_range and sel_idxs is None:
                        sel_idxs = compute_selected_indices(face[:, :2])
                    if sel_idxs is not None:
                        feat, xy_n, center, _ = span_norm_feature_frame(
                            face, w, h, sel_idxs, prev_xy)
                    else:
                        feat = xy_n = center = None
                else:
                    feat, xy_n, center, mw = extract_features_frame(
                        face, w, h, prev_xy)
                    in_range = cfg.mouth_w_min_px <= mw <= cfg.mouth_w_max_px
                if roi_ema is not None and center is not None:
                    # v2 semantics: the EMA updates on EVERY detected frame
                    # ("even if not recording, so it settles",
                    # record_landmarks_v2.py:231-232) — not just mid-clip
                    sm = roi_ema.update([center[0], center[1], mw])
                    sm_center, sm_mw = sm[:2], float(sm[2])
                if recording and in_range and feat is not None:
                    prev_xy = xy_n
                    bufX.append(feat)
                    bufT.append(ts)
                    if cfg.save_roi:
                        c, s = ((sm_center, sm_mw) if sm_center is not None
                                else (center, mw))
                        roi = _crop_roi_host(frame, c, s, cfg, "linear")
                        if roi is not None:
                            bufR.append(roi)
                else:
                    prev_xy = None
                if cfg.draw_points:
                    draw_landmark_points(
                        out, face,
                        sel_idxs if dynamic and sel_idxs is not None
                        else FIXED_IDXS)
                cv2.putText(out, f"mouth_w={mw:.1f}px", (20, 140),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.6,
                            (0, 255, 0) if in_range else (0, 0, 255), 2)

            cv2.putText(out, f"{'REC' if recording else 'IDLE'} | {label}",
                        (20, 40), cv2.FONT_HERSHEY_SIMPLEX, 0.9,
                        (255, 255, 255), 2)
            if cfg.save_roi and sm_center is not None:
                # stabilized ROI preview, top-right corner
                # (record_landmarks_v2.py:274-281)
                preview = _crop_roi_host(frame, sm_center, sm_mw, cfg,
                                         "linear")
                if preview is not None:
                    ph, pw = preview.shape[:2]
                    x0, y0 = out.shape[1] - pw - 20, 20
                    out[y0:y0 + ph, x0:x0 + pw] = preview[..., None]
            cv2.imshow("Recorder", out)
            key = cv2.waitKey(1) & 0xFF
            if key in (27, ord("q")):
                break
            ch = chr(key) if 32 <= key < 127 else ""
            if ch in key_to_word:
                label = key_to_word[ch]
            if ch == "r":
                recording = not recording
                if recording:
                    bufX, bufT, bufR = [], [], []
                    prev_xy = None
                    sel_idxs = None
                elif len(bufX) > cfg.min_frames:
                    clip = Clip(
                        X=np.stack(bufX).astype(np.float32),
                        ts=np.asarray(bufT),
                        label=label,
                        speaker=cfg.speaker,
                        idxs=np.asarray(
                            sel_idxs if dynamic and sel_idxs is not None
                            else FIXED_IDXS, np.int32),
                        roi=np.stack(bufR) if cfg.save_roi and bufR else None,
                    )
                    fname = clip_filename(cfg.speaker, label, int(time.time()), clip_id)
                    save_clip(clip, os.path.join(cfg.out_dir, fname),
                              min_frames=cfg.min_frames)
                    print("saved", fname)
                    clip_id += 1
    finally:
        cam.release()
        lm.close()
        cv2.destroyAllWindows()
