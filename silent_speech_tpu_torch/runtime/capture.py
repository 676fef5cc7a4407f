"""Host capture / landmark / audio shims (port of the JAX
runtime/capture.py; they stay on the host).

OpenCV and MediaPipe are optional dependencies, imported here only if
present: using a shim without them raises a clear ImportError, so the
package imports on a machine with neither (the GPU machine has no cv2).
The camera-fallback probing and the VIDEO-mode landmarker session follow
the reference (live_infer_official.py:236-240,
record_landmarks_official.py:150-163, inactive/caden_record.py:127-134).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import time
from typing import Iterator, Optional

import numpy as np

# the reference ships the FaceLandmarker bundle as
# models/face_landmarker.task (3.7 MB)
LANDMARKER_ENV = "SILENT_SPEECH_LANDMARKER"


def resolve_landmarker_asset(model_path: str) -> str:
    """Resolve the FaceLandmarker .task bundle, failing with instructions.

    Order: explicit existing path -> $SILENT_SPEECH_LANDMARKER -> the same
    relative path under the repo root. The reference hardcodes the relative
    path and fails deep inside mediapipe when it is missing; here the first
    real-camera session gets an error that names the paths tried and the
    variable. Nothing is downloaded."""
    candidates = [model_path]
    env = os.environ.get(LANDMARKER_ENV)
    if env:
        candidates.append(env)
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    candidates.append(os.path.join(here, model_path))
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise FileNotFoundError(
        f"FaceLandmarker model bundle not found (tried: {candidates}).\n"
        f"Place the face_landmarker.task bundle at {model_path}, or point "
        f"${LANDMARKER_ENV} at a copy of it."
    )

try:  # pragma: no cover - optional dependency
    import cv2  # type: ignore
except ImportError:  # pragma: no cover
    cv2 = None

try:  # pragma: no cover - optional dependency
    import mediapipe as mp  # type: ignore
    from mediapipe.tasks import python as mp_python  # type: ignore
    from mediapipe.tasks.python import vision as mp_vision  # type: ignore
except ImportError:  # pragma: no cover
    mp = mp_python = mp_vision = None


def _require(mod, name: str):
    if mod is None:
        raise ImportError(
            f"{name} is required for live capture but is not installed; "
            f"the offline commands and the sim=N harness work without it"
        )


class CameraSource:
    """Webcam frame source with index-fallback probing."""

    def __init__(self, cam_index: int = 0, fallbacks: tuple[int, ...] = (0, 1, 2)):
        _require(cv2, "opencv-python")
        self.cap = cv2.VideoCapture(cam_index)
        if not self.cap.isOpened():
            for idx in fallbacks:
                if idx == cam_index:
                    continue
                self.cap = cv2.VideoCapture(idx)
                if self.cap.isOpened():
                    break
        if not self.cap.isOpened():
            raise RuntimeError("Could not open camera")
        self.t0 = time.monotonic()

    def frames(self) -> Iterator[tuple[np.ndarray, int]]:
        """Yields (BGR frame, ts_ms since session start)."""
        while True:
            ok, frame = self.cap.read()
            if not ok:
                return
            yield frame, int((time.monotonic() - self.t0) * 1000)

    def release(self):
        self.cap.release()


class FaceLandmarkerSession:
    """MediaPipe FaceLandmarker wrapper (VIDEO or IMAGE running mode).

    ``detect(frame_bgr, ts_ms) -> (468, 3) float32 normalized landmarks or
    None`` when no face is found.
    """

    def __init__(self, model_path: str = "models/face_landmarker.task",
                 video_mode: bool = True):
        _require(mp, "mediapipe")
        model_path = resolve_landmarker_asset(model_path)
        mode = (mp_vision.RunningMode.VIDEO if video_mode
                else mp_vision.RunningMode.IMAGE)
        options = mp_vision.FaceLandmarkerOptions(
            base_options=mp_python.BaseOptions(model_asset_path=model_path),
            running_mode=mode,
            num_faces=1,
            output_face_blendshapes=False,
            output_facial_transformation_matrixes=False,
        )
        self.video_mode = video_mode
        self._lm = mp_vision.FaceLandmarker.create_from_options(options)

    def detect(self, frame_bgr: np.ndarray, ts_ms: int = 0) -> Optional[np.ndarray]:
        img = mp.Image(
            image_format=mp.ImageFormat.SRGB,
            data=cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2RGB),
        )
        res = (self._lm.detect_for_video(img, ts_ms) if self.video_mode
               else self._lm.detect(img))
        if not res.face_landmarks:
            return None
        face = res.face_landmarks[0]
        return np.asarray([(p.x, p.y, p.z) for p in face], np.float32)

    def close(self):
        self._lm.close()


def play_audio(path: str) -> Optional[subprocess.Popen]:
    """Portable fire-and-forget audio playback (the reference shells out to
    macOS afplay, live_infer_official.py:59-65)."""
    for player in (["afplay"], ["paplay"], ["aplay", "-q"],
                   ["ffplay", "-nodisp", "-autoexit", "-loglevel", "quiet"]):
        if shutil.which(player[0]):
            return subprocess.Popen(player + [path])
    return None


def draw_landmark_points(frame_bgr, landmarks: np.ndarray, idxs,
                         color=(0, 255, 0), radius: int = 1):
    """Overlay landmark dots (record_landmarks_official.py:121-130)."""
    _require(cv2, "opencv-python")
    h, w = frame_bgr.shape[:2]
    for i in idxs:
        x, y = int(landmarks[i, 0] * w), int(landmarks[i, 1] * h)
        cv2.circle(frame_bgr, (x, y), radius, color, -1)
    return frame_bgr
