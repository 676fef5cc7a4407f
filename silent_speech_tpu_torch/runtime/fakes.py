"""Headless simulation doubles for the camera stack (cv2 / camera /
landmarker); port of the JAX runtime/fakes.py.

The reference's live loops could only ever be eyeball-tested
(live_infer_official.py:229-363, record_landmarks_official.py:135-258 —
SURVEY.md section 4 lists "live demo" as the only end-to-end check). These
doubles drive the exact app loop bodies — keyboard state machines, distance
gating, zero-ROI fallback, the mp4 writer — with scripted keystrokes and
synthetic landmark tracks, both under pytest and as a ``sim=N`` CLI mode on
hosts with no camera/cv2/mediapipe.

Nothing here imports cv2 or mediapipe; the fakes duck-type the slices of
their APIs the apps actually touch.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Iterator, Optional, Sequence

import numpy as np

from ..core.landmarks import (
    LEFT_CORNER,
    LOWER_INNER,
    RIGHT_CORNER,
    UPPER_INNER,
)

NO_KEY = 255  # cv2.waitKey() & 0xFF with no key pressed (-1 & 0xFF)


def make_face(
    mouth_w_px: float = 90.0,
    open_px: float = 12.0,
    *,
    frame_hw: tuple[int, int] = (480, 640),
    center: tuple[float, float] = (0.5, 0.5),
    seed: int = 0,
) -> np.ndarray:
    """A (468, 3) normalized landmark frame with controllable geometry.

    The mouth anchor points are placed so the app-visible quantities come out
    exactly: mouth width = ``mouth_w_px`` pixels, inner-lip opening =
    ``open_px`` pixels (=> openness aspect = open_px / mouth_w_px). The other
    464 points scatter deterministically in a disc around ``center``.
    """
    H, W = frame_hw
    cx, cy = center
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, 468)
    rad = rng.uniform(0.02, 0.12, 468)
    face = np.zeros((468, 3), np.float32)
    face[:, 0] = cx + rad * np.cos(ang)
    face[:, 1] = cy + rad * np.sin(ang)
    half_w = mouth_w_px / (2.0 * W)
    face[LEFT_CORNER, :2] = (cx - half_w, cy)
    face[RIGHT_CORNER, :2] = (cx + half_w, cy)
    half_o = open_px / (2.0 * H)
    face[UPPER_INNER, :2] = (cx, cy - half_o)
    face[LOWER_INNER, :2] = (cx, cy + half_o)
    return np.clip(face, 0.0, 1.0)


def face_track(
    n: int,
    mouth_w_px: float = 90.0,
    open_seq: Optional[Sequence[float]] = None,
    **kw,
) -> list[Optional[np.ndarray]]:
    """n faces with per-frame openness (pixels); None entries = face lost."""
    faces: list[Optional[np.ndarray]] = []
    for i in range(n):
        o = 12.0 if open_seq is None else float(open_seq[min(i, len(open_seq) - 1)])
        faces.append(make_face(mouth_w_px, o, seed=i, **kw))
    return faces


class FakeVideoWriter:
    def __init__(self, path, fourcc, fps, size):
        self.path, self.fourcc, self.fps, self.size = path, fourcc, fps, size
        self.frames_written = 0
        self.released = False
        try:
            # real cv2.VideoWriter creates the file on open — the timed
            # recorder's video-counting dashboard depends on that
            open(path, "wb").close()
        except OSError:
            pass

    def write(self, frame):
        self.frames_written += 1

    def release(self):
        self.released = True


class FakeCV2:
    """The slice of the cv2 module surface the apps touch.

    ``keys``: scripted per-frame keyboard codes; one is consumed per
    ``waitKey`` call, then ``NO_KEY`` forever (the camera's frame budget ends
    the loop).
    """

    FONT_HERSHEY_SIMPLEX = 0
    FONT_HERSHEY_PLAIN = 1
    COLOR_BGR2RGB = 4
    COLOR_BGR2GRAY = 6

    def __init__(self, keys: Sequence[int] = ()):
        self._keys = list(keys)
        self._key_i = 0
        self.texts: list[str] = []
        self.windows: list[str] = []
        self.writers: list[FakeVideoWriter] = []
        self.destroyed = False

    # --- drawing / display ---------------------------------------------
    def putText(self, img, text, org, font, scale, color, thickness=1,
                lineType=None):
        self.texts.append(str(text))

    def circle(self, img, center, radius, color, thickness=1):
        pass

    def rectangle(self, img, pt1, pt2, color, thickness=1):
        pass

    def imshow(self, name, img):
        self.windows.append(name)

    def waitKey(self, delay=0):
        if self._key_i < len(self._keys):
            k = self._keys[self._key_i]
            self._key_i += 1
            return int(k)
        return NO_KEY

    def destroyAllWindows(self):
        self.destroyed = True

    # --- conversion / encode --------------------------------------------
    def cvtColor(self, img, code):
        if code == self.COLOR_BGR2RGB:
            return img[..., ::-1].copy()
        if code == self.COLOR_BGR2GRAY:
            w = np.asarray([0.114, 0.587, 0.299], np.float32)  # BGR order
            return (img.astype(np.float32) @ w).astype(np.uint8)
        return img

    def addWeighted(self, a, alpha, b, beta, gamma):
        out = a.astype(np.float32) * alpha + b.astype(np.float32) * beta + gamma
        return np.clip(out, 0, 255).astype(np.uint8)

    def VideoWriter_fourcc(self, *chars):
        return 0

    def VideoWriter(self, path, fourcc, fps, size):
        vw = FakeVideoWriter(path, fourcc, fps, size)
        self.writers.append(vw)
        return vw


class FakeCamera:
    """Duck-type of runtime.capture.CameraSource over synthetic frames."""

    def __init__(self, n_frames: int, hw: tuple[int, int] = (480, 640),
                 seed: int = 0, frame_delay: float = 0.0):
        self.n_frames = n_frames
        self.hw = hw
        self.frame_delay = frame_delay  # wall-clock pacing for timed loops
        self.released = False
        rng = np.random.default_rng(seed)
        H, W = hw
        # one noise frame reused — apps copy() before drawing
        self._frame = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)

    def frames(self) -> Iterator[tuple[np.ndarray, int]]:
        for i in range(self.n_frames):
            if self.frame_delay:
                time.sleep(self.frame_delay)
            yield self._frame, i * 33

    def release(self):
        self.released = True


class FakeLandmarker:
    """Duck-type of runtime.capture.FaceLandmarkerSession over a face track."""

    def __init__(self, faces: Sequence[Optional[np.ndarray]]):
        self.faces = list(faces)
        self.calls = 0
        self.closed = False

    def detect(self, frame_bgr, ts_ms: int = 0) -> Optional[np.ndarray]:
        face = self.faces[min(self.calls, len(self.faces) - 1)] if self.faces else None
        self.calls += 1
        return face

    def close(self):
        self.closed = True


# the port's camera apps (record-timed, landmarks-view and
# important-landmarks are not ported yet)
_APP_MODULES = (
    "silent_speech_tpu_torch.apps.live",
    "silent_speech_tpu_torch.apps.record",
)


@contextlib.contextmanager
def sim_session(
    *,
    keys: Sequence[int] = (),
    faces: Optional[Sequence[Optional[np.ndarray]]] = None,
    n_frames: int = 60,
    hw: tuple[int, int] = (480, 640),
):
    """Patch the camera stack with fakes for the duration of the block.

    Yields (fake_cv2, camera, landmarker). Replaces the ``cv2`` module (the
    apps import it function-locally), the capture module's cv2 binding (for
    draw_landmark_points), and the CameraSource / FaceLandmarkerSession
    symbols in every app module, restoring everything on exit.
    """
    import importlib

    from . import capture

    fake_cv2 = FakeCV2(keys)
    camera = FakeCamera(n_frames, hw)
    landmarker = FakeLandmarker(faces if faces is not None else face_track(n_frames))

    cam_factory = lambda *a, **k: camera  # noqa: E731
    lm_factory = lambda *a, **k: landmarker  # noqa: E731

    saved_mod = sys.modules.get("cv2")
    sys.modules["cv2"] = fake_cv2
    saved_capture_cv2 = capture.cv2
    capture.cv2 = fake_cv2
    patched: list[tuple[object, str, object]] = []
    try:
        for name in _APP_MODULES:
            mod = importlib.import_module(name)
            for attr, repl in (("CameraSource", cam_factory),
                               ("FaceLandmarkerSession", lm_factory)):
                if hasattr(mod, attr):
                    patched.append((mod, attr, getattr(mod, attr)))
                    setattr(mod, attr, repl)
        yield fake_cv2, camera, landmarker
    finally:
        for mod, attr, orig in reversed(patched):
            setattr(mod, attr, orig)
        capture.cv2 = saved_capture_cv2
        if saved_mod is None:
            sys.modules.pop("cv2", None)
        else:
            sys.modules["cv2"] = saved_mod
