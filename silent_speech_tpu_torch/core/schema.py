"""Data contracts: the `.npz` clip format and the padded batch (copy of the
JAX package's core/schema.py, which the port does not import).

The on-disk clip format is the reference's public contract and is read/written
unchanged (reference: train_model_official.py:1-9 schema comment; writer
record_landmarks_official.py:236-251)::

    X:       (T, D)  float32   per-frame feature vectors
    ts:      (T,)    int       per-frame timestamps (ms since session start)
    label:   str               word label
    speaker: str               speaker id
    idxs:    (K,)    int       landmark indices used (consistency checking)
    roi:     (T, H, W) uint8   optional grayscale mouth crop

Tolerances the loader must keep (reference behaviors):
- ``roi`` and ``idxs`` may be absent (train_model_official.py:159, 330-333);
- feature dim ``D`` varies across clips recorded by different generations
  (train_model_official.py:341-353 filters to the modal dim);
- ``X`` and ``roi`` lengths can disagree; align conservatively to the min
  (train_model_official.py:159-169).

Filename convention ``{speaker}_{label}_{unixtime}_{clipid:04d}.npz``
(record_landmarks_official.py:249); some evaluators parse the label from the
filename (inactive/dataset_eval.py:31-32).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

ROI_W, ROI_H = 96, 48  # official mouth-ROI size (record_landmarks_official.py:17)


@dataclasses.dataclass
class Clip:
    """One recorded clip, host-side (numpy)."""

    X: np.ndarray  # (T, D) float32
    ts: np.ndarray  # (T,) int
    label: str
    speaker: str
    idxs: Optional[np.ndarray] = None  # (K,) int
    roi: Optional[np.ndarray] = None  # (T, H, W) uint8

    @property
    def T(self) -> int:
        return int(self.X.shape[0])

    @property
    def D(self) -> int:
        return int(self.X.shape[1])

    def aligned(self) -> "Clip":
        """Conservatively align X and roi lengths to their min (see module doc)."""
        if self.roi is None:
            return self
        T = min(self.X.shape[0], self.roi.shape[0])
        return dataclasses.replace(
            self, X=self.X[:T], ts=self.ts[:T], roi=self.roi[:T]
        )


def load_clip(path: str) -> Clip:
    """Read one `.npz` clip, tolerating missing optional keys.

    allow_pickle stays False everywhere: the reference schema holds only
    numeric and unicode-string arrays (record_landmarks_official.py:236-251),
    and a pickled object array in an untrusted corpus would execute code at
    load time.
    """
    with np.load(path, allow_pickle=False) as d:
        files = set(d.files)
        if "X" not in files:
            raise ValueError(f"{path}: missing required key 'X'")
        X = np.asarray(d["X"], dtype=np.float32)
        if X.ndim != 2:
            raise ValueError(f"{path}: X must be (T, D), got shape {X.shape}")
        T = X.shape[0]
        ts = (
            np.asarray(d["ts"]).reshape(-1)[:T]
            if "ts" in files
            else np.arange(T, dtype=np.int64)
        )
        label = str(d["label"]) if "label" in files else parse_filename_label(path)
        speaker = str(d["speaker"]) if "speaker" in files else ""
        idxs = np.asarray(d["idxs"], dtype=np.int32) if "idxs" in files else None
        roi = np.asarray(d["roi"], dtype=np.uint8) if "roi" in files else None
    return Clip(X=X, ts=ts, label=label, speaker=speaker, idxs=idxs, roi=roi)


def save_clip(clip: Clip, path: str, *, min_frames: int = 5) -> str:
    """Write one clip in the reference `.npz` format.

    Refuses clips with <= ``min_frames`` frames, matching the recorder's
    too-short-clip guard (record_landmarks_official.py:235).
    Truncates X/ts/roi to a common length before writing, matching the
    recorder's alignment (record_landmarks_official.py:245-248).
    """
    # align FIRST: a clip whose roi is shorter than X must be judged by its
    # post-alignment length, or the guard passes and a too-short clip is
    # written anyway
    clip = clip.aligned()
    if clip.T <= min_frames:
        raise ValueError(f"clip too short: {clip.T} <= {min_frames} frames")
    payload = dict(
        X=clip.X.astype(np.float32),
        ts=np.asarray(clip.ts),
        label=clip.label,
        speaker=clip.speaker,
    )
    if clip.idxs is not None:
        payload["idxs"] = np.asarray(clip.idxs)
    if clip.roi is not None:
        payload["roi"] = clip.roi.astype(np.uint8)
    np.savez_compressed(path, **payload)
    return path


def sanitize_field(s: str) -> str:
    """The filename-field sanitization clip_filename applies ('_' is the
    field separator, so embedded underscores become dashes). Use this when
    comparing an npz-stored label (kept verbatim) against a filename-parsed
    label, or the two forms of 'my_word' would never match."""
    return str(s).replace("_", "-")


def clip_filename(speaker: str, label: str, unixtime: int, clip_id: int) -> str:
    """Reference filename convention (record_landmarks_official.py:249).

    Underscores inside speaker/label are sanitized to dashes at write time:
    '_' is the field separator, so 'john_doe' would make every filename-label
    parser downstream read 'doe' (the reference had this latent corruption;
    consciously fixed)."""
    speaker = sanitize_field(speaker)
    label = sanitize_field(label)
    return f"{speaker}_{label}_{unixtime}_{clip_id:04d}.npz"


def parse_filename_label(path: str) -> str:
    """Extract the label from a clip filename (inactive/dataset_eval.py:31-32)."""
    base = os.path.basename(path)
    parts = base.split("_")
    if len(parts) < 2:
        raise ValueError(f"cannot parse label from filename: {base}")
    return parts[1].lower()


@dataclasses.dataclass
class ClipBatch:
    """A padded, device-ready batch of clips.

    Shapes (all static under jit):
        X:       (B, T_max, D) float32  zero-padded features
        lengths: (B,)          int32    valid frame counts
        roi:     (B, T_max, H, W) uint8 zero-padded ROI (or None)
        y:       (B,)          int32    label ids (or None at pure inference)
    """

    X: np.ndarray
    lengths: np.ndarray
    roi: Optional[np.ndarray] = None
    y: Optional[np.ndarray] = None

    @property
    def batch_size(self) -> int:
        return int(self.X.shape[0])

    @property
    def max_t(self) -> int:
        return int(self.X.shape[1])


def pad_trim_time(X: np.ndarray, max_t: int) -> tuple[np.ndarray, int]:
    """Zero-pad or truncate along time to ``max_t``; returns (array, eff_len).

    Semantics match the reference pad/trim helpers
    (train_model_official.py:93-117) for both (T, D) features and
    (T, H, W) ROI stacks.
    """
    T = X.shape[0]
    if T >= max_t:
        return np.ascontiguousarray(X[:max_t]), max_t
    out = np.zeros((max_t,) + X.shape[1:], dtype=X.dtype)
    out[:T] = X
    return out, T


def fix_dim(X: np.ndarray, d_target: int) -> np.ndarray:
    """Pad/truncate the feature axis to ``d_target``.

    Legacy tolerance for mixed-generation datasets
    (inactive/dataset_eval.py:21-29, inactive/train_model_1130pm.py:41-48).
    """
    D = X.shape[1]
    if D == d_target:
        return X
    if D > d_target:
        return X[:, :d_target]
    pad = np.zeros((X.shape[0], d_target - D), dtype=X.dtype)
    return np.concatenate([X, pad], axis=1)


def batch_clips(
    clips: list[Clip],
    label_to_id: Optional[dict[str, int]],
    max_t: int,
    use_roi: bool,
    roi_hw: tuple[int, int] = (ROI_H, ROI_W),
) -> ClipBatch:
    """Pad/stack host clips into one ClipBatch.

    Clips missing ROI while ``use_roi`` get zero ROI frames, matching the
    reference collate (train_model_official.py:194-200) and the live zero-ROI
    substitution (live_infer_official.py:288-293).
    """
    B = len(clips)
    if B == 0:
        raise ValueError("empty batch")
    D = clips[0].D
    X = np.zeros((B, max_t, D), dtype=np.float32)
    lengths = np.zeros((B,), dtype=np.int32)
    roi = np.zeros((B, max_t) + roi_hw, dtype=np.uint8) if use_roi else None
    y = np.zeros((B,), dtype=np.int32) if label_to_id is not None else None
    for i, c in enumerate(clips):
        c = c.aligned() if use_roi else c
        Xi, Ti = pad_trim_time(c.X, max_t)
        X[i] = Xi
        lengths[i] = Ti
        if use_roi and c.roi is not None:
            Ri, _ = pad_trim_time(c.roi, max_t)
            roi[i] = Ri
        if y is not None:
            y[i] = label_to_id[c.label]
    return ClipBatch(X=X, lengths=lengths, roi=roi, y=y)
