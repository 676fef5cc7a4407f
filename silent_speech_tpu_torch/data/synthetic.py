"""Synthetic clip generation (port of the JAX data/synthetic.py; numpy
only, so the same seed writes the same arrays in both packages).

The reference's official checkpoint was stripped from the snapshot
(.MISSING_LARGE_BLOBS), so parity/benchmark corpora must be generated: each
word class gets a distinct deterministic temporal signature (per-class
frequency/phase patterns over the landmark coordinates plus a class-specific
openness envelope), strong enough for any of the model families to separate,
written in the exact `.npz` clip schema.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

from ..core.landmarks import FEATURE_DIM, N_POINTS, WORDS
from ..core.schema import Clip, clip_filename, save_clip


def synthetic_clip(
    rng: np.random.Generator,
    class_id: int,
    *,
    T: Optional[int] = None,
    feature_dim: int = FEATURE_DIM,
    with_roi: bool = True,
    roi_hw: tuple[int, int] = (48, 96),
    noise: float = 0.05,
) -> tuple[np.ndarray, Optional[np.ndarray]]:
    """One synthetic (X, roi) pair with a class-dependent signature."""
    if T is None:
        T = int(rng.integers(18, 48))
    t = np.linspace(0, 1, T, dtype=np.float32)[:, None]
    d = np.arange(feature_dim, dtype=np.float32)[None, :]
    freq = 1.0 + (class_id % 5)
    phase = 2.0 * np.pi * class_id / 10.0
    base = 0.1 * np.sin(2 * np.pi * freq * t + phase + 0.05 * d)
    base += 0.05 * np.cos(2 * np.pi * (class_id + 1) * t) * np.sin(0.02 * d)
    # a fixed per-class direction in feature space (deterministic), so every
    # model family can separate classes from a handful of examples
    class_rng = np.random.default_rng(1000 + class_id)
    class_dir = class_rng.standard_normal(feature_dim).astype(np.float32)
    base += 0.4 * np.sin(np.pi * t) * class_dir[None, :]
    X = (base + noise * rng.standard_normal((T, feature_dim))).astype(np.float32)
    # put plausible magnitudes in the scalar tail [vel, open_px, mouth_w_px, aspect]
    if feature_dim == FEATURE_DIM:
        X[:, -3] = 10.0 + 5.0 * np.abs(np.sin(2 * np.pi * freq * t[:, 0]))  # open px
        X[:, -2] = 90.0 + class_id  # mouth width px
        X[:, -1] = X[:, -3] / X[:, -2]
        X[1:, -4] = np.abs(X[1:, 0] - X[:-1, 0])
        X[0, -4] = 0.0
    roi = None
    if with_roi:
        H, W = roi_hw
        yy = np.linspace(-1, 1, H, dtype=np.float32)[:, None]
        xx = np.linspace(-1, 1, W, dtype=np.float32)[None, :]
        frames = []
        for ti in range(T):
            openness = 0.3 + 0.2 * np.sin(2 * np.pi * freq * ti / max(T - 1, 1) + phase)
            mouth = np.exp(-((yy / max(openness, 0.05)) ** 2) - (xx / 0.8) ** 2)
            img = 40 + 160 * mouth + 10 * rng.standard_normal((H, W))
            frames.append(np.clip(img, 0, 255).astype(np.uint8))
        roi = np.stack(frames)
    return X, roi


def generate_corpus(
    out_dir: str,
    *,
    clips_per_word: int = 12,
    words: list[str] = WORDS,
    seed: int = 42,
    with_roi: bool = True,
    feature_dim: int = FEATURE_DIM,
    speaker: str = "synth",
) -> list[str]:
    """Write a labeled synthetic corpus in the reference `.npz` layout."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    idxs = np.arange(N_POINTS, dtype=np.int32)
    paths = []
    now = int(time.time())
    clip_id = 0
    for wi, word in enumerate(words):
        for _ in range(clips_per_word):
            X, roi = synthetic_clip(rng, wi, with_roi=with_roi, feature_dim=feature_dim)
            clip = Clip(
                X=X,
                ts=(np.arange(len(X)) * 33).astype(np.int64),
                label=word,
                speaker=speaker,
                idxs=idxs,
                roi=roi,
            )
            fname = clip_filename(speaker, word, now, clip_id)
            paths.append(save_clip(clip, os.path.join(out_dir, fname)))
            clip_id += 1
    return paths
