"""Corpus loading into padded arrays (port of the JAX data/native_loader.py
``load_corpus_arrays``, its numpy path).

The JAX package inflates the npz entries in a native C++ loader, with this
numpy path as its fallback; the port loads through numpy only (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np

from ..core.schema import fix_dim


def load_corpus_arrays(files: list[str], max_t: int, x_dim: int,
                       use_roi: bool, roi_hw: tuple[int, int] = (48, 96)):
    """Returns (X (N, max_t, x_dim) f32, roi (N, max_t, H, W) u8 | None,
    lengths (N,) i32, has_roi (N,) bool).

    Per clip: X and the ROI are aligned conservatively (both cut to the
    shorter one), X's feature axis is padded or cut to ``x_dim``
    (``fix_dim``), then both are cut at ``max_t`` and zero-padded. A file
    that cannot be read, or whose arrays have the wrong shape, raises an
    error naming it."""
    N = len(files)
    H, W = roi_hw
    X = np.zeros((N, max_t, x_dim), np.float32)
    roi = np.zeros((N, max_t, H, W), np.uint8) if use_roi else None
    lengths = np.zeros(N, np.int32)
    has_roi = np.zeros(N, bool)
    for i, f in enumerate(files):
        try:
            with np.load(f, allow_pickle=False) as z:
                Xi = np.asarray(z["X"], np.float32)
                Ri = (np.asarray(z["roi"], np.uint8)
                      if use_roi and "roi" in z.files else None)
        except Exception as e:
            raise IOError(f"{f}: unreadable clip ({type(e).__name__}: {e})"
                          ) from e
        if Xi.ndim != 2:
            raise ValueError(f"{f}: X must be (T, D), got {Xi.shape}")
        if Ri is not None:
            if Ri.ndim != 3 or Ri.shape[1:] != (H, W):
                raise ValueError(f"{f}: roi shape {Ri.shape} != (T,{H},{W})")
            m = min(len(Xi), len(Ri))
            Xi, Ri = Xi[:m], Ri[:m]
        Xi = fix_dim(Xi, x_dim)
        T = min(len(Xi), max_t)
        X[i, :T] = Xi[:T]
        lengths[i] = T
        if Ri is not None:
            roi[i, :T] = Ri[:T]
            has_roi[i] = True
    return X, roi, lengths, has_roi
