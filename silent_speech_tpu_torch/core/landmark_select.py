"""Dynamic landmark selection and smoothing utilities (copy of the JAX
package's core/landmark_select.py, which the port does not import).

The reference's recorder generations explored several selection schemes
beyond the fixed 88-point set:

- index-neighborhood expansion of seed sets
  (important_landmarks.py:75-87 ``expand_by_index_neighbors``);
- per-clip *dynamic* lower-face selection — all landmarks below the nose-base
  cutoff plus cheeks minus the nose set, locked on the first in-range frame
  (inactive/lower_face_record.py:66-85 ``compute_selected_indices``) — the
  source of variable feature dims across datasets;
- EMA stabilization of the ROI center/scale
  (inactive/record_landmarks_v2.py:70-73).
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from .landmarks import MESH_POINTS

# Nose landmarks excluded from lower-face selections — the exact 48-entry
# "fat" set shared by important_landmarks.py:17-31 and
# inactive/lower_face_record.py:23-34.
NOSE_SET = frozenset(
    [1, 2, 4, 5, 6, 19, 20,
     168, 197, 195, 193, 122, 196, 3,
     45, 44, 48, 49, 51, 52, 53,
     275, 274, 278, 279, 281, 282, 283,
     114, 115, 131, 134, 102,
     343, 344, 360, 363, 331,
     94, 97, 99, 100, 101,
     328, 326, 327, 294, 305]
)

# Cutoff anchors: the selection keeps landmarks below max-y of the
# nose-BOTTOM points plus a margin (important_landmarks.py:34-35,
# lower_face_record.py:36,48-49) — not a single nose-tip point.
NOSE_BOTTOM_FOR_CUTOFF = (2, 94, 97, 328, 326)
CUT_MARGIN = 0.003

# The dynamic-selection scripts' own cheek outline (lower_face_record.py:
# 38-40) — distinct from the official recorder's CHEEKS set.
LEFT_CHEEK = (234, 93, 132, 58, 172, 136, 150, 149, 176, 148, 152, 377)
RIGHT_CHEEK = (454, 323, 361, 288, 397, 365, 379, 378, 400, 377, 152, 148)
CHEEK_SET = frozenset(LEFT_CHEEK + RIGHT_CHEEK)


def expand_by_index_neighbors(idx_set: Iterable[int], k: int) -> set[int]:
    """Grow a set by +-1/+-2 *index* neighbors, k rounds.

    Index adjacency is a heuristic the reference used to thicken sparse
    selections (mesh indices are only loosely spatially ordered)."""
    out = set(idx_set)
    for _ in range(max(0, k)):
        more = set()
        for i in out:
            for j in (i - 1, i + 1, i - 2, i + 2):
                if 0 <= j < MESH_POINTS:
                    more.add(j)
        out |= more
    return out


def compute_selected_indices(
    landmarks_xy: np.ndarray,
    *,
    cutoff_idxs: Iterable[int] = NOSE_BOTTOM_FOR_CUTOFF,
    margin: float = CUT_MARGIN,
    cheeks: Iterable[int] = CHEEK_SET,
    exclude: Iterable[int] = NOSE_SET,
) -> np.ndarray:
    """Dynamic lower-face selection from one frame's normalized landmarks
    (lower_face_record.py:48-62 rule, exact): every mesh point whose y lies
    below max-y of the nose-bottom anchors plus CUT_MARGIN, or in the cheek
    set — minus the nose set. Returns sorted indices. The index set (and so
    the recorded feature dim) must match reference-recorded corpora
    point-for-point."""
    lm = np.asarray(landmarks_xy)
    cut_y = float(lm[list(cutoff_idxs), 1].max()) + margin
    below = set(np.where(lm[:, 1] > cut_y)[0].tolist())
    sel = (below | set(cheeks)) - set(exclude)
    return np.asarray(sorted(sel), dtype=np.int32)


class EMA:
    """Exponential moving average smoother (record_landmarks_v2.py:70-73):
    state = alpha * new + (1 - alpha) * state; first update passes through."""

    def __init__(self, alpha: float = 0.3):
        self.alpha = float(alpha)
        self.state: Optional[np.ndarray] = None

    def update(self, value) -> np.ndarray:
        v = np.asarray(value, dtype=np.float64)
        if self.state is None:
            self.state = v.copy()
        else:
            self.state = self.alpha * v + (1.0 - self.alpha) * self.state
        return self.state

    def reset(self):
        self.state = None


class Hysteresis:
    """Two-threshold open/close detector (important_landmarks.py:57-58,
    131-146): opens above ``high``, closes below ``low``."""

    def __init__(self, low: float, high: float, initial: bool = False):
        assert low <= high
        self.low, self.high = low, high
        self.open = initial

    def update(self, value: float) -> bool:
        if self.open and value < self.low:
            self.open = False
        elif not self.open and value > self.high:
            self.open = True
        return self.open
