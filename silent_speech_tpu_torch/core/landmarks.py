"""The landmark constants of the clip format and of the live feature
families (copy of the JAX package's core/landmarks.py, which the port does
not import).

The index sets are part of the data contract with recorded `.npz` clips
(stored in each clip's ``idxs``), so they match the reference recorder
exactly (record_landmarks_official.py:30-44).
"""

from __future__ import annotations

# Mouth anchor points (reference: record_landmarks_official.py:24-25,
# live_infer_official.py:34-37).
LEFT_CORNER = 61
RIGHT_CORNER = 291
UPPER_INNER = 13
LOWER_INNER = 14

# The four regional sets whose union is the official 88-point selection
# (reference: record_landmarks_official.py:30-40).
MOUTH_LOWER = [
    61, 146, 91, 181, 84, 17, 314, 405, 321, 375, 291,
    308, 324, 318, 402, 317, 14, 87, 178, 88, 95,
]
MOUTH_UPPER = [
    185, 40, 39, 37, 0, 267, 269, 270, 409, 415, 310,
    311, 312, 13, 82, 81, 42, 183, 78,
]
CHIN_BOTTOM_ARC = [152, 377, 400, 378, 379, 394, 148, 176, 149, 150, 169]
CHEEKS = [
    214, 212, 57, 186, 202, 210, 204, 211, 194, 32,
    83, 201, 208, 18, 200, 199, 313, 421, 428, 396,
    406, 418, 262, 335, 424, 431, 273, 422, 430, 287,
    432, 434, 364, 410, 322, 436, 416,
]

# Official fixed selection: sorted, de-duplicated union — 88 points
# (reference: record_landmarks_official.py:43-44).
FIXED_IDXS = sorted(set(MOUTH_LOWER + MOUTH_UPPER + CHIN_BOTTOM_ARC + CHEEKS))
N_POINTS = len(FIXED_IDXS)
assert N_POINTS == 88, f"expected 88 fixed landmarks, got {N_POINTS}"

# Official per-frame feature dimensionality: 88 xy pairs + 4 speech scalars
# [vel, mouth_open_px, mouth_w_px, mouth_aspect]
# (reference: record_landmarks_official.py:96-99).
N_SCALARS = 4
FEATURE_DIM = 2 * N_POINTS + N_SCALARS  # 180

# The official 10-word vocabulary (reference: record_landmarks_official.py:137).
WORDS = ["yes", "no", "hello", "thanks", "please", "fahhh", "six", "seven", "lebron", "aura"]

# Ordered 40-point lip ring used by the streaming (83-D) feature family
# (reference: inactive/live_feed.py:16-23 — order matters there).
LIP_ORDER = MOUTH_UPPER + MOUTH_LOWER
assert len(LIP_ORDER) == 40

# Total points in the MediaPipe face mesh.
MESH_POINTS = 468
