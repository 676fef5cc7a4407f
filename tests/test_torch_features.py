"""The port's feature ops and landmark selection
(silent_speech_tpu_torch/ops/features.py, core/landmark_select.py)
against the JAX package's, on the CPU on the same seeded landmarks.

- The official 180-D features, batched (torch) and per frame (numpy),
  against the JAX functions and the sequential frame loop, at
  tests/test_features.py's bars (2e-4 abs / 1e-4 rel; centers and mouth
  widths 1e-2), the velocity's gate resets included.
- lip83 (batched and host, 1e-5), mouth83, span-norm and v3 (the
  official bars: they scale to pixels as it does) against their JAX
  functions; each host frame path bitwise the JAX package's.
- ``compute_selected_indices`` and ``expand_by_index_neighbors`` give JAX's
  sets; ``EMA`` and ``Hysteresis`` step for step.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from silent_speech_tpu.core import landmark_select as JS
from silent_speech_tpu.ops import features as JF
from silent_speech_tpu_torch.core import landmark_select as PS
from silent_speech_tpu_torch.core import landmarks as PL
from silent_speech_tpu_torch.ops import features as PF
from torch_threads import one_blas_thread  # noqa: F401 (autouse)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

W, H = 640, 480
# tests/test_features.py's bars: the families in pixels (the official, and
# mouth83, v3 and span-norm, which scale to pixels as it does), and lip83
# (normalized coordinates)
BAR_FEAT, REL_FEAT, BAR_PX, BAR_LIP83 = 2e-4, 1e-4, 1e-2, 1e-5


def _landmarks(rng, B, T):
    return (0.2 + 0.6 * rng.random((B, T, 468, 3))).astype(np.float32)


def test_landmark_constants_are_the_jax_packages():
    from silent_speech_tpu.core import landmarks as JL

    for name in ("LEFT_CORNER", "RIGHT_CORNER", "UPPER_INNER",
                 "LOWER_INNER", "LIP_ORDER", "MESH_POINTS", "FIXED_IDXS",
                 "FEATURE_DIM", "WORDS"):
        assert getattr(PL, name) == getattr(JL, name), name


def test_official_features_batched_and_frame_loop(rng):
    """Batched torch == batched JAX, and both == the sequential host loop
    of either package (vel[0] = 0, the velocity chained through
    prev_xy)."""
    B, T = 2, 9
    lms = _landmarks(rng, B, T)
    fj, cj, mj = (np.asarray(a) for a in
                  JF.extract_features_batched(jnp.asarray(lms), W, H))
    fp, cp, mp = (a.numpy() for a in
                  PF.extract_features_batched(torch.from_numpy(lms), W, H))
    assert fp.shape == (B, T, 180) and fp.dtype == np.float32
    np.testing.assert_allclose(fp, fj, atol=BAR_FEAT, rtol=REL_FEAT)
    np.testing.assert_allclose(cp, cj, atol=BAR_PX)
    np.testing.assert_allclose(mp, mj, atol=BAR_PX)
    for b in range(B):
        prev_p = prev_j = None
        for t in range(T):
            ref, prev_j, c_ref, mw_ref = JF.extract_features_frame(
                lms[b, t], W, H, prev_j)
            got, prev_p, c_got, mw_got = PF.extract_features_frame(
                lms[b, t], W, H, prev_p)
            np.testing.assert_array_equal(got, ref)  # the same numpy
            np.testing.assert_array_equal(c_got, c_ref)
            assert mw_got == mw_ref
            np.testing.assert_allclose(fp[b, t], ref, atol=BAR_FEAT,
                                       rtol=REL_FEAT)
            np.testing.assert_allclose(cp[b, t], c_ref, atol=BAR_PX)
            np.testing.assert_allclose(mp[b, t], mw_ref, atol=BAR_PX)


def test_velocity_resets_at_gate_breaks(rng):
    lms = _landmarks(rng, 1, 8)
    valid = np.array([[True, True, False, True, True, True, False, False]])
    fj = np.asarray(JF.extract_features_batched(
        jnp.asarray(lms), W, H, jnp.asarray(valid))[0])
    fp = PF.extract_features_batched(torch.from_numpy(lms), W, H,
                                     torch.from_numpy(valid))[0].numpy()
    np.testing.assert_allclose(fp, fj, atol=BAR_FEAT, rtol=REL_FEAT)
    vel = fp[0, :, 2 * 88]
    assert vel[0] == vel[2] == vel[3] == vel[6] == vel[7] == 0.0
    assert vel[4] > 0.0 and vel[5] > 0.0


def test_lip83_batched_and_host(rng):
    lms = _landmarks(rng, 2, 4)
    fj, oj = (np.asarray(a) for a in
              JF.lip83_features_batched(jnp.asarray(lms)))
    fp, op = (a.numpy() for a in
              PF.lip83_features_batched(torch.from_numpy(lms)))
    assert fp.shape == (2, 4, 83)
    np.testing.assert_allclose(fp, fj, atol=BAR_LIP83)
    np.testing.assert_allclose(op, oj, atol=BAR_LIP83)
    for b in range(2):
        for t in range(4):
            f, o = PF.lip83_features_frame_host(lms[b, t])
            fr, orr = JF.lip83_features_frame_host(lms[b, t])
            np.testing.assert_array_equal(f, fr)
            assert o == orr
            # tests/test_features.py's host-vs-batched bar
            np.testing.assert_allclose(f, fp[b, t], rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("family", ["mouth83", "v3", "span_dynamic"])
def test_legacy_families_against_jax(rng, family):
    B, T = 2, 6
    lms = _landmarks(rng, B, T)
    valid = rng.random((B, T)) > 0.2
    if family == "mouth83":
        fj = JF.mouth83_features_batched(jnp.asarray(lms), W, H,
                                         jnp.asarray(valid))
        fp = PF.mouth83_features_batched(torch.from_numpy(lms), W, H,
                                         torch.from_numpy(valid))
        dim = 83
    elif family == "v3":
        fj = JF.v3_features_batched(jnp.asarray(lms), W, H,
                                    jnp.asarray(valid))
        fp = PF.v3_features_batched(torch.from_numpy(lms), W, H,
                                    torch.from_numpy(valid))
        dim = 177
    else:
        idxs = PS.compute_selected_indices(lms[0, 0, :, :2])
        fj = JF.span_norm_features_batched(jnp.asarray(lms),
                                           jnp.asarray(idxs), W, H)
        fp = PF.span_norm_features_batched(torch.from_numpy(lms), idxs, W,
                                           H)
        dim = 2 * len(idxs) + 1
        prev_p = prev_j = None
        for t in range(T):  # the host frame path, both packages
            got, prev_p, _, _ = PF.span_norm_feature_frame(
                lms[0, t], W, H, idxs, prev_p)
            ref, prev_j, _, _ = JF.span_norm_feature_frame(
                lms[0, t], W, H, idxs, prev_j)
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_allclose(fp[0, t].numpy(), got,
                                       atol=BAR_FEAT, rtol=REL_FEAT)
    assert fp.shape == (B, T, dim)
    np.testing.assert_allclose(fp.numpy(), np.asarray(fj), atol=BAR_FEAT,
                               rtol=REL_FEAT)


def test_landmark_selection_sets_equal_jax(rng):
    for seed in ([1, 2, 3], [0], [460, 467], list(range(10, 40, 7))):
        for k in (0, 1, 3):
            assert PS.expand_by_index_neighbors(seed, k) == \
                JS.expand_by_index_neighbors(seed, k)
    for _ in range(4):
        lm = rng.random((468, 2)).astype(np.float32)
        np.testing.assert_array_equal(PS.compute_selected_indices(lm),
                                      JS.compute_selected_indices(lm))
    assert PS.NOSE_SET == JS.NOSE_SET and PS.CHEEK_SET == JS.CHEEK_SET


def test_ema_and_hysteresis_step_for_step(rng):
    ep, ej = PS.EMA(0.3), JS.EMA(0.3)
    for i in range(20):
        v = rng.random(3)
        np.testing.assert_array_equal(ep.update(v), ej.update(v))
        if i == 10:
            ep.reset()
            ej.reset()
    hp, hj = PS.Hysteresis(0.2, 0.5), JS.Hysteresis(0.2, 0.5)
    for v in rng.random(60):
        assert hp.update(float(v)) == hj.update(float(v))
