"""The port's ROI ops (silent_speech_tpu_torch/ops/roi.py) against the JAX
package's ops/roi.py, on the CPU on the same seeded frames.

- The resize matrices within 1e-6 of JAX's, area and linear, for scalar
  and batched crop bounds.
- The host crop (numpy, the capture loop's path) bitwise the JAX host
  crop, degenerate boxes (None) included.
- The batched torch crop bitwise the port's host crop (numpy, which is
  the JAX host crop), and against JAX's batched crop bitwise except where
  the value lies within NEAR_JAX of a rounding boundary (k + 0.5): there
  the two may round apart, by one level. JAX's batched crop on the CPU
  lies up to 3.2e-3 from the float64 crop before its rounding (its CPU
  dot is not a full f32 sum), where the port's lies within 1e-5, so it is
  not bitwise its own host crop either.
- Degenerate boxes give ok False and a zero ROI in both packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from silent_speech_tpu.ops import roi as JR
from silent_speech_tpu_torch.ops import roi as PR
from torch_threads import one_blas_thread  # noqa: F401 (autouse)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# the band around k + 0.5 where JAX's batched crop may round apart from
# the port's: its CPU dot's error before the rounding, measured up to
# 3.2e-3 on these frames, with room
NEAR_JAX = 1e-2
BAR_MATRIX = 1e-6


def _frames(rng, B, T, H=480, W=640):
    frames = rng.integers(0, 256, (B, T, H, W, 3), np.uint8)
    centers = np.stack([rng.uniform(0, W, (B, T)), rng.uniform(0, H, (B, T))],
                       -1).astype(np.float32)
    centers[0, 0] = (W / 2, H / 2)
    scales = rng.uniform(40.0, 120.0, (B, T)).astype(np.float32)
    scales[-1, -1] = 0.5  # degenerate
    centers[-1, 0] = (3.0, 3.0)  # clipped to a sliver
    return frames, centers, scales


def _near(values: np.ndarray) -> np.ndarray:
    return np.abs(values - np.floor(values) - 0.5) < NEAR_JAX


@pytest.mark.parametrize("mode", ["area", "linear"])
def test_resize_matrices_match_jax(mode):
    for a, b, out, n in [(0, 200, 50, 200), (13, 187, 96, 200),
                         (5, 101, 48, 120), (300, 432, 96, 640)]:
        mj = np.asarray(JR.make_resize_matrix(out, jnp.int32(a), jnp.int32(b),
                                              n, mode))
        mp = PR.make_resize_matrix(out, a, b, n, mode).numpy()
        np.testing.assert_allclose(mp, mj, atol=BAR_MATRIX)
        np.testing.assert_allclose(mp.sum(1), 1.0, atol=1e-5)
    # batched bounds: one matrix per box
    a, b = np.array([[0, 13], [5, 300]]), np.array([[200, 187], [101, 432]])
    Wb = PR.make_resize_matrix(48, torch.from_numpy(a), torch.from_numpy(b),
                               480, mode)
    assert Wb.shape == (2, 2, 48, 480)
    for i in range(2):
        for j in range(2):
            mj = np.asarray(JR.make_resize_matrix(
                48, jnp.int32(a[i, j]), jnp.int32(b[i, j]), 480, mode))
            np.testing.assert_allclose(Wb[i, j].numpy(), mj, atol=BAR_MATRIX)


@pytest.mark.parametrize("layout", ["bgr", "rgb"])
def test_host_crop_bitwise_jax_host_crop(rng, layout):
    frame = rng.integers(0, 256, (480, 640, 3), np.uint8)
    for center, scale, mode in [((320.0, 240.0), 55.0, "area"),
                                ((320.0, 240.0), 90.0, "linear"),
                                ((10.0, 10.0), 40.0, "area"),
                                ((630.0, 5.0), 30.0, "linear"),
                                ((160.0, 120.0), 0.5, "area")]:
        for min_side in (0, 2):
            got = PR.crop_resize_gray_frame_host(
                frame, center, scale, mode=mode, input_layout=layout,
                min_side=min_side)
            want = JR.crop_resize_gray_frame_host(
                frame, center, scale, mode=mode, input_layout=layout,
                min_side=min_side)
            if want is None:
                assert got is None
                continue
            assert got.dtype == np.uint8 and got.shape == (48, 96)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode,layout", [("area", "rgb"), ("area", "bgr"),
                                         ("linear", "bgr")])
def test_batched_crop_against_host_and_jax(rng, mode, layout):
    frames, centers, scales = _frames(rng, 2, 3)
    kw = dict(mode=mode, input_layout=layout)
    rp, okp = PR.crop_resize_gray_batched(torch.from_numpy(frames),
                                          torch.from_numpy(centers),
                                          torch.from_numpy(scales), **kw)
    vals = PR.crop_resize_gray_values(torch.from_numpy(frames),
                                      torch.from_numpy(centers),
                                      torch.from_numpy(scales), **kw)[0]
    rj, okj = JR.crop_resize_gray_batched(jnp.asarray(frames),
                                          jnp.asarray(centers),
                                          jnp.asarray(scales), **kw)
    rp, okp, vals = rp.numpy(), okp.numpy(), vals.numpy()
    rj, okj = np.asarray(rj), np.asarray(okj)
    assert rp.shape == (2, 3, 48, 96) and rp.dtype == np.uint8
    np.testing.assert_array_equal(okp, okj)
    assert not okp[-1, -1] and okp[0, 0]
    near = _near(vals)
    for b in range(2):
        for t in range(3):
            host = PR.crop_resize_gray_frame_host(
                frames[b, t], centers[b, t], scales[b, t], **kw)
            if not okp[b, t]:
                assert host is None and rp[b, t].max() == 0 == rj[b, t].max()
                continue
            np.testing.assert_array_equal(rp[b, t], host)
            apart = rp[b, t] != rj[b, t]
            assert np.all(near[b, t][apart]), "JAX differs off a boundary"
            assert np.abs(rp[b, t].astype(int) - rj[b, t]).max() <= 1


def test_area_crop_against_the_area_average(rng):
    """The batched area crop within one level of the float64 fractional
    area average (tests/test_roi.py's independent reference)."""
    frames, _, _ = _frames(rng, 1, 1, H=240, W=320)
    roi, ok = PR.crop_resize_gray_batched(
        torch.from_numpy(frames), torch.tensor([[[160.0, 120.0]]]),
        torch.tensor([[80.0]]), mode="area", input_layout="bgr")
    assert bool(ok.all())
    f = frames[0, 0].astype(np.float64)
    gray = 0.114 * f[..., 0] + 0.587 * f[..., 1] + 0.299 * f[..., 2]
    x1, x2, y1, y2 = 64, 256, 40, 200
    Wy = PR._make_resize_matrix_np(48, y1, y2, 240, "area").astype(np.float64)
    Wx = PR._make_resize_matrix_np(96, x1, x2, 320, "area").astype(np.float64)
    ref = Wy @ gray @ Wx.T
    assert np.abs(roi[0, 0].numpy().astype(np.float64) - ref).max() <= 1.0
