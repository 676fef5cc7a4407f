"""The parity conv1 + pool1 kernel's tensor-core arithmetic, emulated on the
CPU (csrc/roi_parity.cu; ops/cuda_parity_cnn.py).

The kernel forms each frame's products patch x WE and patch x WO on wgmma
TF32: the patch holds the frame's uint8 values widened without scaling,
each exact in TF32, so 3xTF32's split of it has no lo part, and a k8 step
is patch x W_lo, then patch x W_hi; each 32-deep chunk of the 104 patch
lanes sums from zero and the chunks' sums are added in f32.
``tests/tc_emulation.step_product`` forms that order (its lo x hi term is
exactly zero here), each MMA rounded to f32 (the card truncates; the card
tests and chip_smoke.py hold the kernel itself). The emulation is held to
the kernel's bars against the plain version (ops/cuda_parity_cnn
``parity_halves_plain``) and against the JAX kernel (scripts/
proto_parity_cnn.py ``conv1pool1_parity``, interpret mode): packed weights
within 1e-4 (proto_parity_cnn.py:223), random unpacked weights (outputs in
the thousands) within 1e-6 of max|ref|. W_hi's pass alone misses the
random-weight bar. The kernel's addressing is mirrored in numpy: the
zero-haloed image in shared memory (rows of 104 bytes, the data at byte 4)
and each patch lane's byte offset give the plain version's patches, and
the warps' slices give every output once.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from silent_speech_tpu_torch.ops import cuda_parity_cnn as pc
from tc_emulation import split_tf32, step_product, tf32_rna
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 16
BAR_PACKED, BAR_REL = 1e-4, 1e-6  # chip_smoke.BAR_PARITY, BAR_PARITY_REL
IMG_S, CHUNK = 104, 32  # csrc/roi_parity.cu: image row bytes, chunk depth


def _problem():
    rng = np.random.default_rng(19)
    roi = rng.integers(0, 256, (N, 48, 96), dtype=np.uint8)
    roi[-2], roi[-1] = 0, 255
    packed = [w.numpy() for w in pc.pack_parity_conv1(
        rng.standard_normal((3, 3, 1, 8)).astype(np.float32) * 0.3,
        rng.standard_normal(8).astype(np.float32) * 0.1)]
    rand = [rng.standard_normal(s).astype(np.float32)
            for s in ((104, 128), (104, 128), (1, 384))]
    return roi, {"packed": packed, "random": rand}


ROI, WEIGHTS = _problem()
CLASSES = [torch.from_numpy(np.ascontiguousarray(ROI[:, c::4]))
           for c in range(4)]


def _emulated(kind: str, passes: int = 3):
    """The kernel's halves as the tensor cores form them (module doc)."""
    WE, WO, bias = (torch.from_numpy(w) for w in WEIGHTS[kind])
    patch = pc.parity_patches(CLASSES).reshape(-1, pc.KP)
    ys = [step_product(patch, W, passes, CHUNK).reshape(N, 48, 3, 128)
          for W in (WE, WO)]
    return pc.pool_halves(*ys, bias)


def _assert_within(got, want, kind):
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        err = np.abs(g - w).max()
        bar = BAR_PACKED if kind == "packed" else BAR_REL * np.abs(w).max()
        assert err <= bar, (kind, err, bar)


def test_every_uint8_is_exact_in_tf32():
    """The patch needs no lo plane: each of the 256 values is its own TF32
    rounding, bitwise, and its split's lo part is zero."""
    v = torch.arange(256, dtype=torch.float32)
    assert torch.equal(tf32_rna(v).view(torch.int32), v.view(torch.int32))
    hi, lo = split_tf32(v)
    assert torch.equal(hi, v) and not lo.any()


def test_image_offsets_form_the_patch():
    """The kernel's shared-memory image (50 rows of IMG_S bytes: a zero row
    above and below, bytes 4..99 the frame's row, zeros around) read at row
    2p (+ IMG_S for class cb), column 32 j + 3 and lane_offset(r) is the
    plain version's patch lane r of image row 2p (2p + 1), tile j."""
    img = np.zeros((N, 50, IMG_S), np.uint8)
    img[:, 1:49, 4:100] = ROI
    flat = img.reshape(N, -1)
    r = np.arange(102)
    dy = (r >= 34).astype(int) + (r >= 68)
    off = r + dy * (IMG_S - 34)  # lane_offset
    patch = pc.parity_patches(CLASSES).numpy()  # (N, 48, 3, 104)
    for j in range(3):
        for p in range(24):
            origin = 2 * p * IMG_S + 32 * j + 3
            for row, h in ((origin, 2 * p), (origin + IMG_S, 2 * p + 1)):
                np.testing.assert_array_equal(
                    flat[:, row + off].astype(np.float32),
                    patch[:, h, j, :102])
    assert not patch[..., 102:].any()


def test_slices_cover_every_output_once():
    """Tile tt of a group, warp wl: slice 4 tt + wl -> frame f = sl / 9,
    s = sl % 9, tile j = s / 3, pairs p = 8 (s % 3) + g, g < 8 (k = p / 2,
    m-parity p % 2); the kernel's three warpgroups (WGS = 3: warpgroup wg
    takes tiles wg, wg + 3, ...) take six tiles each and give each
    (frame, k, parity, j) of the group's 8 frames once."""
    wgs, tiles = 3, 8 * 9 // 4
    seen = []
    for wg in range(wgs):
        mine = list(range(wg, tiles, wgs))
        assert len(mine) == tiles // wgs == 6
        for tt in mine:
            for wl in range(4):
                sl = 4 * tt + wl
                f, s = divmod(sl, 9)
                for g in range(8):
                    p = 8 * (s % 3) + g
                    seen.append((f, p // 2, p % 2, s // 3))
    assert len(seen) == len(set(seen)) == 8 * 12 * 2 * 3


@pytest.mark.parametrize("kind", ["packed", "random"])
def test_emulated_kernel_matches_plain(kind):
    want = pc.parity_halves_plain(
        CLASSES, *(torch.from_numpy(w) for w in WEIGHTS[kind]))
    _assert_within(_emulated(kind), want, kind)


@pytest.fixture(scope="module")
def jax_pp():
    spec = importlib.util.spec_from_file_location(
        "_jax_proto_parity_cnn",
        os.path.join(REPO, "scripts", "proto_parity_cnn.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kind", ["packed", "random"])
def test_emulated_kernel_matches_jax(jax_pp, kind):
    want = jax_pp.conv1pool1_parity(
        *(jnp.asarray(c.numpy()) for c in CLASSES),
        *map(jnp.asarray, WEIGHTS[kind]), interpret=True)
    _assert_within(_emulated(kind), [np.asarray(q) for q in want], kind)


def test_one_hi_pass_misses_the_random_weight_bar():
    """W_hi's pass alone (W rounded to TF32) is another function: the bar
    that holds the two passes refuses it."""
    want = pc.parity_halves_plain(
        CLASSES, *(torch.from_numpy(w) for w in WEIGHTS["random"]))
    got = _emulated("random", passes=1)
    scale = max(w.abs().max().item() for w in want)
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    assert err > 10 * BAR_REL * scale, err / scale


def test_two_passes_are_the_3xtf32_order():
    """With the patch exact, step_product's 3xTF32 order (lo x hi, hi x lo,
    hi x hi a k8 step) is the kernel's two passes (patch x W_lo, then
    patch x W_hi), bitwise: the first term is an exact zero."""
    WE = torch.from_numpy(WEIGHTS["random"][0])
    patch = pc.parity_patches(CLASSES).reshape(-1, pc.KP)[:512]
    hi, lo = split_tf32(WE)
    want = torch.zeros((patch.shape[0], 128))
    for c0 in range(0, pc.KP, CHUNK):
        d = torch.zeros_like(want)
        for k in range(c0, min(c0 + CHUNK, pc.KP), 8):
            for w in (lo, hi):
                d = (d.double() + patch[:, k:k + 8].double()
                     @ w[k:k + 8].double()).float()
        want = want + d
    assert torch.equal(step_product(patch, WE, 3, CHUNK), want)
