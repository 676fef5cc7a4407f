"""The front probe's ladder (csrc/roi_front_probe.cu ``ring_kernel``;
ops/cuda_front_probe) on the CPU: numpy models of the pieces of its
persistent design that its plain version cannot show.

- The /255: the product by the rounded 1/255 and one FMA of its residual
  (``quotient``, in exact arithmetic) is bitwise ``b / 255.0f``, K1's
  IEEE division, for every byte; the product alone is not. So is
  front_std's division by the frame's std, on sampled frames.
- A thread's pixels, image stores, read-back and weights: the warps' byte
  walk (lane l of warp w: pixels 512 w + 32 k + l) covers every pixel
  once, its stores every interior value of the (50 x 98) image once and 32
  consecutive floats of one row a warp step (no two lanes in one bank),
  its read-back (the float4s tid + 288 j) every image value once, halo
  included; the moments a thread forms with its weights, summed over the
  threads, are the plain version's.
- The ring's frame walk (``frame_walk``, the kernel's launch and count)
  covers every frame once at ragged N, and the one geometry of every rung
  leaves room for three blocks an SM.
The kernel runs on the card only (tests/test_torch_cuda.py,
chip_smoke.py).
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from silent_speech_tpu_torch.ops import cuda_front_probe as fp

from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _round_f32(v: Fraction) -> np.float32:
    """v rounded to the nearest f32, ties to even."""
    c = np.float32(float(v))  # within an ulp: the neighbours decide
    cands = [np.nextafter(c, np.float32(-np.inf)), c,
             np.nextafter(c, np.float32(np.inf))]
    return min(cands, key=lambda f: (abs(Fraction(float(f)) - v),
                                     int(np.array(f).view(np.uint32)) & 1))


def quotient(a: np.float32, b: np.float32) -> np.float32:
    """The ladder's a / b in exact arithmetic: q = RN(a r), r = RN(1/b);
    the residual a - b q (exact in f32, so the FMA that forms it rounds
    nothing); then RN(q + r (a - b q)), one FMA. Each step rounds once to
    nearest f32, as the card's FMUL, FFMA and __frcp_rn do."""
    a, b = Fraction(float(a)), Fraction(float(b))
    r = Fraction(float(_round_f32(1 / b)))
    q = Fraction(float(_round_f32(a * r)))
    e = _round_f32(a - b * q)
    assert Fraction(float(e)) == a - b * q
    return _round_f32(Fraction(float(e)) * r + q)


def scaled_byte(b: int) -> np.float32:
    """The ladder's /255 of byte b (its u8 -> f32 conversion is exact)."""
    return quotient(np.float32(b), np.float32(255))


def thread_pixels(tid: int) -> np.ndarray:
    """Thread tid's pixels in the order it takes them."""
    return 512 * (tid // 32) + 32 * np.arange(16) + tid % 32


def image_index(p: np.ndarray) -> np.ndarray:
    """Pixel p's index in K1's (50 x 98) haloed image."""
    return (p // fp.W0 + 1) * fp.XP_W + p % fp.W0 + 1


def read_back(tid: int) -> np.ndarray:
    """The image values thread tid reads back: its float4s tid + 288 j."""
    e = tid + fp.THREADS * np.arange(-(-fp.XP_SIZE // (4 * fp.THREADS)))
    e = e[e < fp.XP_SIZE // 4]
    return (4 * e[:, None] + np.arange(4)).reshape(-1)


def test_scaled_byte_is_the_ieee_division_for_every_byte():
    b = np.arange(256, dtype=np.float32)
    want = b / np.float32(255)  # IEEE division, rounded to nearest
    got = np.array([scaled_byte(i) for i in range(256)], np.float32)
    assert got.view(np.uint32).tolist() == want.view(np.uint32).tolist()
    product = b * (np.float32(1) / np.float32(255))
    assert (product != want).sum() > 100  # the correction is needed


def test_std_quotient_is_the_ieee_division():
    """front_std's (v - mu) / sd by the same corrected product, r =
    RN(1/sd): bitwise the IEEE division on frames of every contrast, the
    clamped std (1e-6) of a near-constant frame included."""
    rng = np.random.default_rng(3)
    pairs = []
    for span in (1, 2, 5, 17, 64, 255):
        for _ in range(4):
            v = (rng.integers(0, span + 1, fp.FRAME_BYTES).astype(np.float32)
                 / np.float32(255))
            mu = np.float32(v.mean(dtype=np.float64))
            sd = np.float32(max(v.std(ddof=1, dtype=np.float64), 1e-6))
            pairs += [(d, sd) for d in (v[rng.integers(0, v.size, 60)] - mu)]
    pairs += [(np.float32(d), np.float32(1e-6))
              for d in rng.uniform(-1, 1, 40).astype(np.float32)]
    got = np.array([quotient(a, b) for a, b in pairs], np.float32)
    want = np.array([a / b for a, b in pairs], np.float32)
    assert got.view(np.uint32).tolist() == want.view(np.uint32).tolist()


def test_thread_maps_cover_the_frame_and_the_image():
    pix = np.stack([thread_pixels(t) for t in range(fp.THREADS)])
    assert np.array_equal(np.sort(pix.ravel()), np.arange(fp.FRAME_BYTES))
    at = image_index(pix)
    img = np.zeros((fp.H0 + 2, fp.XP_W), bool)
    img.ravel()[at.ravel()] = True
    assert img[1:-1, 1:-1].all() and img.sum() == fp.FRAME_BYTES
    # a warp's step k: 32 consecutive floats of one image row
    for w in range(fp.THREADS // 32):
        for k in range(16):
            s = at[32 * w:32 * w + 32, k]
            assert np.array_equal(s, s[0] + np.arange(32))
    reads = np.concatenate([read_back(t) for t in range(fp.THREADS)])
    assert np.array_equal(np.sort(reads), np.arange(fp.XP_SIZE))


@pytest.mark.parametrize("kind", ["pixel", "image"])
def test_thread_weights_are_each_index_modulo_31(kind):
    """The third moment as the kernel forms it: each thread's values (its
    pixels for widen; for front, its float4s of the image its warps
    stored) times the weights it computes once, (512 warp + 32 k + lane) %
    31 or (4 (tid + 288 j) + c) % 31, summed over the threads, against the
    plain version's index-weighted moment, with the other two."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (3 * 12, 384), dtype=np.uint8))
    frames = (x.numpy().reshape(3, -1).astype(np.float64)
              / np.float64(np.float32(255)))
    got = np.zeros((3, 3))
    for f, frame in enumerate(frames):
        img = np.zeros(fp.XP_SIZE)
        for t in range(fp.THREADS):
            warp, lane = divmod(t, 32)
            k = np.arange(16)
            p = thread_pixels(t)
            if kind == "pixel":
                v, wt = frame[p], (512 * warp + 32 * k + lane) % 31
            else:
                img[image_index(p)] = frame[p]
                continue
            got[f] += [v.sum(), (v * v).sum(), (wt * v).sum()]
        if kind == "image":
            for t in range(fp.THREADS):
                e = read_back(t).reshape(-1, 4)  # float4 tid + 288 j
                j, c = (e[:, 0] // 4 - t) // fp.THREADS, np.arange(4)
                wt = (4 * (t + fp.THREADS * j[:, None]) + c) % 31
                v = img[e]
                got[f] += [v.sum(), (v * v).sum(), (wt * v).sum()]
    stage = "widen" if kind == "pixel" else "front"
    want = fp.probe_plain(stage, x).double().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_frame_walk_covers_every_frame_once_and_the_ring_fits():
    """The ladder's launch at ragged N on waves of 1 to 3 blocks an SM:
    every frame once, in order within a block, every block a frame and the
    blocks at most a frame apart; the one geometry three blocks an SM in
    the card's 228 KB with their 1 KB reserved and static arrays."""
    for n in (1, 15, 16, 263, 264, 265, 272, 8192):
        for blocks in (1, 132, 264, 396):
            walk = fp.frame_walk(n, blocks)
            assert len(walk) == min(n, blocks)
            assert sorted(f for b in walk for f in b) == list(range(n))
            sizes = [len(b) for b in walk]
            assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    geo = fp.ring_geometry()
    assert geo.slots == fp.RING_SLOTS and geo.threads == fp.THREADS
    assert geo.smem == geo.slots * fp.FRAME_BYTES + 2 * 4 * fp.XP_SIZE
    assert geo.smem % 16 == 0 and geo.smem + 1024 <= 232448
    assert 3 * (geo.smem + 1024 + 1024) <= 233472 < 4 * geo.smem
