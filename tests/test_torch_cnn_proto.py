"""The CNN-front prototypes of the port (silent_speech_tpu_torch.scripts.
proto_parity_cnn, proto_parity_e2e, proto_ablate, probe_front;
ops/cuda_parity_cnn.py, ops/cuda_front_probe.py and K1's debug stops in
ops/cuda_cnn.py) against the JAX scripts' functions (scripts/
proto_parity_cnn.py, proto_parity_e2e.py, loaded from their files and run
in Pallas interpret mode) and the JAX K1's front (ops/pallas_cnn2.py
``_front_widen``, ``_front_classes``).

On the CPU the port's wrappers run their plain versions; the CUDA kernels
are held against those on the card (tests/test_torch_cuda.py,
chip_smoke.py). Inputs are numpy draws from a seed at N=32 frames (two
grid steps of 16). Bars: the JAX scripts' f32 bar 1e-4 with packed weights
(proto_parity_cnn.py:223, proto_parity_e2e.py:165); with random unpacked
weights (proto_ablate's draws, outputs in the thousands) max|err| /
max|ref| <= 1e-6; bf16 2e-2 (proto_parity_e2e.py:165); the front's slices
bitwise, its standardized values within 1e-5 (values of |x| < 2, f32 sums
of 4,608 terms in two orders, one pass against two).
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from silent_speech_tpu.models import bigru as jax_bigru
from silent_speech_tpu.ops import pallas_cnn2
from silent_speech_tpu_torch.models.bigru import BiGRUClassifier, BiGRUConfig
from silent_speech_tpu_torch.ops import cuda_cnn
from silent_speech_tpu_torch.ops import cuda_front_probe as fp
from silent_speech_tpu_torch.ops import cuda_parity_cnn as pc
from silent_speech_tpu_torch.scripts import (probe_front, proto_ablate,
                                             proto_parity_cnn,
                                             proto_parity_e2e)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 32
ATOL, REL_RANDOM, TOL_BF16, TOL_STD = 1e-4, 1e-6, 2e-2, 1e-5
SCRIPTS = {"proto_parity_cnn": proto_parity_cnn,
           "proto_parity_e2e": proto_parity_e2e,
           "proto_ablate": proto_ablate, "probe_front": probe_front}


def _load_jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_pp():
    return _load_jax_script("proto_parity_cnn")


@pytest.fixture(scope="module")
def jax_pe():
    return _load_jax_script("proto_parity_e2e")


def _problem():
    """The scripts' draws at N=32: frames, conv1's k and b; random unpacked
    WE, WO, bias as proto_ablate draws them."""
    rng = np.random.default_rng(0)
    roi = rng.integers(0, 256, (N, 48, 96), dtype=np.uint8)
    k = rng.standard_normal((3, 3, 1, 8)).astype(np.float32) * 0.3
    b = rng.standard_normal(8).astype(np.float32) * 0.1
    rand = (rng.standard_normal((104, 128)).astype(np.float32),
            rng.standard_normal((104, 128)).astype(np.float32),
            rng.standard_normal((1, 384)).astype(np.float32))
    return roi, k, b, rand


ROI, K, B, RANDOM_W = _problem()
CLASSES = [np.ascontiguousarray(ROI[:, c::4]) for c in range(4)]


def _weights(kind):
    if kind == "packed":
        return [w.numpy() for w in pc.pack_parity_conv1(K, B)]
    return list(RANDOM_W)


@pytest.fixture(scope="module")
def jax_halves(jax_pp):
    """The JAX kernel's two halves in interpret mode, per weight kind."""
    out = {}
    for kind in ("packed", "random"):
        qs = jax_pp.conv1pool1_parity(
            *map(jnp.asarray, CLASSES), *map(jnp.asarray, _weights(kind)),
            interpret=True)
        out[kind] = [np.asarray(q) for q in qs]
    return out


def _port_halves(kind):
    return pc.conv1pool1_parity(
        *map(torch.from_numpy, CLASSES),
        *(torch.from_numpy(w) for w in _weights(kind)))


# ------------------------------------------------------------- packing


@pytest.mark.parametrize("script", ["proto_parity_cnn", "proto_parity_e2e"])
def test_pack_parity_conv1_is_bitwise_the_jax_packing(script):
    mod = _load_jax_script(script)
    rng = np.random.default_rng(1)
    for scale in (1.0 / 255.0, 1.0):
        k = rng.standard_normal((3, 3, 1, 8)).astype(np.float32)
        b = rng.standard_normal(8).astype(np.float32)
        for got, want in zip(pc.pack_parity_conv1(k, b, scale),
                             mod.pack_parity_conv1(k, b, scale)):
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------- the kernel's plain version


def test_conv1pool1_parity_matches_jax_packed(jax_halves):
    for got, want in zip(_port_halves("packed"), jax_halves["packed"]):
        assert got.shape == (N * 12, 384)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_pooled1_matches_the_jax_reference(jax_pp, jax_halves):
    """Through pooled1_from_quadrants, against the script's XLA reference
    and the port's plain conv1 + pool1."""
    got = pc.pooled1_from_quadrants(_port_halves("packed"), N)
    jax_q = np.asarray(jax_pp.pooled1_from_quadrants(
        [jnp.asarray(q) for q in jax_halves["packed"]], N))
    want = np.asarray(jax_pp.ref_conv1pool1(
        jnp.asarray(ROI), jnp.asarray(K), jnp.asarray(B)))
    assert got.shape == (N, 24, 48, 8)
    np.testing.assert_allclose(got.numpy(), jax_q, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    ref = pc.ref_conv1pool1(torch.from_numpy(ROI), torch.from_numpy(K),
                            torch.from_numpy(B))
    np.testing.assert_allclose(ref.numpy(), want, atol=ATOL, rtol=0)


def test_conv1pool1_parity_matches_jax_with_random_weights(jax_halves):
    """proto_ablate feeds unpacked weights: the function of all 104 rows."""
    for got, want in zip(_port_halves("random"), jax_halves["random"]):
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= REL_RANDOM, err


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_conv1pool1_one_array_matches_jax(jax_pe, out_dtype):
    xs = [c.reshape(N * 12, 96) for c in CLASSES]
    w = _weights("packed")
    want = jax_pe.conv1pool1(*map(jnp.asarray, xs), *map(jnp.asarray, w),
                             interpret=True,
                             out_dtype=getattr(jnp, out_dtype))
    got = pc.conv1pool1(*map(torch.from_numpy, xs),
                        *map(torch.from_numpy, w),
                        out_dtype=getattr(torch, out_dtype))
    assert got.shape == (N, 24, 48, 8) and got.dtype == getattr(torch,
                                                                out_dtype)
    bar = ATOL if out_dtype == "float32" else TOL_BF16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=bar, rtol=0)


@pytest.mark.parametrize("dtype,bar", [("float32", ATOL),
                                       ("bfloat16", TOL_BF16)])
def test_roi_cnn_parity_matches_jax(jax_pe, dtype, bar):
    """The whole CNN, the same JAX parameters carried across by the port's
    converter."""
    cfg_j = jax_bigru.BiGRUConfig(x_dim=180, num_classes=10, use_roi=True)
    params = jax_bigru.init_params(jax.random.PRNGKey(0), cfg_j)
    cnn_j = params["roi_cnn"]
    model = BiGRUClassifier.from_jax_params(
        jax.tree.map(np.asarray, params),
        BiGRUConfig(x_dim=180, num_classes=10, use_roi=True))
    cnn_t = model.params_tree()["roi_cnn"]
    w = [jnp.asarray(a) for a in jax_pe.pack_parity_conv1(
        np.asarray(cnn_j["conv0"]["w"]), np.asarray(cnn_j["conv0"]["b"]))]
    want = np.asarray(jax_pe.roi_cnn_parity(
        cnn_j, jnp.asarray(ROI), *w, interpret=True,
        compute_dtype=getattr(jnp, dtype)))
    wt = pc.pack_parity_conv1(cnn_t["conv0"]["w"].detach(),
                              cnn_t["conv0"]["b"].detach())
    with torch.no_grad():
        got = pc.roi_cnn_parity(cnn_t, torch.from_numpy(ROI), *wt,
                                compute_dtype=getattr(torch, dtype))
    assert got.shape == want.shape == (N, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=bar, rtol=0)
    if dtype == "float32":  # and the port's K1 plain version
        np.testing.assert_allclose(
            got.numpy(), cuda_cnn.roi_cnn_plain(torch.from_numpy(ROI),
                                                cnn_t).detach().numpy(),
            atol=ATOL, rtol=0)


def test_ablation_full_is_the_parity_kernel_bitwise():
    xs = [torch.from_numpy(c.reshape(N * 12, 96)) for c in CLASSES]
    w = [torch.from_numpy(a) for a in RANDOM_W]
    full = pc.run(*xs, *w, mode="full")
    pp = pc.conv1pool1_parity(*[x.reshape(N, 12, 96) for x in xs], *w)
    for a, b in zip(full, pp):
        assert torch.equal(a, b)


# --------------------------------------------------- the front (K1's)


@pytest.mark.parametrize("front", ["u8", "f32", "bf16"])
def test_front_widen_is_bitwise_the_jax_front(front):
    x = ROI.reshape(N * 12, 384)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    if front != "u8":
        xj = xj.astype(getattr(jnp, {"f32": "float32",
                                     "bf16": "bfloat16"}[front]))
        xt = xt.to({"f32": torch.float32, "bf16": torch.bfloat16}[front])
    want = np.asarray(pallas_cnn2._front_widen(xj, front))
    got = fp.front_widen(xt, front)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("standardize", [False, True])
def test_front_classes_matches_the_jax_front(standardize):
    F = 8
    x = ROI[:F].reshape(F * 12, 384)
    xw = pallas_cnn2._front_widen(jnp.asarray(x), "u8")
    want = pallas_cnn2._front_classes(xw, standardize, F)
    got = fp.front_classes(fp.front_widen(torch.from_numpy(x)), standardize,
                           F)
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.shape == (F * 12, 96)
        if standardize:
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=TOL_STD, rtol=0)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("value", [0, 255])
def test_front_classes_on_a_constant_frame_gives_exact_zeros(value):
    """Two passes: the mean of equal values is exact, so x - mu is 0 and
    the frame standardizes to exact zeros, as in float64."""
    x = np.full((2 * 12, 384), value, np.uint8)
    x[12:] = ROI[0].reshape(12, 384)  # a random frame beside it
    got = torch.cat(fp.front_classes(fp.front_widen(torch.from_numpy(x)),
                                     True, 2), dim=1)
    x64 = torch.from_numpy(x).double().reshape(2, -1) / 255.0
    mu = x64.mean(dim=1, keepdim=True)
    sd = torch.clamp((x64 - mu).std(dim=1, keepdim=True), min=1e-6)
    want = ((x64 - mu) / sd).reshape(24, 384)
    assert torch.equal(got[:12], torch.zeros(12, 384))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL_STD,
                               rtol=0)


def _moments64(v):
    """(rows, K) float64 -> the sum, the sum of squares and the
    index-weighted sum ((i % 31) v_i) of each row."""
    w = np.arange(v.shape[1]) % 31
    return np.stack([v.sum(1), (v * v).sum(1), (v * w).sum(1)], axis=1)


def _assert_moments(got, vals, extra=None):
    """f32 moments against float64 ones of the values *vals*: within 1e-6
    of each moment's sum of absolute terms (the standardized sums are about
    0, far below their terms)."""
    want = _moments64(vals)
    if extra is not None:
        extra(want)
    bar = 1e-6 * _moments64(np.abs(vals))
    if extra is not None:
        extra(bar)
    err = np.abs(np.asarray(got, np.float64) - want)
    assert (err <= bar).all(), (err / bar).max(axis=0)


def _std64(frames):
    mu = frames.mean(axis=1, keepdims=True)
    sd = np.maximum((frames - mu).std(axis=1, ddof=1, keepdims=True), 1e-6)
    return (frames - mu) / sd


def _haloed64(img):
    return np.pad(img.reshape(-1, 48, 96), ((0, 0), (1, 1), (1, 1))
                  ).reshape(img.shape[0], -1)


@pytest.mark.parametrize("stage", list(fp.STAGES))
def test_probe_stage_values_on_the_cpu(stage):
    """Each stage's per-block values, from the plain versions, against a
    direct float64 computation: the integer sums of dma and overlap_b, the
    moments of the pixels (widen) or of the haloed image (the rest)."""
    x = torch.from_numpy(ROI.reshape(N * 12, 384))
    if stage == "overlap_b":
        x = torch.from_numpy(ROI[:, 0, :4].copy())
    got = fp.probe(stage, x).double().numpy()
    frames = ROI.reshape(N, -1).astype(np.float64) / 255.0
    if stage in fp.SCALAR:
        want = (ROI.reshape(N, -1).view(np.uint32).astype(np.uint64)
                .sum(axis=1) % 2 ** 32).astype(np.uint32).view(np.int32) \
            if stage in ("dma", "dma_ring") else \
            576.0 * ROI[:, 0, :4].astype(np.float64).sum(axis=1) + 288 * 28
        assert got.shape == (N,)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-3)
        return
    vals = frames if stage == "widen" else _haloed64(
        _std64(frames) if stage == "front_std" else frames)

    def chains(m):  # overlap_a: the chains' sum, the image's, added
        m[:, 0] *= 2
    assert got.shape == (N, 3)
    _assert_moments(got, vals, chains if stage == "overlap_a" else None)


@pytest.mark.parametrize("fault", ["ddof0", "no_division", "shift_right",
                                   "shift_down", "into_halo"])
def test_probe_front_std_bar_sees_a_faulty_image(fault):
    """The front_std moments, held at fp.bar, fail an image with the wrong
    scale (ddof=0, no division by sd) or a store one place off, in every
    block: the sum of a standardized image is about 0 whatever its scale,
    the squares and the index weights are not."""
    x = torch.from_numpy(ROI.reshape(N * 12, 384))
    frames = ROI.reshape(N, -1).astype(np.float64) / 255.0
    mu = frames.mean(axis=1, keepdims=True)
    img = _haloed64(_std64(frames)).reshape(N, 50, 98)
    if fault == "ddof0":
        img = _haloed64((frames - mu) / (frames - mu).std(
            axis=1, keepdims=True)).reshape(N, 50, 98)
    elif fault == "no_division":
        img = _haloed64(frames - mu).reshape(N, 50, 98)
    elif fault == "shift_right":
        img = np.roll(img, 1, axis=2)
    elif fault == "shift_down":
        img = np.roll(img, 1, axis=1)
    else:  # the interior written one row and one column up-left
        img = np.roll(img, (-1, -1), axis=(1, 2))
    bad = _moments64(img.reshape(N, -1))
    good = fp.probe_plain("front_std", x).double().numpy()
    bar = fp.bar("front_std", x).double().numpy()
    assert (np.abs(bad - good) > bar).any(axis=1).all()
    assert (np.abs(_moments64(_haloed64(_std64(frames))) - good)
            <= bar).all()


@pytest.mark.parametrize("fault", ["scale", "shift"])
def test_debug_stop_bar_sees_a_faulty_norm_image(fault):
    """K1's stop=norm moments, standardized, held at their bar (1e-5 of the
    moments of |values|), fail a frame scaled 1% off or its image stored
    one column off, where the frame's sum alone (about 0) could not."""
    roi = torch.from_numpy(ROI[:4])
    p = _cnn()
    good = cuda_cnn.roi_cnn_debug_plain(roi, p, True, "norm").double()
    bar = 1e-5 * cuda_cnn.roi_cnn_debug_plain(roi, p, True, "norm",
                                              absolute=True).double()
    img = cuda_cnn.preprocess_roi(roi, True, torch.float32)
    img = torch.nn.functional.pad(img, (1, 1, 1, 1))
    img = img * 1.01 if fault == "scale" else torch.roll(img, 1, dims=2)
    bad = cuda_cnn.stage_moments(img.flatten(1)).double()
    assert ((bad[:, :3] - good[:, :3]).abs() > bar[:, :3]).any(dim=1).all()
    assert ((bad[:, 0] - good[:, 0]).abs() <= 1e-2).all()  # the sum is blind


def test_probe_dma_frames_a_block_sums_the_block():
    x = torch.from_numpy(ROI.reshape(N * 12, 384))
    one = fp.probe("dma", x)
    for F in (2, 4):
        blk = fp.probe("dma", x, F)
        assert blk.shape == (N // F,) and blk.dtype == torch.int32
        wide = one.to(torch.int64).reshape(-1, F).sum(dim=1) & 0xFFFFFFFF
        assert torch.equal(blk.to(torch.int64) & 0xFFFFFFFF, wide)


# ---------------------------------------------------- what raises


@pytest.mark.parametrize("wrapper", ["conv1pool1_parity", "conv1pool1",
                                     "run"])
def test_n_not_a_multiple_of_16_raises(wrapper):
    """The TPU grid would leave the last N % 16 frames unwritten."""
    n = 24
    xs = [torch.zeros((n, 12, 96), dtype=torch.uint8) for _ in range(4)]
    if wrapper != "conv1pool1_parity":
        xs = [x.reshape(n * 12, 96) for x in xs]
    w = [torch.from_numpy(a) for a in RANDOM_W]
    with pytest.raises(ValueError, match="multiple of 16"):
        getattr(pc, wrapper)(*xs, *w)
    with pytest.raises(ValueError, match="multiple of 16"):
        pc.roi_cnn_parity({}, torch.zeros((n, 48, 96), dtype=torch.uint8),
                          *w, group=8)


@pytest.mark.parametrize("mode", ["halo_aligned", "no_patch",
                                  "patch_aligned", "dma", "bogus"])
def test_ablation_modes_without_a_counterpart_raise(mode):
    xs = [torch.zeros((16 * 12, 96), dtype=torch.uint8) for _ in range(4)]
    w = [torch.from_numpy(a) for a in RANDOM_W]
    with pytest.raises(ValueError, match="counterpart" if mode in
                       pc.NO_COUNTERPART else "unknown mode"):
        pc.run(*xs, *w, mode=mode)


@pytest.mark.parametrize("mode", ["io_only", "widen_only", "halo_only",
                                  "no_dot"])
def test_ablation_stops_need_the_kernel(mode):
    xs = [torch.zeros((16 * 12, 96), dtype=torch.uint8) for _ in range(4)]
    w = [torch.from_numpy(a) for a in RANDOM_W]
    with pytest.raises(ValueError, match="stop of the CUDA kernel"):
        pc.run(*xs, *w, mode=mode)
    with pytest.raises(ValueError, match="CUDA tensor"):
        pc.run(*xs, *w, mode=mode, impl="kernel")


def test_roi_cnn_parity_group_must_divide_n():
    w = [torch.from_numpy(a) for a in RANDOM_W]
    with pytest.raises(ValueError, match="group"):
        pc.roi_cnn_parity({}, torch.zeros((32, 48, 96), dtype=torch.uint8),
                          *w, group=24)


@pytest.mark.parametrize("stage,F", [("bogus", 1), ("widen", 2),
                                     ("dma", 3), ("front", 4)])
def test_probe_refuses_unknown_stages_and_frames(stage, F):
    x = torch.zeros((16 * 12, 384), dtype=torch.uint8)
    with pytest.raises(ValueError):
        fp.probe(stage, x, F)


def _cnn(emb=32):
    g = torch.Generator().manual_seed(0)
    from silent_speech_tpu_torch.models.bigru import init_roi_cnn
    return init_roi_cnn(emb, g)


@pytest.mark.parametrize("stop", list(cuda_cnn.DEBUG_STOPS))
def test_debug_stop_raises_without_the_kernel(stop):
    roi = torch.zeros((2, 48, 96), dtype=torch.uint8)
    p = _cnn()
    for impl in ("plain", "auto"):
        with pytest.raises(ValueError, match="stop of the CUDA kernel"):
            cuda_cnn.roi_cnn_fused(roi, p, impl=impl, debug_stop=stop)
    with pytest.raises(ValueError, match="no backward"):
        cuda_cnn.roi_cnn_fused_train(roi, p, debug_stop=stop)


def test_unknown_debug_stop_raises():
    roi = torch.zeros((2, 48, 96), dtype=torch.uint8)
    with pytest.raises(ValueError, match="unknown debug_stop"):
        cuda_cnn.roi_cnn_fused(roi, _cnn(), debug_stop="conv4")
    with pytest.raises(ValueError, match="unknown debug_stop"):
        cuda_cnn.roi_cnn_debug_plain(roi, _cnn(), False, "fc")


def test_debug_stop_none_is_the_plain_forward():
    roi = torch.from_numpy(ROI[:4])
    p = _cnn()
    assert torch.equal(cuda_cnn.roi_cnn_fused(roi, p, debug_stop=None),
                       cuda_cnn.roi_cnn_plain(roi, p))


@pytest.mark.parametrize("standardize", [False, True])
def test_debug_plain_stage_sums(jax_pp, standardize):
    """The debug stops' plain values, entry j the moment j % 3: the load
    moments ignore standardization and index the frame's pixels; norm's
    index the haloed image (standardized: sum about 0, squares 4,607 =
    N - 1); conv1's sum is the JAX reference conv1 + pool1's (live);
    conv3's sum is 288 times the summed mean features."""
    roi = torch.from_numpy(ROI[:4])
    p = _cnn()
    d = {s: cuda_cnn.roi_cnn_debug_plain(roi, p, standardize, s)
         for s in cuda_cnn.DEBUG_STOPS}
    for s in d.values():
        assert s.shape == (4, 32)
        assert torch.equal(s, s[:, :3].repeat(1, 11)[:, :32])
    x = roi.double().reshape(4, -1).numpy() / 255.0
    _assert_moments(d["load"][:, :3].numpy(), x)
    if standardize:
        np.testing.assert_allclose(d["norm"][:, 0].numpy(), 0.0, atol=1e-3)
        np.testing.assert_allclose(d["norm"][:, 1].numpy(), 4607.0,
                                   rtol=1e-6)
        _assert_moments(d["norm"][:, :3].numpy(), _haloed64(_std64(x)))
    else:
        _assert_moments(d["norm"][:, :3].numpy(), _haloed64(x))
        want = np.asarray(jax_pp.ref_conv1pool1(
            jnp.asarray(ROI[:4]), jnp.asarray(p["conv0"]["w"].numpy()),
            jnp.asarray(p["conv0"]["b"].numpy()))).sum(axis=(1, 2, 3))
        np.testing.assert_allclose(d["conv1"][:, 0].numpy(), want, rtol=1e-5)
    emb = cuda_cnn.roi_cnn_plain(roi, {**p, "fc": {
        "w": torch.eye(24), "b": torch.zeros(24)}}, standardize)
    np.testing.assert_allclose(d["conv3"][:, 0].numpy(),
                               288 * emb.sum(1).numpy(), rtol=1e-5)
    absolute = cuda_cnn.roi_cnn_debug_plain(roi, p, standardize, "conv3",
                                            absolute=True)
    assert torch.equal(absolute, d["conv3"])  # ReLU outputs: |v| = v


# ------------------------------------------------------ the scripts


def test_scripts_take_n_a_multiple_of_16():
    with pytest.raises(SystemExit):
        proto_parity_cnn.parse_args(["24", "device=cpu"], "x")
    with pytest.raises(SystemExit):
        proto_parity_cnn.parse_args(["32", "B=3"], "x")
    assert proto_parity_cnn.parse_args(["device=cpu"], "x").N == 8192


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_script_main_on_the_cpu(script, capsys):
    out = SCRIPTS[script].main(["32", "device=cpu", "iters=1"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == out
    assert out["device"] == "cpu" and out["N"] == 32
    assert "not a device measurement" in out["timer"]
    ran = [r for r in out["rows"] if r["ms"] is not None]
    assert ran and all(r["ms"] > 0 for r in ran)
    for r in ran:
        if r.get("max_abs_err") is not None:
            assert r["max_abs_err"] <= (TOL_BF16 if "bf16" in r["name"]
                                        else ATOL), r
    if script == "proto_ablate":  # the stops and the TPU-only modes say why
        assert [r["name"] for r in out["rows"]] == list(pc.JAX_MODES)
        assert all(r["note"] for r in out["rows"] if r["ms"] is None)
    if script == "probe_front":
        assert set(fp.LADDER) <= set(out["ms"]) and "k1_full" in out["ms"]


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_script_without_a_gpu_raises_unless_the_cpu_is_asked_for(script):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", f"silent_speech_tpu_torch.scripts.{script}",
         "32"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "device=cpu" in proc.stderr
    assert proc.stdout.strip() == ""
