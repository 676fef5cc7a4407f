"""The port's CUDA kernels against their plain versions, on the card.

Edge shapes the smoke run (chip_smoke.py) does not reach: single frames and
rows, ragged batch tiles, zero lengths, constant frames under
standardization, odd widths; the ROI CNN backward (K3) on tie frames, its
determinism and the inputs it refuses, its plan, N at the edges of its
wave, emb 1-64, and its recomputed conv3 means bitwise K1's; K2's two kernels (gru_proj,
gru_seq) each against its plain version at B 1-256, D 83-384, H 16-1024
(clusters of 1, 2, 4 and 8, Wh from device memory at H 512 and 1024), both
directions, lengths 0, 1 and T, bitwise repeatable, on a side stream, and
refusing autograd; the variant families' GRU predictors (reduced, GRU-word,
uni-GRU at their full widths) through K2 against gru_impl='plain'; gru_proj on both routes at ragged M, K and N, bitwise
repeatable, its plan the Python mirror's;
a train step through the kernels against the plain path; the serving
modes' CNN kernels (K1-bf16, K4 int8, K5 im2col) on ragged and single
frames, narrow embeddings, the inputs they refuse, and the Predictor in
each mode against its plain path; K4's and K5's plans, N at the edges of
their waves, their rows bitwise independent of the batch, K5's debug stops
and K4's check entry (its stops, and stage 1 on either route); the GRU probes' kernels (the recurrence
kernel with one and two weight sets, the dual-chain kernel) in f32 and
bf16, their launch counts, their independence of the knobs and the inputs
they refuse; the CNN-front prototypes' kernels (the parity conv1 + pool1
kernel in both layouts, bitwise on a repeat, its ablation stops, the
front probe's stages (its ladder on persistent blocks also at N just
below and above one wave, both /255 routes bitwise equal),
K1's debug stops) against their plain versions, and the four scripts' main
at N=64; the forward rate probes' kernels (the matmul-rate kernel at small
ragged shapes, the chained-dot kernel in every mode at K=384 and 512 (in
bf16 every cluster size bitwise the check instantiation at
1, 3 and 256 steps, and its plan; int8 and int8i bitwise at a partial last
sweep of their persistent grid, on repeats, their plan), the
layout kernel in every body, its moving bodies also at a step
count that leaves their persistent blocks a partial last sweep, its
product body also within a float64 bar
that one TF32 pass misses, its copied lanes bitwise, at 1 to 512 steps)
against their plain versions, their launch
counts, the inputs they refuse, and the three scripts' main at small
sizes; the matmul-rate kernel also at the probe's six shapes, and both
it and the chained-dot kernel's f32 chain bitwise on repeats, their
plans their Python mirrors', their timing stops; the backward-dot
probes' kernels (tt, xp, nt, and nn with its two epilogues) at ragged
shapes, bitwise repeatable, nt's zero tail, nt within the float64 bar
with one TF32 pass outside it, its stops and plan, the inputs they
refuse, and the three scripts' main at small sizes. Every test
needs
a CUDA device and skips without one. On the GPU machine (which has no jax, and tests/conftest.py
imports jax) run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import os
import pathlib

import pytest
import torch

import numpy as np

from silent_speech_tpu_torch.infer.predictor import Predictor, full_f32
from silent_speech_tpu_torch.models.bigru import (BiGRUClassifier,
                                                  BiGRUConfig, init_params,
                                                  init_roi_cnn)
from silent_speech_tpu_torch.train.step import (make_optimizer,
                                                smoothed_cross_entropy)
from silent_speech_tpu_torch.ops import (_kernels, cuda_bwd_dots, cuda_cnn,
                                         cuda_cnn_check, cuda_cnn_im2col,
                                         cuda_cnn_q8,
                                         cuda_dot_chain,
                                         cuda_front_probe, cuda_gru,
                                         cuda_gru_proto, cuda_layout_micro,
                                         cuda_mm_rate, cuda_parity_cnn)
from silent_speech_tpu_torch.ops import gru as gru_ops
from silent_speech_tpu_torch.ops.nn import gru_dir_init

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """The CUDA device, with TF32 off for the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with full_f32():
        yield torch.device("cuda")


def _cnn_params(dev, seed, emb=32):
    g = torch.Generator().manual_seed(seed)
    return {k: {n: t.to(dev) for n, t in v.items()}
            for k, v in init_roi_cnn(emb, g).items()}


@pytest.mark.parametrize("standardize,bar", [(False, 2e-4), (True, 2e-3)])
@pytest.mark.parametrize("N", [1, 7, 300])
def test_roi_cnn_kernel_matches_plain(dev, N, standardize, bar):
    g = torch.Generator().manual_seed(N)
    roi = torch.randint(0, 256, (N, 48, 96), generator=g, dtype=torch.uint8)
    roi[0] = 255  # a constant frame: std clamps at 1e-6 under standardize
    roi = roi.to(dev)
    p = _cnn_params(dev, N)
    before = cuda_cnn.KERNEL.launches
    got = cuda_cnn.roi_cnn_fused(roi, p, standardize=standardize,
                                 impl="kernel")
    torch.cuda.synchronize()
    assert cuda_cnn.KERNEL.launches == before + 1
    ref = cuda_cnn.roi_cnn_plain(roi, p, standardize)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=bar, rtol=0)


def test_roi_cnn_kernel_narrow_embedding(dev):
    roi = torch.randint(0, 256, (5, 48, 96), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(1)).to(dev)
    p = _cnn_params(dev, 2, emb=8)
    got = cuda_cnn.roi_cnn_fused(roi, p)
    torch.testing.assert_close(got, cuda_cnn.roi_cnn_plain(roi, p),
                               atol=2e-4, rtol=0)


def test_roi_cnn_kernel_weights_per_launch_on_two_streams(dev):
    """Launches with two weight sets, in turns on two streams, each give
    their own plain result: no launch reads the other's weights."""
    roi = torch.randint(0, 256, (64, 48, 96), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(4)).to(dev)
    ps = [_cnn_params(dev, s) for s in (5, 6)]
    flats = [cuda_cnn.flat_weights(p) for p in ps]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = [[], []]
    torch.cuda.synchronize()
    for _ in range(4):
        for i in (0, 1):
            with torch.cuda.stream(streams[i]):
                outs[i].append(cuda_cnn.roi_cnn_fused(roi, ps[i],
                                                      flat=flats[i]))
    torch.cuda.synchronize()
    for i in (0, 1):
        ref = cuda_cnn.roi_cnn_plain(roi, ps[i])
        for got in outs[i]:
            torch.testing.assert_close(got, ref, atol=2e-4, rtol=0)


def test_roi_cnn_kernel_rejects_what_it_does_not_take(dev):
    p = _cnn_params(dev, 3)
    roi = torch.zeros((4, 48, 96), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_cnn.roi_cnn_fused(roi[::2], p)
    with pytest.raises(ValueError, match="48x96"):
        cuda_cnn.roi_cnn_fused(torch.zeros((2, 40, 96), dtype=torch.uint8,
                                           device=dev), p)
    with pytest.raises(ValueError, match="f32"):
        cuda_cnn.roi_cnn_fused(roi, _cnn_params("cpu", 3))
    flat = cuda_cnn.flat_weights(p)
    for bad in (flat[:-1], flat.cpu(), flat.double()):
        with pytest.raises(ValueError, match="flat_weights"):
            cuda_cnn.roi_cnn_fused(roi, p, flat=bad)


# K1 and K1-bf16 (csrc/roi_cnn.cu: persistent blocks, conv2 and conv3 on
# the tensor cores) against their plain versions (TF32 off). f32: the 3xTF32
# bars of chip_smoke.py (BAR_K1_LIVE / BAR_K1_STD), which sit between the
# split's error and one TF32 pass's (tests/test_torch_roi_cnn_tc.py holds
# both, emulated, on either side of them). bf16: chip_smoke's BAR_BF16
# (BAR_BF16_CONST on constant frames, where one bf16 crossing moves a whole
# map)
_K1_BARS = {"f32": (2e-6, 1e-5), "bf16": (1e-4, 1e-4)}


def _k1_call(build, roi, p, standardize, impl="kernel"):
    if build == "bf16":
        return cuda_cnn.roi_cnn_bf16(roi, p, standardize=standardize,
                                     impl=impl)
    return cuda_cnn.roi_cnn_fused(roi, p, standardize=standardize, impl=impl)


def _k1_check(build, roi, p, standardize):
    before = _kernels.launch_counts()
    got = _k1_call(build, roi, p, standardize)
    torch.cuda.synchronize()
    after = _kernels.launch_counts()
    assert [k for k in after if after[k] != before[k]] == \
        [{"f32": "roi_cnn", "bf16": "roi_cnn_bf16"}[build]]
    ref = _k1_call(build, roi, p, standardize, impl="plain")
    N = roi.shape[0]
    assert got.shape == ref.shape and torch.isfinite(got).all()
    const = roi.reshape(N, -1).amin(1) == roi.reshape(N, -1).amax(1)
    bar = _K1_BARS[build][standardize]
    if build == "bf16":
        torch.testing.assert_close(got[const], ref[const],
                                   atol=_BF16_CONST_BAR, rtol=0)
        got, ref = got[~const], ref[~const]
    torch.testing.assert_close(got, ref, atol=bar, rtol=0)


@pytest.mark.parametrize("build", ["f32", "bf16"])
def test_roi_cnn_plan_is_one_wave_of_resident_blocks(dev, build):
    """The kernel's own sizing (roi_cnn_plan): 288 threads, at least two
    blocks resident an SM, the wave that many on every SM."""
    pl = cuda_cnn.plan(bf16=build == "bf16")
    props = torch.cuda.get_device_properties(dev)
    assert pl.threads == 288 and pl.smem <= 232448
    assert pl.blocks_per_sm >= 2 and pl.sms == props.multi_processor_count
    assert pl.wave == pl.blocks_per_sm * pl.sms


@pytest.mark.parametrize("standardize", [False, True])
@pytest.mark.parametrize("N", ["1", "2", "33", "8192", "wave-1", "wave",
                               "wave+1", "2*wave-1", "2*wave+1"])
@pytest.mark.parametrize("build", ["f32", "bf16"])
def test_roi_cnn_kernels_match_plain_across_waves(dev, build, N, standardize):
    """Batches of one frame a block, one wave, and a wave and a frame:
    the frames a block walks past its first."""
    wave = cuda_cnn.plan(bf16=build == "bf16").wave
    n = eval(N, {"wave": wave})
    g = torch.Generator().manual_seed(n)
    roi = torch.randint(0, 256, (n, 48, 96), generator=g, dtype=torch.uint8)
    _k1_check(build, roi.to(dev), _cnn_params(dev, n % 97), standardize)


@pytest.mark.parametrize("standardize", [False, True])
@pytest.mark.parametrize("build", ["f32", "bf16"])
def test_roi_cnn_kernels_on_constant_frames(dev, build, standardize):
    roi = _const_frames((0, 255, 0, 255, 255)).to(dev)
    _k1_check(build, roi, _cnn_params(dev, 11), standardize)


@pytest.mark.parametrize("standardize", [False, True])
@pytest.mark.parametrize("emb", [1, 32, 64])
@pytest.mark.parametrize("build", ["f32", "bf16"])
def test_roi_cnn_kernels_embedding_widths(dev, build, emb, standardize):
    roi = torch.randint(0, 256, (40, 48, 96), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(emb))
    _k1_check(build, roi.to(dev), _cnn_params(dev, emb, emb), standardize)


@pytest.mark.parametrize("standardize", [False, True])
@pytest.mark.parametrize("build", ["f32", "bf16"])
def test_roi_cnn_kernels_rows_do_not_depend_on_the_launch(dev, build,
                                                          standardize):
    """Bitwise: two launches on the same frames are equal, and frames
    launched alone equal the same frames in a batch of 33 and in a batch
    of two waves and a frame (where another block, at another step of its
    walk, takes them)."""
    wave = cuda_cnn.plan(bf16=build == "bf16").wave
    g = torch.Generator().manual_seed(21)
    roi = torch.randint(0, 256, (2 * wave + 1, 48, 96), generator=g,
                        dtype=torch.uint8)
    roi[32] = 255
    roi, p = roi.to(dev), _cnn_params(dev, 21)
    big = _k1_call(build, roi, p, standardize)
    again = _k1_call(build, roi, p, standardize)
    assert torch.equal(big, again)
    whole = _k1_call(build, roi[:33].contiguous(), p, standardize)
    assert torch.equal(whole, big[:33])
    for lo, hi in ((0, 1), (5, 6), (3, 17), (31, 33)):
        part = _k1_call(build, roi[lo:hi].contiguous(), p, standardize)
        assert torch.equal(part, whole[lo:hi]), (lo, hi)
    tail = _k1_call(build, roi[-3:].contiguous(), p, standardize)
    assert torch.equal(tail, big[-3:])


@pytest.mark.parametrize("B,T,D,H", [(1, 1, 4, 8), (9, 5, 13, 40),
                                     (17, 33, 212, 192), (1, 32, 166, 128),
                                     (64, 32, 360, 128)])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_kernel_matches_plain(dev, B, T, D, H, reverse):
    g = torch.Generator().manual_seed(B * 100 + T)
    x = torch.randn(B, T, D, generator=g).to(dev)
    lengths = torch.randint(0, T + 1, (B,), generator=g)
    lengths[0] = T
    if B > 2:
        lengths[1] = 0
    p = {k: v.to(dev) for k, v in gru_dir_init(D, H, g).items()}
    got = cuda_gru.gru_layer(x, lengths, p, reverse=reverse, impl="kernel")
    torch.cuda.synchronize()
    ref = gru_ops.gru_layer_single_direction(x, lengths.to(dev), p,
                                             reverse=reverse)[0]
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)


def test_bigru_kernel_one_launch_per_layer(dev):
    g = torch.Generator().manual_seed(5)
    B, T, D, H = 11, 9, 20, 16
    layers = [{"fwd": gru_dir_init(d, H, g), "bwd": gru_dir_init(d, H, g)}
              for d in (D, 2 * H)]
    layers = [{k: {n: t.to(dev) for n, t in v.items()} for k, v in lp.items()}
              for lp in layers]
    x = torch.randn(B, T, D, generator=g).to(dev)
    lengths = torch.randint(1, T + 1, (B,), generator=g).to(dev)
    _kernels.reset_launch_counts()
    got = cuda_gru.bigru_kernel(x, lengths, layers)
    counts = _kernels.launch_counts()
    assert counts["gru_proj"] == 2 and counts["gru_seq"] == 2  # per layer
    ref = gru_ops.bigru(x, lengths, layers)[0]
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)


# K2's two kernels, each against its own plain version: H=16 and 64 run
# clusters of 1, 128 of 2, 192 of 4, 200 of 8 (U=25, not whole warps); 512
# and 1024 read Wh from device memory (the kernel's plan, cuda_gru.plan)
# D=83 and 166 (the variant families' lip83 features and their deltas, not
# multiples of 4: gru_proj's 4-byte copies), H=64 and 128 (the variants'
# hidden sizes: clusters of 1 and 2)
GRU_B, GRU_D = (1, 3, 17, 256), (83, 166, 180, 212, 384)
GRU_H = (16, 64, 128, 192, 200, 512, 1024)


def _gru_lengths(g, B, T):
    """Ragged, with T, 0 and 1 among them."""
    lengths = torch.randint(0, T + 1, (B,), generator=g)
    lengths[:3] = torch.tensor([T, 0, 1])[:B]
    return lengths


@pytest.mark.parametrize("H", GRU_H)
@pytest.mark.parametrize("D", GRU_D)
@pytest.mark.parametrize("B", GRU_B)
def test_gru_proj_kernel_matches_plain(dev, B, D, H):
    g = torch.Generator().manual_seed(B * 7 + D + H)
    T = 5
    x = torch.randn(B, T, D, generator=g).to(dev)
    wi = (torch.randn(D, 6 * H, generator=g) / D ** 0.5).to(dev)
    bi = torch.randn(6 * H, generator=g).to(dev)
    before = cuda_gru.PROJ.launches
    got = cuda_gru.gru_proj(x, wi, bi, impl="kernel")
    again = cuda_gru.gru_proj(x, wi, bi, impl="kernel")
    torch.cuda.synchronize()
    assert cuda_gru.PROJ.launches == before + 2
    assert torch.equal(got, again)  # a fixed summation order
    torch.testing.assert_close(got, cuda_gru.gru_proj_plain(x, wi, bi),
                               atol=1e-4, rtol=0)


# both routes of gru_proj at ragged M (tiles, waves), ragged K (181: the
# 4-byte copies; 212: a ragged last chunk) and N (1150)
PROJ_CASES = [(M, K, N) for M in (1, 33, 257, 1000, 8193)
              for K, N in ((212, 1152), (384, 1152), (181, 1150))]


@pytest.mark.parametrize("route", cuda_gru.PROJ_ROUTES)
@pytest.mark.parametrize("M,K,N", PROJ_CASES)
def test_gru_proj_routes_match_plain(dev, route, M, K, N):
    g = torch.Generator().manual_seed(M + K + N)
    x = torch.randn(M, K, generator=g).to(dev)
    wi = (torch.randn(K, N, generator=g) / K ** 0.5).to(dev)
    bi = torch.randn(N, generator=g).to(dev)
    before = cuda_gru.PROJ.launches
    got = cuda_gru.gru_proj(x, wi, bi, impl="kernel", route=route)
    again = cuda_gru.gru_proj(x, wi, bi, impl="kernel", route=route)
    torch.cuda.synchronize()
    assert cuda_gru.PROJ.launches == before + 2
    assert torch.equal(got, again)  # a fixed summation order
    torch.testing.assert_close(got, cuda_gru.gru_proj_plain(x, wi, bi),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("M,K", [(1000, 212), (5760, 384), (33, 212)])
def test_gru_proj_stop_is_the_large_route(dev, M, K):
    """The timing stop at the shapes' tile width with 3 passes is the
    large route bitwise; each width is within the bar of the plain
    version; one TF32 pass is another function, and counts apart."""
    g = torch.Generator().manual_seed(M + K)
    N = 1152
    x = torch.randn(M, K, generator=g).to(dev)
    wi = (torch.randn(K, N, generator=g) / K ** 0.5).to(dev)
    bi = torch.randn(N, generator=g).to(dev)
    wt = cuda_gru.pack_wi_tc(wi)
    want = cuda_gru.gru_proj(x, wi, bi, impl="kernel", route="large", wt=wt)
    before = cuda_gru.PROJ.launches
    assert torch.equal(cuda_gru.gru_proj_stop(x, wt, bi), want)
    plain = cuda_gru.gru_proj_plain(x, wi, bi)
    for bn in cuda_gru.PROJ_BNS:
        torch.testing.assert_close(cuda_gru.gru_proj_stop(x, wt, bi, bn=bn),
                                   plain, atol=1e-4, rtol=0)
    one = cuda_gru.gru_proj_stop(x, wt, bi, passes=1)
    torch.cuda.synchronize()
    assert cuda_gru.PROJ.launches == before
    assert (one - plain).abs().max().item() > 1e-4
    with pytest.raises(ValueError, match="bn in"):
        cuda_gru.gru_proj_stop(x, wt, bi, bn=128)


@pytest.mark.parametrize("M,K,N", [(32, 212, 1152), (32, 384, 1152),
                                   (8192, 212, 1152), (32768, 384, 1152),
                                   (5760, 212, 1152), (1000, 181, 1150)])
def test_gru_proj_plan_is_the_mirror(dev, M, K, N):
    """The kernel's route and tile are proj_geometry's; the large route
    launches one persistent block a resident slot, at most one a tile."""
    for route in (None,) + cuda_gru.PROJ_ROUTES:
        pl = cuda_gru.proj_plan(M, K, N, route)
        geo = cuda_gru.proj_geometry(M, K, N, route)
        assert pl._asdict() == {**geo._asdict(), "blocks": pl.blocks}
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        want = geo.tiles if geo.route == "small" else min(geo.tiles, sms)
        assert pl.blocks == want


@pytest.mark.parametrize("dirs", ["fwd", "rev", "both"])
@pytest.mark.parametrize("H", GRU_H)
@pytest.mark.parametrize("B", GRU_B)
def test_gru_seq_kernel_matches_plain(dev, B, H, dirs):
    g = torch.Generator().manual_seed(B * 11 + H)
    T = 7
    pf, pb = [{k: v.to(dev) for k, v in gru_dir_init(4, H, g).items()}
              for _ in range(2)]
    pack = cuda_gru.pack_layer({"fwd": [(pf, False)], "rev": [(pb, True)],
                                "both": [(pf, False), (pb, True)]}[dirs])
    ndir = len(pack.reverse)
    xp = torch.randn(B, T, ndir * 3 * H, generator=g).to(dev)
    lengths = _gru_lengths(g, B, T).to(dev)
    before = cuda_gru.SEQ.launches
    got = cuda_gru.gru_recurrence(xp, lengths, pack, impl="kernel")
    again = cuda_gru.gru_recurrence(xp, lengths, pack, impl="kernel")
    torch.cuda.synchronize()
    assert cuda_gru.SEQ.launches == before + 2
    assert torch.equal(got, again)  # a fixed summation order
    ref = cuda_gru.gru_recurrence(xp, lengths, pack, impl="plain")
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)
    for b, n in enumerate(lengths.tolist()):
        assert not got[b, n:].any()


@pytest.mark.parametrize("H", GRU_H)
@pytest.mark.parametrize("B", (1, 32, 64, 256, 1024))
def test_gru_plan_waves_fit_the_card(dev, B, H):
    """The kernel's plan (gru_seq_plan): the pack's layout, a block that
    fits, and the waves its clusters take on this card by
    cudaOccupancyMaxActiveClusters; at the model's H=192 one wave."""
    pl = cuda_gru.plan(B, H, 2)
    C = cuda_gru.cluster_size(H)
    assert (pl.C, pl.U, pl.Up, pl.Hk) == (C, *cuda_gru._layout(H, C))
    assert pl.threads <= 512 and pl.smem <= 232448
    assert pl.smem_w == (H <= 384)
    assert pl.BT in (1, 2) or pl.BT % 4 == 0
    tiles = -(-B // pl.BT) * 2
    assert pl.blocks == C * tiles and pl.clusters >= 1
    assert pl.waves == -(-tiles // pl.clusters)
    if B == 1:
        assert pl.BT == 1 and pl.waves == 1
    if H == 192:
        assert pl.waves == 1, pl


def test_gru_plan_fits_every_hidden_size(dev):
    """Every H the kernel takes, 1..1024, gets a plan on this card, Wh in
    shared memory up to H=384, and gru_seq runs it."""
    g = torch.Generator().manual_seed(13)
    for H in range(1, cuda_gru.MAX_HIDDEN + 1):
        for B in (1, 256):
            pl = cuda_gru.plan(B, H, 2)
            assert pl.smem_w == (H <= 384) and pl.waves >= 1, (H, B)
    for H in (1, 7, 100, 385, 1000):
        p = {k: v.to(dev) for k, v in gru_dir_init(4, H, g).items()}
        pack = cuda_gru.pack_layer([(p, True)])
        xp = torch.randn(3, 4, 3 * H, generator=g).to(dev)
        lengths = torch.tensor([4, 0, 2], device=dev)
        torch.testing.assert_close(
            cuda_gru.gru_recurrence(xp, lengths, pack, impl="kernel"),
            cuda_gru.gru_recurrence(xp, lengths, pack, impl="plain"),
            atol=1e-4, rtol=0)


def test_gru_kernels_on_a_side_stream(dev):
    """Launched on a non-default stream, the two kernels give the default
    stream's bits."""
    g = torch.Generator().manual_seed(12)
    B, T, D, H = 17, 9, 212, 192
    layers = [{k: {n: t.to(dev) for n, t in gru_dir_init(d, H, g).items()}
               for k in ("fwd", "bwd")} for d in (D, 2 * H)]
    x = torch.randn(B, T, D, generator=g).to(dev)
    lengths = _gru_lengths(g, B, T).to(dev)
    ref = cuda_gru.bigru_kernel(x, lengths, layers)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        got = cuda_gru.bigru_kernel(x, lengths, layers)
    side.synchronize()
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


# --------------------------------------------------------------------- K3


def _plain_weight_grads(roi, dE, p, standardize, route=None):
    """Autograd through the plain version, or along ``route``."""
    leaves = {k: {n: t.detach().clone().requires_grad_(True)
                  for n, t in v.items()} for k, v in p.items()}
    out = (cuda_cnn.roi_cnn_train_plain(roi, leaves, standardize)
           if route is None else
           cuda_cnn_check.roi_cnn_plain_routed(roi, leaves, standardize,
                                               route))
    flat = [t for v in leaves.values() for t in v.values()]
    grads = iter(torch.autograd.grad(out, flat, dE))
    return cuda_cnn.flat_weights({k: {n: next(grads) for n in v}
                                  for k, v in leaves.items()})


def _assert_rel(got, ref, emb, bar=5e-5):
    """max |d| / max |ref| < bar for each parameter tensor of the flat
    layout (tests/test_fused_train.py's bar)."""
    o = 0
    for n in (72, 8, 1152, 16, 3456, 24, 24 * emb, emb):
        a, b = got[o:o + n].double(), ref[o:o + n].double()
        rel = ((a - b).abs().max() / b.abs().max()).item()
        assert rel < bar, f"entries {o}:{o + n}: rel err {rel:.2e}"
        o += n


def _const_frames(levels):
    return torch.tensor(levels, dtype=torch.uint8)[:, None, None].expand(
        len(levels), 48, 96).contiguous()


@pytest.mark.parametrize("N,standardize,levels,emb", [
    (1, False, (), 32), (10, False, (0, 37, 128, 255), 32),
    (10, True, (0, 255), 32), (133, True, (), 8), (300, False, (), 32)])
def test_roi_cnn_bwd_matches_plain(dev, N, standardize, levels, emb):
    """Random frames plus constant tie frames (every 2x2 window a tie);
    under the standardization only 0 and 255 standardize exactly. N=133
    gives some blocks two frames."""
    g = torch.Generator().manual_seed(N)
    roi = torch.cat([torch.randint(0, 256, (N, 48, 96), generator=g,
                                   dtype=torch.uint8), _const_frames(levels)])
    roi, p = roi.to(dev), _cnn_params(dev, N, emb)
    dE = torch.randn(roi.shape[0], emb, generator=g).to(dev)
    flat = cuda_cnn.flat_weights(p)
    before = cuda_cnn.BWD_KERNEL.launches
    got = cuda_cnn.roi_cnn_weight_grads(roi, dE, flat,
                                        standardize=standardize)
    again = cuda_cnn.roi_cnn_weight_grads(roi, dE, flat,
                                          standardize=standardize)
    torch.cuda.synchronize()
    assert cuda_cnn.BWD_KERNEL.launches == before + 2
    assert torch.equal(got, again)  # a fixed summation order
    _assert_k3_close(got, roi, dE, p, standardize, ties=len(levels))


def test_roi_cnn_fused_train_autograd_reaches_the_parameters(dev):
    """Through the kernels (forward K1, backward K3) autograd gives the
    module's OIHW and (out, in) parameters the plain version's gradients."""
    cfg = BiGRUConfig(x_dim=4, hidden=8, head_hidden=4, roi_emb=16)
    model = BiGRUClassifier.from_jax_params(
        init_params(cfg, torch.Generator().manual_seed(3)), cfg).to(dev)
    roi = torch.randint(0, 256, (40, 48, 96), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(4)).to(dev)
    grads = []
    for impl in ("kernel", "plain"):
        model.zero_grad()
        out = cuda_cnn.roi_cnn_fused_train(
            roi, model.roi_cnn.params_tree(), impl=impl)
        torch.tanh(out).sum().backward()
        grads.append([p.grad.clone() for p in model.roi_cnn.parameters()])
    for a, b in zip(*grads):
        assert ((a - b).abs().max() / b.abs().max()).item() < 5e-5


def test_roi_cnn_bwd_rejects_what_it_does_not_take(dev):
    p = _cnn_params(dev, 3)
    flat = cuda_cnn.flat_weights(p)
    roi = torch.zeros((4, 48, 96), dtype=torch.uint8, device=dev)
    dE = torch.zeros((4, 32), device=dev)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_cnn.roi_cnn_weight_grads(roi.cpu(), dE, flat, standardize=True)
    with pytest.raises(ValueError, match="dE"):
        cuda_cnn.roi_cnn_weight_grads(roi, dE[:3], flat, standardize=True)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_cnn.roi_cnn_weight_grads(roi[::2], dE[:2], flat,
                                      standardize=True)
    with pytest.raises(ValueError, match="flat_weights"):
        cuda_cnn.roi_cnn_weight_grads(roi, dE, flat[:-1], standardize=True)
    zero = cuda_cnn.roi_cnn_weight_grads(roi[:0], dE[:0], flat,
                                         standardize=True)
    torch.cuda.synchronize()
    assert zero.shape == flat.shape and not zero.any()


# K3's redesign (csrc/roi_cnn_bwd.cu: persistent blocks, the recompute
# through K1's stage code, the backward products as 3xTF32 on mma.sync).
# K3 differentiates the branch K1's forward took; two f32 forwards take
# different branches at some near-tied pool windows and near-zero ReLU
# inputs, more of them the more frames, and the gradient moves by up to a
# few 1e-4 of a tensor's largest entry there (PERF.md, section 6). So K3 is
# held to the plain version on its own route at chip_smoke.py's BAR_K3 up
# to _SMALL_N frames (random and tie frames: the card readings in
# PERF.md stayed within 3e-6 there, while from 133 frames up the f32 plain version
# itself lay up to 2.2e-4 from its float64 evaluation), and above it at
# BAR_K3_ROUTING against both the f32 plain version and its float64
# evaluation; in every case at BAR_K3 to the plain version along the route
# K3's check entry reports (cuda_cnn_check.roi_cnn_plain_routed), and that
# route to the float64 plain forward's own: it may differ only by
# near-ties, gaps under ROUTE_TOL of a layer's largest value in the frame,
# and never at an exact tie (chip_smoke.py ROUTE_TOL). On constant frames,
# whose interior windows are exact ties, its pool argmaxes must be the
# float64 plain forward's: the first max.
_SMALL_N, _BAR_K3_ROUTING, _ROUTE_TOL = 64, 5e-4, 1e-5


def _assert_k3_close(got, roi, dE, p, standardize, ties=0):
    """``got``, K3's gradients, against the plain version as above; the
    last ``ties`` frames of ``roi`` are constant."""
    emb = dE.shape[1]
    p64 = {k: {n: t.double() for n, t in v.items()} for k, v in p.items()}
    if roi.shape[0] <= _SMALL_N:
        _assert_rel(got, _plain_weight_grads(roi, dE, p, standardize), emb)
    else:
        for q, d in ((p, dE), (p64, dE.double())):
            _assert_rel(got, _plain_weight_grads(roi, d, q, standardize),
                        emb, _BAR_K3_ROUTING)
    again, _, route = cuda_cnn_check.roi_cnn_bwd_check(
        roi, dE, cuda_cnn.flat_weights(p), standardize=standardize)
    assert torch.equal(again, got)
    _assert_rel(got, _plain_weight_grads(roi, dE, p, standardize, route),
                emb)
    gaps = cuda_cnn_check.route_gaps(roi, p64, standardize, route)
    assert cuda_cnn_check.near_ties_only(gaps, _ROUTE_TOL), gaps
    if ties:
        own = cuda_cnn_check.plain_route(roi[-ties:], p64, standardize)
        assert torch.equal(route.arg1[-ties:], own.arg1)
        assert torch.equal(route.arg2[-ties:], own.arg2)


def _k3_case(dev, n, seed, emb=32, levels=()):
    g = torch.Generator().manual_seed(seed)
    roi = torch.cat([torch.randint(0, 256, (n, 48, 96), generator=g,
                                   dtype=torch.uint8), _const_frames(levels)])
    p = _cnn_params(dev, seed % 97, emb)
    dE = torch.randn(roi.shape[0], emb, generator=g).to(dev)
    return roi.to(dev), p, dE, cuda_cnn.flat_weights(p)


def _k3_check(roi, p, dE, flat, standardize, ties=0):
    before = _kernels.launch_counts()
    got = cuda_cnn.roi_cnn_weight_grads(roi, dE, flat,
                                        standardize=standardize)
    torch.cuda.synchronize()
    after = _kernels.launch_counts()
    assert [k for k in after if after[k] != before[k]] == ["roi_cnn_bwd"]
    assert got.shape == flat.shape and torch.isfinite(got).all()
    _assert_k3_close(got, roi, dE, p, standardize, ties)


def test_roi_cnn_bwd_plan_is_one_wave_of_resident_blocks(dev):
    """The backward kernel's own sizing (roi_cnn_bwd_plan): 288 threads,
    at least two blocks resident an SM, the wave that many on every SM."""
    pl = cuda_cnn.bwd_plan()
    props = torch.cuda.get_device_properties(dev)
    assert pl.threads == 288 and pl.smem <= 232448 // 2
    assert pl.blocks_per_sm >= 2 and pl.sms == props.multi_processor_count
    assert pl.wave == pl.blocks_per_sm * pl.sms


@pytest.mark.parametrize("standardize", [False, True])
@pytest.mark.parametrize("N", ["1", "2", "wave-1", "wave+1", "2*wave-1",
                               "2*wave+1", "8192"])
def test_roi_cnn_bwd_matches_plain_across_waves(dev, N, standardize):
    """One frame a block, a wave either side, two waves either side (the
    frames a block walks past its first), and the serving batch."""
    n = eval(N, {"wave": cuda_cnn.bwd_plan().wave})
    _k3_check(*_k3_case(dev, n, n), standardize)


@pytest.mark.parametrize("standardize", [False, True])
@pytest.mark.parametrize("emb", [1, 32, 64])
def test_roi_cnn_bwd_embedding_widths(dev, emb, standardize):
    _k3_check(*_k3_case(dev, 40, emb, emb), standardize)


@pytest.mark.parametrize("standardize,levels", [
    (False, (0, 37, 128, 255, 0)), (True, (0, 255, 255, 0))])
def test_roi_cnn_bwd_on_constant_frames(dev, standardize, levels):
    """Frames that are all ties (every 2x2 window), with two random ones
    (standardized constant frames are all zeros: alone, dW1 would be 0)."""
    _k3_check(*_k3_case(dev, 2, 13, levels=levels), standardize,
              ties=len(levels))


@pytest.mark.parametrize("standardize", [False, True])
def test_roi_cnn_bwd_is_bitwise_repeatable(dev, standardize):
    """Two launches on two waves and a frame give equal bits: one fixed
    summation order, whatever block takes a frame."""
    n = 2 * cuda_cnn.bwd_plan().wave + 1
    roi, p, dE, flat = _k3_case(dev, n, 31, levels=(0, 255))
    a = cuda_cnn.roi_cnn_weight_grads(roi, dE, flat, standardize=standardize)
    b = cuda_cnn.roi_cnn_weight_grads(roi, dE, flat, standardize=standardize)
    assert torch.equal(a, b)


def test_roi_cnn_bwd_stops_end_after_their_stages(dev):
    """The check entry's stops (for timing the stages): each gives the
    gradient entries its stages form bitwise as the whole kernel does, and
    zeros elsewhere. Flat layout: W1, B1 0:80, W2 80:1232, B2 1232:1248,
    then W3, B3 and the fc from 1248."""
    roi, p, dE, flat = _k3_case(dev, 300, 17, levels=(0, 255))
    full = cuda_cnn.roi_cnn_weight_grads(roi, dE, flat, standardize=True)
    done = torch.zeros_like(full, dtype=torch.bool)
    for stop, lo, hi in (("forward", 0, 0), ("dw3", 1248, full.numel()),
                         ("dp2", 1232, 1248), ("dw2", 80, 1232)):
        done[lo:hi] = True
        got = cuda_cnn.roi_cnn_bwd_entry(roi, dE, flat, True, stop=stop)
        torch.cuda.synchronize()
        assert torch.equal(got[done], full[done]), stop
        assert not got[~done].any(), stop


def _identity_fc(p):
    """p with the fc set to the 24 x 24 identity and a zero bias: the
    forward's output is then its conv3 means, exactly."""
    dev = p["fc"]["w"].device
    return dict(p, fc={"w": torch.eye(24, device=dev),
                       "b": torch.zeros(24, device=dev)})


@pytest.mark.parametrize("standardize", [False, True])
@pytest.mark.parametrize("N", ["wave-1", "wave+1"])
def test_roi_cnn_bwd_recompute_is_the_forward_bitwise(dev, N, standardize):
    """The conv3 means the backward kernel recomputes (its check entry) are
    bitwise the forward kernel's (emb=24 identity fc) on the same frames
    and weights, random and constant tie frames: the backward routes the
    gradient through the forward's own argmaxes and ReLU masks."""
    n = eval(N, {"wave": cuda_cnn.bwd_plan().wave})
    roi, p, _, _ = _k3_case(dev, n, 7, levels=(0, 37, 128, 255))
    p = _identity_fc(p)
    flat = cuda_cnn.flat_weights(p)
    dE = torch.randn(roi.shape[0], 24, generator=torch.Generator(
        ).manual_seed(n)).to(dev)
    before = cuda_cnn.BWD_CHECK_KERNEL.launches
    grads, feat, _ = cuda_cnn_check.roi_cnn_bwd_check(
        roi, dE, flat, standardize=standardize)
    fwd = cuda_cnn.roi_cnn_fused(roi, p, standardize=standardize,
                                 impl="kernel", flat=flat)
    torch.cuda.synchronize()
    assert cuda_cnn.BWD_CHECK_KERNEL.launches == before + 1
    assert torch.equal(feat, fwd)
    assert torch.equal(grads, cuda_cnn.roi_cnn_weight_grads(
        roi, dE, flat, standardize=standardize))


def test_gru_kernel_refuses_autograd(dev):
    g = torch.Generator().manual_seed(6)
    p = {k: v.to(dev) for k, v in gru_dir_init(8, 16, g).items()}
    x = torch.randn(3, 5, 8, generator=g).to(dev)
    lengths = torch.tensor([5, 3, 1])
    cuda_gru.gru_layer(x, lengths, p, impl="kernel")  # nothing requires grad
    for grad_x, grad_w in ((True, False), (False, True)):
        xx = x.clone().requires_grad_(grad_x)
        pp = {k: v.clone().requires_grad_(grad_w) for k, v in p.items()}
        with pytest.raises(RuntimeError, match="no backward"):
            cuda_gru.gru_layer(xx, lengths, pp, impl="kernel")
        with torch.no_grad():
            cuda_gru.gru_layer(xx, lengths, pp, impl="kernel")
    # each of the two kernels on its own
    pack = cuda_gru.pack_layer([(p, False)])
    xp = torch.randn(3, 5, 48, generator=g).to(dev)
    with pytest.raises(RuntimeError, match="no backward"):
        cuda_gru.gru_proj(x, p["wi"].clone().requires_grad_(), p["bi"],
                          impl="kernel")
    with pytest.raises(RuntimeError, match="no backward"):
        cuda_gru.gru_recurrence(xp.clone().requires_grad_(), lengths, pack,
                                impl="kernel")
    layer = {"fwd": p, "bwd": dict(p, wi=p["wi"].clone().requires_grad_())}
    with pytest.raises(RuntimeError, match="no backward"):
        cuda_gru.bigru_kernel(x, lengths, [layer], impl="kernel")


def test_train_step_kernels_match_plain(dev):
    """One step (forward, loss, backward, clip, Adam) through K1 and K3
    against the plain path; the bars of tests/test_fused_train.py:180-189
    and tests/test_train.py:101,113."""
    cfg = BiGRUConfig(x_dim=12, num_classes=4, hidden=16, roi_emb=8,
                      head_hidden=8, gru_dropout=0.0, head_dropout=0.0)
    params = init_params(cfg, torch.Generator().manual_seed(7))
    rng = np.random.default_rng(7)
    B, T = 4, 16
    X = torch.from_numpy(rng.standard_normal((B, T, 12)).astype(np.float32))
    L = torch.tensor([16, 9, 5, 12])
    R = torch.from_numpy(rng.integers(0, 256, (B, T, 48, 96),
                                      dtype=np.uint8))
    y = torch.tensor([0, 3, 1, 2])
    batch = [t.to(dev) for t in (X, L, R, y)]
    res = []
    for impl in ("kernel", "plain"):
        model = BiGRUClassifier.from_jax_params(params, cfg).to(dev)
        opt = make_optimizer(model, 3e-4)
        _kernels.reset_launch_counts()
        logits = model.train_forward(*batch[:3], roi_impl=impl,
                                     generator=torch.Generator(device=dev))
        loss = smoothed_cross_entropy(logits, batch[3], 4, 0.05)
        loss.backward()
        grads = [p.grad.clone() for p in model.parameters()]
        opt.step()
        counts = _kernels.launch_counts()
        want = 1 if impl == "kernel" else 0
        assert counts["roi_cnn"] == counts["roi_cnn_bwd"] == want
        assert counts["gru_seq"] == 0  # the training GRU is the plain scan
        assert all(g.abs().max() > 0 for g in grads)
        res.append((loss.item(), grads,
                    [p.detach().clone() for p in model.parameters()]))
    (lk, gk, pk), (lp, gp, pp) = res
    assert abs(lk - lp) < 1e-5
    assert max((a - b).abs().max().item() for a, b in zip(gk, gp)) <= 1e-4
    assert max((a - b).abs().max().item() for a, b in zip(pk, pp)) <= 3e-4


# ----------------------------------------------------- K1-bf16, K4 and K5

# chip_smoke.py's bars (live, standardized): bf16 crossings of rounding
# boundaries after f32 reassociation; int8 bitwise up to the last ReLU;
# im2col computes K1's function as 3xTF32, at K1's f32 bars (which one TF32
# pass misses: tests/test_torch_roi_cnn_im2col_tc.py). On a constant frame
# one bf16 crossing moves a whole map: chip_smoke.py's BAR_BF16_CONST there.
_MODE_BARS = {"bf16": (1e-4, 1e-4), "q8": (1e-6, None),
              "im2col": _K1_BARS["f32"]}
_BF16_CONST_BAR = 2e-3


def _mode_call(mode, roi, p, standardize, impl="kernel", packed=None):
    if mode == "bf16":
        return cuda_cnn.roi_cnn_bf16(roi, p, standardize=standardize,
                                     impl=impl, flat=packed)
    if mode == "q8":
        return cuda_cnn_q8.roi_cnn_q8(roi, p, standardize=standardize,
                                      impl=impl, packed=packed)
    return cuda_cnn_im2col.roi_cnn_im2col(roi, p, standardize=standardize,
                                          impl=impl, packed=packed)


@pytest.mark.parametrize("mode", ["bf16", "q8", "im2col"])
@pytest.mark.parametrize("N,emb", [(1, 32), (33, 32), (300, 8), (7, 64)])
def test_serving_mode_kernel_matches_plain(dev, mode, N, emb):
    g = torch.Generator().manual_seed(N)
    roi = torch.randint(0, 256, (N, 48, 96), generator=g, dtype=torch.uint8)
    roi[-1] = 255
    if N > 2:
        roi[0] = 0
    roi, p = roi.to(dev), _cnn_params(dev, N, emb)
    for std, bar in zip((False, True), _MODE_BARS[mode]):
        if bar is None:
            continue
        before = _kernels.launch_counts()
        got = _mode_call(mode, roi, p, std)
        torch.cuda.synchronize()
        after = _kernels.launch_counts()
        assert [k for k in after if after[k] != before[k]] == \
            [{"bf16": "roi_cnn_bf16", "q8": "roi_cnn_q8",
              "im2col": "roi_cnn_im2col"}[mode]]
        ref = _mode_call(mode, roi, p, std, impl="plain")
        assert got.shape == (N, emb) and torch.isfinite(got).all()
        const = roi.reshape(N, -1).amin(1) == roi.reshape(N, -1).amax(1)
        if mode == "bf16":
            torch.testing.assert_close(got[const], ref[const],
                                       atol=_BF16_CONST_BAR, rtol=0)
            got, ref = got[~const], ref[~const]
        torch.testing.assert_close(got, ref, atol=bar, rtol=0)


def test_q8_kernel_rows_do_not_depend_on_the_batch(dev):
    roi = torch.randint(0, 256, (65, 48, 96), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(8)).to(dev)
    p = _cnn_params(dev, 8)
    q = cuda_cnn_q8.quantize_roi_cnn(p)
    whole = cuda_cnn_q8.roi_cnn_q8(roi, p, packed=q)
    for lo, hi in ((0, 1), (64, 65), (10, 43)):
        part = cuda_cnn_q8.roi_cnn_q8(roi[lo:hi].contiguous(), p, packed=q)
        assert torch.equal(part, whole[lo:hi])


# K4 and K5 (csrc/roi_cnn_q8.cu, csrc/roi_cnn_im2col.cu): persistent
# blocks, one wave sized by the kernel (cuda_cnn_q8.plan,
# cuda_cnn_im2col.plan)
_MODE_PLANS = {"q8": (cuda_cnn_q8.plan, 3), "im2col": (cuda_cnn_im2col.plan, 2)}


@pytest.mark.parametrize("mode", ["q8", "im2col"])
def test_serving_mode_plan_is_one_wave_of_resident_blocks(dev, mode):
    plan, per_sm = _MODE_PLANS[mode]
    pl = plan()
    props = torch.cuda.get_device_properties(dev)
    assert pl.threads == 288 and pl.smem <= 232448
    assert pl.blocks_per_sm >= per_sm
    assert pl.sms == props.multi_processor_count
    assert pl.wave == pl.blocks_per_sm * pl.sms


@pytest.mark.parametrize("N", ["1", "33", "wave", "wave+1", "8192"])
@pytest.mark.parametrize("mode", ["q8", "im2col"])
def test_serving_mode_kernels_match_plain_across_waves(dev, mode, N):
    """A frame a block, one wave, one wave and a frame, and the serving
    batch (where each block walks many frames), standardize off and on
    (im2col)."""
    n = eval(N, {"wave": _MODE_PLANS[mode][0]().wave})
    g = torch.Generator().manual_seed(n)
    roi = torch.randint(0, 256, (n, 48, 96), generator=g, dtype=torch.uint8)
    roi[n // 2] = 255
    roi, p = roi.to(dev), _cnn_params(dev, n % 89)
    packed = {"q8": cuda_cnn_q8.quantize_roi_cnn,
              "im2col": cuda_cnn_im2col.pack_im2col}[mode](p)
    for std, bar in zip((False, True), _MODE_BARS[mode]):
        if bar is None:
            continue
        got = _mode_call(mode, roi, p, std, packed=packed)
        ref = _mode_call(mode, roi, p, std, impl="plain", packed=packed)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, ref, atol=bar, rtol=0)


@pytest.mark.parametrize("standardize", [False, True])
def test_im2col_kernel_rows_do_not_depend_on_the_batch(dev, standardize):
    """Bitwise: frames launched alone equal the same frames in a batch of
    two waves and a frame (other blocks, at other steps of their walk), and
    two launches are equal."""
    wave = cuda_cnn_im2col.plan().wave
    roi = torch.randint(0, 256, (2 * wave + 1, 48, 96), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(8)).to(dev)
    roi[40] = 0
    p = _cnn_params(dev, 8)
    w = cuda_cnn_im2col.pack_im2col(p)
    call = lambda r: cuda_cnn_im2col.roi_cnn_im2col(
        r.contiguous(), p, standardize=standardize, packed=w)
    whole = call(roi)
    assert torch.equal(whole, call(roi))
    for lo, hi in ((0, 1), (64, 65), (10, 43), (2 * wave - 2, 2 * wave + 1)):
        assert torch.equal(call(roi[lo:hi]), whole[lo:hi]), (lo, hi)


@pytest.mark.parametrize("standardize", [False, True])
@pytest.mark.parametrize("stop", ["load", "norm", "conv1", "conv2", "conv3"])
def test_im2col_debug_stop_matches_plain(dev, stop, standardize):
    """K5's stops write K1's moments (cuda_cnn.roi_cnn_debug_plain) of its
    own buffers, read in the plain version's order: within 1e-5 of each
    moment's sum of absolute terms, as K1's stops."""
    g = torch.Generator().manual_seed(17)
    roi = torch.randint(0, 256, (9, 48, 96), generator=g, dtype=torch.uint8)
    roi = roi.to(dev)
    p = _cnn_params(dev, 17)
    before = _kernels.launch_counts()
    got = cuda_cnn_im2col.roi_cnn_im2col(roi, p, standardize=standardize,
                                         debug_stop=stop)
    torch.cuda.synchronize()
    after = _kernels.launch_counts()
    assert {n for n in after if after[n] != before[n]} == \
        {"roi_cnn_im2col_debug"}
    ref = cuda_cnn.roi_cnn_debug_plain(roi, p, standardize, stop)
    bar = 1e-5 * cuda_cnn.roi_cnn_debug_plain(roi, p, standardize, stop,
                                              absolute=True)
    assert torch.isfinite(got).all()
    assert ((got - ref).abs() <= bar).all(), (got - ref).abs().max().item()


@pytest.mark.parametrize("stop", [None, "stage1", "stage2", "stage3"])
def test_q8_check_entry_matches_plain(dev, stop):
    """K4's check entry: without a stop its output is bitwise the serving
    kernel's; its stops hold the moments of each stage's ReLU output
    (bitwise the plain version's values, f32 sums of up to 9,216 terms)
    within 1e-5 of each moment's sum of |terms|."""
    g = torch.Generator().manual_seed(19)
    roi = torch.randint(0, 256, (70, 48, 96), generator=g, dtype=torch.uint8)
    roi[3] = 255
    roi, p = roi.to(dev), _cnn_params(dev, 19)
    q = cuda_cnn_q8.quantize_roi_cnn(p)
    got = cuda_cnn_q8.roi_cnn_q8_entry(roi, p, q, stop=stop)
    if stop is None:
        assert torch.equal(got, cuda_cnn_q8.roi_cnn_q8(roi, p, packed=q))
        return
    ref = cuda_cnn_q8.roi_cnn_q8_debug_plain(roi, q, stop)
    bar = 1e-5 * cuda_cnn_q8.roi_cnn_q8_debug_plain(roi, q, stop,
                                                     absolute=True)
    assert torch.isfinite(got).all()
    assert ((got - ref).abs() <= bar).all(), (got - ref).abs().max().item()


@pytest.mark.parametrize("mode", ["bf16", "q8", "im2col"])
def test_serving_mode_kernel_rejects_what_it_does_not_take(dev, mode):
    p = _cnn_params(dev, 3)
    roi = torch.zeros((4, 48, 96), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="uint8"):
        _mode_call(mode, roi.float(), p, False)
    with pytest.raises(ValueError, match="contiguous"):
        _mode_call(mode, roi[::2], p, False)
    off = torch.zeros(4 * 48 * 96 + 1, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="aligned"):  # 16-byte copies
        _mode_call(mode, off[1:].view(4, 48, 96), p, False)
    with pytest.raises(ValueError, match="48x96"):
        _mode_call(mode, torch.zeros((2, 40, 96), dtype=torch.uint8,
                                     device=dev), p, False)
    with pytest.raises(ValueError, match="f32"):
        _mode_call(mode, roi, _cnn_params("cpu", 3), False)
    bad = {"bf16": cuda_cnn.flat_weights_bf16(p)[:-1],
           "q8": {"qi": cuda_cnn_q8.quantize_roi_cnn(p)["qi"][:-1],
                  "qf": cuda_cnn_q8.quantize_roi_cnn(p)["qf"]},
           "im2col": cuda_cnn_im2col.pack_im2col(p).double()}[mode]
    with pytest.raises(ValueError):
        _mode_call(mode, roi, p, False, packed=bad)
    if mode == "q8":
        with pytest.raises(ValueError, match="serving-only"):
            _mode_call(mode, roi, p, True)
    assert _mode_call(mode, roi[:0], p, False).shape == (0, 32)


@pytest.mark.parametrize("knobs,kernel", [
    ({"compute_dtype": "bfloat16"}, "roi_cnn_bf16"),
    ({"roi_variant": "tiled3_q8"}, "roi_cnn_q8"),
    ({"roi_variant": "im2col"}, "roi_cnn_im2col"),
    ({"roi_variant": "tiled3_q8", "compute_dtype": "bfloat16"}, "roi_cnn_q8"),
])
def test_predictor_serving_mode_kernels_match_plain(dev, knobs, kernel):
    """Each mode's Predictor through its kernels against the same mode's
    plain path on the card (the GRU kernel's 1e-4 and the CNN's bars carry
    through a narrow model to well under 1e-3 on the logits)."""
    cfg = BiGRUConfig(x_dim=12, num_classes=5, hidden=16, roi_emb=8,
                      head_hidden=8)
    model = BiGRUClassifier.from_jax_params(
        init_params(cfg, torch.Generator().manual_seed(9)), cfg)
    rng = np.random.default_rng(9)
    X = rng.standard_normal((6, 20, 12)).astype(np.float32)
    L = np.array([20, 5, 11, 20, 1, 17], np.int32)
    R = rng.integers(0, 256, (6, 20, 48, 96), dtype=np.uint8)
    labels = dict(enumerate("abcde"))
    _kernels.reset_launch_counts()
    got = Predictor(model=model, id_to_label=labels, device="cuda",
                    **knobs).predict_batch(X, L, R)
    counts = _kernels.launch_counts()
    assert counts[kernel] == 1 and counts["gru_seq"] == 2
    assert counts["gru_proj"] == 2 and sum(counts.values()) == 5
    ref = Predictor(model=model, id_to_label=labels, device="cuda",
                    roi_impl="plain", gru_impl="plain",
                    **knobs).predict_batch(X, L, R)
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)
    assert (got.argmax(-1) == ref.argmax(-1)).all()


# the variant families at their full widths: family, init arguments, T
_VARIANTS = [("ReducedBiGRU", dict(d_in=83, num_classes=5), 60),
             ("ReducedBiGRU", dict(d_in=180, num_classes=5), 60),
             ("GRUWordClassifier", dict(d_in=83, num_classes=20), 60),
             ("UniGRUClassifier", dict(d_in=166, num_classes=10), 32),
             ("UniGRUClassifier", dict(d_in=360, num_classes=10), 32)]


@pytest.mark.parametrize("cls,kw,T", _VARIANTS,
                         ids=[f"{c}-{k['d_in']}" for c, k, _ in _VARIANTS])
def test_variant_predictor_kernels_match_plain(dev, cls, kw, T):
    """A variant family's VariantPredictor on K2 (gru_proj and gru_seq, one
    launch each a layer and clip) against gru_impl='plain' on the card at
    chip_smoke.py's bars: logits within 1e-3 with the same argmax, the
    GRU's outputs within 1e-4 at B=1 and at the validation's B=64."""
    from silent_speech_tpu_torch.infer.variant_predictor import \
        VariantPredictor
    from silent_speech_tpu_torch.models import variants as V

    model = getattr(V, cls).init(torch.Generator().manual_seed(T), **kw)
    labels = {i: f"w{i}" for i in range(kw["num_classes"])}
    pred = VariantPredictor(model, labels, kw["d_in"], T, device="cuda")
    plain = VariantPredictor(model, labels, kw["d_in"], T, device="cuda",
                             gru_impl="plain")
    rng = np.random.default_rng(T)
    layers = model.gru.num_layers
    for n in (5, T, 90):
        X = rng.standard_normal((n, kw["d_in"])).astype(np.float32)
        _kernels.reset_launch_counts()
        got = pred.logits(X)
        counts = _kernels.launch_counts()
        assert counts["gru_proj"] == counts["gru_seq"] == layers
        assert sum(counts.values()) == 2 * layers
        want = plain.logits(X)
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
        assert got.argmax() == want.argmax()
    for B in (1, 64):
        x = torch.from_numpy(rng.standard_normal(
            (B, T, kw["d_in"])).astype(np.float32)).to(dev)
        with torch.inference_mode():
            torch.testing.assert_close(
                model.run_gru(x, gru_impl="kernel"),
                model.run_gru(x, gru_impl="plain"), atol=1e-4, rtol=0)


# ----------------------------------------------- the GRU probes' kernels

# chip_smoke.py's bars: f32 as K2; with bf16_mm an h within one f32 sum
# order of a bf16 rounding boundary rounds one bf16 step apart in the kernel
# and its plain version, which moves the next step's product by up to
# max|Wh| * 2^-8 * |h| (about 1e-3 here)
_PROBE_BARS = {False: 1e-4, True: 2e-3}


def _probe_problem(dev, B, T, D, H, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, T, D, generator=g)
    lengths = torch.randint(1, T + 1, (B,), generator=g)
    lengths[0] = T
    lengths[-1] = 1
    if B > 2:
        lengths[1] = 0
    ps = [{k: v.to(dev) for k, v in gru_dir_init(D, H, g).items()}
          for _ in range(2)]
    return x.to(dev), lengths.to(dev), ps


def _assert_zero_past(y: torch.Tensor, lengths: torch.Tensor) -> None:
    L = lengths.cpu()
    for b in range(y.shape[0]):
        assert not y[b, int(L[b]):].any(), b


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("B", [1, 33, 512])
@pytest.mark.parametrize("sets", [1, 2])
def test_recurrence_kernel_matches_plain(dev, sets, B, bf16):
    """At the plan's tile, one launch a call, y zero past each length."""
    T, D, H = 32, 180, 192
    x, lengths, ps = _probe_problem(dev, B, T, D, H, B + 10 * sets)
    xps = [x @ p["wi"] + p["bi"] for p in ps[:sets]]
    xp, L = torch.cat(xps), lengths.repeat(sets)
    wh = torch.stack([p["wh"] for p in ps[:sets]])
    bh = torch.stack([p["bh"] for p in ps[:sets]])
    kernel = cuda_gru_proto.KSTEP if sets == 1 else cuda_gru_proto.KSTEP_2W
    before = _kernels.launch_counts()
    if sets == 1:
        got = cuda_gru_proto.gru_sequence_kstep(xp, L, wh[0], bh[0],
                                                bf16_mm=bf16)
    else:
        got = cuda_gru_proto.gru_sequence_kstep_2w(xp, L, wh, bh,
                                                   bf16_mm=bf16)
    torch.cuda.synchronize()
    after = _kernels.launch_counts()
    assert {n for n in after if after[n] != before[n]} == {kernel.name}
    assert after[kernel.name] == before[kernel.name] + 1
    ref = torch.cat([cuda_gru_proto.gru_recurrence_plain(
        xps[s], lengths, wh[s], bh[s], bf16) for s in range(sets)])
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=_PROBE_BARS[bf16], rtol=0)
    _assert_zero_past(got, L)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("D", [180, 384])
@pytest.mark.parametrize("B", [1, 33, 512])
def test_dual_kernel_matches_plain(dev, B, D, bf16):
    """At the plan's tile and chunk, one launch a call, y zero past each
    length."""
    T, H = 32, 192
    x, lengths, (pf, pb) = _probe_problem(dev, B, T, D, H, B + D)
    x_flip = gru_ops.flip_padded(x, lengths)
    before = _kernels.launch_counts()
    got = cuda_gru_proto.gru_layer_dual(x, x_flip, lengths, pf, pb,
                                        bf16_mm=bf16)
    torch.cuda.synchronize()
    after = _kernels.launch_counts()
    assert {n for n in after if after[n] != before[n]} == {"gru_dual"}
    assert cuda_gru_proto.DUAL.launches == before["gru_dual"] + 1
    ref = cuda_gru_proto.gru_layer_dual_plain(x, x_flip, lengths, pf, pb,
                                              bf16)
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, r, atol=_PROBE_BARS[bf16], rtol=0)
        _assert_zero_past(g, lengths)


@pytest.mark.parametrize("bf16", [False, True])
def test_probe_kernels_repeat_bitwise(dev, bf16):
    """Two calls on the same inputs give the same bits, at tiles of each
    body (1 and 2 rows: split; 4 n: tiled)."""
    x, lengths, (pf, pb) = _probe_problem(dev, 70, 32, 180, 192, 8)
    xp = x @ pf["wi"] + pf["bi"]
    x_flip = gru_ops.flip_padded(x, lengths)
    for tile in (None, 1, 2, 16):
        a, b = (cuda_gru_proto.gru_sequence_kstep(
            xp, lengths, pf["wh"], pf["bh"], batch_tile=tile, bf16_mm=bf16)
            for _ in range(2))
        assert torch.equal(a, b), tile
        a, b = (cuda_gru_proto.gru_layer_dual(
            x, x_flip, lengths, pf, pb, batch_tile=tile, bf16_mm=bf16)
            for _ in range(2))
        assert all(torch.equal(u, v) for u, v in zip(a, b)), tile


def test_probe_kernels_f32_do_not_depend_on_the_knobs(dev):
    """Every row's sums run in the same order whatever the tile (the split
    and the tiled body) and the chunk: the f32 outputs are bitwise equal
    across the knobs, at a small width and at full width."""
    for B, T, D, H in ((37, 20, 24, 64), (70, 32, 180, 192)):
        x, lengths, (pf, pb) = _probe_problem(dev, B, T, D, H, 3)
        xp = x @ pf["wi"] + pf["bi"]
        x_flip = gru_ops.flip_padded(x, lengths)
        rec = [cuda_gru_proto.gru_sequence_kstep(
            xp, lengths, pf["wh"], pf["bh"], batch_tile=bt, k_steps=k)
            for bt, k in ((8, 8), (1, 1), (16, 3), (2, 20), (4, 32),
                          (32, 8), (64, 8), (None, 8))]
        dual = [cuda_gru_proto.gru_layer_dual(x, x_flip, lengths, pf, pb,
                                              batch_tile=bt, k_steps=k)
                for bt, k in ((8, 8), (1, 1), (4, 3), (2, 32), (16, 4),
                              (32, 1), (None, 8), (None, None))]
        ref = cuda_gru_proto.gru_recurrence_plain(xp, lengths, pf["wh"],
                                                  pf["bh"])
        for y in rec:
            torch.testing.assert_close(y, ref, atol=1e-4, rtol=0)
        ref = cuda_gru_proto.gru_layer_dual_plain(x, x_flip, lengths, pf, pb)
        for y in dual:
            for g, r in zip(y, ref):
                torch.testing.assert_close(g, r, atol=1e-4, rtol=0)
        for y in rec[1:]:
            assert torch.equal(y, rec[0]), (y - rec[0]).abs().max().item()
        for y in dual[1:]:
            for g, r in zip(y, dual[0]):
                assert torch.equal(g, r), (g - r).abs().max().item()


@pytest.mark.parametrize("bf16", [False, True])
def test_probe_plans_are_the_mirrors(dev, bf16):
    """The kernels' plans (gru_rec_plan, gru_dual_plan) lay the block out
    as ops/cuda_gru_proto's mirror does, and choose the tile (and the dual
    kernel's chunk) the mirror chooses given the card's co-resident
    clusters; a given tile and chunk are taken as they are."""
    H, T = 192, 32
    for B in (1, 33, 512):
        for sets in (1, 2):
            pl = cuda_gru_proto.rec_plan(B, sets, H, bf16_mm=bf16)
            g = cuda_gru_proto.rec_geometry(H, pl.BT, bf16)
            assert pl[:5] + (pl.threads, pl.smem) == \
                (g.C, g.U, g.Up, g.Hk, g.BT, g.threads, g.smem)
            cap = lambda g: cuda_gru_proto.rec_plan(
                B, sets, H, g.BT, bf16).clusters
            assert cuda_gru_proto.choose_tile(
                B, sets, lambda t: cuda_gru_proto.rec_geometry(H, t, bf16),
                cap).BT == pl.BT
            assert pl.blocks == pl.C * -(-B // pl.BT) * sets
        for D in (180, 384):
            pl = cuda_gru_proto.dual_plan(B, D, H, T, bf16_mm=bf16)
            g = cuda_gru_proto.dual_geometry(D, H, pl.BT, pl.K, bf16)
            assert pl[:5] + (pl.threads, pl.smem) == \
                (g.C, g.U, g.Up, g.Hk, g.BT, g.threads, g.smem)
            cap = lambda g, k: cuda_gru_proto.dual_plan(
                B, D, H, T, g.BT, k, bf16).clusters
            g, k = cuda_gru_proto.choose_chunk(B, D, H, T, cap, bf16)
            assert (g.BT, k) == (pl.BT, pl.K)
    pl = cuda_gru_proto.dual_plan(512, 180, H, T, 4, 8)
    assert (pl.BT, pl.K) == (4, 8)


def test_probe_kernels_refuse_what_they_do_not_take(dev):
    x, lengths, (pf, pb) = _probe_problem(dev, 4, 6, 8, 16, 4)
    xp = x @ pf["wi"] + pf["bi"]
    with pytest.raises(RuntimeError, match="no backward"):
        cuda_gru_proto.gru_sequence_kstep(
            xp, lengths, pf["wh"].clone().requires_grad_(), pf["bh"])
    with pytest.raises(RuntimeError, match="no backward"):
        cuda_gru_proto.gru_layer_dual(x.clone().requires_grad_(), x, lengths,
                                      pf, pb)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_gru_proto.gru_sequence_kstep(xp.transpose(0, 1).contiguous()
                                          .transpose(0, 1), lengths,
                                          pf["wh"], pf["bh"])
    with pytest.raises(ValueError, match="f32"):
        cuda_gru_proto.gru_layer_dual(x.double(), x.double(), lengths, pf,
                                      pb)
    with pytest.raises(ValueError, match="batch_tile"):
        cuda_gru_proto.gru_layer_dual(x, x, lengths, pf, pb, batch_tile=128)
    xw, lw, (qf, qb) = _probe_problem(dev, 64, 8, 384, 192, 5)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_gru_proto.gru_layer_dual(xw, xw, lw, qf, qb, batch_tile=64)
    before = cuda_gru_proto.DUAL.launches
    yw = torch.empty((2, 64, 8, 192), device=dev)
    with pytest.raises(RuntimeError, match="gru_dual_forward"):
        # past the mirror's check, the kernel's own refusal (a 64-row tile
        # at D=384): CUDA error, no launch counted
        cuda_gru_proto.DUAL.launch(*(_kernels.ptr(t) for t in (
            xw, xw, lw.int(), qf["wi"], qf["bi"], qf["wh"], qf["bh"],
            qb["wi"], qb["bi"], qb["wh"], qb["bh"], yw[0], yw[1])),
            64, 8, 384, 192, 64, 8, 0, _kernels.stream_ptr(xw.device))
    assert cuda_gru_proto.DUAL.launches == before
    y = cuda_gru_proto.gru_sequence_kstep(xp[:0], lengths[:0], pf["wh"],
                                          pf["bh"])
    assert y.shape == (0, 6, 16)


def test_k2_outputs_bitwise_the_parent_tree(dev):
    """K2's serving stack at B=1, 256 and 1024 bitwise the parent commit's
    (the cluster recurrence's bodies moved into csrc/gru_cluster.cuh), both
    trees in turns in one run: SST_PARENT_TREE names a checkout of the
    parent (git archive)."""
    parent = os.environ.get("SST_PARENT_TREE")
    if not parent:
        pytest.skip("SST_PARENT_TREE names no parent checkout")
    import chip_smoke

    times = chip_smoke.k2_against_parent(pathlib.Path(parent).resolve(), "")
    assert set(times) == set(chip_smoke.K2_B)


# ---------------------------------------------- the CNN-front prototypes


def _parity_inputs(dev, N, kind, seed, const=None):
    """Class arrays of N frames (the last two all-0 and all-255 when
    ``const``) and packed or random (unpacked) WE, WO, bias."""
    rng = np.random.default_rng(seed)
    roi = rng.integers(0, 256, (N, 48, 96), dtype=np.uint8)
    if const:
        roi[-2], roi[-1] = 0, 255
    if kind == "packed":
        w = cuda_parity_cnn.pack_parity_conv1(
            rng.standard_normal((3, 3, 1, 8)).astype(np.float32) * 0.3,
            rng.standard_normal(8).astype(np.float32) * 0.1)
    else:
        w = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for s in ((104, 128), (104, 128), (1, 384))]
    roi = torch.from_numpy(roi).to(dev)
    return roi, cuda_parity_cnn.split_classes(roi), [t.to(dev) for t in w]


def _parity_close(got, ref, kind):
    """Packed: the scripts' f32 bar 1e-4; random weights (outputs in the
    thousands): max|err| / max|ref| <= 1e-6."""
    assert torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    if kind == "packed":
        assert err <= 1e-4, err
    else:
        assert err <= 1e-6 * ref.abs().max().item(), err


@pytest.mark.parametrize("kind", ["packed", "random"])
@pytest.mark.parametrize("N", [16, 48])
def test_parity_kernel_matches_plain(dev, N, kind):
    """Both layouts against the plain version (N=48: a partial group of 8
    frames for some blocks), a second launch bitwise the first."""
    roi, xs, w = _parity_inputs(dev, N, kind, N, const=True)
    before = _kernels.launch_counts()
    halves = cuda_parity_cnn.conv1pool1_parity(*xs, *w)
    one = cuda_parity_cnn.conv1pool1(*[x.reshape(-1, 96) for x in xs], *w)
    torch.cuda.synchronize()
    after = _kernels.launch_counts()
    assert {n: after[n] - before[n] for n in after
            if after[n] != before[n]} == {"conv1pool1_parity": 1,
                                          "conv1pool1": 1}
    again = cuda_parity_cnn.conv1pool1_parity(*xs, *w)
    for a, b in zip(again, halves):
        assert torch.equal(a, b)
    ref = cuda_parity_cnn.parity_halves_plain(xs, *w)
    for g, r in zip(halves, ref):
        _parity_close(g, r, kind)
    _parity_close(one, cuda_parity_cnn.pooled1_from_quadrants(ref, N), kind)
    assert torch.equal(one, cuda_parity_cnn.pooled1_from_quadrants(
        halves, N))
    if kind == "packed":
        _parity_close(one, cuda_parity_cnn.ref_conv1pool1(
            roi, *_conv0_of(w, dev)), kind)


def _conv0_of(w, dev):
    """Recover (k, b) from packed WE and bias: WE[dy*34 + dx, co] holds
    k[dy, dx, 0, co] / 255 (t = 0)."""
    WE, _, bias = (t.cpu() for t in w)
    k = torch.stack([torch.stack([WE[dy * 34 + dx, :8] for dx in range(3)])
                     for dy in range(3)])[:, :, None, :] * 255.0
    return k.to(dev), bias[0, :8].to(dev)


def test_parity_ablation_full_is_the_kernel_bitwise(dev):
    """Every stop runs (finite values of the outputs' shapes); ``full`` is
    the kernel, bitwise."""
    roi, xs, w = _parity_inputs(dev, 32, "random", 5)
    flat = [x.reshape(-1, 96) for x in xs]
    pp = cuda_parity_cnn.conv1pool1_parity(*xs, *w)
    before = cuda_parity_cnn.ABLATE.launches
    full = cuda_parity_cnn.run(*flat, *w, mode="full")
    for mode in ("io_only", "widen_only", "halo_only", "no_dot"):
        out = cuda_parity_cnn.run(*flat, *w, mode=mode)
        assert [o.shape for o in out] == [(32 * 12, 384)] * 2
        assert all(torch.isfinite(o).all() for o in out)
    torch.cuda.synchronize()
    assert cuda_parity_cnn.ABLATE.launches == before + 5
    for a, b in zip(full, pp):
        assert torch.equal(a, b)


def test_parity_kernel_refuses_what_it_does_not_take(dev):
    _, xs, w = _parity_inputs(dev, 16, "packed", 1)
    with pytest.raises(ValueError, match="multiple of 16"):
        cuda_parity_cnn.conv1pool1_parity(*[x[:8] for x in xs], *w)
    with pytest.raises(ValueError, match="WE"):
        cuda_parity_cnn.conv1pool1_parity(*xs, w[0].double(), *w[1:])
    with pytest.raises(ValueError, match="must be on"):
        cuda_parity_cnn.conv1pool1_parity(*xs, w[0].cpu(), *w[1:])
    with pytest.raises(ValueError, match="counterpart"):
        cuda_parity_cnn.run(*[x.reshape(-1, 96) for x in xs], *w,
                            mode="no_patch")


@pytest.mark.parametrize("stage,F", [("dma", 1), ("dma", 2), ("dma", 4),
                                     ("widen", 1), ("front", 1),
                                     ("front_std", 1), ("overlap_a", 1),
                                     ("overlap_b", 1)])
def test_front_probe_stage_matches_plain(dev, stage, F):
    rng = np.random.default_rng(F)
    roi = rng.integers(0, 256, (36, 48, 96), dtype=np.uint8)
    roi[0], roi[1] = 0, 255
    x = torch.from_numpy(roi.reshape(-1, 384))
    if stage == "overlap_b":
        x = torch.from_numpy(roi[:, 5, :4].copy())
    before = cuda_front_probe.PROBE.launches
    got = cuda_front_probe.probe(stage, x.to(dev), F)
    torch.cuda.synchronize()
    assert cuda_front_probe.PROBE.launches == before + 1
    want = cuda_front_probe.probe_plain(stage, x, F)
    err = (got.cpu().double() - want.double()).abs()
    assert (err <= cuda_front_probe.bar(stage, x, F).double()).all(), \
        err.max().item()


@pytest.mark.parametrize("stage", list(cuda_front_probe.LADDER))
def test_front_probe_ladder_at_ragged_n(dev, stage):
    """The ladder's persistent kernel at N 1 and just below and above one
    wave of its blocks (multiples of 16): one launch a call, every frame
    within the bar, a second launch bitwise the first; its plan, every
    rung's, the mirror's."""
    pl = cuda_front_probe.plan()
    assert (pl.slots, pl.smem, pl.threads) == cuda_front_probe.ring_geometry()
    assert pl.blocks >= pl.sms
    rng = np.random.default_rng(len(stage))
    for n in (1, 16 * ((pl.blocks - 1) // 16), 16 * (pl.blocks // 16 + 1)):
        roi = rng.integers(0, 256, (n, 48, 96), dtype=np.uint8)
        roi[0, :4] = 255
        x = torch.from_numpy(roi.reshape(-1, 384))
        before = cuda_front_probe.PROBE.launches
        got = cuda_front_probe.probe(stage, x.to(dev))
        torch.cuda.synchronize()
        assert cuda_front_probe.PROBE.launches == before + 1
        want = cuda_front_probe.probe_plain(stage, x)
        err = (got.cpu().double() - want.double()).abs()
        assert (err <= cuda_front_probe.bar(stage, x).double()).all(), n
        assert torch.equal(got, cuda_front_probe.probe(stage, x.to(dev))), n


@pytest.mark.parametrize("mode", ["int8", "int8i"])
@pytest.mark.parametrize("K", cuda_dot_chain.KS)
def test_dot_chain_s8_bitwise_plain_at_ragged_steps(dev, mode, K):
    """DC-s8 at 1 step and at one step more than a sweep of its persistent
    grid holds (a partial last sweep): the check instantiation's output and
    moments bitwise the plain chain's, the timed one bitwise the checked
    one (cuda_dot_chain.check), repeats bitwise; its plan the mirror's."""
    pl = cuda_dot_chain.plan(K, mode=mode)
    geo = cuda_dot_chain.s8_geometry(K)
    assert (pl.cluster, pl.stages, pl.smem, pl.chunk, pl.threads) == (
        geo.cluster, 1, geo.smem, geo.w_bytes, cuda_dot_chain.S8_THREADS)
    assert pl.sms_used == pl.clusters * pl.cluster <= pl.sms
    w = cuda_dot_chain.make_weights(mode, K).to(dev)
    packed = cuda_dot_chain.pack_weights(w, mode)
    slots = pl.clusters * cuda_dot_chain.S8_WARPGROUPS
    for steps in (1, slots // cuda_dot_chain.TILES + 1):
        x = torch.from_numpy(np.random.default_rng(steps).integers(
            0, 256, (steps * 8, 128), dtype=np.uint8)).to(dev)
        r = cuda_dot_chain.check(x, w, mode, packed=packed)
        assert r["share_of_bar"] == 0.0
        runs = [cuda_dot_chain.dot_chain(x, w, mode, packed=packed,
                                         check=True) for _ in range(2)]
        assert torch.equal(runs[0][0], runs[1][0])
        assert torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("standardize", [False, True])
@pytest.mark.parametrize("stop", ["load", "norm", "conv1", "conv2", "conv3"])
def test_roi_cnn_debug_stop_matches_plain(dev, stop, standardize):
    """Each row holds three moments of the stage (sum, sum of squares,
    index-weighted sum): f32 sums of 4,608 to 10,400 terms against float64,
    within 1e-5 of each moment's sum of absolute terms."""
    g = torch.Generator().manual_seed(7)
    roi = torch.randint(0, 256, (9, 48, 96), generator=g, dtype=torch.uint8)
    roi = roi.to(dev)
    p = _cnn_params(dev, 7)
    before = _kernels.launch_counts()
    got = cuda_cnn.roi_cnn_fused(roi, p, standardize=standardize,
                                 debug_stop=stop)
    torch.cuda.synchronize()
    after = _kernels.launch_counts()
    assert {n for n in after if after[n] != before[n]} == {"roi_cnn_debug"}
    ref = cuda_cnn.roi_cnn_debug_plain(roi, p, standardize, stop)
    bar = 1e-5 * cuda_cnn.roi_cnn_debug_plain(roi, p, standardize, stop,
                                              absolute=True)
    assert torch.isfinite(got).all()
    assert ((got - ref).abs() <= bar).all(), (got - ref).abs().max().item()


@pytest.mark.parametrize("script", ["proto_parity_cnn", "proto_parity_e2e",
                                    "proto_ablate", "probe_front"])
def test_cnn_front_script_main_on_the_card(dev, script, capsys):
    import importlib
    mod = importlib.import_module(f"silent_speech_tpu_torch.scripts.{script}")
    _kernels.reset_launch_counts()
    out = mod.main(["64", "iters=2"])
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    assert out["timer"] == "cuda events" and out["N"] == 64
    want = {"proto_parity_cnn": ["conv1pool1_parity"],
            "proto_parity_e2e": ["conv1pool1", "roi_cnn"],
            "proto_ablate": ["parity_ablate"],
            "probe_front": ["roi_front_probe", "roi_cnn", "roi_cnn_debug"]}
    assert all(counts[k] > 0 for k in want[script]), counts
    assert all(r["ms"] is not None for r in out["rows"]
               if "no counterpart" not in r.get("note", ""))


# ------------------------------------------------ the forward rate probes


@pytest.mark.parametrize("M,K,N,reps,grid", [
    (16, 24, 16, 9, 2), (70, 104, 130, 9, 2), (1, 8, 1, 1, 1),
    (192, 104, 128, 64, 3)])
def test_mm_rate_kernel_matches_plain(dev, M, K, N, reps, grid):
    a, b = cuda_mm_rate.make_problem(M, K, N, dev)
    before = cuda_mm_rate.KERNEL.launches
    r = cuda_mm_rate.check(a, b, reps, grid)
    torch.cuda.synchronize()
    assert cuda_mm_rate.KERNEL.launches == before + 1
    assert r["share_of_bar"] <= 1.0


@pytest.mark.parametrize("M,K,N,reps,grid", [
    (M, K, N, cuda_mm_rate.REPS, cuda_mm_rate.GRID)
    for M, K, N, _ in cuda_mm_rate.SHAPES] + [
    (16, 24, 16, 9, 2), (70, 104, 130, 9, 2), (192, 104, 128, 9, 2)])
def test_mm_rate_plan_repeats_and_bar(dev, M, K, N, reps, grid):
    """MR at the probe's six shapes and the small ragged ones: within its
    bar of the plain version, two launches and both column tiles bitwise
    equal, the launch plan its Python mirror's."""
    a, b = cuda_mm_rate.make_problem(M, K, N, dev)
    with full_f32():
        assert cuda_mm_rate.check(a, b, reps, grid)["share_of_bar"] <= 1.0
    first = cuda_mm_rate.mm_rate(a, b, reps, grid)
    assert torch.equal(first, cuda_mm_rate.mm_rate(a, b, reps, grid))
    for bn in cuda_mm_rate.BNS:  # every column tile: the same sums
        assert torch.equal(first, cuda_mm_rate.mm_rate(a, b, reps, grid,
                                                       bn=bn))
    pl = cuda_mm_rate.plan(M, K, N, grid)
    geo = cuda_mm_rate.geometry(M, K, N, grid)
    assert (pl.bn, pl.items, pl.smem, pl.stages, pl.threads) == (
        geo.bn, geo.items, geo.smem, geo.stages, geo.threads)
    assert 1 <= pl.blocks == min(pl.items, pl.slots)


@pytest.mark.parametrize("K", cuda_dot_chain.KS)
def test_dot_chain_f32_plan_repeats_and_stops(dev, K):
    """DC-f32 at 3 and 256 steps: within BAR_F32 of the plain chain, two
    launches bitwise equal, its launch plan its Python mirror's; its three
    timing stops launch, count apart and compute other values."""
    w = cuda_dot_chain.make_weights("f32", K).to(dev)
    packed = cuda_dot_chain.pack_weights(w, "f32")
    for steps in (3, 256):
        x = torch.from_numpy(np.random.default_rng(K + steps).integers(
            0, 256, (steps * 8, 128), dtype=np.uint8)).to(dev)
        with full_f32():
            cuda_dot_chain.check(x, w, "f32", packed=packed)
        want = cuda_dot_chain.dot_chain(x, w, "f32", packed=packed)
        assert torch.equal(cuda_dot_chain.dot_chain(x, w, "f32",
                                                    packed=packed), want)
    pl = cuda_dot_chain.plan(K, mode="f32")
    geo = cuda_dot_chain.f32_geometry(K)
    assert (pl.cluster, pl.stages, pl.smem, pl.chunk) == (
        geo.cluster, geo.units, geo.smem, geo.unit)
    assert pl.threads == 256 and pl.clusters >= 1
    assert pl.sms_used == pl.clusters * pl.cluster <= pl.sms
    before = cuda_dot_chain.KERNEL.launches
    stops = cuda_dot_chain.KERNEL_F32_STOP.launches
    for stop in cuda_dot_chain.F32_STOPS:
        got = cuda_dot_chain.dot_chain_f32_stop(x, w, stop, packed=packed)
        torch.cuda.synchronize()
        assert got.shape == want.shape and not torch.equal(got, want), stop
    assert cuda_dot_chain.KERNEL.launches == before
    assert cuda_dot_chain.KERNEL_F32_STOP.launches == stops + 3


@pytest.mark.parametrize("mode", cuda_dot_chain.MODES)
@pytest.mark.parametrize("K", cuda_dot_chain.KS)
def test_dot_chain_kernel_matches_plain(dev, mode, K):
    rng = np.random.default_rng(K)
    x = torch.from_numpy(rng.integers(0, 256, (3 * 8, 128),
                                      dtype=np.uint8)).to(dev)
    x[:8] = 255  # the largest seed
    w = cuda_dot_chain.make_weights(mode, K).to(dev)
    before = cuda_dot_chain.KERNEL.launches
    cuda_dot_chain.check(x, w, mode)  # the check and timed instantiations
    torch.cuda.synchronize()
    assert cuda_dot_chain.KERNEL.launches == before + 2
    timed = cuda_dot_chain.dot_chain(x, w, mode)
    want = cuda_dot_chain.output_of(cuda_dot_chain.chain_plain(x, w, mode))
    if mode.startswith("int8"):
        assert torch.equal(timed, want)
    if mode == "bf16":  # chains held in f32 or f16 fail the rounding check
        for keep in (torch.float32, torch.float16):
            assert cuda_dot_chain.rounding_outside(
                cuda_dot_chain.trace_plain(x, w, keep), x, w) > 0


@pytest.mark.parametrize("K", cuda_dot_chain.KS)
@pytest.mark.parametrize("steps", [1, 3, 256])
def test_dot_chain_bf16_every_cluster_is_the_check(dev, K, steps):
    """The bf16 chain at 1, 3 and 256 steps: the check instantiation
    against the plain version, its trace's rounding (the f32- and f16-held
    controls fail it), and the timed output of every cluster size bitwise
    the checked one."""
    rng = np.random.default_rng(K + steps)
    x = torch.from_numpy(rng.integers(0, 256, (steps * 8, 128),
                                      dtype=np.uint8)).to(dev)
    w = cuda_dot_chain.make_weights("bf16", K).to(dev)
    packed = cuda_dot_chain.pack_weights(w, "bf16")
    cuda_dot_chain.check(x, w, "bf16", packed=packed)
    out, _, trace = cuda_dot_chain.dot_chain(x, w, "bf16", packed=packed,
                                             check=True)
    for keep in (torch.float32, torch.float16):
        assert cuda_dot_chain.rounding_outside(
            cuda_dot_chain.trace_plain(x, w, keep), x, w) > 0
    assert cuda_dot_chain.rounding_outside(trace, x, w) == 0
    for c in cuda_dot_chain.BF16_CLUSTERS:
        got = cuda_dot_chain.dot_chain(x, w, "bf16", packed=packed,
                                       cluster=c)
        assert torch.equal(got, out), c


@pytest.mark.parametrize("K", cuda_dot_chain.KS)
def test_dot_chain_bf16_plan_fits_the_card(dev, K):
    geo = cuda_dot_chain.bf16_geometry(K)
    chosen = cuda_dot_chain.plan(K)
    assert chosen.cluster in cuda_dot_chain.BF16_CLUSTERS
    assert 16 * chosen.sms_used >= 15 * chosen.sms or chosen.cluster == 1
    for c in cuda_dot_chain.BF16_CLUSTERS:
        pl = cuda_dot_chain.plan(K, c)
        assert cuda_dot_chain.TILES % pl.cluster == 0 and pl.cluster == c
        assert (pl.stages, pl.smem, pl.chunk) == (geo.stages, geo.smem,
                                                  geo.chunk)
        assert pl.clusters >= 1 and pl.sms_used == pl.clusters * c
        if c > chosen.cluster:
            assert 16 * pl.sms_used < 15 * pl.sms  # too few SMs


def test_rate_probe_kernels_refuse_what_they_do_not_take(dev):
    x = torch.zeros((16, 128), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="K in"):
        cuda_dot_chain.dot_chain(x, cuda_dot_chain.make_weights(
            "f32", 256).to(dev), "f32")
    w = cuda_dot_chain.make_weights("int8", 384).to(dev)
    with pytest.raises(ValueError, match="packed"):
        cuda_dot_chain.dot_chain(x, w, "int8", packed=w.float())
    with pytest.raises(ValueError, match="uint8"):
        cuda_dot_chain.dot_chain(x[:, :64], w, "int8")
    with pytest.raises(ValueError, match="cluster"):
        cuda_dot_chain.dot_chain(x, w, "int8", cluster=2)
    with pytest.raises(ValueError, match="cluster"):
        cuda_dot_chain.dot_chain(x, cuda_dot_chain.make_weights(
            "bf16", 384).to(dev), "bf16", cluster=4)
    a, b = cuda_mm_rate.make_problem(8, 16, 8, dev)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_mm_rate.mm_rate(a.t(), b[:8].t().contiguous())
    xs = torch.zeros((768, 768), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_layout_micro.layout("copy", xs.t())
    with pytest.raises(ValueError, match="unknown body"):
        cuda_layout_micro.layout("gather", xs)


@pytest.mark.parametrize("body", cuda_layout_micro.BODIES)
def test_layout_kernel_matches_plain(dev, body):
    """Every body bitwise its plain version (the product within its bars)
    at 2 steps; a moving body also at a step count where its persistent
    blocks' last sweep is partial (its plan: more units than blocks, not a
    multiple of them)."""
    from silent_speech_tpu_torch.scripts import mosaic_micro
    lm = cuda_layout_micro
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2 * 768, 768)).astype(np.float32)).to(dev)
    before = lm.KERNEL.launches
    mosaic_micro.check_body(body, x)
    torch.cuda.synchronize()
    assert lm.KERNEL.launches == before + 1
    if body not in lm.MOVING:
        return
    steps = next(s for s in range(3, 200)
                 if (p := lm.move_plan(body, s)).units > p.blocks
                 and p.units % p.blocks)
    x = torch.from_numpy(np.random.default_rng(steps).standard_normal(
        (steps * 768, 768)).astype(np.float32)).to(dev)
    mosaic_micro.check_body(body, x)


@pytest.mark.parametrize("script,argv,want", [
    ("probe_int8", ["2", "iters=2"], ["dot_chain"]),
    ("mosaic_micro", ["2", "iters=2"], ["layout_micro"]),
    ("bench_fused_cnn", ["64", "iters=2"],
     ["mm_rate", "roi_cnn", "roi_cnn_bf16", "roi_cnn_debug", "gru_seq"])])
def test_rate_probe_script_main_on_the_card(dev, script, argv, want,
                                            monkeypatch):
    import importlib
    mod = importlib.import_module(f"silent_speech_tpu_torch.scripts.{script}")
    monkeypatch.setattr(cuda_mm_rate, "REPS", 2)  # the mxu probe, cut
    monkeypatch.setattr(cuda_mm_rate, "GRID", 2)
    _kernels.reset_launch_counts()
    parts = [mod.probe_mxu, mod.main] if script == "bench_fused_cnn" \
        else [mod.main]
    outs = [part(argv) for part in parts]
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    assert all(counts[k] > 0 for k in want), counts
    assert all(o["timer"] == "cuda events" for o in outs)
    assert all(r["ms"] > 0 for o in outs for r in o["rows"]
               if r["ms"] is not None)


# ---------------------------------------------- the backward-dot probes

BWD_KERNELS = {"tt": cuda_bwd_dots.KERNEL_TT, "xp": cuda_bwd_dots.KERNEL_XP,
               "nt": cuda_bwd_dots.KERNEL_NT,
               "base": cuda_bwd_dots.KERNEL_BASE,
               "nn": cuda_bwd_dots.KERNEL_NN}


def _bwd_operands(kind, dev, rows, m, K, N, seed=5):
    rng = np.random.default_rng(seed)
    p = cuda_bwd_dots.draw(rng, (rows, K), dev)
    dy = cuda_bwd_dots.draw(rng, (rows, N), dev)
    w = cuda_bwd_dots.draw(rng, (K, N), dev)
    return {"tt": (p, dy, {"m": m}), "xp": (p, dy, {"m": m}),
            "nt": (dy, w, {"m": m}), "base": (p, w, {"m": m}),
            "nn": (p[:m].T.contiguous(), dy[:m].contiguous(),
                   {"steps": 3})}[kind]


@pytest.mark.parametrize("kind", cuda_bwd_dots.KINDS)
@pytest.mark.parametrize("rows,m,K,N", [(100, 24, 104, 130), (64, 64, 16, 8),
                                        (1, 1, 1, 1), (300, 37, 65, 63)])
def test_bwd_dot_kernel_matches_plain(dev, kind, rows, m, K, N):
    a, b, kw = _bwd_operands(kind, dev, rows, m, K, N)
    before = BWD_KERNELS[kind].launches
    r = cuda_bwd_dots.check(kind, a, b, **kw)
    torch.cuda.synchronize()
    assert BWD_KERNELS[kind].launches == before + 1
    assert r["share_of_bar"] <= 1.0


@pytest.mark.parametrize("M,K,N,steps", [(384, 104, 256, 7), (24, 130, 70, 3),
                                         (384, 512, 256, 600)])
def test_bwd_dot_tt_steps_match_plain(dev, M, K, N, steps):
    """dots3's form: one tile of M rows, its product added in each step."""
    p, dy, _ = _bwd_operands("tt", dev, M, M, K, N)
    cuda_bwd_dots.check("tt", p, dy, m=M, steps=steps)
    pk = p.T.contiguous()
    cuda_bwd_dots.check("nn", pk, dy, steps=steps)


@pytest.mark.parametrize("kind", cuda_bwd_dots.KINDS)
def test_bwd_dot_kernels_are_bitwise_repeatable(dev, kind):
    a, b, kw = _bwd_operands(kind, dev, 3000, 384 if kind != "nn" else 96,
                             104, 256)
    one = cuda_bwd_dots.run(kind, a, b, **kw)
    two = cuda_bwd_dots.run(kind, a, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(one, two)


@pytest.mark.parametrize("kind,K,N,steps,groups", [
    ("tt", 512, 256, 256, 16),   # 8 128x128 tiles, 1 an SM: 128 of 132
    ("nn", 104, 256, 512, 64),   # 2 tiles: 66 slots, 8 steps a group
    ("xp", 512, 256, 256, 16),   # tt's tile and groups
    ("tt", 128, 192, 4, 4),      # fewer steps than slots: a step a group
    ("tt", 1600, 1600, 5, 1)])   # more tiles than slots: one group
def test_bwd_dot_groups_fill_one_wave(dev, kind, K, N, steps, groups):
    """csrc/bwd_dots.cu sizes the groups from the shapes alone: at most one
    wave of the blocks its launch bounds guarantee on 132 SMs (tt, xp and
    nn: one 128 x 128 tile an SM)."""
    n = cuda_bwd_dots._scratch(kind, K, N, steps, dev).numel()
    assert n == (0 if groups == 1 else groups * K * N)
    assert cuda_bwd_dots.plan(kind, K, N, steps).groups == groups


@pytest.mark.parametrize("kind,tile,resident", [("tt", 128, 1), ("nn", 128, 1),
                                                ("xp", 128, 1)])
def test_bwd_dot_plan_fits_the_card(dev, kind, tile, resident):
    """The occupancy the groups assume is the card's: the ring (4 stages
    of 32 contraction rows; xp's 3 and its two transposed planes) leaves
    one block an SM."""
    pl = cuda_bwd_dots.plan(kind, 512, 256, 256)
    assert (pl.tile_m, pl.tile_n) == (tile, tile)
    assert pl.resident_per_sm == resident
    assert pl.tiles * pl.groups <= 132 * resident
    assert (pl.chunk, pl.threads) == (32, 256)
    assert pl.stages == (3 if kind == "xp" else 4)
    assert 128 * 1024 < pl.smem_bytes <= 227 * 1024


@pytest.mark.parametrize("m,N,G,items", [(384, 256, 256, 1536),
                                         (1536, 256, 64, 1536),
                                         (24, 130, 4, 8), (1, 1, 1, 1)])
def test_bwd_dot_base_plan_is_one_persistent_wave(dev, m, N, G, items):
    """base's items are the steps' 128-row tiles by 128-column tiles; at
    most one persistent block an SM walks them, and one fits an SM."""
    pl = cuda_bwd_dots.plan("base", m, N, G)
    assert (pl.tile_m, pl.tile_n, pl.chunk, pl.stages) == (128, 128, 32, 4)
    assert pl.tiles == items and pl.groups == min(items, 132)
    assert pl.steps_per_group == -(-items // pl.groups)
    assert pl.resident_per_sm == 1
    assert pl.smem_bytes <= 227 * 1024


@pytest.mark.parametrize("rows,m,K,N", [(100, 24, 104, 130), (1, 1, 1, 1),
                                        (300, 37, 65, 63), (3000, 384, 104,
                                                            256),
                                        (98304, 384, 512, 256),
                                        (98304, 1536, 512, 256)])
def test_bwd_dot_xp_is_tt_bitwise(dev, rows, m, K, N):
    """xp's transpose only moves values into the plane its fragments are
    read from: the same MMAs on the same values as tt, so the same bits,
    ragged (K, N not multiples of 4: 4-byte copies) and at dots2's full
    shapes."""
    p, dy, kw = _bwd_operands("xp", dev, rows, m, K, N)
    before = BWD_KERNELS["xp"].launches
    xp = cuda_bwd_dots.bwd_dot_xp(p, dy, m)
    tt = cuda_bwd_dots.bwd_dot_tt(p, dy, m)
    torch.cuda.synchronize()
    assert BWD_KERNELS["xp"].launches == before + 1
    assert torch.equal(xp, tt)


@pytest.mark.parametrize("rows,m,K,N", [(40, 20, 16, 8), (1000, 127, 96, 64),
                                        (1000, 128, 104, 130),
                                        (1200, 200, 512, 256),
                                        (2600, 1300, 67, 129),
                                        (3000, 384, 512, 256)])
def test_bwd_dot_base_matches_plain_at_ragged_m(dev, rows, m, K, N):
    """base against its plain version and the float64 version at m under
    128, at 128, not a multiple of 128 (a ragged last tile a step), with
    ragged K and N (4-byte copies) and a tail of rows past G m."""
    a, b, kw = _bwd_operands("base", dev, rows, m, K, N)
    r = cuda_bwd_dots.check("base", a, b, **kw)
    assert r["share_of_bar"] <= 1.0 and r["share_of_bar64"] <= 1.0


@pytest.mark.parametrize("stop", cuda_bwd_dots.STOPS)
def test_bwd_dot_tt_stops_run(dev, stop):
    """bwd_dot_tt's kernel stopped after each part runs; 'all' is bwd_dot_tt
    bitwise, 'ring' leaves the sums zero."""
    p, dy, _ = _bwd_operands("tt", dev, 3000, 384, 104, 256)
    got = cuda_bwd_dots.bwd_dot_tt_stop(p, dy, 384, stop)
    torch.cuda.synchronize()
    if stop == "all":
        assert torch.equal(got, cuda_bwd_dots.bwd_dot_tt(p, dy, 384))
    elif stop == "ring":
        assert not got.any()
    with pytest.raises(ValueError, match="multiples of 4"):
        cuda_bwd_dots.bwd_dot_tt_stop(p[:, :103].contiguous(), dy, 384, stop)


def test_bwd_dot_tc_kernels_take_unaligned_rows(dev):
    """tt and nn copy 4 bytes at a time when a row does not start on 16
    bytes (K or M not a multiple of 4, an offset view): still within both
    bars."""
    rng = np.random.default_rng(9)
    p = cuda_bwd_dots.draw(rng, (260, 67), dev)
    dy = cuda_bwd_dots.draw(rng, (261, 130), dev)[1:]  # 4-byte offset rows
    cuda_bwd_dots.check("tt", p, dy, m=65)
    cuda_bwd_dots.check("nn", p[:65].T.contiguous(), dy[:65], steps=5)


def test_bwd_dot_nt_writes_zeros_past_the_tiles(dev):
    dy, w, kw = _bwd_operands("nt", dev, 100, 24, 104, 130)
    m = kw["m"]
    junk = torch.full((100, 104), float("nan"), device=dev)
    del junk  # the allocator hands the block to the output next
    out = cuda_bwd_dots.bwd_dot_nt(dy, w, m)
    torch.cuda.synchronize()
    assert torch.equal(out[96:], torch.zeros_like(out[96:]))
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("rows,m,K,N", [(100, 24, 104, 130), (1, 1, 1, 1),
                                        (300, 37, 65, 63),
                                        (3000, 384, 104, 256),
                                        (3000, 192, 256, 512),
                                        (2000, 384, 512, 256),
                                        (98304, 384, 512, 256)])
def test_bwd_dot_nt_within_both_bars_and_one_pass_is_not(dev, rows, m, K,
                                                         N):
    """nt (3xTF32 on wgmma) within compare's plain and float64 bars, ragged
    (N, K not multiples of 4: 4-byte copies and single stores; K past one
    104- or 128-column tile) and at dots1's widths; one TF32 pass, formed
    on the host (cuda_bwd_dots.one_pass), outside the float64 bar."""
    dy, w, kw = _bwd_operands("nt", dev, rows, m, K, N)
    r = cuda_bwd_dots.check("nt", dy, w, **kw)
    assert r["share_of_bar"] <= 1.0 and r["share_of_bar64"] <= 1.0
    control = cuda_bwd_dots.measure("nt", cuda_bwd_dots.one_pass(
        "nt", dy, w, **kw), dy, w, **kw)
    assert control["share_of_bar64"] > 1.0


@pytest.mark.parametrize("m,K,N", [(192, 104, 256), (384, 512, 256),
                                   (384, 256, 512)])
def test_bwd_dot_nt_stops(dev, m, K, N):
    """bwd_dot_nt_stop: 3 passes bitwise bwd_dot_nt; the kernel's own one
    TF32 pass outside the float64 bar; rows of 16 bytes only."""
    dy, w, kw = _bwd_operands("nt", dev, 3000, m, K, N)
    route = cuda_bwd_dots.bwd_dot_nt(dy, w, m)
    before = cuda_bwd_dots.KERNEL_NT_STOP.launches
    assert torch.equal(cuda_bwd_dots.bwd_dot_nt_stop(dy, w, m), route)
    one = cuda_bwd_dots.bwd_dot_nt_stop(dy, w, m, passes=1)
    assert cuda_bwd_dots.measure("nt", one, dy, w, **kw)[
        "share_of_bar64"] > 1.0
    assert cuda_bwd_dots.KERNEL_NT_STOP.launches == before + 2
    with pytest.raises(ValueError, match="multiples of 4"):
        cuda_bwd_dots.bwd_dot_nt_stop(dy[:, :-1].contiguous(),
                                      w[:, :-1].contiguous(), m)


@pytest.mark.parametrize("Gm,K,N,bn,tiles", [(98304, 104, 256, 104, 768),
                                             (98304, 512, 256, 128, 3072),
                                             (98304, 256, 512, 128, 1536),
                                             (96, 130, 130, 128, 2),
                                             (1, 1, 1, 104, 1)])
def test_bwd_dot_nt_plan_is_one_persistent_wave(dev, Gm, K, N, bn, tiles):
    """nt's tiles of out: 128 rows by 104 columns (K <= 104) or 128; at
    most one persistent block an SM walks them, and one fits an SM; its
    scratch is w's hi and lo planes, N padded to 32."""
    pl = cuda_bwd_dots.plan("nt", Gm, K, N)
    assert (pl.tile_m, pl.tile_n, pl.chunk, pl.stages) == (128, bn, 32, 4)
    assert pl.tiles == tiles and pl.groups == min(tiles, 132)
    assert pl.steps_per_group == -(-tiles // pl.groups)
    assert pl.resident_per_sm == 1 and pl.smem_bytes <= 227 * 1024
    n = cuda_bwd_dots._scratch("nt", K, N, 1, dev).numel()
    assert n == 2 * K * (-(-N // 32) * 32)


@pytest.mark.parametrize("steps", [1, 2, 23, 512])
def test_layout_product_within_both_bars_and_one_pass_is_not(dev, steps):
    """LP's product body (3xTF32 on mma.sync, persistent blocks over the
    (step, 128-row tile) items; 23 steps: 138 items, more than one a
    block on some): lanes 128..767 bitwise the input, the product within
    the f32 plain bar and the float64 bar (compare_product), bitwise on a
    repeat; one TF32 pass (cuda_layout_micro.one_pass) outside the float64
    bar."""
    lm = cuda_layout_micro
    x = torch.from_numpy(np.random.default_rng(steps).standard_normal(
        (steps * lm.R, lm.L)).astype(np.float32)).to(dev)
    one = lm.layout(lm.MATMUL, x)
    two = lm.layout(lm.MATMUL, x)
    torch.cuda.synchronize()
    assert torch.equal(one, two)
    r = lm.compare_product(one, x)
    assert r["share_of_bar"] <= 1.0 and r["share_of_bar64"] <= 1.0
    assert lm.measure_product(lm.one_pass(x), x)["share_of_bar64"] > 1.0


def test_bwd_dot_kernels_refuse_what_they_do_not_take(dev):
    p, dy, w = (_bwd_operands(k, dev, 64, 16, 16, 16)[i]
                for k, i in (("tt", 0), ("tt", 1), ("nt", 1)))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_bwd_dots.bwd_dot_tt(p, dy.T.contiguous().T, 16)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_bwd_dots.bwd_dot_nt(dy, w.T.contiguous().T, 16)
    with pytest.raises(ValueError, match="one device"):
        cuda_bwd_dots.bwd_dot_base(p, w.cpu(), 16)
    with pytest.raises(ValueError, match="f32"):
        cuda_bwd_dots.bwd_dot_nn(p.T.contiguous().half(), dy, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_bwd_dots.bwd_dot_xp(p.cpu(), dy.cpu(), 16, impl="kernel")


@pytest.mark.parametrize("script,argv,want", [
    ("proto_bwd_dots", ["3072", "iters=2"], ["bwd_dot_tt", "bwd_dot_nt"]),
    ("proto_bwd_dots2", ["3072", "iters=2"],
     ["bwd_dot_base", "bwd_dot_tt", "bwd_dot_xp"]),
    ("proto_bwd_dots3", ["4", "iters=2"], ["bwd_dot_tt", "bwd_dot_nn"])])
def test_bwd_dots_script_main_on_the_card(dev, script, argv, want):
    import importlib
    mod = importlib.import_module(f"silent_speech_tpu_torch.scripts.{script}")
    _kernels.reset_launch_counts()
    out = mod.main(argv)
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    assert all(counts[k] > 0 for k in want), counts
    assert out["timer"] == "cuda events"
    assert all(r["ms"] > 0 and r["share_of_bar"] <= 1.0 for r in out["rows"])


# --------------------------------------------------------- the CTC family

def _ctc_batch(dev, B, T, seed):
    from silent_speech_tpu_torch.models import ctc_model

    rng = np.random.default_rng(seed)
    X = torch.from_numpy(rng.standard_normal((B, T, 180)).astype(np.float32))
    L = torch.from_numpy(rng.integers(T // 2, T + 1, B))
    L[0] = T
    R = torch.from_numpy(rng.integers(0, 256, (B, T, 48, 96),
                                      dtype=np.uint8))
    enc = [ctc_model.encode_text(w) for w in ("hello", "no", "six")[:B]]
    y = torch.zeros((B, 5), dtype=torch.long)
    for i, e in enumerate(enc):
        y[i, :len(e)] = torch.tensor(e)
    ylen = torch.tensor([len(e) for e in enc])
    return [t.to(dev) for t in (X, L, R, y, ylen)]


def test_ctc_forward_kernels_match_plain(dev):
    """The CTC model at full width (hidden 192, 3 layers, emb 32) on K1 and
    K2 against its plain version: log-probabilities within the serving
    bar 1e-3 and the dictionary argmax equal; K1 once, K2 once a layer."""
    from silent_speech_tpu_torch.infer.ctc_decode import (CTCDecoder,
                                                          Dictionary)
    from silent_speech_tpu_torch.models import ctc_model

    params = ctc_model.init_params(180, torch.Generator().manual_seed(3))
    X, L, R, _, _ = _ctc_batch(dev, 3, 80, 3)
    d = Dictionary.from_words(["yes", "no", "hello", "thanks", "please",
                               "six", "seven", "aura", "lebron", "fahhh"])
    decs = [CTCDecoder(params, d, device=dev, roi_impl=impl, gru_impl=impl)
            for impl in ("kernel", "plain")]
    args = [t.cpu().numpy() for t in (X, R, L)]
    _kernels.reset_launch_counts()
    got = decs[0].logprobs(*args)
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    assert (counts["roi_cnn"], counts["gru_proj"], counts["gru_seq"]) == \
        (1, 3, 3)
    ref = decs[1].logprobs(*args)
    assert got.shape == (3, 80, 27) and torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=1e-3, rtol=0)
    s = [dec.score_batch(*args) for dec in decs]
    assert (s[0].argmax(-1) == s[1].argmax(-1)).all()
    # the lattice is elementwise a word: the word chunks change nothing
    chunked = CTCDecoder(params, d, device=dev, chunk_words=3)
    np.testing.assert_array_equal(chunked.score_batch(*args), s[0])


def test_ctc_train_step_kernels_match_plain(dev):
    """One CTC train step at full width (B=2, T=16: 32 frames, standardize
    off) through K1 and K3 against the plain path, at the official step's
    bars (the loss's relative to its magnitude)."""
    from silent_speech_tpu_torch.models import ctc_model
    from silent_speech_tpu_torch.ops.ctc import ctc_loss

    cfg = ctc_model.CTCConfig(gru_dropout=0.0)
    params = ctc_model.init_params(180, torch.Generator().manual_seed(5))
    X, L, R, y, ylen = _ctc_batch(dev, 2, 16, 5)
    res = []
    for impl in ("kernel", "plain"):
        model = ctc_model.BiGRUCTC.from_jax_params(params, cfg).to(dev)
        opt = make_optimizer(model, 3e-4, grad_clip_norm=1e9)
        _kernels.reset_launch_counts()
        lp = model(X, L, R, train=True, generator=torch.Generator(device=dev),
                   roi_impl=impl)
        loss = ctc_loss(lp, L, y, ylen)
        loss.backward()
        grads = [p.grad.clone() for p in model.parameters()]
        opt.step()
        counts = _kernels.launch_counts()
        want = 1 if impl == "kernel" else 0
        assert counts["roi_cnn"] == counts["roi_cnn_bwd"] == want
        assert counts["gru_seq"] == 0
        assert all(g.abs().max() > 0 for g in grads)
        res.append((loss.item(), grads,
                    [p.detach().clone() for p in model.parameters()]))
    (lk, gk, pk), (lp_, gp, pp) = res
    assert abs(lk - lp_) <= 1e-5 * max(1.0, abs(lp_))
    assert max((a - b).abs().max().item() for a, b in zip(gk, gp)) <= 1e-4
    assert max((a - b).abs().max().item() for a, b in zip(pk, pp)) <= 3e-4


def test_bf16_train_step_on_the_card_matches_the_cpu(dev):
    """The official bf16 training route on the card (K1 and K3 in f32, the
    embedding cast, the scan and head in bf16 on cuBLAS) against the same
    route on the CPU: the bars of tests/test_torch_ctc_train.py's bf16
    step (loss within 2^-8 of itself, each gradient within 2^-4 of its
    tensor's largest |g|); parameters and gradients f32."""
    cfg = BiGRUConfig(x_dim=12, num_classes=4, hidden=16, roi_emb=8,
                      head_hidden=8, gru_dropout=0.0, head_dropout=0.0)
    params = init_params(cfg, torch.Generator().manual_seed(9))
    rng = np.random.default_rng(9)
    X = torch.from_numpy(rng.standard_normal((3, 8, 12)).astype(np.float32))
    L = torch.tensor([8, 5, 3])
    R = torch.from_numpy(rng.integers(0, 256, (3, 8, 48, 96),
                                      dtype=np.uint8))
    y = torch.tensor([0, 3, 1])
    res = []
    for device in (dev, torch.device("cpu")):
        model = BiGRUClassifier.from_jax_params(params, cfg).to(device)
        _kernels.reset_launch_counts()
        logits = model.train_forward(
            *(t.to(device) for t in (X, L, R)), compute_dtype="bfloat16",
            generator=torch.Generator(device=device))
        loss = smoothed_cross_entropy(logits, y.to(device), 4, 0.05)
        loss.backward()
        if device.type == "cuda":
            counts = _kernels.launch_counts()
            assert counts["roi_cnn"] == counts["roi_cnn_bwd"] == 1
        assert all(p.dtype == p.grad.dtype == torch.float32
                   for p in model.parameters())
        res.append((loss.item(), [p.grad.cpu() for p in model.parameters()]))
    (lc, gc), (lh, gh) = res
    assert abs(lc - lh) <= 2 ** -8 * abs(lh)
    for a, b in zip(gc, gh):
        assert (a - b).abs().max() <= 2 ** -4 * max(b.abs().max(), 2e-3)
