"""The GRU probes' kernels on K2's cluster recurrence (csrc/gru_proto.cu on
csrc/gru_cluster.cuh, ops/cuda_gru_proto.py) on the CPU: P4's projection
route emulated, and the Python mirror of the kernels' launch plan.

P4's dual-chain kernel projects each chunk of ``k_steps`` steps on the
tensor cores before its steps: in f32 as 3xTF32 on m16n8k8 mma.sync (x and
Wi split hi = tf32(v), lo = tf32(v - hi), each 8-deep slice adding lo*hi,
hi*lo and hi*hi to one f32 accumulator over all of D, then bi); under
bf16_mm x and Wi are rounded to bf16 first, values TF32 holds exactly, so
one pass forms the exact products.
tests/tc_emulation.step_product forms those MMAs in float64 and rounds once
an MMA. Fed to the plain recurrence, the emulated route is held against
scripts/proto_gru4.py's Pallas kernel in interpret mode at chip_smoke.py's
bars (BAR_GRU 1e-4, BAR_GRU_BF16 2e-3); the projection alone against its
float64 value within tf32_bars.bar64, which one TF32 pass misses. The
recurrence itself is K2's (tests/test_torch_gru_split.py emulates it block
by block); the kernels run on the card only (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from silent_speech_tpu_torch.ops import cuda_gru_proto as gp
from silent_speech_tpu_torch.ops.tf32_bars import bar64, shares
from tc_emulation import step_product
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BAR_GRU, BAR_GRU_BF16 = 1e-4, 2e-3  # chip_smoke.py
H = 192


def _cast(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.bfloat16).float()


def _projection(x: torch.Tensor, wi: torch.Tensor, bi: torch.Tensor,
                bf16: bool, passes: int = 3) -> torch.Tensor:
    """x (M, D) Wi + bi as the dual kernel forms it (one pass on the bf16
    values under bf16_mm)."""
    depth = x.shape[1]  # one accumulator over D
    if bf16:
        return step_product(_cast(x), _cast(wi), 1, depth) + bi
    return step_product(x, wi, passes, depth) + bi


def _layer(seed: int, M: int, D: int):
    rng = np.random.default_rng(seed)
    s = 1 / np.sqrt(H)
    x = rng.standard_normal((M, D)).astype(np.float32)
    wi = rng.uniform(-s, s, (D, 3 * H)).astype(np.float32)
    bi = rng.uniform(-s, s, 3 * H).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(wi), torch.from_numpy(bi)


@pytest.mark.parametrize("D", [180, 384])
def test_projection_is_f32_and_one_pass_is_not(D):
    """The 3xTF32 route within the float64 bar of a 3xTF32 result (steps:
    the accumulator, and bi added in f32), at a chunk of 8 steps x 64 rows;
    one TF32 pass (hi*hi alone) outside it."""
    x, wi, bi = _layer(D, 512, D)
    ref = x.double() @ wi.double() + bi.double()
    absolute = x.double().abs() @ wi.double().abs() + bi.double().abs()
    bar = bar64(ref, absolute, 2)
    three = _projection(x, wi, bi, False)
    one = _projection(x, wi, bi, False, passes=1)
    assert shares(three.double(), ref, bar)["share_of_bar"] <= 1.0
    assert shares(one.double(), ref, bar)["share_of_bar"] > 1.0


def _load_proto_gru4():
    spec = importlib.util.spec_from_file_location(
        "_jax_tc_proto_gru4", os.path.join(REPO, "scripts", "proto_gru4.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flip(x: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    out = x.copy()
    for b, n in enumerate(lengths):
        out[b, :n] = x[b, :n][::-1]
    return out


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16_mm"])
def test_emulated_dual_route_matches_the_jax_kernel(bf16):
    """Each chain's emulated projection, then the plain recurrence (h and
    Wh rounded under bf16_mm), against proto_gru4.gru_layer_dual in
    interpret mode: both outputs within the card's bar, zero past each
    length."""
    B, T, D, Hs = 4, 9, 40, 24
    rng = np.random.default_rng(7)
    s = 1 / np.sqrt(Hs)
    params = [{k: rng.uniform(-s, s, shape).astype(np.float32) for k, shape
               in (("wi", (D, 3 * Hs)), ("bi", (3 * Hs,)),
                   ("wh", (Hs, 3 * Hs)), ("bh", (3 * Hs,)))}
              for _ in range(2)]
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    lengths = np.array([9, 5, 1, 7], np.int32)
    x_flip = _flip(x, lengths)
    want = _load_proto_gru4().gru_layer_dual(
        jnp.asarray(x), jnp.asarray(x_flip), jnp.asarray(lengths),
        *({k: jnp.asarray(v) for k, v in p.items()} for p in params),
        batch_tile=2, k_steps=4, bf16_mm=bf16, interpret=True)
    L = torch.from_numpy(lengths)
    for xx, p, w in zip((x, x_flip), params, want):
        pt = {k: torch.from_numpy(v) for k, v in p.items()}
        xp = _projection(torch.from_numpy(xx).reshape(-1, D), pt["wi"],
                         pt["bi"], bf16).reshape(B, T, 3 * Hs)
        got = gp.gru_recurrence_plain(xp, L, pt["wh"], pt["bh"], bf16).numpy()
        np.testing.assert_allclose(got, np.asarray(w), rtol=0,
                                   atol=BAR_GRU_BF16 if bf16 else BAR_GRU)
        for b, n in enumerate(lengths):
            assert not got[b, n:].any()


def test_cluster_size_and_named_geometries():
    """C from the slices (K2's 128 KiB target): 4 for the recurrence at
    H=192 (Wh 110,592 bytes a block), 8 for the dual kernel (Wh + Wi at
    C=4: 221,184 bytes at D=180); under bf16_mm the recurrence's blocks
    hold Wh as bf16, half the bytes: 2 (the dual kernel's stay f32); a
    block's threads and bytes at named tiles, as csrc/gru_cluster.cuh lays
    them out."""
    assert gp.cluster_of(H) == 4 and gp.cluster_of(16) == 1
    assert gp.cluster_of(H, 180) == gp.cluster_of(H, 384) == 8
    assert gp.cluster_of(1024) == 8 and gp.cluster_of(16, 20) == 1
    assert gp.cluster_of(H, bf16_mm=True) == 2
    assert gp.cluster_of(H, 180, True) == gp.cluster_of(H, 384, True) == 8
    # Wh 192 x 144 x 4 + h 2 x BT x 192 x 4 + lengths
    for tile, threads, smem in ((1, 192, 112_144), (2, 192, 113_680),
                                (4, 64, 116_752), (20, 384, 141_392),
                                (36, 288, 166_032), (64, 384, 209_152)):
        g = gp.rec_geometry(H, tile)
        assert (g.C, g.Up, g.Hk, g.threads, g.smem) == (4, 48, 192, threads,
                                                        smem)
    # + Wi [Dp][WLD = 72] + the chunk's xp K x BT x 72; at least 4 Up
    # threads (the split body's: Up / 8 warps to project)
    g = gp.dual_geometry(180, H, 36, 4)
    assert (g.C, g.Up, g.threads, g.smem) == (8, 24, 288, 207_504)
    g = gp.dual_geometry(384, H, 24, 4)
    assert (g.C, g.threads, g.smem) == (8, 192, 230_496)
    assert gp.dual_geometry(180, H, 4, 8).threads == 96  # the tiled body: 32
    assert gp.rec_geometry(H, 3) is None  # the tiled body takes 4 n rows
    # bf16_mm: Wh 192 x 288 x 2 (C=2) + h; 36 rows pass the tiled body's
    # threads at 96 units a block
    for tile, threads, smem in ((1, 384, 112_144), (8, 192, 122_912),
                                (32, 384, 159_872)):
        g = gp.rec_geometry(H, tile, bf16_mm=True)
        assert (g.C, g.Up, g.threads, g.smem) == (2, 96, threads, smem)
    assert gp.rec_geometry(H, 36, bf16_mm=True) is None
    assert gp.dual_geometry(180, H, 36, 4, bf16_mm=True) == \
        gp.dual_geometry(180, H, 36, 4)


def test_every_plan_fits_a_block():
    """The mirror's plan (the kernel's make_plan) at D 180 and 384, B 1, 33
    and 512, for one weight set, two, and the dual kernel at k_steps 1, 8
    and 32 (min(k_steps, T) for T = 32), in f32 and under bf16_mm, whatever
    the card's co-resident clusters: within 232,448 bytes and the body's
    threads."""
    for B, bf16 in ((b, m) for b in (1, 33, 512) for m in (False, True)):
        for clusters in (1, 15, 30, 1000):
            for sets in (1, 2):
                g = gp.choose_tile(
                    B, sets, lambda t: gp.rec_geometry(H, t, bf16), clusters)
                assert g.smem <= gp.SMEM_LIMIT and g.threads <= 512
            for D in (180, 384):
                for k in (1, 8, 32):
                    g = gp.choose_tile(
                        B, 2, lambda t: gp.dual_geometry(D, H, t, k, bf16),
                        clusters)
                    assert g.smem <= gp.SMEM_LIMIT and g.threads <= 512


def test_plan_takes_the_fewest_waves():
    """Of the tiles that fit, the smallest whose clusters take the fewest
    waves: with 30 co-resident clusters of 4 (the H100's, one block an SM),
    P2a's 512 rows take 20-row tiles (26 clusters) and P2b's two sets 36
    (30); B=33 takes 2 rows. The dual kernel's chunk, unless given, is the
    largest of 8, 4, 2 with the fewest waves: with 15 clusters of 8, 2 x
    512 chains take 36-row tiles of 4-step chunks at D=180 (2 waves; 8-step
    chunks take 3 waves from 24 rows), 24 rows at D=384 (3 waves); B=1 takes one
    row and 8-step chunks. Under bf16_mm, with 66 clusters of 2 (C=2, one
    block an SM): P2a's rows take 8-row tiles, P2b's 16."""
    rec = lambda t: gp.rec_geometry(H, t)
    assert gp.choose_tile(512, 1, rec, 30).BT == 20
    assert gp.choose_tile(512, 2, rec, 30).BT == 36
    assert gp.choose_tile(33, 1, rec, 30).BT == 2
    assert gp.choose_tile(1, 2, rec, 30).BT == 1
    for D, tile in ((180, 36), (384, 24)):
        g, k = gp.choose_chunk(512, D, H, 32, 15)
        assert (g.BT, k) == (tile, 4)
        g, k = gp.choose_chunk(1, D, H, 32, 15)
        assert (g.BT, k) == (1, 8)
    dual8 = lambda t: gp.dual_geometry(180, H, t, 8)
    assert gp.choose_tile(512, 2, dual8, 15).BT == 24
    rec16 = lambda t: gp.rec_geometry(H, t, True)
    assert gp.choose_tile(512, 1, rec16, 66).BT == 8
    assert gp.choose_tile(512, 2, rec16, 66).BT == 16
    with pytest.raises(ValueError, match="shared memory"):
        gp.choose_tile(1, 1, lambda t: gp.rec_geometry(1024, t), 30)
