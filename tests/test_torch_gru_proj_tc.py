"""K2p, the GRU input projection (csrc/gru_proj.cu, ops/cuda_gru.gru_proj),
on the CPU: its large route's arithmetic emulated, and the Python mirror of
the launch plan.

The large route forms x Wi as 3xTF32 on the tensor cores (wgmma): x split
hi = tf32(x), lo = tf32(x - hi) in registers, Wi^T split the same way once
(``pack_wi_tc``), and each product lo*hi + hi*lo + hi*hi summed in f32.
``tc_product`` (tests/tc_emulation.py) forms those products exactly in
float64; the emulated route stays within a tenth of the card's bar (1e-4,
the JAX package's GRU parity bar, chip_smoke.BAR_GRU) of the float64
product at the live and serving shapes, while one TF32 pass (hi*hi alone)
lies outside the bar: 3xTF32 is f32's function, one pass is another. The
small route is f32 FMAs, the plain version's arithmetic in another order.
The kernel itself runs on the card only (tests/test_torch_cuda.py,
chip_smoke.py); the plain version against the Pallas GRU is
tests/test_torch_gru_split.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from silent_speech_tpu_torch.ops import cuda_gru
from tc_emulation import split_tf32, tc_product
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BAR = 1e-4
N = 1152  # 6H at H=192: both directions of a layer


def _layer(seed, M, D):
    """x (M, D) standard normal, Wi and bi as the model initialises them
    (uniform in +-1/sqrt(H), H = 192)."""
    rng = np.random.default_rng(seed)
    s = 1 / np.sqrt(N // 6)
    x = rng.standard_normal((M, D)).astype(np.float32)
    wi = rng.uniform(-s, s, (D, N)).astype(np.float32)
    bi = rng.uniform(-s, s, N).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(wi), torch.from_numpy(bi)


@pytest.mark.parametrize("M,D", [(32, 212), (32, 384), (8192, 212),
                                 (8192, 384)])
def test_large_route_is_f32_and_one_pass_is_not(M, D):
    x, wi, bi = _layer(M + D, M, D)
    ref = x.double() @ wi.double() + bi.double()
    three = (tc_product(x, wi, torch.matmul, 3) + bi.double()).float()
    one = (tc_product(x, wi, torch.matmul, 1) + bi.double()).float()
    assert (three.double() - ref).abs().max().item() <= BAR / 10
    assert (one.double() - ref).abs().max().item() > BAR
    plain = cuda_gru.gru_proj_plain(x, wi, bi)  # the CPU route: f32
    assert (plain.double() - ref).abs().max().item() <= BAR / 10


def test_emulated_route_matches_the_jax_projection():
    """The emulated large route against the projection the Pallas GRU's
    body computes (pallas_gru.py:95-99: jnp.dot at highest precision, plus
    bi), at a small size."""
    x, wi, bi = _layer(3, 40, 212)
    want = jnp.dot(jnp.asarray(x.numpy()), jnp.asarray(wi.numpy()),
                   precision=jax.lax.Precision.HIGHEST) + jnp.asarray(
                       bi.numpy())
    got = (tc_product(x, wi, torch.matmul, 3) + bi.double()).float()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=BAR,
                               rtol=0)


@pytest.mark.parametrize("D", [212, 384, 181])
def test_packed_planes_are_the_kernels_split(D):
    """pack_wi_tc: Wi^T's hi and lo planes as tc_emulation (and the
    kernel's split) round them, zeros from D to a multiple of 32."""
    _, wi, _ = _layer(D, 1, D)
    wt = cuda_gru.pack_wi_tc(wi)
    kp = -(-D // cuda_gru.PROJ_BK) * cuda_gru.PROJ_BK
    assert wt.shape == (2, N, kp) and wt.dtype == torch.float32
    hi, lo = split_tf32(wi.t().contiguous())
    assert torch.equal(wt[0, :, :D], hi) and torch.equal(wt[1, :, :D], lo)
    assert not wt[:, :, D:].any()


@pytest.mark.parametrize("M,K,route", [
    (32, 212, "small"), (32, 384, "small"), (512, 212, "small"),
    (513, 212, "large"), (2048, 212, "large"), (8192, 212, "large"),
    (32768, 384, "large"), (5760, 212, "large"), (5120, 384, "large"),
    (32, 833, "large")])
def test_route_choice(M, K, route):
    """Small M (at most PROJ_SMALL_M rows, K within the small route's
    shared memory) on the FMAs; the rest on the tensor cores."""
    assert cuda_gru.proj_geometry(M, K, N).route == route


@pytest.mark.parametrize("M,bn", [(8192, 192), (32768, 192), (5120, 192),
                                  (5760, 144), (1024, 144), (2048, 144)])
def test_large_tile_leaves_the_smaller_tail(M, bn):
    """BN 192 (6 column tiles) or 144 (8), whichever costs the fewer
    waves of 132 tiles, a tile about BN + 64 columns' time (on the H100
    the faster width at each of these M, chip_smoke.time_k2p)."""
    g = cuda_gru.proj_geometry(M, 212, N)
    assert (g.bm, g.bn) == (128, bn)
    assert g.tiles == -(-M // 128) * (N // bn)


@pytest.mark.parametrize("route", cuda_gru.PROJ_ROUTES)
@pytest.mark.parametrize("M,K", [(1, 1), (32, 212), (32, 384),
                                 (8193, 181), (32768, 832), (100, 2048)])
def test_each_route_fits_a_block(route, M, K):
    """Each route's shared memory within the H100's 232,448 bytes a block
    (the small route stages the tile's whole K: it takes K <= 832)."""
    if route == "small" and K > cuda_gru.PROJ_KMAX:
        with pytest.raises(ValueError, match="small route"):
            cuda_gru.proj_geometry(M, K, N, route)
        return
    g = cuda_gru.proj_geometry(M, K, N, route)
    assert g.route == route and 0 < g.smem <= cuda_gru.SMEM_BYTES
    assert g.stages >= (1 if route == "small" else 3)


def test_gru_proj_plain_takes_every_route_on_the_cpu():
    """On a CPU tensor the wrapper runs the plain version whatever the
    route; on the card the route is the kernel's (tests/test_torch_cuda.py)."""
    x, wi, bi = _layer(7, 6, 12)
    want = cuda_gru.gru_proj_plain(x, wi, bi)
    for route in (None,) + cuda_gru.PROJ_ROUTES:
        assert torch.equal(cuda_gru.gru_proj(x, wi, bi, route=route), want)
    with pytest.raises(ValueError, match="unknown route"):
        cuda_gru.proj_geometry(32, 12, N, "medium")
    with pytest.raises(ValueError, match="unknown route"):
        cuda_gru.gru_proj(x, wi, bi, route="large_one_pass")
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_gru.gru_proj_stop(x, cuda_gru.pack_wi_tc(wi), bi, passes=1)
