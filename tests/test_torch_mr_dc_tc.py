"""MR (csrc/mm_rate.cu; ops/cuda_mm_rate.mm_rate) and DC's f32 chain
(csrc/dot_chain.cu, namespace chain32; ops/cuda_dot_chain.dot_chain in
mode ``f32``) on the CPU: their tensor-core arithmetic emulated in the
kernels' own sum orders, their operand layouts, and the Python mirrors of
their plans.

Both form their products as 3xTF32 on wgmma: each operand x split hi =
tf32(x), lo = tf32(x - hi), an 8-deep slice adding lo*hi, hi*lo and hi*hi,
the 12 wgmmas of a 32-k chunk summed from zero and added into an f32 total
(tests/tc_emulation.step_product over one chunk forms them exactly in
float64 and rounds once an MMA; the card's MMA may truncate instead). MR's
total takes the (chunk, rep) groups chunks outer, reps inner, rep r's A
read from a chunk staged with an 8-column halo at column 8 - r % 8; DC's
takes a product's chunks from the computing block's own half of y on,
14 products a step. The emulations are
held against the plain versions and the JAX scripts' Pallas kernels in
interpret mode (bench_fused_cnn ``_mm_kernel``; probe_int8 ``_kernel`` in
mode f32, its rows cut to 16, W passed as an input, as
tests/test_torch_rate_probes.py runs it) within the kernels' bars (MR:
``cuda_mm_rate.compare``'s 4 sqrt(reps K) 2^-24 of each sum of |terms|;
DC: ``cuda_dot_chain.BAR_F32``); one TF32 pass misses MR's float64 bar
(``tf32_bars.bar64``) and DC's bar. The kernels run on the card only
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from silent_speech_tpu_torch.ops import cuda_dot_chain as dc
from silent_speech_tpu_torch.ops import cuda_mm_rate as mr
from silent_speech_tpu_torch.ops.tf32_bars import (BAR_DEPTH, bar64, shares,
                                                   tf32_round)
from tc_emulation import split_tf32, step_product
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MR_REPS, MR_GRID = 9, 2  # every r % 8
DC_STEPS, DC_K, DC_ROWS = 3, 384, 16
STATIC_SMEM = 1024  # a block's static shared memory, at most


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_mr_dc_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------------ MR


def mr_emulate(a, b, reps, passes=3):
    """csrc/mm_rate.cu's sum: for each 32-k chunk (b's rows past K zero)
    and each rep r, the chunk's wgmmas from zero on A'[m, k] = a[m, (k -
    r % 8) mod K] (k past K too: the staged halo), added into the f32
    total, chunks outer, reps inner."""
    K = a.shape[1]
    KP = mr.geometry(a.shape[0], K, b.shape[1], 1).kp
    bp = torch.zeros((KP, b.shape[1]))
    bp[:K] = b
    total = torch.zeros((a.shape[0], b.shape[1]))
    for c0 in range(0, KP, mr.BK):
        cols = torch.arange(c0, c0 + mr.BK)
        for r in range(reps):
            ak = a[:, (cols - r % mr.ROLLS) % K]
            total = total + step_product(ak, bp[c0:c0 + mr.BK], passes,
                                         chunk=mr.BK)
    return total


def _mr_float64(a, b, reps):
    ref = absolute = 0
    for r in range(reps):
        ar = torch.roll(a, r % mr.ROLLS, dims=1).double()
        ref = ref + ar @ b.double()
        absolute = absolute + ar.abs() @ b.double().abs()
    return ref, absolute


@pytest.mark.parametrize("M,K,N", [(70, 104, 130), (16, 24, 16)])
def test_mr_emulation_holds_the_bars(M, K, N):
    """The emulated kernel within MR's bar of the plain version and of the
    Pallas ``_mm_kernel`` (interpret mode, grid 2); within the float64 bar
    of (chunks x reps) f32 adds, which one TF32 pass misses."""
    a, b = mr.make_problem(M, K, N, "cpu")
    got = mr_emulate(a, b, MR_REPS)
    assert mr.compare(got, a, b, MR_REPS)["share_of_bar"] <= 1.0

    jax_bfc = _load("bench_fused_cnn")
    f = pl.pallas_call(
        functools.partial(jax_bfc._mm_kernel, MR_REPS), grid=(MR_GRID,),
        in_specs=[pl.BlockSpec((M, K), lambda i: (0, 0)),
                  pl.BlockSpec((K, N), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((M, N), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((M, N), jnp.float32), interpret=True)
    want = torch.from_numpy(np.array(
        f(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))))
    absolute = mr.mm_rate_plain(a.abs(), b.abs(), MR_REPS, 1)
    bar = BAR_DEPTH * (MR_REPS * K) ** 0.5 * 2.0 ** -24 * absolute
    assert shares(got, want, bar)["share_of_bar"] <= 1.0

    ref, absolute64 = _mr_float64(a, b, MR_REPS)
    steps = mr.geometry(M, K, N, 1).kp // mr.BK * MR_REPS
    b64 = bar64(ref, absolute64, steps)
    assert shares(got.double(), ref, b64)["share_of_bar"] <= 1.0
    one = mr_emulate(a, b, MR_REPS, passes=1)
    assert shares(one.double(), ref, b64)["share_of_bar"] > 1.0


def test_mr_halo_fragments_are_the_rolled_a():
    """A chunk staged as the kernel stages it (rows, columns [k0 - 8, k0 +
    32) mod K) read at the fragments' columns 8 + kk - r % 8 gives rep r's
    rolled A on every k below K, for every chunk and roll; a warp's
    fragment loads (8 rows g by 4 columns t4) fall on 32 banks."""
    M, K = 70, 104
    a = torch.arange(M * K, dtype=torch.float32).reshape(M, K)
    kp = mr.geometry(M, K, 130, 1).kp
    for k0 in range(0, kp, mr.BK):
        staged = a[:, (k0 - mr.ROLLS + torch.arange(mr.BK + mr.ROLLS)) % K]
        live = min(mr.BK, K - k0)
        for s in range(mr.ROLLS):
            got = staged[:, mr.ROLLS + torch.arange(mr.BK) - s]
            want = torch.roll(a, s, dims=1)[:, k0:k0 + live]
            assert torch.equal(got[:, :live], want)
    g, t4 = np.meshgrid(np.arange(8), np.arange(4), indexing="ij")
    for col0 in range(1, mr.BK + mr.ROLLS - 7):
        assert len(set(((g * mr.A_LD + col0 + t4) % 32).ravel())) == 32


def test_mr_plan_mirror_fits_a_block():
    """The mirror of the kernel's plan at the probe's six shapes (grid 64)
    and the small ones: the column tile whose items take an SM the least
    time (a BN-64 column at 5/4 of a BN-128 one), the items, stages and
    shared memory, which a block holds."""
    want_bn = {(192, 104, 128): 64, (192, 1152, 384): 128,
               (192, 512, 128): 64, (192, 1152, 576): 128,
               (512, 512, 512): 128, (1024, 1024, 1024): 128}
    shapes = [(M, K, N, mr.GRID) for M, K, N, _ in mr.SHAPES]
    shapes += [(70, 104, 130, 2), (16, 24, 16, 2), (1, 8, 1, 1)]
    for M, K, N, grid in shapes:
        geo = mr.geometry(M, K, N, grid)
        cost = {bn: -(-(-(-M // 64) * -(-N // bn) * grid) // mr.SMS) * bn
                * {128: 4, 64: 5}[bn] for bn in mr.BNS}
        assert cost[geo.bn] == min(cost.values())
        assert geo.bn == 128 or cost[64] < cost[128]
        if (M, K, N) in want_bn and grid == mr.GRID:
            assert geo.bn == want_bn[(M, K, N)]
        assert geo.items == -(-M // 64) * -(-N // geo.bn) * grid
        assert geo.kp % mr.BK == 0 and K <= geo.kp < K + mr.BK
        assert geo.stages == 2 and geo.threads == 128
        stage = 2 * geo.bn * 128 + 64 * mr.A_LD * 4
        assert stage % 1024 == 0
        assert geo.smem == 1024 + 2 * stage <= dc.SMEM_BYTES - STATIC_SMEM
    with pytest.raises(ValueError):
        mr.geometry(0, 8, 8)
    a, b = mr.make_problem(8, 16, 8, "cpu")
    with pytest.raises(ValueError, match="bn"):
        mr.mm_rate(a, b, 1, 1, bn=96)


# ------------------------------------------------------------------ DC


def dc_product(y, w, passes=3):
    """One product y W as chain32 forms it: block `rank` of the cluster
    sums its half of the columns chunk by chunk in
    ``cuda_dot_chain.f32_chunk_order`` (from its own half of y on), each
    32-k chunk's wgmmas from zero, the chunks' sums added in f32."""
    K = w.shape[0]
    cols = K // dc.F32_CLUSTER
    parts = []
    for rank in range(dc.F32_CLUSTER):
        k = torch.cat([torch.arange(32 * c, 32 * c + 32)
                       for c in dc.f32_chunk_order(K, rank)])
        parts.append(step_product(y[:, k], w[k, rank * cols:rank * cols +
                                             cols], passes, chunk=32))
    return torch.cat(parts, dim=1)


def dc_emulate(x, w, passes=3):
    """csrc/dot_chain.cu's f32 chain: y0 = f32(seed) 1e-6, then 14
    products (:func:`dc_product`). Every row of a step is the same sum of
    the same values, so one row a step is formed: (steps, 384, K)."""
    rows = []
    for s in dc.seeds(x):
        y = (torch.tensor(float(s), dtype=torch.float32)
             * torch.tensor(1e-6, dtype=torch.float32)).expand(1, w.shape[0])
        for _ in range(dc.DEPTH):
            y = dc_product(y.contiguous(), w, passes)
        rows.append(y[0])
    return torch.stack(rows)[:, None].expand(-1, dc.M, -1)


def test_dc_f32_emulation_holds_the_bar():
    """3 steps at K=384 (the largest seed in the first): the emulated chain
    within BAR_F32 of the plain chain (output and moments) and of the
    Pallas kernel (interpret mode, its rows cut to 16); one TF32 pass
    outside it."""
    rng = np.random.default_rng(DC_K)
    xn = rng.integers(0, 256, (DC_STEPS * 8, 128), dtype=np.uint8)
    xn[:8] = 255
    x = torch.from_numpy(xn)
    w = dc.make_weights("f32", DC_K)
    y = dc_emulate(x, w)
    plain = dc.chain_plain(x, w, "f32")
    assert dc.compare(dc.output_of(y), dc.chain_moments(y), plain,
                      "f32")["share_of_bar"] <= 1.0

    jax_int8 = _load("probe_int8")
    jax_int8.M = DC_ROWS  # every row of the chain is the same
    f = pl.pallas_call(
        lambda x_ref, w_ref, o_ref: jax_int8._kernel("f32", DC_K, x_ref,
                                                     o_ref, w_ref),
        grid=(DC_STEPS,),
        in_specs=[pl.BlockSpec((8, 128), lambda i: (i, 0)),
                  pl.BlockSpec((DC_K, DC_K), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((1, 8, 128), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((DC_STEPS, 8, 128), jnp.float32),
        interpret=True)
    want = np.asarray(f(jnp.asarray(xn), jnp.asarray(w.numpy())))
    got = dc.output_of(y).numpy()
    scale = y[:, 0, :128].abs().sum(dim=1).numpy()[:, None, None]
    assert (np.abs(got - want) <= dc.BAR_F32 * scale).all()

    one = dc_emulate(x, w, passes=1)
    with pytest.raises(RuntimeError, match="off the plain"):
        dc.compare(dc.output_of(one), dc.chain_moments(one), plain, "f32")


def test_dc_f32_chunks_and_y_layout():
    """Block `rank`'s planes of chunk c, runs of pack_weights' f32 layout
    read at the 128-byte swizzle, are its rows of W^T's hi and lo planes,
    split as the kernel splits; each block's chunk order starts at its own
    half and takes every chunk once; y kept at column c ^ 4 (r % 8) reads
    back by the fragments' index, a warp's loads on 32 banks, and a block's
    half of each row is one run of it."""
    for K in dc.KS:
        w = dc.make_weights("f32", K)
        flat = dc.pack_weights(w, "f32").reshape(-1)
        hi, lo = split_tf32(w.t().contiguous())
        assert torch.equal(hi, tf32_round(w.t()))
        cols = dc.f32_geometry(K).cols
        i = torch.arange(cols)[:, None]
        unit = torch.arange(8)[None, :] ^ (i % 8)
        for rank in range(dc.F32_CLUSTER):
            order = dc.f32_chunk_order(K, rank)
            assert sorted(order) == list(range(K // 32))
            assert order[0] * 32 == rank * cols  # its own half first
            for c in (0, 5, K // 32 - 1):
                for p, plane in enumerate((hi, lo)):
                    base = ((c * 2 + p) * K + rank * cols) * 32
                    run = flat[base:base + cols * 32]
                    got = run.reshape(cols, 8, 4)[i, unit]
                    want = plane[rank * cols:(rank + 1) * cols,
                                 32 * c:32 * c + 32]
                    assert torch.equal(got.reshape(cols, 32), want)
        y = torch.randn(dc.TM, K)
        r = torch.arange(dc.TM)[:, None]
        col = torch.arange(K)[None, :]
        ys = torch.empty(dc.TM * K)
        ys[r * K + (col ^ (4 * (r % 8)))] = y  # the product's stores
        assert torch.equal(ys[r * K + (col ^ (4 * (r % 8)))], y)
        for rank in range(dc.F32_CLUSTER):  # the half a block copies
            run = ys.reshape(dc.TM, K)[:, rank * cols:rank * cols + cols]
            assert torch.equal(run.sort(dim=1).values, y[:, rank * cols:
                               rank * cols + cols].sort(dim=1).values)
        g, t4 = np.meshgrid(np.arange(8), np.arange(4), indexing="ij")
        for k in range(0, K, 8):  # a k8 step's loads, and its + 4
            for off in (0, 4):
                banks = ((g * K + ((k + off + t4) ^ (4 * g))) % 32).ravel()
                assert len(set(banks)) == 32


def test_dc_f32_geometry_fits_a_block():
    """The mirror of chain32's shared memory at both K: clusters of 2, a
    ring of whole chunks where two fit (K=384) and of planes else, at
    least 3 planes of it beside y, fitting a block with its static shared
    memory, on the swizzle's period; each warpgroup's n a wgmma width."""
    want = {384: (96, 2, 49152, 2, 197664), 512: (128, 1, 32768, 3, 230448)}
    for K, (width, planes, unit, units, smem) in want.items():
        geo = dc.f32_geometry(K)
        assert (geo.width, geo.planes, geo.unit, geo.units, geo.smem) == (
            width, planes, unit, units, smem)
        assert geo.cluster == 2 and geo.cols == K // 2 == 2 * geo.width
        assert geo.unit == geo.planes * geo.cols * 128
        assert geo.unit % 1024 == 0 and geo.units * geo.planes >= 3
        assert (geo.width * 128) % 1024 == 0 and geo.y_bytes == 64 * K * 4
        assert geo.smem + STATIC_SMEM <= dc.SMEM_BYTES
    with pytest.raises(ValueError):
        dc.f32_geometry(200)
    x = torch.zeros((16, 128), dtype=torch.uint8)
    with pytest.raises(ValueError, match="cluster"):
        dc.dot_chain(x, dc.make_weights("f32", 384), "f32", cluster=2)
