"""The bf16 chain of the chained-dot probe (csrc/dot_chain.cu, namespace
chain16; ops/cuda_dot_chain) on the CPU: the Python mirror of its
geometry (clusters along a step's tiles, the ring of W chunks beside y in
a block's shared memory) and the chunk layout ``pack_weights`` gives W.

The chain's arithmetic (chain_plain, the trace and its rounding check)
against probe_int8's Pallas kernel is tests/test_torch_rate_probes.py; the
kernel runs on the card only (tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from silent_speech_tpu_torch.ops import cuda_dot_chain as dc
from silent_speech_tpu_torch.ops.tf32_bars import tf32_round
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("K", dc.KS)
def test_clusters_divide_a_steps_tiles(K):
    assert dc.TILES == 6 and dc.M == dc.TILES * dc.TM
    for c in dc.BF16_CLUSTERS:
        assert dc.TILES % c == 0
    assert dc.bf16_geometry(K).chunk == K // 2 * dc.BF16_ROW


@pytest.mark.parametrize("K,stages", [(384, 7), (512, 5)])
def test_ring_and_y_fit_a_block(K, stages):
    """y (64 x K bf16), the ring's stages (a chunk and two 8-byte barriers
    each) and the alignment pad within 232,448 bytes less the kernel's
    static 1 KB; one stage more would not fit (or pass the cap of 8)."""
    g = dc.bf16_geometry(K)
    assert g.y_bytes == dc.TM * K * 2 and g.stages == stages
    assert g.smem == dc.BF16_ALIGN + g.y_bytes + g.stages * (g.chunk + 16)
    assert g.smem <= dc.SMEM_BYTES - 1024
    assert g.stages == dc.BF16_MAX_STAGES or \
        g.smem + g.chunk + 16 > dc.SMEM_BYTES - 1024
    assert (g.y_bytes % dc.BF16_ALIGN, g.chunk % dc.BF16_ALIGN) == (0, 0)


def _unit(packed, K, a, n, u):
    """The 8 bf16 values the kernel reads as unit u of W^T row n in atom a:
    byte a K 128 + n 128 + (u ^ n % 8) 16."""
    flat = packed.reshape(-1)
    at = (a * K * 128 + n * 128 + ((u ^ (n % 8)) * 16)) // 2
    return flat[at:at + 8]


@pytest.mark.parametrize("K", dc.KS)
def test_packed_bf16_weights_are_the_chunk_layout(K):
    w = dc.make_weights("bf16", K)
    packed = dc.pack_weights(w, "bf16")
    assert packed.shape == (K, K) and packed.dtype == torch.bfloat16
    wt = w.t().to(torch.bfloat16)
    rng = np.random.default_rng(K)
    for a, n, u in zip(rng.integers(0, K // 64, 200),
                       rng.integers(0, K, 200), rng.integers(0, 8, 200)):
        assert torch.equal(_unit(packed, K, a, n, u),
                           wt[n, 64 * a + 8 * u:64 * a + 8 * u + 8])
    # chunk (a, h), rows [h K/2, h K/2 + K/2) of atom a: one contiguous run
    # of W^T's values, each row's 8 units a permutation of its own
    flat = packed.reshape(K // 64, K, 64)
    for a in range(K // 64):
        for n in (0, 7, K // 2, K - 1):
            got = flat[a, n].float().sort().values
            want = wt[n, 64 * a:64 * a + 64].float().sort().values
            assert torch.equal(got, want)


def test_the_other_modes_keep_their_packing():
    w8 = dc.make_weights("int8", 384)  # the s8 chains' swizzled atoms
    units = dc.pack_weights(w8, "int8").reshape(384 // 128, 384, 8, 16)
    n = torch.arange(384)[:, None]
    units = units[:, n, torch.arange(8)[None, :] ^ (n % 8)]
    assert torch.equal(units.permute(1, 0, 2, 3).reshape(384, 384),
                       w8.t())
    w32 = dc.make_weights("f32", 384)  # the f32 chain's split planes
    planes = dc.pack_weights(w32, "f32").reshape(384 // 32, 2, 384, 8, 4)
    n = torch.arange(384)[:, None]
    units = planes[:, :, n, torch.arange(8)[None, :] ^ (n % 8)]
    hi, lo = units.permute(1, 2, 0, 3, 4).reshape(2, 384, 384)
    want = tf32_round(w32.t())
    assert torch.equal(hi, want)
    assert torch.equal(lo, tf32_round(w32.t() - want))


def test_variant_codes_and_refusals():
    """The variant is the cluster size, 0 for the kernel's choice; the
    other modes take none."""
    assert dc._variant(0) == 0
    assert [dc._variant(c) for c in dc.BF16_CLUSTERS] == [1, 2, 3, 6]
    for bad in (4, 5, 12):
        with pytest.raises(ValueError):
            dc._variant(bad)
    x = torch.zeros((16, 128), dtype=torch.uint8)
    with pytest.raises(ValueError, match="cluster"):
        dc.dot_chain(x, dc.make_weights("int8", 384), "int8", cluster=2)
    y = dc.dot_chain(x, dc.make_weights("bf16", 384), "bf16", cluster=3)
    assert y.shape == (2, 8, 128)  # the CPU runs the plain version
