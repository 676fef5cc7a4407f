"""K2's two kernels (silent_speech_tpu_torch.ops.cuda_gru: gru_proj and
gru_seq) on the CPU: their plain versions, composed, against the JAX
package's Pallas GRU (ops/pallas_gru.py) in interpret mode; the per-block
layout of Wh (pack_wh) against the index csrc/gru_seq.cu reads it with; the
cluster recurrence emulated block by block from that layout; the cluster
size and layout the pack is made in at the shapes the model runs; and the
packs kept for unchanged weights. The rest of the launch (BT, the route of
Wh) is chosen by the kernel on the card (tests/test_torch_cuda.py).

The kernels themselves run on the card only (tests/test_torch_cuda.py,
chip_smoke.py). atol 1e-4: the bar of the JAX package's own GRU parity
tests."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from silent_speech_tpu.ops.pallas_gru import (bigru_pallas, gru_layer_pallas,
                                              gru_sequence_pallas)
from silent_speech_tpu_torch.ops import cuda_gru
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-4


def _dir(rng, d, h):
    s = 1 / np.sqrt(h)
    return {k: rng.uniform(-s, s, shape).astype(np.float32)
            for k, shape in (("wi", (d, 3 * h)), ("bi", (3 * h,)),
                             ("wh", (h, 3 * h)), ("bh", (3 * h,)))}


def _t(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _lengths(rng, B, T):
    """Ragged, with T, 0 and 1 among them."""
    lengths = rng.integers(0, T + 1, B).astype(np.int32)
    lengths[:3] = (T, 0, 1)[:B]
    return lengths


@pytest.mark.parametrize("B,T,D,H,reverse", [
    (5, 6, 7, 20, False), (5, 6, 7, 20, True), (3, 1, 4, 16, True),
    (7, 9, 12, 8, False)])
def test_split_parts_match_gru_pallas(rng, B, T, D, H, reverse):
    """gru_proj's plain version, then gru_seq's, against the Pallas
    direction (the reverse one through gru_layer_pallas' flips)."""
    p = _dir(rng, D, H)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    lengths = _lengths(rng, B, T)
    tp = _t(p)
    xp = cuda_gru.gru_proj_plain(torch.from_numpy(x), tp["wi"], tp["bi"])
    got = cuda_gru.gru_recurrence_plain(xp, torch.from_numpy(lengths),
                                        tp["wh"], tp["bh"], reverse=reverse)
    if reverse:
        want = gru_layer_pallas(jnp.asarray(x), jnp.asarray(lengths), _j(p),
                                reverse=True, batch_tile=8, interpret=True)
    else:
        want = gru_sequence_pallas(jnp.asarray(x), jnp.asarray(lengths),
                                   **_j(p), batch_tile=8, k_steps=4,
                                   interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    for b, n in enumerate(lengths):
        assert not got[b, n:].any()


def test_split_layers_match_bigru_pallas(rng):
    """Two bidirectional layers, each gru_proj then gru_seq over the packed
    layer (plain versions), against bigru_pallas."""
    B, T, D, H = 6, 7, 10, 20
    layers = [{"fwd": _dir(rng, d, H), "bwd": _dir(rng, d, H)}
              for d in (D, 2 * H)]
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    lengths = _lengths(rng, B, T)
    L = torch.from_numpy(lengths)
    out = torch.from_numpy(x)
    for lp in layers:
        pack = cuda_gru.pack_layer([(_t(lp["fwd"]), False),
                                    (_t(lp["bwd"]), True)])
        xp = cuda_gru.gru_proj(out, pack.wi, pack.bi)
        assert xp.shape == (B, T, 6 * H)
        out = cuda_gru.gru_recurrence(xp, L, pack)
    want = bigru_pallas(jnp.asarray(x), jnp.asarray(lengths),
                        [{k: _j(v) for k, v in lp.items()} for lp in layers],
                        batch_tile=8, interpret=True)
    assert out.shape == (B, T, 2 * H)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    torch.testing.assert_close(out, cuda_gru.bigru_kernel(
        torch.from_numpy(x), L,
        [{k: _t(v) for k, v in lp.items()} for lp in layers]), atol=ATOL,
        rtol=0)


@pytest.mark.parametrize("H", [1, 16, 20, 192, 200, 365, 512])
@pytest.mark.parametrize("C", cuda_gru.CLUSTERS)
def test_pack_wh_is_the_kernels_index(H, C):
    """pack_wh's element [c, q, g, u, i] is Wh[4q + i, gH + cU + u] where
    that unit is block c's and below H, and k = 4q + i < H; zero
    elsewhere."""
    wh = torch.arange(1, 1 + 3 * H * H, dtype=torch.float32).reshape(
        H, 3 * H)
    packed = cuda_gru.pack_wh(wh, C)
    U, Up, Hk = cuda_gru._layout(H, C)
    assert packed.shape == (C, Hk // 4, 3, Up, 4) and packed.is_contiguous()
    assert Up % cuda_gru.UNITS_PER_WARP == 0 and Hk % cuda_gru.H_ALIGN == 0
    k = torch.arange(Hk // 4)[:, None, None, None] * 4 + torch.arange(4)
    g = torch.arange(3)[:, None, None]
    for c in range(C):
        u = torch.arange(Up)[:, None]
        j = c * U + u
        ok = (u < U) & (j < H) & (k < H)
        idx = (k.clamp(max=H - 1) * 3 * H + g * H
               + j.clamp(max=H - 1)).expand(Hk // 4, 3, Up, 4)
        want = torch.where(ok.expand_as(idx), wh.flatten()[idx], 0.0)
        assert torch.equal(packed[c], want), c
    # every weight lands once
    assert torch.equal(packed[packed != 0].sort().values, wh.flatten())


def _emulate(xp, lengths, whp, bh, H, C, reverse):
    """csrc/gru_seq.cu block by block: block c's units from its own slice
    whp[c] (Hk/4, 3, Up, 4) and the whole h of the previous step; xp read
    and y written at L-1-t for the reverse direction."""
    U, Up, Hk = cuda_gru._layout(H, C)
    B, T, _ = xp.shape
    h = torch.zeros(B, Hk)
    y = torch.zeros(B, T, H)
    rows = torch.arange(B)
    for t in range(T):
        valid = lengths > t
        tt = torch.where(valid & reverse, lengths - 1 - t, t)
        x_t = xp[rows, tt.clamp(min=0)]
        h_next = h.clone()
        for c in range(C):
            w = whp[c].permute(0, 3, 1, 2).reshape(Hk, 3, Up)
            acc = torch.einsum("bk,kgu->bgu", h, w)
            n_own = max(0, min(U, H - c * U))
            for u in range(n_own):
                j = c * U + u
                r = torch.sigmoid(x_t[:, j] + (acc[:, 0, u] + bh[j]))
                z = torch.sigmoid(x_t[:, H + j] + (acc[:, 1, u] + bh[H + j]))
                n = torch.tanh(x_t[:, 2 * H + j]
                               + r * (acc[:, 2, u] + bh[2 * H + j]))
                h_new = torch.where(valid, (1 - z) * n + z * h[:, j],
                                    h[:, j])
                h_next[:, j] = h_new
                y[rows, tt, j] = torch.where(valid, h_new, 0.0)
        h = h_next
    return y


@pytest.mark.parametrize("C", cuda_gru.CLUSTERS)
@pytest.mark.parametrize("reverse", [False, True])
def test_cluster_recurrence_emulated_matches_plain(rng, C, reverse):
    """The kernel's blocked recurrence over the packed slices at H=20 (no
    cluster size divides it into whole warps) agrees with gru_seq's plain
    version."""
    B, T, H = 5, 6, 20
    p = _t(_dir(rng, 4, H))
    xp = torch.from_numpy(rng.standard_normal((B, T, 3 * H)).astype(
        np.float32))
    lengths = torch.from_numpy(_lengths(rng, B, T)).long()
    got = _emulate(xp, lengths, cuda_gru.pack_wh(p["wh"], C), p["bh"], H, C,
                   reverse)
    want = cuda_gru.gru_recurrence_plain(xp, lengths, p["wh"], p["bh"],
                                         reverse=reverse)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("H,C,layout", [
    (1, 1, (1, 8, 16)), (16, 1, (16, 16, 16)), (20, 1, (20, 24, 32)),
    (64, 1, (64, 64, 64)), (100, 2, (50, 56, 112)), (192, 4, (48, 48, 192)),
    (200, 8, (25, 32, 208)), (365, 8, (46, 48, 368)),
    (385, 8, (49, 56, 400)), (1024, 8, (128, 128, 1024))])
def test_cluster_size_at_named_shapes(H, C, layout):
    """C, the blocks a cluster, and the per-block layout (U, Up, Hk) the
    pack is made in: 4 blocks of 48 units at the model's H=192 (110.6 KB of
    Wh a block); 8 at H=200, where 4 blocks' slices would pass 128 KiB."""
    assert cuda_gru.cluster_size(H) == C
    assert cuda_gru._layout(H, C) == layout
    U, Up, Hk = layout
    p = _t(_dir(np.random.default_rng(H), 3, H))
    pack = cuda_gru.pack_layer([(p, False)])
    assert pack.C == C and pack.whp.shape == (1, C, Hk // 4, 3, Up, 4)


def test_cluster_size_fits_every_hidden_size():
    """Every H the kernel takes, 1..1024: the smallest cluster whose Wh
    slice is at most W_SLICE_TARGET (else 8), its blocks covering H in whole
    warps of units and H padded to H_ALIGN."""
    for H in range(1, cuda_gru.MAX_HIDDEN + 1):
        C = cuda_gru.cluster_size(H)
        U, Up, Hk = cuda_gru._layout(H, C)
        assert C * U >= H and U <= Up < U + cuda_gru.UNITS_PER_WARP, H
        assert Up % cuda_gru.UNITS_PER_WARP == 0, H
        assert H <= Hk < H + cuda_gru.H_ALIGN and Hk % cuda_gru.H_ALIGN == 0
        fits = [c for c in cuda_gru.CLUSTERS
                if cuda_gru._layout(H, c)[2] * 3 * cuda_gru._layout(H, c)[1]
                * 4 <= cuda_gru.W_SLICE_TARGET]
        assert C == (fits[0] if fits else cuda_gru.CLUSTERS[-1]), H
    for bad in (0, cuda_gru.MAX_HIDDEN + 1):
        with pytest.raises(ValueError, match="hidden size"):
            cuda_gru.cluster_size(bad)


def test_layer_pack_is_kept_until_the_weights_change(rng):
    """gru_sequence's and bigru_kernel's pack: made once for unchanged
    weights, made anew after an in-place change, and for each direction
    order of its own."""
    p = _t(_dir(rng, 5, 12))
    first = cuda_gru.layer_pack([(p, False)])
    assert cuda_gru.layer_pack([(p, False)]) is first
    assert cuda_gru.layer_pack([(p, True)]).reverse == (True,)
    with torch.no_grad():
        p["wh"].mul_(2.0)
    again = cuda_gru.layer_pack([(p, False)])
    assert again is not first
    assert torch.equal(again.whp, cuda_gru.pack_layer([(p, False)]).whp)
    assert torch.equal(again.whp, 2 * first.whp)


def test_layer_pack_of_inference_tensors_is_made_each_call(rng):
    """Tensors made under inference mode keep no version counter: their
    pack is made at every call, never taken from the kept ones."""
    with torch.inference_mode():
        p = {k: v.clone() for k, v in _t(_dir(rng, 5, 12)).items()}
    a = cuda_gru.layer_pack([(p, False)])
    b = cuda_gru.layer_pack([(p, False)])
    assert a is not b and torch.equal(a.whp, b.whp)


def test_plain_parts_at_the_edges():
    """T=0, B=0 and every length 0: empty or all-zero outputs."""
    H = 8
    p = {k: torch.ones(s) * 0.1 for k, s in (("wh", (H, 3 * H)),
                                              ("bh", (3 * H,)))}
    xp = torch.ones(2, 3, 3 * H)
    y = cuda_gru.gru_recurrence_plain(xp, torch.zeros(2, dtype=torch.long),
                                      p["wh"], p["bh"], reverse=True)
    assert y.shape == (2, 3, H) and not y.any()
    assert cuda_gru.gru_recurrence_plain(
        xp[:, :0], torch.zeros(2, dtype=torch.long), p["wh"],
        p["bh"]).shape == (2, 0, H)
    assert cuda_gru.gru_proj_plain(torch.zeros(0, 3, 5), torch.ones(5, 6),
                                   torch.ones(6)).shape == (0, 3, 6)


def test_pack_layer_refuses_mismatched_directions():
    rng = np.random.default_rng(0)
    a, b = _t(_dir(rng, 6, 8)), _t(_dir(rng, 6, 12))
    with pytest.raises(ValueError, match="wi"):
        cuda_gru.pack_layer([(a, False), (b, True)])
    with pytest.raises(ValueError, match="1 or 2"):
        cuda_gru.pack_layer([(a, False)] * 3)
    pack = cuda_gru.pack_layer([(a, False), (a, True)])
    assert pack.wi.shape == (6, 48) and pack.bh.shape == (2, 24)
    assert pack.whp.shape[0] == 2 and pack.reverse == (False, True)
    with pytest.raises(ValueError, match="xp"):
        cuda_gru.gru_recurrence(torch.zeros(2, 3, 24), torch.tensor([3, 1]),
                                pack)
