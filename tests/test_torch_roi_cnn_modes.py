"""The ROI CNN's serving modes in the port against the JAX package's Pallas
kernels in interpret mode, on the CPU (where each wrapper runs its plain
version; the CUDA kernels are held against these plain versions on the card,
tests/test_torch_cuda.py and chip_smoke.py):

- bf16 (``cuda_cnn.roi_cnn_bf16``) against ``roi_cnn_fused(compute_dtype=
  bfloat16, variant='tiled3')``;
- int8 (``cuda_cnn_q8``) against ``roi_cnn_fused(variant='tiled3_q8')``,
  and its s8 weights and scales against ``_quantize_pack``'s;
- im2col (``cuda_cnn_im2col``; its plain version is ``roi_cnn_plain``)
  against ``roi_cnn_pallas``, and its packing against ``_pack_conv``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from silent_speech_tpu.models.bigru import init_roi_cnn
from silent_speech_tpu.ops import pallas_cnn
from silent_speech_tpu.ops.pallas_cnn2 import (_pack_indices,
                                               pack_roi_cnn_fused,
                                               roi_cnn_fused)
from silent_speech_tpu_torch.ops import cuda_cnn, cuda_cnn_im2col, cuda_cnn_q8
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# bf16 against the Pallas bf16 kernel: both round at the same points, so
# they differ by f32 reassociation, and where an f32 sum taken in another
# order lands on the other side of a bf16 rounding boundary (one bf16 step,
# 2^-8 relative, of one activation: about 1e-6 of the output). Measured
# 4.5e-8 (1.7e-7 of the output scale) on these inputs; the bar is 5e-5 of
# the scale, 400x tighter than the JAX test's 0.02 * scale, which measures
# the bf16 error against f32. The f32 function lies 1.5e-3 of the scale away.
BAR_BF16_REL = 5e-5
BAR_Q8 = 3e-5  # tests/test_pallas_cnn2.py test_fused2_q8_matches_fake_quant


def _params(seed):
    return jax.tree.map(np.asarray, init_roi_cnn(jax.random.PRNGKey(seed)))


def _torch(params):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)


def _frames(rng, n):
    return rng.integers(0, 256, (n, 48, 96), dtype=np.uint8)


@pytest.mark.parametrize("N,seed", [(32, 1), (9, 2)])
def test_bf16_matches_pallas_bf16(rng, N, seed):
    params = _params(seed)
    roi = _frames(rng, N)
    packed = pack_roi_cnn_fused(params)
    want = np.asarray(roi_cnn_fused(jnp.asarray(roi), packed,
                                    compute_dtype=jnp.bfloat16,
                                    variant="tiled3", interpret=True))
    got = cuda_cnn.roi_cnn_bf16(torch.from_numpy(roi), _torch(params))
    assert got.shape == (N, 32) and got.dtype == torch.float32
    f32 = cuda_cnn.roi_cnn_plain(torch.from_numpy(roi), _torch(params))
    scale = float(np.abs(want).max())
    err = float(np.abs(got.numpy() - want).max())
    assert err < BAR_BF16_REL * scale, (err, scale)
    # and it is the bf16 function, not the f32 one
    assert float((f32 - got).abs().max()) > 10 * err


def test_bf16_weights_round_where_the_kernel_rounds():
    p = _torch(_params(3))
    flat, flat16 = cuda_cnn.flat_weights(p), cuda_cnn.flat_weights_bf16(p)
    keep = torch.zeros_like(flat, dtype=torch.bool)
    keep[1232:1248] = True  # b2
    keep[4704:] = True      # b3, fc
    assert torch.equal(flat16[keep], flat[keep])
    assert torch.equal(flat16[~keep], cuda_cnn.round_bf16(flat[~keep]))
    assert not torch.equal(flat16, flat)


@pytest.mark.parametrize("N", [64, 33])
def test_q8_matches_pallas_q8(rng, N):
    params = _params(5)
    roi = _frames(rng, N)
    pq = pack_roi_cnn_fused(params, variant="tiled3_q8")
    want = np.asarray(roi_cnn_fused(jnp.asarray(roi), pq,
                                    variant="tiled3_q8", interpret=True))
    got = cuda_cnn_q8.roi_cnn_q8(torch.from_numpy(roi), _torch(params))
    assert got.shape == (N, 32)
    assert float(np.abs(got.numpy() - want).max()) < BAR_Q8


def test_q8_frame_does_not_depend_on_its_neighbours(rng):
    """The activation scales are per frame, so a frame's embedding does not
    depend on the batch: bitwise where the CPU's f32 mean and fc take the
    same code path (N > 1 here); at N=1 the fc runs as a matrix-vector
    product and may round its sums in another order (<= 1e-7 measured).
    The kernel itself is held bitwise at N=1 on the card."""
    params = _torch(_params(0))
    roi = torch.from_numpy(_frames(rng, 33))
    roi[5] = 0
    roi[6] = 255
    q = cuda_cnn_q8.quantize_roi_cnn(params)
    full = cuda_cnn_q8.roi_cnn_q8(roi, params, packed=q)
    assert torch.isfinite(full).all()
    for lo, hi in ((0, 7), (4, 9), (20, 33)):
        part = cuda_cnn_q8.roi_cnn_q8(roi[lo:hi], params, packed=q)
        assert torch.equal(part, full[lo:hi]), (lo, hi)
    for i in (5, 6, 32):
        one = cuda_cnn_q8.roi_cnn_q8(roi[i:i + 1], params, packed=q)
        torch.testing.assert_close(one, full[i:i + 1], atol=1e-6, rtol=0)


def test_q8_weights_and_scales_match_quantize_pack():
    """Each packed column of ``_quantize_pack`` holds one output channel's
    s8 kernel and scales; the port's per-channel values are the same."""
    params = _params(7)
    pq = jax.tree.map(np.asarray,
                      pack_roi_cnn_fused(params, variant="tiled3_q8"))
    q = cuda_cnn_q8.quantize_roi_cnn(_torch(params))
    idx = _pack_indices()
    for key, (rows, cols, flat), co, per_col in (
            ("1", idx[0], 8, ("d1", "cf1")), ("2", idx[3], 16, ("sw2", "cq2")),
            ("3", idx[5], 24, ("sw3", "cq3"))):
        wq = q[f"w{key}q"].numpy().reshape(-1)
        packed = pq[f"w{key}q"]
        np.testing.assert_array_equal(packed[rows, cols], wq[flat], key)
        for name in per_col:
            np.testing.assert_array_equal(
                pq[name][0, cols],
                q[name].numpy().astype(pq[name].dtype)[flat % co], name)
    assert q["qi"].dtype == torch.int32 and \
        q["qi"].numel() == cuda_cnn_q8.QI_SIZE
    assert q["qf"].numel() == cuda_cnn_q8.QF_FC + 25 * 32


def test_q8_close_to_f32_and_standardize_raises(rng):
    p = _torch(_params(4))
    roi = torch.from_numpy(_frames(rng, 16))
    f32 = cuda_cnn.roi_cnn_plain(roi, p)
    q8 = cuda_cnn_q8.roi_cnn_q8(roi, p)
    assert float((q8 - f32).abs().max()) < 0.01 * float(f32.abs().max())
    with pytest.raises(ValueError, match="serving-only"):
        cuda_cnn_q8.roi_cnn_q8(roi, p, standardize=True)


@pytest.mark.parametrize("N,standardize,atol,rtol",
                         [(32, False, 2e-4, 1e-4), (17, True, 2e-3, 1e-3)])
def test_im2col_plain_matches_pallas_im2col(rng, N, standardize, atol, rtol):
    params = _params(N)
    roi = _frames(rng, N)
    want = pallas_cnn.roi_cnn_pallas(
        jnp.asarray(roi), pallas_cnn.pack_roi_cnn_params(params),
        standardize=standardize, interpret=True)
    got = cuda_cnn_im2col.roi_cnn_im2col(torch.from_numpy(roi),
                                         _torch(params),
                                         standardize=standardize)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=rtol)


def test_im2col_packing_matches_pack_conv():
    params = _params(8)
    packed = cuda_cnn_im2col.pack_im2col(_torch(params))
    assert packed.numel() == cuda_cnn_im2col.n_packed(32)
    o = 0
    for key, (w_tile, wx_len), c_in, c_out in zip(
            ("conv0", "conv1", "conv2"), cuda_cnn_im2col.TILES,
            (1, 8, 16), (8, 16, 24)):
        rows = 3 * wx_len * c_in
        want = pallas_cnn._pack_conv(params[key]["w"], w_tile, wx_len, rows)
        got = packed[o:o + want.size].reshape(want.shape).numpy()
        np.testing.assert_array_equal(got, want, key)
        o += want.size
        np.testing.assert_array_equal(
            packed[o:o + w_tile * c_out].numpy(),
            np.tile(params[key]["b"], w_tile), key)
        o += w_tile * c_out
    np.testing.assert_array_equal(packed[o:o + 24 * 32].numpy(),
                                  params["fc"]["w"].reshape(-1))


@pytest.mark.parametrize("conv", [0, 1, 2])
def test_im2col_fragments_cover_the_nonzeros_once(conv):
    """The kernel's fragment walk (cuda_cnn_im2col.nonzero_fragments)
    covers every nonzero entry of pack_im2col's matrix exactly once, no
    fragment it drops holds a nonzero, and each listed fragment holds the
    (dy, dx) slice that the kernel copies once a block (tap_blocks)."""
    params = _params(9)
    p = _torch(params)
    w_tile, wx_len = cuda_cnn_im2col.TILES[conv]
    c_in, c_out = (1, 8, 16)[conv], (8, 16, 24)[conv]
    m = cuda_cnn_im2col.pack_conv(p[f"conv{conv}"]["w"], w_tile, wx_len)
    want = pallas_cnn._pack_conv(params[f"conv{conv}"]["w"], w_tile, wx_len,
                                 3 * wx_len * c_in)
    np.testing.assert_array_equal(m.numpy(), want)
    taps = cuda_cnn_im2col.tap_blocks(cuda_cnn_im2col.pack_im2col(p),
                                      32)[conv]
    torch.testing.assert_close(taps, p[f"conv{conv}"]["w"], atol=0, rtol=0)
    fk, fn = cuda_cnn_im2col.FRAG_K[conv], cuda_cnn_im2col.FRAG_N[conv]
    count = torch.zeros(m.shape, dtype=torch.int32)
    for r, c, dy, dx in cuda_cnn_im2col.nonzero_fragments(conv):
        count[r:r + fk, c:c + fn] += 1
        ci0, co0 = r % c_in, c % c_out
        assert (r // c_in) // wx_len == dy
        assert (r // c_in) % wx_len - c // c_out == dx
        assert torch.equal(m[r:r + fk, c:c + fn],
                           taps[dy, dx, ci0:ci0 + fk, co0:co0 + fn])
    assert (count <= 1).all()
    assert (count[m != 0] == 1).all()
    assert (m[count == 0] == 0).all()
    # the random weights have no zeros: the listed fragments are all of
    # the function's taps, 9 a (w_off, output tile, input tile)
    assert int((count == 1).sum()) == int((m != 0).sum()) == \
        9 * w_tile * c_in * c_out


def test_q8_fragment_weights_match_quantize_pack():
    """The int8 kernel's s8 weights in its m16n8k32 fragment order
    (cuda_cnn_q8.fragment_weights) hold each s8 weight of quantize_roi_cnn
    and _quantize_pack exactly once (stage 1: once for each column of the
    pool window), zeros in the K pad, and their column sums give the
    zero-point corrections (the pad adds nothing)."""
    params = _params(10)
    pq = jax.tree.map(np.asarray,
                      pack_roi_cnn_fused(params, variant="tiled3_q8"))
    q = cuda_cnn_q8.quantize_roi_cnn(_torch(params))
    frags = cuda_cnn_q8.fragment_weights(q)
    idx = _pack_indices()
    for key, (ci, co), jax_idx in (("1", (1, 8), idx[0]),
                                   ("2", (8, 16), idx[3]),
                                   ("3", (16, 24), idx[5])):
        f = frags[f"stage{key}"]
        w = torch.zeros((3, 3, ci, co), dtype=torch.int32)
        seen = torch.zeros((3, 3, ci, co), dtype=torch.int32)
        for (kb, nt, lane, r, b), v in np.ndenumerate(f.numpy()):
            g, t = divmod(lane, 4)
            if key == "1":  # column g: channel 2 (g // 2) + nt, window col g % 2
                kx = b - g % 2
                tap = 3 * t + kx if t < 3 and 0 <= kx < 3 and r == 0 else 9
                c, col = 0, 2 * (g // 2) + nt
            elif key == "2":
                tap, c = 4 * kb + 2 * r + t // 2, 4 * (t % 2) + b
            else:
                tap, c = 2 * kb + r, 4 * t + b
            if key != "1":
                col = 8 * nt + g
            if tap >= 9:
                assert v == 0, (key, kb, nt, lane, r, b)
                continue
            w[tap // 3, tap % 3, c, col] = int(v)
            seen[tap // 3, tap % 3, c, col] += 1
        assert (seen == (2 if key == "1" else 1)).all(), key
        assert torch.equal(w, q[f"w{key}q"].to(torch.int32)), key
        rows, cols, flat = jax_idx
        np.testing.assert_array_equal(pq[f"w{key}q"][rows, cols],
                                      w.numpy().reshape(-1)[flat], key)
        if key == "1":  # each window column's fragment column
            for p in (0, 1):
                colsum = torch.stack([
                    f[:, c % 2, 4 * (2 * (c // 2) + p):4 * (2 * (c // 2) + p)
                      + 4].to(torch.int32).sum() for c in range(co)])
                np.testing.assert_array_equal(
                    (128.0 * colsum.float() * q["d1"]).numpy(),
                    q["cf1"].numpy())
        else:
            colsum = torch.stack([
                f[:, nt, 4 * g:4 * g + 4].to(torch.int32).sum()
                for nt in range(co // 8) for g in range(8)])
            assert torch.equal(128 * colsum, q[f"cq{key}"]), key
