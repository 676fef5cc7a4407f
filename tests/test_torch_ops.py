"""The port's plain building blocks (silent_speech_tpu_torch.ops.nn,
.pooling, .gru) against the JAX package's, on the same numpy inputs.

Both sides compute in float32 on the CPU; atol 1e-5 covers the different
summation orders of the two frameworks."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from silent_speech_tpu.ops import gru as jgru
from silent_speech_tpu.ops import nn as jnn
from silent_speech_tpu.ops import pooling as jpool
from silent_speech_tpu_torch.ops import gru as tgru
from silent_speech_tpu_torch.ops import nn as tnn
from silent_speech_tpu_torch.ops import pooling as tpool
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5


def _np(tree):
    """numpy tree -> (jax tree, torch tree)."""
    if isinstance(tree, dict):
        pairs = {k: _np(v) for k, v in tree.items()}
        return ({k: a for k, (a, _) in pairs.items()},
                {k: b for k, (_, b) in pairs.items()})
    return jnp.asarray(tree), torch.from_numpy(np.array(tree))


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=0)


def _gru_dir(rng, d, h):
    s = 1 / np.sqrt(h)
    return {"wi": rng.uniform(-s, s, (d, 3 * h)).astype(np.float32),
            "wh": rng.uniform(-s, s, (h, 3 * h)).astype(np.float32),
            "bi": rng.uniform(-s, s, (3 * h,)).astype(np.float32),
            "bh": rng.uniform(-s, s, (3 * h,)).astype(np.float32)}


def test_dense_and_layer_norm(rng):
    x = rng.standard_normal((5, 12)).astype(np.float32) * 3 + 1
    pj, pt = _np({"w": rng.standard_normal((12, 7)).astype(np.float32),
                  "b": rng.standard_normal(7).astype(np.float32)})
    xj, xt = _np(x)
    _close(tnn.dense(xt, pt), jnn.dense(xj, pj))
    lj, lt = _np({"scale": rng.standard_normal(12).astype(np.float32),
                  "bias": rng.standard_normal(12).astype(np.float32)})
    _close(tnn.layer_norm(xt, lt), jnn.layer_norm(xj, lj))


@pytest.mark.parametrize("shape", [(2, 12, 20, 3), (3, 7, 9, 1)])
def test_conv2d_nhwc_and_max_pool(rng, shape):
    c_in = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    pj, pt = _np({"w": rng.standard_normal((3, 3, c_in, 5)).astype(
        np.float32), "b": rng.standard_normal(5).astype(np.float32)})
    xj, xt = _np(x)
    yt, yj = tnn.conv2d_nhwc(xt, pt), jnn.conv2d_nhwc(xj, pj)
    _close(yt, yj)
    _close(tnn.max_pool_2x2(yt), jnn.max_pool_2x2(yj))  # odd sizes floor


def test_inits_use_the_explicit_generator():
    a = tnn.gru_dir_init(6, 4, torch.Generator().manual_seed(3))
    b = tnn.gru_dir_init(6, 4, torch.Generator().manual_seed(3))
    for k in a:
        assert torch.equal(a[k], b[k])
    assert a["wi"].shape == (6, 12) and a["wh"].shape == (4, 12)
    assert a["wi"].abs().max() <= 0.5  # U(+-1/sqrt(H))
    conv = tnn.conv_init(3, 3, 8, 16, torch.Generator().manual_seed(0))
    assert conv["w"].shape == (3, 3, 8, 16)
    assert conv["w"].abs().max() <= 1 / np.sqrt(72)


def test_length_mask_and_attn_pool(rng):
    h = rng.standard_normal((4, 9, 6)).astype(np.float32)
    lengths = np.array([9, 1, 4, 6], np.int32)
    pj, pt = _np({"score": {
        "w": rng.standard_normal((6, 1)).astype(np.float32),
        "b": rng.standard_normal(1).astype(np.float32)}})
    hj, ht = _np(h)
    lj, lt = _np(lengths)
    assert np.array_equal(tpool.length_mask(lt, 9).numpy(),
                          np.asarray(jpool.length_mask(lj, 9)))
    _close(tpool.attn_pool(ht, lt, pt), jpool.attn_pool(hj, lj, pj))
    assert tpool.NEG_INF == jpool.NEG_INF == -1e9


def test_flip_padded(rng):
    x = rng.standard_normal((3, 7, 2)).astype(np.float32)
    lengths = np.array([7, 3, 0], np.int32)
    got = tgru.flip_padded(torch.from_numpy(x), torch.from_numpy(lengths))
    want = jgru.flip_padded(jnp.asarray(x), jnp.asarray(lengths))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gru_cell_step(rng):
    h, d = 5, 5
    p = _gru_dir(rng, d, h)
    hv = rng.standard_normal((3, h)).astype(np.float32)
    xp = rng.standard_normal((3, 3 * h)).astype(np.float32)
    got = tgru.gru_cell_step(torch.from_numpy(hv), torch.from_numpy(xp),
                             torch.from_numpy(p["wh"]),
                             torch.from_numpy(p["bh"]))
    _close(got, jgru.gru_cell_step(jnp.asarray(hv), jnp.asarray(xp),
                                   jnp.asarray(p["wh"]),
                                   jnp.asarray(p["bh"])))


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_layer_single_direction_ragged(rng, reverse):
    B, T, D, H = 5, 11, 7, 6
    p = _gru_dir(rng, D, H)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    lengths = np.array([11, 1, 6, 0, 9], np.int32)
    pj, pt = _np(p)
    yt, ht = tgru.gru_layer_single_direction(
        torch.from_numpy(x), torch.from_numpy(lengths), pt, reverse=reverse)
    yj, hj = jgru.gru_layer_single_direction(
        jnp.asarray(x), jnp.asarray(lengths), pj, reverse=reverse)
    _close(yt, yj)
    _close(ht, hj)
    assert (yt[3] == 0).all() and (yt[1, 1:] == 0).all()  # zero past length


def test_bigru_stack(rng):
    B, T, D, H = 4, 8, 5, 6
    layers = [{"fwd": _gru_dir(rng, d, H), "bwd": _gru_dir(rng, d, H)}
              for d in (D, 2 * H)]
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    lengths = np.array([8, 2, 5, 7], np.int32)
    lj = [_np(lp)[0] for lp in layers]
    lt = [_np(lp)[1] for lp in layers]
    ot, ft = tgru.bigru(torch.from_numpy(x), torch.from_numpy(lengths), lt)
    oj, fj = jgru.bigru(jnp.asarray(x), jnp.asarray(lengths), lj)
    _close(ot, oj)
    _close(ft, fj)
