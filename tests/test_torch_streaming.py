"""The port's streaming engines and chunked GRU
(silent_speech_tpu_torch/infer/streaming.py, ops/gru.py) against the JAX
package's, on the CPU on the same seeded sequences.

- ``SlidingWindowEngine``: the same cadence (which frames predict), the
  same windows handed to the forward, the same (label, conf) given the same
  logits; ``stream_probs`` within one f32 ulp.
- ``OpennessGate``: the same ``ClipEvent``s (frames and ROIs bitwise) on
  the same openness sequences, the max_clip cap and resets included.
- ``CarryStreamingGRU`` (two stacked layers) within 1e-5 of the JAX engine
  frame by frame, and of the port's full scan over the same frames.
- ``unidirectional_gru_chunked`` within 1e-5 of JAX's, at several chunk
  sizes and ragged lengths, and of the port's one-chunk scan.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from silent_speech_tpu.core.config import StreamConfig as JStreamConfig
from silent_speech_tpu.infer import streaming as JS
from silent_speech_tpu.ops import gru as JG
from silent_speech_tpu.ops.nn import dense as jdense
from silent_speech_tpu_torch.core.config import StreamConfig
from silent_speech_tpu_torch.infer import streaming as PS
from silent_speech_tpu_torch.ops import gru as PG
from silent_speech_tpu_torch.ops.nn import dense, gru_dir_init, linear_init
from torch_threads import one_blas_thread  # noqa: F401 (autouse)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BAR = 1e-5


def _tree(gen, dims, hidden, classes):
    """A stacked forward-GRU tree {'gru': [{'fwd': ...}], 'head': ...} as
    numpy, from a torch generator."""
    layers, d = [], dims
    for _ in range(2):
        layers.append({"fwd": {k: v.numpy() for k, v in
                               gru_dir_init(d, hidden, gen).items()}})
        d = hidden
    head = {k: v.numpy() for k, v in linear_init(hidden, classes,
                                                 gen).items()}
    return {"gru": layers, "head": head}


def test_sliding_window_cadence_and_predictions(rng):
    kw = dict(max_t=20, pred_every=3, warmup_min=7)
    table = rng.standard_normal((64, 5)).astype(np.float32)
    windows = {"jax": [], "port": []}

    def fwd(name):
        def f(X):
            X = np.asarray(X)
            windows[name].append(X.copy())
            return table[len(windows[name]) % 64][None]
        return f

    ej = JS.SlidingWindowEngine(fwd("jax"), 83, JStreamConfig(**kw))
    ep = PS.SlidingWindowEngine(fwd("port"), 83, StreamConfig(**kw))
    for i in range(60):
        if i == 40:
            ej.reset()
            ep.reset()
        f = rng.standard_normal(83).astype(np.float32)
        rj, rp = ej.push(f), ep.push(f)
        assert (rj is None) == (rp is None), i
        if rj is not None:
            assert rj[0] == rp[0] and rj[1] == rp[1]
            np.testing.assert_array_equal(rp[2], rj[2])
    assert len(windows["port"]) == len(windows["jax"]) > 10
    for a, b in zip(windows["port"], windows["jax"]):
        assert a.shape == (1, 20, 83)
        np.testing.assert_array_equal(a, b)
    logits = rng.standard_normal(11).astype(np.float32) * 30
    np.testing.assert_allclose(PS.stream_probs(logits),
                               JS.stream_probs(logits), rtol=1e-6)


@pytest.mark.parametrize("kw", [dict(open_thresh=0.5, start_n=2, end_n=3,
                                     max_clip=50),
                                dict(open_thresh=0.3, start_n=1, end_n=2,
                                     max_clip=9)])
def test_openness_gate_events_equal_jax(rng, kw):
    gj, gp = JS.OpennessGate(JStreamConfig(**kw)), \
        PS.OpennessGate(StreamConfig(**kw))
    opens = np.repeat(rng.random(40), rng.integers(1, 6, 40))
    n_events = 0
    for i, o in enumerate(opens):
        f = rng.standard_normal(6).astype(np.float32)
        roi = rng.integers(0, 256, (4, 8), np.uint8) if i % 3 else None
        if i == len(opens) // 2:
            gj.reset()
            gp.reset()
        ej, ep = gj.push(float(o), f, roi), gp.push(float(o), f, roi)
        assert (ej is None) == (ep is None), i
        assert gj.speaking == gp.speaking
        if ej is not None:
            n_events += 1
            np.testing.assert_array_equal(ep.frames, ej.frames)
            if ej.rois is None:
                assert ep.rois is None
            else:
                np.testing.assert_array_equal(ep.rois, ej.rois)
    assert n_events >= 3


def test_carry_engine_against_jax_and_full_scan(rng):
    D, Hd, C, T = 12, 16, 5, 40
    tree = _tree(torch.Generator().manual_seed(3), D, Hd, C)
    seq = rng.standard_normal((T, D)).astype(np.float32)
    jtree = jax.tree.map(jnp.asarray, tree)
    ej = JS.CarryStreamingGRU(jtree["gru"],
                              head=lambda h: jdense(h, jtree["head"]))
    ttree = jax.tree.map(torch.from_numpy, tree)
    ep = PS.CarryStreamingGRU(ttree["gru"],
                              head=lambda h: dense(h, ttree["head"]))
    got, want = [], []
    for t in range(T):
        got.append(ep.push(seq[t]))
        want.append(np.asarray(ej.push(seq[t])))
        if t == 25:  # a reset drops the context in both
            ej.reset()
            ep.reset()
    got, want = np.stack(got), np.stack(want)
    np.testing.assert_allclose(got, want, atol=BAR)
    # the full scan over each segment gives every frame's logits
    for s, e in ((0, 26), (26, T)):
        x = torch.from_numpy(seq[None, s:e])
        top, _ = PG.unidirectional_gru_chunked(
            x, torch.tensor([e - s]), ttree["gru"], chunk_size=e - s)
        np.testing.assert_allclose(got[s:e], dense(top[0], ttree["head"])
                                   .numpy(), atol=BAR)


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_chunked_gru_matches_jax(rng, chunk):
    B, T, D, Hd = 3, 37, 10, 12
    tree = _tree(torch.Generator().manual_seed(chunk), D, Hd, 4)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    lengths = np.array([37, 20, 5], np.int32)
    yj, cj = JG.unidirectional_gru_chunked(
        jnp.asarray(x), jnp.asarray(lengths),
        jax.tree.map(jnp.asarray, tree["gru"]), chunk_size=chunk)
    ttree = jax.tree.map(torch.from_numpy, tree["gru"])
    yp, cp = PG.unidirectional_gru_chunked(
        torch.from_numpy(x), torch.from_numpy(lengths), ttree,
        chunk_size=chunk)
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), atol=BAR)
    for a, b in zip(cp, cj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=BAR)
    whole, _ = PG.unidirectional_gru_chunked(
        torch.from_numpy(x), torch.from_numpy(lengths), ttree, chunk_size=T)
    np.testing.assert_allclose(yp.numpy(), whole.numpy(), atol=BAR)
    assert not yp[2, 5:].any()  # zero past each length
