"""The port's CTC family (silent_speech_tpu_torch.ops.ctc,
models.ctc_model, infer.ctc_decode) against the JAX package's, on the CPU
at small widths (hidden 24, roi_emb 8, 2 and 3 GRU layers, B=3, T=12; the
ROI stays 48x96), the JAX side as its own tests run it ('xla' CNN, scan
GRU).

Bars:
- the lattice (loss, its gradient, dictionary scores): 1e-5 abs and rel,
  tighter than tests/test_ctc.py's 1e-4 (both sides run the same f32
  recursion; only exp and log differ in their last bits);
- the model's log-probabilities: 1e-5 (f32 matmuls and convolutions
  summed in another order);
- train-mode gradients of the CTC loss: tests/test_ctc_serving.py:104's
  bar, atol 5e-5 of each tensor's largest |g|, rtol 5e-4;
- the decoder's scores: 1e-4 and the same ranking (the log-probabilities'
  1e-5 summed over up to 2 T lattice terms);
- trim_silence, Dictionary and chunked against one-shot scores: bitwise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from silent_speech_tpu.infer import ctc_decode as jdec
from silent_speech_tpu.models import ctc_model as jcm
from silent_speech_tpu.ops import ctc as jctc
from silent_speech_tpu_torch.infer import ctc_decode as tdec
from silent_speech_tpu_torch.models import ctc_model as tcm
from silent_speech_tpu_torch.ops import ctc as tctc
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=1e-5, rtol=1e-5)
WORDS = ["yes", "no", "hello", "please", "thanks", "six", "seven", "aura"]


def _log_probs(rng, B, T, C=27, scale=3.0):
    logits = rng.standard_normal((B, T, C)).astype(np.float32) * scale
    return np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))


# (labels, label lengths, input lengths) at B=3, T=12
CASES = {
    "repeats": ([[3, 3, 5], [7, 7, 7], [1, 2, 1]], [3, 3, 3], [12, 12, 12]),
    "empty": ([[0, 0, 0], [4, 0, 0], [9, 9, 0]], [0, 1, 2], [12, 7, 12]),
    "short_inputs": ([[5, 6, 7], [2, 0, 0], [8, 8, 0]], [3, 1, 2],
                     [4, 2, 9]),
    # 6 labels with two repeats need 8 frames; 3 and 1 frames cannot hold
    # them: an NLL of 1e30, dropped by zero_infinity
    "impossible": ([[1, 1, 2, 2, 3, 4], [5, 6, 0, 0, 0, 0],
                    [1, 2, 3, 0, 0, 0]], [6, 2, 3], [3, 12, 1]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ctc_loss_and_gradient_match_jax(rng, case):
    labels, ll, il = (np.asarray(a, np.int32) for a in CASES[case])
    lp = _log_probs(rng, 3, 12)
    args = (jnp.asarray(il), jnp.asarray(labels), jnp.asarray(ll))
    want, g_want = jax.value_and_grad(
        lambda x: jctc.ctc_loss(x, *args))(jnp.asarray(lp))
    nll_want = np.asarray(jctc._ctc_nll_single(jnp.asarray(lp), *args, 0))
    x = torch.tensor(lp, requires_grad=True)
    targs = tuple(map(torch.from_numpy, (il, labels, ll)))
    got = tctc.ctc_loss(x, *targs)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_want), **TOL)
    assert np.isfinite(x.grad.numpy()).all()
    nll = tctc._ctc_nll_single(torch.from_numpy(lp), *targs).numpy()
    np.testing.assert_allclose(nll, nll_want, **TOL)
    if case == "impossible":
        assert nll[0] >= 1e30 and nll[2] >= 1e30 and nll[1] < 1e30


def test_ctc_loss_matches_torch_builtin(rng):
    """torch.nn.functional.ctc_loss as an oracle (tests/test_ctc.py:47)."""
    labels, ll, il = (np.asarray(a, np.int64) for a in CASES["short_inputs"])
    lp = _log_probs(rng, 3, 12)
    ref = torch.nn.functional.ctc_loss(
        torch.from_numpy(lp).transpose(0, 1), torch.from_numpy(labels),
        torch.from_numpy(il), torch.from_numpy(ll), zero_infinity=True)
    got = tctc.ctc_loss(torch.from_numpy(lp), *map(torch.from_numpy,
                                                   (il, labels, ll)))
    np.testing.assert_allclose(got.item(), ref.item(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("len_lambda", [0.0, 0.02])
def test_dictionary_scores_match_jax(rng, len_lambda):
    """One clip against the dictionary, a batch of clips against it, and
    each word alone; with and without the length prior. The chunked
    sweep's scores are bitwise the one-shot sweep's."""
    d = tdec.Dictionary.from_words(WORDS)
    lp = _log_probs(rng, 3, 12)
    T = np.asarray([12, 9, 5], np.int32)
    want = np.stack([np.asarray(jctc.ctc_word_logprobs_batch(
        jnp.asarray(lp[b]), jnp.asarray(d.ids), jnp.asarray(d.lens),
        jnp.asarray(T[b]))) for b in range(3)])
    if len_lambda:
        want = np.stack([np.asarray(jctc.length_prior_penalty(
            jnp.asarray(want[b]), jnp.asarray(d.lens), jnp.asarray(T[b]),
            len_lambda)) for b in range(3)])

    def prior(s, t):
        return tctc.length_prior_penalty(s, d.lens, t, len_lambda) \
            if len_lambda else s

    lpt = torch.from_numpy(lp)
    one = torch.stack([prior(tctc.ctc_word_logprobs_batch(
        lpt[b], d.ids, d.lens, int(T[b])), int(T[b])) for b in range(3)])
    clips = prior(tctc.ctc_word_logprobs_clips(lpt, torch.from_numpy(T),
                                               d.ids, d.lens),
                  torch.from_numpy(T)[:, None])
    np.testing.assert_allclose(one.numpy(), want, **TOL)
    np.testing.assert_array_equal(clips.numpy(), one.numpy())
    word = tctc.ctc_word_logprob(lpt[1], d.ids[2], d.lens[2], int(T[1]))
    np.testing.assert_allclose(
        word.item(), float(jctc.ctc_word_logprob(
            jnp.asarray(lp[1]), jnp.asarray(d.ids[2]), jnp.asarray(d.lens[2]),
            jnp.asarray(T[1]))), **TOL)
    chunked = torch.cat([tctc.ctc_word_logprobs_clips(
        lpt, torch.from_numpy(T), ids, lens)[:, :n]
        for ids, lens, n in tdec._chunks(d, 3)], dim=1)
    np.testing.assert_array_equal(
        chunked.numpy(), tctc.ctc_word_logprobs_clips(
            lpt, torch.from_numpy(T), d.ids, d.lens).numpy())


def test_trim_silence_and_dictionary_match_jax(rng):
    X = rng.standard_normal((30, 180)).astype(np.float32)
    R = rng.integers(0, 256, (30, 4, 4), dtype=np.uint8)
    X[:, -3] = 0.0
    X[7:20, -3] = 1.0
    for kw in ({}, {"pad": 0}, {"thresh": 0.5, "pad": 5}):
        for x in (X, X[:0], np.zeros_like(X)):
            r = R[:len(x)]
            got, want = tdec.trim_silence(x, r, **kw), jdec.trim_silence(
                x, r, **kw)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    words = WORDS + ["Hi-There", "x"]
    got, want = tdec.Dictionary.from_words(words), jdec.Dictionary.from_words(
        words)
    assert got.words == want.words
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.lens, want.lens)
    assert got.ids.dtype == want.ids.dtype == np.int32
    assert tcm.VOCAB == jcm.VOCAB and tcm.BLANK_ID == jcm.BLANK_ID
    assert [tcm.encode_text(tcm.normalize_label(w)) for w in words] == \
        [jcm.encode_text(jcm.normalize_label(w)) for w in words]


def _jax_params(layers, seed=3):
    return jax.tree.map(np.asarray, jcm.init_params(
        jax.random.PRNGKey(seed), 180, hidden=24, gru_layers=layers,
        roi_emb=8))


def _inputs(seed=7, B=3, T=12):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, 180)).astype(np.float32),
            rng.integers(0, 256, (B, T, 48, 96), dtype=np.uint8),
            np.array([12, 7, 3], np.int32)[:B])


@pytest.mark.parametrize("layers", [2, 3])
def test_forward_matches_jax(layers):
    """from_jax_params carries the JAX weights over (params_tree gives them
    back bitwise, under the reference state_dict names); the inference
    forward's per-frame log-probabilities match JAX's."""
    params = _jax_params(layers)
    model = tcm.BiGRUCTC.from_jax_params(params)
    assert model.cfg == tcm.CTCConfig(hidden=24, gru_layers=layers,
                                      roi_emb=8)
    names = set(dict(model.named_parameters()))
    assert {"proj.weight", "roi_cnn.net.6.weight",
            f"gru.weight_hh_l{layers - 1}_reverse"} <= names
    tree = jax.tree.map(lambda t: t.detach().numpy(), model.params_tree())
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    X, R, L = _inputs()
    want = np.asarray(jcm.forward(params, *map(jnp.asarray, (X, R, L))))
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (X, L)), torch.from_numpy(R))
    assert got.dtype == torch.float32 and got.shape == (3, 12, 27)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_train_gradients_match_jax():
    """The CTC loss's gradients through the differentiable forward (plain
    ROI CNN and GRU scan, dropout off) against jax.grad of the JAX forward
    in train mode."""
    params = _jax_params(3)
    X, R, L = _inputs()
    y = np.asarray([[8, 9, 0], [3, 0, 0], [5, 2, 1]], np.int32)
    ylen = np.asarray([2, 1, 3], np.int32)

    def jloss(p):
        lp = jcm.forward(p, jnp.asarray(X), jnp.asarray(R), jnp.asarray(L),
                         train=True, rng=jax.random.PRNGKey(0),
                         dropout_rate=0.0)
        return jctc.ctc_loss(lp, jnp.asarray(L), jnp.asarray(y),
                             jnp.asarray(ylen))

    want_loss, g_want = jax.jit(jax.value_and_grad(jloss))(
        jax.tree.map(jnp.asarray, params))
    model = tcm.BiGRUCTC.from_jax_params(params, tcm.CTCConfig(
        hidden=24, gru_layers=3, roi_emb=8, gru_dropout=0.0))
    lp = model(torch.from_numpy(X), torch.from_numpy(L), torch.from_numpy(R),
               train=True, generator=torch.Generator())
    loss = tctc.ctc_loss(lp, *map(torch.from_numpy, (L, y, ylen)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    named = {n: p.grad for n, p in model.named_parameters()}
    g_tree = {"roi_cnn": tcm.roi_cnn_tree(named, "roi_cnn."),
              "gru": tcm.gru_tree(named, 3),
              "proj": {"w": named["proj.weight"].t(),
                       "b": named["proj.bias"]}}
    assert jax.tree.structure(jax.tree.map(lambda t: 0, g_tree)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, params))
    for got, ref in zip(jax.tree.leaves(g_tree), jax.tree.leaves(g_want)):
        ref = np.asarray(ref)
        scale = max(1e-3, float(np.abs(ref).max()))
        np.testing.assert_allclose(got.numpy(), ref, atol=5e-5 * scale,
                                   rtol=5e-4)


def test_decoder_matches_jax(rng):
    """CTCDecoder.score_clip and score_batch against the JAX decoder on the
    same parameters, with chunk_words 0 and 3 (a ragged tail), and a
    chunked batch bitwise the one-shot batch."""
    params = _jax_params(2)
    B, T = 3, 16
    X = rng.standard_normal((B, T, 180)).astype(np.float32)
    X[:, 2:13, -3] = 1.0  # the openness channel: trim keeps frames 0..14
    R = rng.integers(0, 256, (B, T, 48, 96), dtype=np.uint8)
    L = np.asarray([16, 11, 6], np.int32)
    d_t, d_j = (m.Dictionary.from_words(WORDS) for m in (tdec, jdec))
    jd = jdec.CTCDecoder(jax.tree.map(jnp.asarray, params), d_j, max_t=T)
    want_batch = jd.score_batch(X, R, L)
    batches = {}
    for cw in (0, 3):
        dec = tdec.CTCDecoder(params, d_t, device="cpu", max_t=T,
                              chunk_words=cw)
        batches[cw] = dec.score_batch(X, R, L)
        np.testing.assert_allclose(batches[cw], want_batch, atol=1e-4,
                                   rtol=1e-4)
        assert (batches[cw].argmax(-1) == want_batch.argmax(-1)).all()
        for b in range(B):
            got, want = dec.score_clip(X[b], R[b]), jd.score_clip(X[b], R[b])
            assert [w for w, _ in got] == [w for w, _ in want]
            np.testing.assert_allclose([s for _, s in got],
                                       [s for _, s in want], atol=1e-4,
                                       rtol=1e-4)
        assert dec.predict(X[0], R[0]) == jd.predict(X[0], R[0])
    np.testing.assert_array_equal(batches[3], batches[0])
    assert tdec.CTCDecoder(params, d_t, device="cpu").word_chunk(64) == 8


def test_serving_modes_and_refusals():
    """The serving modes (their plain versions on the CPU) decode to
    finite log-probabilities near f32's; q8 refuses training, as in the
    JAX package; sharding and negative word chunks raise."""
    model = tcm.BiGRUCTC.from_jax_params(_jax_params(2))
    X, R, L = map(torch.from_numpy, _inputs())
    with torch.no_grad():
        ref = model(X, L, R)
        for knobs in ({"compute_dtype": "bfloat16"},
                      {"roi_variant": "tiled3_q8"},
                      {"roi_variant": "im2col"}):
            got = model(X, L, R, **knobs)
            assert got.dtype == torch.float32 and torch.isfinite(got).all()
            assert (got - ref).abs().max() < 0.15
    with pytest.raises(ValueError, match="serving-only"):
        model(X, L, R, train=True, generator=torch.Generator(),
              roi_variant="tiled3_q8")
    with pytest.raises(ValueError, match="generator"):
        model(X, L, R, train=True)
    d = tdec.Dictionary.from_words(WORDS)
    dec = tdec.CTCDecoder(model, d, device="cpu")
    with pytest.raises(NotImplementedError, match="slice 7"):
        dec.shard(None)
    with pytest.raises(ValueError, match="chunk_words"):
        tdec.CTCDecoder(model, d, device="cpu", chunk_words=-1)
    with pytest.raises(ValueError, match="roi_impl"):
        tdec.CTCDecoder(model, d, device="cpu", roi_impl="fused")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdec.CTCDecoder(model, d)
