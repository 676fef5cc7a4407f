"""The port's CTC trainer, CTC sweep and CLI (silent_speech_tpu_torch.train.
ctc_loop, infer.evaluator.evaluate_ctc_dataset, apps.cli), and the official
trainer's bf16 and host_data options, on the CPU at small widths, against
the JAX package where both packages compute the same function.

Bars:
- CTC checkpoints: the metadata contract of tests/test_train_ctc.py:28-34
  and the JAX trainer's keys (train/ctc_loop.py:188-196 there), equal; a
  checkpoint written by either package decodes in the other to the same
  accuracy and the same argmax on every clip, scores within 1e-4;
- one official bf16 train step against the JAX bf16 step (roi_impl='fused'
  with its Pallas pair replaced by its plain f32 reference, the CNN f32 and
  its embedding cast to bf16, the rest in bf16): two bf16 forwards that
  round at different places differ by a few bf16 steps (2^-8 relative) an
  operation, accumulated over the recurrence; the loss within 2^-8 of
  itself and each gradient tensor within 2^-4 of its largest |g| (the
  bf16 route itself moves them up to about 2^-6 from f32 at these sizes;
  running the CNN in bf16 moves the CNN's gradients by more than 2^-2);
- bf16 training learns and the parameters stay f32 (tests/test_train.py:
  296); host_data trains bitwise as the device-resident corpus.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from silent_speech_tpu.infer import ctc_decode as jdec
from silent_speech_tpu.infer import evaluator as jeval
from silent_speech_tpu.models import bigru as jm
from silent_speech_tpu.models import ctc_model as jcm
from silent_speech_tpu.ops import pallas_cnn2_grad
from silent_speech_tpu.train import checkpoint as jckpt
from silent_speech_tpu.train import step as jstep
from silent_speech_tpu_torch.apps import cli
from silent_speech_tpu_torch.core.config import CTCTrainConfig, TrainConfig
from silent_speech_tpu_torch.data.synthetic import generate_corpus
from silent_speech_tpu_torch.infer import ctc_decode as tdec
from silent_speech_tpu_torch.infer.evaluator import evaluate_ctc_dataset
from silent_speech_tpu_torch.models.bigru import (BiGRUClassifier,
                                                  BiGRUConfig, jax_tree,
                                                  tree_leaves)
from silent_speech_tpu_torch.train import checkpoint as tckpt
from silent_speech_tpu_torch.train.ctc_loop import train_ctc
from silent_speech_tpu_torch.train.loop import train
from silent_speech_tpu_torch.train.step import smoothed_cross_entropy
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

WORDS = ["yes", "no", "hello"]
CTC = dict(epochs=3, patience=3, batch_size=4, max_t=40, hidden=24,
           gru_layers=2, roi_emb=8)
# the JAX CTC trainer's checkpoint metadata (train/ctc_loop.py:188-196)
CTC_META = {"x_dim", "max_t", "vocab", "blank_id", "label_to_text",
            "uniq_labels", "exp_len", "len_lambda", "gru_layers", "seed",
            "roi_h", "roi_w"}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("ctc")
    generate_corpus(str(d), clips_per_word=4, words=WORDS, seed=5)
    return str(d)


def _sweep_arrays(dec, clip_dir):
    """The clips as evaluate_ctc_dataset batches them (trimmed, padded)."""
    from silent_speech_tpu_torch.core.schema import load_clip
    from silent_speech_tpu_torch.data.corpus import scan_corpus

    clips = [load_clip(f).aligned()
             for f in scan_corpus(clip_dir, verbose=False).files]
    Xs, Rs, Ls = zip(*(tdec.trim_pad(c.X, c.roi, dec.max_t, **dec.trim_kw)
                       for c in clips))
    return np.stack(Xs), np.stack(Rs), np.asarray(Ls, np.int32)


def _same_sweep(path, clip_dir, evaluators=True):
    """Both packages' decoders on one checkpoint: the same argmax on every
    clip, scores within 1e-4; with ``evaluators`` both packages' eval-ctc
    sweeps, the same result dict."""
    if evaluators:
        got = evaluate_ctc_dataset(path, clip_dir, batch_size=4,
                                   verbose=False, device="cpu")
        want = jeval.evaluate_ctc_dataset(path, clip_dir, batch_size=4,
                                          verbose=False)
        assert got["n"] == want["n"] == 4 * len(WORDS)
        assert got["accuracy"] == want["accuracy"]
        assert sorted(got["confusions"]) == sorted(want["confusions"])
    params, meta, _ = jckpt.load_checkpoint(path)
    dec = tdec.CTCDecoder.from_checkpoint(path, device="cpu")
    jd = jdec.CTCDecoder(jax.tree.map(jnp.asarray, params),
                         jdec.Dictionary.from_words(meta["uniq_labels"]),
                         max_t=int(meta["max_t"]))
    X, R, L = _sweep_arrays(dec, clip_dir)
    s_got, s_want = dec.score_batch(X, R, L), jd.score_batch(X, R, L)
    np.testing.assert_allclose(s_got, s_want, atol=1e-4, rtol=1e-4)
    assert (s_got.argmax(-1) == s_want.argmax(-1)).all()


def test_ctc_checkpoints_serve_across_packages(corpus, tmp_path):
    """train_ctc's checkpoint keeps the JAX trainer's metadata contract and
    decodes in the JAX package as in the port; a JAX-written checkpoint
    decodes in the port as in the JAX package."""
    out = str(tmp_path / "port.ckpt")
    r = train_ctc(CTCTrainConfig(clip_dir=corpus, out_path=out, **CTC),
                  verbose=False, device="cpu")
    assert 0.0 <= r["best_acc"] <= 1.0 and len(r["history"]) >= 1
    losses = [h["loss"] for h in r["history"]]
    assert all(np.isfinite(losses)) and losses[0] > 0
    _, meta, opt = tckpt.load_checkpoint(out)
    assert set(meta) == CTC_META and opt is None
    assert meta["vocab"][0] == "<blank>" and len(meta["vocab"]) == 27
    assert meta["blank_id"] == 0
    assert set(meta["uniq_labels"]) == set(WORDS)
    assert meta["label_to_text"]["hello"] == "hello"
    assert meta["x_dim"] == 180 and meta["max_t"] == 40
    assert meta == dict(r["meta"])
    _same_sweep(out, corpus, evaluators=False)

    jpath = str(tmp_path / "jax.ckpt")
    params = jcm.init_params(jax.random.PRNGKey(1), 180, hidden=24,
                             gru_layers=2, roi_emb=8)
    jckpt.save_checkpoint(jpath, jax.tree.map(np.asarray, params),
                          dict(meta, seed=1))
    _same_sweep(jpath, corpus)


def test_ctc_cli(corpus, tmp_path, capsys):
    """train-ctc (bf16 training route), eval-ctc and predict on the CTC
    checkpoint, on the CPU when asked; the usage errors exit 2."""
    out = str(tmp_path / "cli.ckpt")
    assert cli.main(["train-ctc", f"clip_dir={corpus}", f"out_path={out}",
                     "epochs=2", "batch_size=4", "max_t=40", "hidden=16",
                     "gru_layers=2", "roi_emb=8", "compute_dtype=bfloat16",
                     "device=cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln[:6] for ln in lines[:2]] == ["ep 001", "ep 002"]
    assert all(re.match(r"^ep \d{3} \| loss \d+\.\d{4} \| val acc \d\.\d{3} "
                        r"\[\d+\.\ds\]$", ln) for ln in lines[:2]), lines
    assert lines[-1].startswith("Best val acc:")
    params, _, _ = tckpt.load_checkpoint(out)
    assert all(a.dtype == np.float32 for a in jax.tree.leaves(params))
    assert cli.main(["eval-ctc", f"ckpt_path={out}", f"clip_dir={corpus}",
                     "batch_size=5", "chunk_words=2", "device=cpu",
                     "roi_variant=tiled3_q8"]) == 0
    text = capsys.readouterr().out
    assert re.search(r"^dataset acc: \S+$", text, re.M)
    assert re.search(r"^top confusions: \[", text, re.M)
    assert cli.main(["predict", f"ckpt_path={out}",
                     f"clip={corpus}/*.npz", "device=cpu", "k=2"]) == 0
    text = capsys.readouterr().out.strip().splitlines()
    assert len(text) == 4 * len(WORDS)
    dec = tdec.CTCDecoder.from_checkpoint(out, device="cpu")
    from silent_speech_tpu_torch.core.schema import load_clip
    for line in text:
        path, ranked = line.split(": ", 1)
        c = load_clip(path).aligned()
        assert ranked == str(dec.score_clip(c.X, c.roi)[:2])
    for argv in (["eval-ctc", f"clip_dir={corpus}"],
                 ["eval-ctc", f"ckpt_path={out}", "no_such_key=1"],
                 ["train-ctc", "no_such_key=1"]):
        assert cli.main(argv) == 2
    assert "usage" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="slice 7"):
        cli.main(["eval-ctc", f"ckpt_path={out}", f"clip_dir={corpus}",
                  "mesh_shape=data:2", "device=cpu"])
    with pytest.raises(ValueError, match="CTC checkpoint"):
        from silent_speech_tpu_torch.infer.predictor import load_predictor
        load_predictor(out, device="cpu")


# ------------------------------------------- the official trainer's options

SMALL = dict(x_dim=12, num_classes=4, hidden=16, roi_emb=8, head_hidden=8,
             gru_dropout=0.0, head_dropout=0.0)


def _fused_plain(roi_u8, params, *, standardize=True, **_):
    """The plain reference of the JAX fused training CNN: the f32 'xla'
    TinyROICNN on the same frames."""
    return jm.roi_cnn_forward(params, jm.preprocess_roi(roi_u8[None],
                                                        standardize))[0]


def test_bf16_train_step_matches_jax(monkeypatch):
    """One official train step in bf16 (dropout off): the loss and every
    gradient against the JAX bf16 step on the fused route; the parameters
    and the gradients stay f32, and the GRU ran in bf16."""
    monkeypatch.setattr(pallas_cnn2_grad, "roi_cnn_fused_train", _fused_plain)
    rng = np.random.default_rng(5)
    B, T = 3, 8
    L = rng.integers(3, T + 1, B).astype(np.int32)
    L[0] = T
    X = rng.standard_normal((B, T, 12)).astype(np.float32)
    R = rng.integers(0, 256, (B, T, 48, 96), dtype=np.uint8)
    y = rng.integers(0, 4, B).astype(np.int32)
    params = jax.tree.map(np.asarray, jm.init_params(
        jax.random.PRNGKey(0), jm.BiGRUConfig(**SMALL)))
    jcfg = jm.BiGRUConfig(**SMALL)

    def jloss(p):
        lg = jm.train_forward(p, jcfg, *map(jnp.asarray, (X, L, R)),
                              train=True, rng=jax.random.PRNGKey(0),
                              compute_dtype=jnp.bfloat16, roi_impl="fused")
        return jstep.smoothed_cross_entropy(lg, jnp.asarray(y), 4, 0.05)

    want, g_want = jax.jit(jax.value_and_grad(jloss))(jax.tree.map(jnp.asarray,
                                                          params))
    model = BiGRUClassifier.from_jax_params(params, BiGRUConfig(**SMALL))
    args = tuple(map(torch.from_numpy, (X, L, R)))
    out, _ = model.encode(*args, roi_standardize=True, train=True,
                          generator=torch.Generator(),
                          compute_dtype="bfloat16")
    assert out.dtype == torch.bfloat16
    logits = model.train_forward(*args, generator=torch.Generator(),
                                 compute_dtype="bfloat16")
    loss = smoothed_cross_entropy(logits, torch.from_numpy(y), 4, 0.05)
    loss.backward()
    with torch.no_grad():
        f32 = smoothed_cross_entropy(model.train_forward(
            *args, generator=torch.Generator()), torch.from_numpy(y), 4,
            0.05)
    assert logits.dtype == torch.float32 and loss.item() != f32.item()
    assert abs(loss.item() - float(want)) <= 2 ** -8 * abs(float(want))
    grads = jax_tree({n: p.grad for n, p in model.named_parameters()},
                     model.cfg)
    for got, ref in zip(tree_leaves(grads), jax.tree.leaves(g_want)):
        assert got.dtype == torch.float32
        ref = np.asarray(ref, np.float32)
        # pool.score.b's true gradient is 0 (the softmax ignores a shift):
        # both sides hold bf16 rounding noise there, about 1e-4
        bar = 2 ** -4 * max(float(np.abs(ref).max()), 2e-3)
        assert float(np.abs(got.numpy() - ref).max()) <= bar


def test_bf16_training_learns_and_params_stay_f32(tmp_path):
    """tests/test_train.py:296's bar for compute_dtype='bfloat16': it
    learns (beats 3-way chance) and the master parameters stay f32."""
    corpus = tmp_path / "clips"
    generate_corpus(str(corpus), clips_per_word=5, words=WORDS, seed=3)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        r = train(TrainConfig(clip_dir=str(corpus),
                              out_path=str(tmp_path / "m.ckpt"), epochs=10,
                              patience=10, batch_size=8, max_t=40, lr=1e-3,
                              hidden=32, roi_emb=8,
                              compute_dtype="bfloat16"),
                  verbose=False, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert r["history"][-1]["train_acc"] >= 0.5
    assert all(a.dtype == np.float32 for a in tree_leaves(r["params"]))


def test_host_data_trains_bitwise_as_the_device_corpus(tmp_path):
    corpus = tmp_path / "hc"
    generate_corpus(str(corpus), clips_per_word=4, words=["yes", "no"],
                    seed=8)
    runs = [train(TrainConfig(clip_dir=str(corpus), host_data=host,
                              out_path=str(tmp_path / f"{host}.ckpt"),
                              epochs=2, patience=5, batch_size=4, max_t=40,
                              hidden=8, roi_emb=4),
                  verbose=False, device="cpu") for host in (False, True)]
    assert [len(r["history"]) for r in runs] == [2, 2]
    for a, b in zip(tree_leaves(runs[0]["params"]),
                    tree_leaves(runs[1]["params"])):
        np.testing.assert_array_equal(a, b)
    timeless = [[{k: v for k, v in h.items() if k != "seconds"}
                 for h in r["history"]] for r in runs]
    assert timeless[0] == timeless[1]
    assert (tmp_path / "True.ckpt").exists()
