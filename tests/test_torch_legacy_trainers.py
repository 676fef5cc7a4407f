"""The port's legacy trainers (silent_speech_tpu_torch/train/legacy_loops.py)
against the JAX package's, on the CPU.

- The preprocessing helpers and ``stratified_split_3way``: bitwise the JAX
  ones.
- One step of each trainer (augmentation and dropout off, small widths)
  against the JAX step assembled here from the JAX package's forward and
  optax, as its legacy_loops.py assembles it: the loss within BAR_LOSS, the
  clipped gradients within BAR_GRAD, the parameters after the step within
  BAR_PARAM (tests/test_torch_train.py::test_one_step_matches_jax's bars).
- Each trainer for 2 epochs through the port's CLI (device=cpu) beside the
  JAX trainer on the same corpus: the same ``meta``, tag included, the same
  console lines but for the numbers, and a checkpoint that both packages'
  ``VariantPredictor.from_checkpoint`` serve.
"""

import contextlib
import io
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import optax

from silent_speech_tpu.data import corpus as jcorpus
from silent_speech_tpu.infer.variant_predictor import \
    VariantPredictor as JVariantPredictor
from silent_speech_tpu.models import variants as JV
from silent_speech_tpu.train import legacy_loops as JL
from silent_speech_tpu.train.step import make_optimizer as jax_make_optimizer
from silent_speech_tpu_torch.apps import cli
from silent_speech_tpu_torch.data import corpus as tcorpus
from silent_speech_tpu_torch.data.synthetic import generate_corpus
from silent_speech_tpu_torch.infer import VariantPredictor
from silent_speech_tpu_torch.models import variants as V
from silent_speech_tpu_torch.train import legacy_loops as L
from silent_speech_tpu_torch.train.checkpoint import load_checkpoint
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BAR_LOSS, BAR_GRAD, BAR_PARAM = 1e-5, 1e-4, 3e-4
B, T, D, H, C = 6, 10, 13, 8, 5


def test_preprocessing_helpers_are_the_jax_ones():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((40, 18)).astype(np.float32)
    Xodd = np.concatenate([X, rng.random((40, 1), np.float32)], axis=1)
    quiet = np.zeros((40, 19), np.float32)  # no activity: the pad/trim
    for x in (X, Xodd, quiet):
        np.testing.assert_array_equal(L.activity_from_X(x),
                                      JL.activity_from_X(x))
        for t in (24, 60):
            np.testing.assert_array_equal(L.trim_by_activity(x, t),
                                          JL.trim_by_activity(x, t))
        np.testing.assert_array_equal(L.add_deltas(x), JL.add_deltas(x))
        np.testing.assert_array_equal(L.zscore_per_clip(x),
                                      JL.zscore_per_clip(x))
    files = [f"f{i}.npz" for i in range(23)]
    labels = [f"w{i % 4}" for i in range(23)]
    for seed in (0, 42):
        assert tcorpus.stratified_split_3way(list(files), labels, seed) == \
            jcorpus.stratified_split_3way(list(files), labels, seed)


def _problem(kind: str):
    """(JAX params, X, y, JAX forward, port model, port optimizer, optax
    optimizer) of one trainer at small widths."""
    rng = np.random.default_rng(1)
    X = rng.standard_normal((B, T, D)).astype(np.float32)
    y = rng.integers(0, C, B).astype(np.int32)
    key = jax.random.PRNGKey(2)
    if kind == "reduced":
        cfg = L.ReducedConfig()
        params = JV.init_reduced_bigru(key, D, C, hidden=H)
        fwd = JV.reduced_bigru_forward
        jopt = optax.chain(optax.clip_by_global_norm(cfg.grad_clip_norm),
                           optax.adam(cfg.lr))
        cls, make = V.ReducedBiGRU, L.reduced_optimizer
    elif kind == "unigru":
        cfg = L.UniGRUConfig()
        params = JV.init_unigru_classifier(key, D, C, hidden=H)
        fwd = JV.unigru_classifier_forward
        jopt = optax.chain(optax.clip_by_global_norm(1.0),
                           optax.adamw(cfg.lr,
                                       weight_decay=cfg.weight_decay))
        cls, make = V.UniGRUClassifier, L.unigru_optimizer
    else:
        cfg = L.MLPQuickConfig()
        params = JV.init_mlp(key, 2 * D, C)
        X = np.concatenate([X.mean(1), X.std(1)], -1).astype(np.float32)
        fwd = JV.mlp_forward
        jopt = jax_make_optimizer(cfg.lr, grad_clip_norm=1e9)
        cls, make = V.SummaryMLP, L.mlp_optimizer
    params = jax.tree.map(np.asarray, params)
    model = cls.from_jax_params(params)
    return params, X, y, fwd, model, make(model, cfg), jopt


def _max_diff(a, b) -> float:
    pa, pb = dict(V.named_leaves(a)), dict(V.named_leaves(b))
    assert sorted(pa) == sorted(pb)
    return max(float(np.abs(np.asarray(pa[k].detach() if isinstance(
        pa[k], torch.Tensor) else pa[k], np.float64) - np.asarray(
        pb[k], np.float64)).max()) for k in pa)


@pytest.mark.parametrize("kind", ["reduced", "unigru", "mlp"])
def test_one_step_matches_jax(kind):
    params, X, y, fwd, model, opt, jopt = _problem(kind)
    onehot = jax.nn.one_hot(jnp.asarray(y), C)

    def loss_fn(p):
        return jnp.mean(optax.softmax_cross_entropy(fwd(p, jnp.asarray(X)),
                                                    onehot))

    @jax.jit
    def jax_step(p):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, _ = jopt.update(grads, jopt.init(p), p)
        clipped, _ = optax.clip_by_global_norm(
            1e9 if kind == "mlp" else 1.0).update(grads, None)
        return loss, clipped, optax.apply_updates(p, updates)

    jloss, jclipped, want = jax_step(jax.tree.map(jnp.asarray, params))

    target = F.one_hot(torch.from_numpy(y).long(), C).to(torch.float32)
    loss, _ = L.legacy_step(opt, lambda x: model(x), torch.from_numpy(X),
                            target)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=BAR_LOSS)
    # the gradients after the clip, as the step left them in .grad, laid
    # out as a JAX tree through a model that holds them as parameters
    grads = type(model).from_jax_params(params)
    with torch.no_grad():
        for (_, g), (_, p) in zip(grads.named_parameters(),
                                  model.named_parameters()):
            g.copy_(p.grad)
    assert _max_diff(grads.params_tree(), jclipped) <= BAR_GRAD
    assert _max_diff(model.params_tree(), want) <= BAR_PARAM


WORDS5 = ["hello", "water", "thanks", "please", "apple"]
# trainer: (CLI command, JAX trainer and config, the config's overrides,
# the corpus's words and clips per word)
TRAINERS = {
    "reduced": ("train-reduced", JL.train_reduced, JL.ReducedConfig,
                dict(epochs=2, batch_size=8, max_t=40), WORDS5, 4),
    "unigru": ("train-unigru", JL.train_unigru, JL.UniGRUConfig,
               dict(epochs=2, batch_size=4, t_target=24), ["yes", "no"], 5),
    "mlp": ("train-mlp", JL.train_mlp_quick, JL.MLPQuickConfig,
            dict(epochs=2, batch_size=8), ["yes", "no", "hello"], 8),
}


def _masked(text: str) -> list[str]:
    """Console lines with their numbers and paths masked."""
    text = re.sub(r"\S*\.ckpt", "<ckpt>", text)
    return re.sub(r"\d+(\.\d+)?", "#", text).strip().splitlines()


@pytest.mark.parametrize("kind", list(TRAINERS))
def test_trainer_cli_writes_what_the_jax_trainer_writes(tmp_path, kind):
    cmd, jtrain, jcfg, over, words, per_word = TRAINERS[kind]
    corpus = str(tmp_path / "c")
    generate_corpus(corpus, clips_per_word=per_word, words=words, seed=1,
                    with_roi=False)
    jout = io.StringIO()
    with contextlib.redirect_stdout(jout):
        jtrain(jcfg(clip_dir=corpus, out_path=str(tmp_path / "j.ckpt"),
                    **over))
    out = io.StringIO()
    path = str(tmp_path / "t.ckpt")
    with contextlib.redirect_stdout(out):
        assert cli.main([cmd, f"clip_dir={corpus}", f"out_path={path}",
                         "device=cpu"] + [f"{k}={v}" for k, v in
                                          over.items()]) == 0
    _, meta, _ = load_checkpoint(path)
    _, jmeta, _ = load_checkpoint(str(tmp_path / "j.ckpt"))
    assert meta == jmeta and meta["model"] == {
        "reduced": "reduced_bigru", "unigru": "unigru",
        "mlp": "summary_mlp"}[kind]
    got, want = _masked(out.getvalue()), _masked(jout.getvalue())
    first = next(i for i, s in enumerate(want) if s.startswith("ep "))
    assert got[:first] == want[:first]  # the corpus and split lines
    assert {s for s in got if not s.startswith("  saved")} == \
        {s for s in want if not s.startswith("  saved")}
    X = np.random.default_rng(3).standard_normal((30, 180)).astype(
        np.float32)
    mine = VariantPredictor.from_checkpoint(path, device="cpu")
    theirs = JVariantPredictor.from_checkpoint(path)
    g, w = mine.predict_features(X, k=len(words)), \
        theirs.predict_features(X, k=len(words))
    assert [a for a, _ in g] == [a for a, _ in w]
    np.testing.assert_allclose([p for _, p in g], [p for _, p in w],
                               atol=1e-5, rtol=0)
