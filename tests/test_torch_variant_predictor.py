"""The port's VariantPredictor, load_predictor routing and variant sweeps
against the JAX package's, on the CPU.

- Every reference ``.pt`` schema (word_model_5.pt with its ``head.0.*``
  head and with the bare ``head.*`` skew, the GRU-word model with the same
  top-level keys, the 1130pm uni-GRU with its trim and deltas, the
  TemporalCNN, the quick MLP with 256 / 128 hidden units) routed by both
  packages' ``load_predictor``: the same family, and every top-k
  probability within BAR_PROBS of the JAX ``VariantPredictor`` on the same
  file and clips.
- npz checkpoints of the three legacy tags written by the JAX package and
  served by the port, and the reverse.
- ``evaluate_variant_dataset`` and ``evaluate_temporal_cnn`` give the JAX
  result on a tiny synthetic corpus, and the CLI's ``eval-dataset`` and
  ``predict`` route a variant checkpoint.
"""

import glob

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax

from silent_speech_tpu.infer import load_predictor as jax_load_predictor
from silent_speech_tpu.infer.evaluator import (
    evaluate_temporal_cnn as jax_evaluate_temporal_cnn,
    evaluate_variant_dataset as jax_evaluate_variant_dataset)
from silent_speech_tpu.infer.variant_predictor import \
    VariantPredictor as JVariantPredictor
from silent_speech_tpu.models import variants as JV
from silent_speech_tpu.train import checkpoint as jckpt
from silent_speech_tpu_torch.apps import cli
from silent_speech_tpu_torch.core.schema import load_clip
from silent_speech_tpu_torch.data.synthetic import generate_corpus
from silent_speech_tpu_torch.infer import (VariantPredictor,
                                           evaluate_temporal_cnn,
                                           evaluate_variant_dataset,
                                           load_predictor)
from silent_speech_tpu_torch.models import variants as V
from silent_speech_tpu_torch.train import checkpoint as tckpt
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# probabilities of the same f32 function, the sums in another order
BAR_PROBS = 1e-5
WORDS = [f"w{i}" for i in range(5)]


class _GRUHead(nn.Module):
    """The reference GRU classifiers: nn.GRU, then a head on its mean or on
    its final hidden state."""

    def __init__(self, d, h, layers, bidirectional, head):
        super().__init__()
        self.gru = nn.GRU(d, h, num_layers=layers, batch_first=True,
                          bidirectional=bidirectional)
        self.head = head


class _TemporalCNN(nn.Module):
    def __init__(self, d_in, c, width=16):
        super().__init__()
        self.net = nn.Sequential(
            nn.Conv1d(d_in, width, 5, padding=2), nn.ReLU(),
            nn.Conv1d(width, width, 5, padding=2), nn.ReLU(),
            nn.AdaptiveAvgPool1d(1))
        self.head = nn.Linear(width, c)


class _QuickMLP(nn.Module):
    def __init__(self, d_in, c):
        super().__init__()
        self.net = nn.Sequential(
            nn.Linear(d_in, 256), nn.ReLU(), nn.Dropout(0.2),
            nn.Linear(256, 128), nn.ReLU(), nn.Dropout(0.2),
            nn.Linear(128, c))


def _word5(sd, d, max_t=60):
    return {"model": sd, "id_to_label": dict(enumerate(WORDS)),
            "label_to_id": {w: i for i, w in enumerate(WORDS)},
            "input_dim": d, "max_t": max_t, "words": WORDS}


def _schema(name: str):
    """(checkpoint dict, the port's family, clip width) of one reference
    schema, weights from a seed."""
    torch.manual_seed(len(name))
    if name in ("reduced", "reduced_bare_head"):
        head = (nn.Sequential(nn.Linear(16, 5)) if name == "reduced"
                else nn.Linear(16, 5))
        m = _GRUHead(83, 8, 1, True, head)
        return _word5(m.state_dict(), 83), V.ReducedBiGRU, 83
    if name == "gru_word":
        m = _GRUHead(83, 8, 2, True, nn.Sequential(
            nn.LayerNorm(16), nn.Linear(16, 128), nn.ReLU(), nn.Dropout(0.2),
            nn.Linear(128, 5)))
        return _word5(m.state_dict(), 83), V.GRUWordClassifier, 83
    if name == "unigru":
        m = _GRUHead(166, 8, 1, False, nn.Linear(8, 5))
        return ({"model_state": m.state_dict(), "d_in": 166,
                 "id_to_word": dict(enumerate(WORDS)), "t_target": 32,
                 "d_target": 83, "use_deltas": True,
                 "trim": {"q": 0.6, "margin": 2, "min_keep": 6}},
                V.UniGRUClassifier, 90)
    if name == "temporal_cnn":
        return ({"model_state": _TemporalCNN(100, 5).state_dict(),
                 "d_in": 100, "num_classes": 5,
                 "id_to_word": dict(enumerate(WORDS))}, V.TemporalCNN, 120)
    return ({"model_state": _QuickMLP(166, 5).state_dict(),
             "labels": WORDS, "in_dim": 166}, V.SummaryMLP, 83)


@pytest.mark.parametrize("name", ["reduced", "reduced_bare_head",
                                  "gru_word", "unigru", "temporal_cnn",
                                  "mlp"])
def test_load_predictor_routes_every_torch_schema(tmp_path, name):
    ckpt, family, width = _schema(name)
    path = str(tmp_path / f"{name}.pt")
    torch.save(ckpt, path)
    got = load_predictor(path, device="cpu")
    want = jax_load_predictor(path)
    assert isinstance(got, VariantPredictor) and type(got.model) is family
    assert isinstance(want, JVariantPredictor)
    assert got.cfg.use_roi is False and got.d_in == want.d_in
    rng = np.random.default_rng(3)
    for T in (7, 40, 75):
        X = rng.standard_normal((T, width)).astype(np.float32)
        g, w = got.predict_arrays(X, None, k=5), want.predict_arrays(X, None,
                                                                     k=5)
        assert [a for a, _ in g] == [a for a, _ in w]
        np.testing.assert_allclose([p for _, p in g], [p for _, p in w],
                                   atol=BAR_PROBS, rtol=0)
    if name == "temporal_cnn":  # no label map: refused at load time
        del ckpt["id_to_word"]
        torch.save(ckpt, path)
        with pytest.raises(ValueError, match="id_to_word"):
            load_predictor(path, device="cpu")


def _legacy_checkpoints(tmp_path, writer: str) -> dict:
    """The three legacy tags' npz checkpoints (JAX init, their trainers'
    meta keys), written by ``writer``'s package."""
    key = jax.random.PRNGKey(5)
    trees = {
        "reduced_bigru": (JV.init_reduced_bigru(key, 83, 5, hidden=8),
                          dict(x_dim=83, max_t=40)),
        "unigru": (JV.init_unigru_classifier(key, 166, 5, hidden=8),
                   dict(d_in=166, d_target=83, t_target=24, use_deltas=True,
                        trim=dict(q=0.6, margin=2, min_keep=6),
                        id_to_word={str(i): w for i, w in enumerate(WORDS)})),
        "summary_mlp": (JV.init_mlp(key, 166, 5), dict(in_dim=166)),
    }
    paths = {}
    for tag, (params, meta) in trees.items():
        meta = dict(meta, model=tag, seed=0,
                    id_to_label={str(i): w for i, w in enumerate(WORDS)})
        paths[tag] = str(tmp_path / f"{writer}_{tag}.ckpt")
        if writer == "jax":
            jckpt.save_checkpoint(paths[tag], jax.tree.map(np.asarray,
                                                           params), meta)
        else:
            cls = {"reduced_bigru": V.ReducedBiGRU,
                   "unigru": V.UniGRUClassifier,
                   "summary_mlp": V.SummaryMLP}[tag]
            model = cls.from_jax_params(jax.tree.map(np.asarray, params))
            tckpt.save_checkpoint(paths[tag], model.params_tree(), meta)
    return paths


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npz_checkpoints_serve_in_both_packages(tmp_path, writer):
    rng = np.random.default_rng(4)
    for tag, path in _legacy_checkpoints(tmp_path, writer).items():
        got = VariantPredictor.from_checkpoint(path, device="cpu")
        want = JVariantPredictor.from_checkpoint(path)
        assert isinstance(load_predictor(path, device="cpu"),
                          VariantPredictor)
        for T in (9, 33):
            X = rng.standard_normal((T, 83)).astype(np.float32)
            g, w = got.predict_features(X, k=5), want.predict_features(X, k=5)
            assert [a for a, _ in g] == [a for a, _ in w], tag
            np.testing.assert_allclose([p for _, p in g], [p for _, p in w],
                                       atol=BAR_PROBS, rtol=0)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    out = tmp_path_factory.mktemp("variant_corpus") / "c"
    generate_corpus(str(out), clips_per_word=3, words=WORDS[:3], seed=9,
                    with_roi=False)
    return str(out)


def test_evaluators_match_jax(tmp_path, corpus):
    """Both sweeps on both packages, the same checkpoints: the same
    accuracy, count and confusions, the average confidence within
    BAR_PROBS."""
    def same(got, want):
        assert (got["accuracy"], got["n"], got["confusions"]) == (
            want["accuracy"], want["n"], [tuple(c) for c in
                                          want["confusions"]])
        assert abs(got["avg_conf"] - want["avg_conf"]) <= BAR_PROBS

    for path in _legacy_checkpoints(tmp_path, "port").values():
        same(evaluate_variant_dataset(load_predictor(path, device="cpu"),
                                      corpus, verbose=False),
             jax_evaluate_variant_dataset(jax_load_predictor(path), corpus,
                                          verbose=False))
    torch.manual_seed(6)
    ref = _TemporalCNN(180, 3)
    model = V.TemporalCNN.from_state_dict(ref.state_dict())
    params = jax.tree.map(lambda t: t.detach().numpy(), model.params_tree())
    i2w = dict(enumerate(WORDS[:3]))
    same(evaluate_temporal_cnn(model, 180, i2w, corpus, verbose=False),
         jax_evaluate_temporal_cnn(params, 180, i2w, corpus, verbose=False))


def test_cli_routes_variant_checkpoints(tmp_path, corpus, capsys):
    """eval-dataset and predict on a variant checkpoint (device=cpu):
    evaluate_variant_dataset's report and predict_features' top k."""
    path = _legacy_checkpoints(tmp_path, "port")["unigru"]
    pred = load_predictor(path, device="cpu")
    want = evaluate_variant_dataset(pred, corpus, verbose=False)
    capsys.readouterr()
    assert cli.main(["eval-dataset", f"ckpt_path={path}",
                     f"clip_dir={corpus}", "device=cpu"]) == 0
    out = capsys.readouterr().out
    assert f"dataset acc: {want['accuracy']}" in out
    assert f"top confusions: {want['confusions']}" in out
    clip = sorted(glob.glob(f"{corpus}/*.npz"))[0]
    top = pred.predict_features(load_clip(clip).X.astype(np.float32), k=2)
    assert cli.main(["predict", f"ckpt_path={path}", f"clip={clip}",
                     "device=cpu", "k=2"]) == 0
    assert capsys.readouterr().out.strip() == f"{clip}: {top}"
