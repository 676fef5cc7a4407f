"""The port's corpus sweep (``eval-dataset``) and its serving modes against
the JAX package, on the CPU, on a small trained checkpoint (hidden 16, ROI
embedding 8, head 8; the ROI stays 48x96).

- The whole slice: the port's Predictor in bf16, q8 and im2col against the
  JAX live forward in the same mode (bf16 with roi_impl='fused',
  gru_impl='pallas'; q8 with the fused q8 kernel; im2col as
  roi_impl='pallas'), its Pallas kernels in interpret mode: the JAX
  Predictor for the first two, ``live_forward`` with the packed weights for
  im2col (the JAX Predictor packs them inside its jit there, and raises).
  Same argmax and logits within BAR_SAME_MODE; and each mode against the
  f32 path with tests/test_bf16_parity.py's guardrail (argmax equal, drift
  < LOGIT_TOL).
- ``load_corpus_arrays`` bitwise equal to the JAX one.
- ``evaluate_dataset`` and ``eval-dataset device=cpu``: the JAX
  ``evaluate_dataset``'s accuracy and confusions, avg_conf within 1e-5.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from silent_speech_tpu.data.native_loader import \
    load_corpus_arrays as jax_load_corpus_arrays
from silent_speech_tpu.infer.evaluator import \
    evaluate_dataset as jax_evaluate_dataset
from silent_speech_tpu.infer.predictor import Predictor as JPredictor
from silent_speech_tpu.models import bigru as jm
from silent_speech_tpu.ops import pallas_cnn
from silent_speech_tpu_torch.apps import cli
from silent_speech_tpu_torch.core.config import EvalConfig, serving_kwargs
from silent_speech_tpu_torch.core.schema import Clip, save_clip
from silent_speech_tpu_torch.data.corpus import scan_corpus
from silent_speech_tpu_torch.data.loader import load_corpus_arrays
from silent_speech_tpu_torch.data.synthetic import generate_corpus
from silent_speech_tpu_torch.infer import evaluator
from silent_speech_tpu_torch.infer.predictor import Predictor
from silent_speech_tpu_torch.train.loop import train
from silent_speech_tpu_torch.core.config import TrainConfig
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

WORDS = ["yes", "no", "hello", "thanks"]
MAX_T = 24
LOGIT_TOL = 0.15  # tests/test_bf16_parity.py
# the same mode in both packages: the f32 sums differ in order only (and,
# in bf16, where such a sum crosses a bf16 rounding boundary); measured
# 3.0e-7 (bf16), 3.0e-7 (q8), 2.4e-7 (im2col) on this checkpoint
BAR_SAME_MODE = 1e-5
# the port's modes and the JAX Predictor's knobs for the same function
MODES = {
    "bf16": (dict(compute_dtype="bfloat16"),
             dict(compute_dtype="bfloat16", roi_impl="fused",
                  gru_impl="pallas")),
    "q8": (dict(roi_variant="tiled3_q8"),
           dict(roi_impl="fused", roi_variant="tiled3_q8", gru_impl="scan")),
    "im2col": (dict(roi_variant="im2col"), None),
}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A corpus of 4 words x 4 clips and a checkpoint the port trained on
    it for 6 epochs on the CPU."""
    tmp = tmp_path_factory.mktemp("eval")
    corpus = str(tmp / "clips")
    generate_corpus(corpus, clips_per_word=4, words=WORDS, seed=3)
    ckpt = str(tmp / "m.ckpt")
    res = train(TrainConfig(clip_dir=corpus, out_path=ckpt, epochs=6,
                            patience=6, batch_size=8, max_t=MAX_T, lr=3e-3,
                            hidden=16, roi_emb=8), verbose=False,
                device="cpu")
    return corpus, ckpt, res


def _jax_predictor(res, **knobs):
    p = res["params"]
    mcfg = res["model_config"]
    cfg = jm.BiGRUConfig(x_dim=mcfg.x_dim, num_classes=mcfg.num_classes,
                         hidden=mcfg.hidden, roi_emb=mcfg.roi_emb,
                         head_hidden=mcfg.head_hidden,
                         gru_layers=mcfg.gru_layers)
    id_to_label = {int(k): v for k, v in res["meta"]["id_to_label"].items()}
    return JPredictor(params=jax.tree.map(jnp.asarray, p), cfg=cfg,
                      id_to_label=id_to_label, max_t=MAX_T, **knobs)


def _jax_logits(res, jax_kw, X, L, R):
    if jax_kw is not None:
        return _jax_predictor(res, **jax_kw).predict_batch(X, L, R)
    jp = _jax_predictor(res)
    return np.asarray(jm.live_forward(
        jp.params, jp.cfg, jnp.asarray(X), jnp.asarray(L), jnp.asarray(R),
        roi_impl="pallas", gru_impl="scan",
        roi_packed=pallas_cnn.pack_roi_cnn_params(res["params"]["roi_cnn"])))


def _corpus_arrays(corpus, x_dim):
    files = scan_corpus(corpus, verbose=False).files
    X, R, L, _ = load_corpus_arrays(files, MAX_T, x_dim, True)
    return X, L, R


@pytest.mark.parametrize("mode", sorted(MODES))
def test_serving_mode_matches_jax_and_f32(trained, mode):
    corpus, ckpt, res = trained
    port_kw, jax_kw = MODES[mode]
    ours = Predictor.from_checkpoint(ckpt, device="cpu", **port_kw)
    X, L, R = _corpus_arrays(corpus, ours.cfg.x_dim)
    got = ours.predict_batch(X, L, R)
    want = _jax_logits(res, jax_kw, X, L, R)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert np.abs(got - want).max() < BAR_SAME_MODE
    f32 = Predictor.from_checkpoint(ckpt, device="cpu").predict_batch(X, L, R)
    np.testing.assert_array_equal(got.argmax(-1), f32.argmax(-1))
    drift = np.abs(got - f32).max()
    assert drift < LOGIT_TOL, drift
    # im2col computes the f32 function (on the CPU through the same plain
    # version); bf16 and q8 are other functions
    assert (drift == 0) == (mode == "im2col"), drift


def test_bf16_mode_rounds_x_and_the_embedding_only(trained):
    """bf16 is the JAX gru_impl='pallas' serving mode: the GRU and head in
    f32 on bf16-rounded inputs, not the bf16 scan."""
    corpus, ckpt, res = trained
    ours = Predictor.from_checkpoint(ckpt, device="cpu",
                                     compute_dtype="bfloat16")
    X, L, R = _corpus_arrays(corpus, ours.cfg.x_dim)
    scan16 = _jax_predictor(res, compute_dtype="bfloat16", roi_impl="fused",
                            gru_impl="scan").predict_batch(X, L, R)
    pallas16 = _jax_predictor(res, **MODES["bf16"][1]).predict_batch(X, L, R)
    got = ours.predict_batch(X, L, R)
    assert np.abs(got - pallas16).max() < BAR_SAME_MODE < \
        np.abs(got - scan16).max()


def _write(path, X, roi=None, label="yes"):
    save_clip(Clip(X=X, ts=np.arange(len(X)) * 33, label=label,
                   speaker="t", roi=roi), path, min_frames=1)


def test_load_corpus_arrays_matches_jax(tmp_path, rng):
    d = tmp_path / "c"
    d.mkdir()
    u8 = lambda T: rng.integers(0, 256, (T, 48, 96), dtype=np.uint8)
    f32 = lambda T, D=20: rng.standard_normal((T, D)).astype(np.float32)
    _write(str(d / "t_yes_0_0001.npz"), f32(12), u8(12))
    _write(str(d / "t_yes_0_0002.npz"), f32(30), u8(30))        # > max_t
    _write(str(d / "t_no_0_0003.npz"), f32(10), u8(7))          # X longer
    _write(str(d / "t_no_0_0004.npz"), f32(6), u8(9))           # roi longer
    _write(str(d / "t_no_0_0005.npz"), f32(9, 26), u8(9))       # wider X
    _write(str(d / "t_hi_0_0006.npz"), f32(8, 14))              # no roi
    files = sorted(str(p) for p in d.glob("*.npz"))
    for use_roi in (True, False):
        got = load_corpus_arrays(files, MAX_T, 20, use_roi)
        want = jax_load_corpus_arrays(files, MAX_T, 20, use_roi)
        for a, b in zip(got, want):
            if b is None:
                assert a is None
            else:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    bad = str(d / "t_no_0_0007.npz")
    with open(bad, "wb") as f:
        f.write(b"not a zip")
    with pytest.raises(IOError, match=os.path.basename(bad)):
        load_corpus_arrays(files + [bad], MAX_T, 20, True)


def test_evaluate_dataset_and_cli_match_jax(trained, capsys):
    corpus, ckpt, res = trained
    want = jax_evaluate_dataset(
        _jax_predictor(res, roi_impl="xla", gru_impl="scan"), corpus,
        batch_size=5, chunk_size=7, verbose=False)
    ours = Predictor.from_checkpoint(ckpt, device="cpu")
    got = evaluator.evaluate_dataset(ours, corpus, batch_size=5, chunk_size=7,
                                     verbose=False)
    assert got["n"] == want["n"] == 16
    assert got["accuracy"] == want["accuracy"]
    assert got["confusions"] == want["confusions"]
    assert abs(got["avg_conf"] - want["avg_conf"]) < 1e-5
    capsys.readouterr()
    assert cli.main(["eval-dataset", f"ckpt_path={ckpt}",
                     f"clip_dir={corpus}", "batch_size=5", "device=cpu"]) == 0
    out = capsys.readouterr().out
    assert f"dataset acc: {want['accuracy']}" in out
    assert f"top confusions: {want['confusions']}" in out
    conf = float(out.split("avg conf:")[1].split()[0])
    assert abs(conf - want["avg_conf"]) < 1e-5


def test_eval_config_serving_kwargs_and_unported(trained, capsys):
    corpus, ckpt, _ = trained
    cfg = EvalConfig(compute_dtype="bfloat16", roi_variant="tiled3_q8",
                     matmul_precision="none")
    assert serving_kwargs(cfg) == dict(
        compute_dtype="bfloat16", roi_impl="auto", roi_variant="tiled3_q8",
        gru_impl="auto", matmul_precision=None)
    with pytest.raises(NotImplementedError, match="slice 7"):
        serving_kwargs(EvalConfig(mesh_shape={"data": 2}))
    with pytest.raises(NotImplementedError, match="slice 7"):
        cli.main(["eval-dataset", f"ckpt_path={ckpt}", f"clip_dir={corpus}",
                  "mesh_shape=data:2", "device=cpu"])
    with pytest.raises(ValueError, match="roi_impl"):
        cli.main(["eval-dataset", f"ckpt_path={ckpt}", f"clip_dir={corpus}",
                  "roi_impl=pallas", "device=cpu"])
    assert cli.main(["eval-dataset", "no_such_key=1"]) == 2
    assert "unknown arguments" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="slice 7"):
        evaluator.evaluate_ctc_dataset(ckpt, corpus, mesh_shape={"data": 2},
                                       device="cpu")
