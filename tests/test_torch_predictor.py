"""The port's serving entry points (silent_speech_tpu_torch.infer.predictor,
the ``predict`` CLI) against the JAX package's Predictor on the same npz
checkpoint, on the CPU (plain paths on both sides)."""

import numpy as np
import pytest
import torch

import jax

from silent_speech_tpu.core.schema import Clip, save_clip
from silent_speech_tpu.core.torch_export import export_reference_checkpoint
from silent_speech_tpu.infer.predictor import Predictor as JPredictor
from silent_speech_tpu.models import bigru as jm
from silent_speech_tpu.train.checkpoint import save_checkpoint as jsave
from silent_speech_tpu_torch.apps import cli
from silent_speech_tpu_torch.infer.predictor import (Predictor, _bucket,
                                                     load_predictor,
                                                     topk_from_logits)
from silent_speech_tpu_torch.train.checkpoint import (load_checkpoint,
                                                      reference_meta,
                                                      save_checkpoint)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LABELS = ["yes", "no", "hello", "thanks", "please", "six", "seven", "aura",
          "lebron", "fahhh"]
MAX_T = 90  # buckets (16, 32, 64, 90)


def _meta():
    l2i = {w: i for i, w in enumerate(LABELS)}
    return reference_meta(x_dim=180, max_t=MAX_T, use_roi=True, roi_w=96,
                          roi_h=48, labels=LABELS, label_to_id=l2i,
                          id_to_label={i: w for w, i in l2i.items()}, seed=7)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A full-width official checkpoint written by the JAX package."""
    params = jax.tree.map(np.asarray,
                          jm.init_params(jax.random.PRNGKey(11),
                                         jm.BiGRUConfig()))
    path = str(tmp_path_factory.mktemp("ckpt") / "m.ckpt")
    jsave(path, params, _meta())
    return path, params


def test_predictor_matches_jax_per_bucket(ckpt, rng):
    path, _ = ckpt
    ours = Predictor.from_checkpoint(path, device="cpu")
    ref = JPredictor.from_checkpoint(path, roi_impl="xla", gru_impl="scan")
    assert ours.buckets == ref.buckets == (16, 32, 64, 90)
    for T in (11, 27, 50, 90):  # one clip per bucket
        feats = rng.standard_normal((T, 180)).astype(np.float32)
        roi = rng.integers(0, 256, (T, 48, 96), dtype=np.uint8)
        got, want = ours.predict_arrays(feats, roi), ref.predict_arrays(
            feats, roi)
        assert [w for w, _ in got] == [w for w, _ in want]
        np.testing.assert_allclose([p for _, p in got],
                                   [p for _, p in want], atol=1e-4)
    X = rng.standard_normal((3, 32, 180)).astype(np.float32)
    L = np.array([32, 5, 20], np.int32)
    R = rng.integers(0, 256, (3, 32, 48, 96), dtype=np.uint8)
    got, want = ours.predict_batch(X, L, R), ref.predict_batch(X, L, R)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_checkpoint_round_trip_and_torch_checkpoint(ckpt, tmp_path, rng):
    """npz written by the port reads back equal (and in either package);
    a reference .pt loads through from_torch_checkpoint to the same
    logits."""
    path, params = ckpt
    p2 = str(tmp_path / "port.ckpt")
    save_checkpoint(p2, params, _meta())
    back, meta, opt = load_checkpoint(p2)
    assert meta == _meta() and opt is None
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    pt = str(tmp_path / "ref.pt")
    export_reference_checkpoint(params, _meta(), pt)
    a = Predictor.from_checkpoint(p2, device="cpu")
    b = Predictor.from_torch_checkpoint(pt, device="cpu")
    X = rng.standard_normal((2, 16, 180)).astype(np.float32)
    L = np.array([16, 9], np.int32)
    R = rng.integers(0, 256, (2, 16, 48, 96), dtype=np.uint8)
    np.testing.assert_array_equal(a.predict_batch(X, L, R),
                                  b.predict_batch(X, L, R))
    assert b.id_to_label == a.id_to_label and b.max_t == MAX_T
    with pytest.raises(NotImplementedError, match="orbax"):
        load_checkpoint(str(tmp_path))


def test_load_predictor_warmup_and_cli(ckpt, tmp_path, rng, capsys):
    path, _ = ckpt
    pred = load_predictor(path, device="cpu").warmup(batch_sizes=(1, 2))
    assert isinstance(pred, Predictor)
    clip = Clip(X=rng.standard_normal((12, 180)).astype(np.float32),
                ts=np.arange(12), label="yes", speaker="t",
                roi=rng.integers(0, 256, (14, 48, 96), dtype=np.uint8))
    cpath = str(tmp_path / "t_yes_0_0001.npz")
    save_clip(clip, cpath)
    want = pred.predict_clip(clip)
    capsys.readouterr()
    assert cli.main(["predict", f"ckpt_path={path}", f"clip={cpath}",
                     "device=cpu", "k=3"]) == 0
    out = capsys.readouterr().out.strip()
    assert out == f"{cpath}: {want}"
    assert cli.main(["record-timed", "out_dir=x"]) == 2
    assert "not yet ported" in capsys.readouterr().out
    assert cli.main(["predict", f"ckpt_path={path}"]) == 2


def test_short_clip_bucket_and_topk(ckpt, rng):
    pred = Predictor.from_checkpoint(ckpt[0], device="cpu", min_frames=5)
    with pytest.raises(ValueError, match="too short"):
        pred.predict_arrays(np.zeros((4, 180), np.float32), None)
    assert [_bucket(t, (16, 32)) for t in (1, 16, 17, 40)] == [16, 16, 32, 32]
    top = topk_from_logits(np.arange(10.0), dict(enumerate(LABELS)), k=10)
    assert [w for w, _ in top] == LABELS[::-1]
    assert abs(sum(p for _, p in top) - 1.0) < 1e-9
    with torch.no_grad():
        assert pred.predict_arrays(
            rng.standard_normal((8, 180)).astype(np.float32), None)
