"""The port's data modules (silent_speech_tpu_torch.data) against the JAX
package's: the synthetic corpus, the corpus preflight and split, the
padded dataset and the epoch sampler. All of them are numpy or plain
Python in both packages, so the bar is equality."""

import os

import numpy as np
import pytest
import torch

from silent_speech_tpu.data import corpus as jcorpus
from silent_speech_tpu.data import dataset as jdataset
from silent_speech_tpu.data.synthetic import generate_corpus as jgenerate
from silent_speech_tpu_torch.core.schema import Clip, load_clip, save_clip
from silent_speech_tpu_torch.data import corpus as tcorpus
from silent_speech_tpu_torch.data import dataset as tdataset
from silent_speech_tpu_torch.data.synthetic import generate_corpus

WORDS = ["yes", "no", "hello"]


def _by_clip_id(paths):
    # file names carry time.time(); the clip id is the last field
    return sorted(paths, key=lambda p: os.path.basename(p).rsplit("_", 1)[1])


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("clips")
    generate_corpus(str(d), clips_per_word=4, words=WORDS, seed=3)
    return str(d)


@pytest.mark.parametrize("with_roi", [True, False])
def test_synthetic_corpus_matches_jax(tmp_path, with_roi):
    got = _by_clip_id(generate_corpus(str(tmp_path / "t"), clips_per_word=2,
                                      words=WORDS, seed=5,
                                      with_roi=with_roi))
    want = _by_clip_id(jgenerate(str(tmp_path / "j"), clips_per_word=2,
                                 words=WORDS, seed=5, with_roi=with_roi))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        a, b = load_clip(g), load_clip(w)
        assert (a.label, a.speaker) == (b.label, b.speaker)
        for key in ("X", "ts", "idxs", "roi"):
            x, y = getattr(a, key), getattr(b, key)
            assert (x is None) == (y is None) == (key == "roi"
                                                  and not with_roi)
            if x is not None:
                np.testing.assert_array_equal(x, y)


def test_scan_filter_and_idx_signatures_match_jax(tmp_path, corpus_dir):
    # two clips of another feature dim and another idx signature
    rng = np.random.default_rng(0)
    d = tmp_path / "mixed"
    d.mkdir()
    for f in sorted(os.listdir(corpus_dir)):
        os.link(os.path.join(corpus_dir, f), d / f)
    for i in range(2):
        save_clip(Clip(X=rng.standard_normal((9, 40)).astype(np.float32),
                       ts=np.arange(9), label="no", speaker="x",
                       idxs=np.arange(5)), str(d / f"x_no_1_{i:04d}.npz"))
    ti = tcorpus.scan_corpus(str(d), verbose=False)
    ji = jcorpus.scan_corpus(str(d), verbose=False)
    for field in ("files", "labels", "dims", "has_roi", "idx_signatures"):
        assert getattr(ti, field) == getattr(ji, field), field
    (tf, tdim), (jf, jdim) = (tcorpus.filter_modal_dim(ti, verbose=False),
                              jcorpus.filter_modal_dim(ji, verbose=False))
    assert tdim == jdim == 180 and tf.files == jf.files
    assert tcorpus.warn_mixed_idx_signatures(ti, verbose=False) == \
        jcorpus.warn_mixed_idx_signatures(ji, verbose=False) == 2


@pytest.mark.parametrize("seed,val_frac", [(42, 0.15), (7, 0.3), (0, 0.5)])
def test_split_weights_and_label_maps_match_jax(corpus_dir, seed, val_frac):
    idx = tcorpus.scan_corpus(corpus_dir, verbose=False)
    got = tcorpus.split_by_label(idx.files, idx.labels, val_frac, seed=seed,
                                 verbose=False)
    want = jcorpus.split_by_label(idx.files, idx.labels, val_frac, seed=seed,
                                  verbose=False)
    assert got == want
    assert tcorpus.build_label_maps(idx.labels) == \
        jcorpus.build_label_maps(idx.labels)
    labels = [idx.labels[idx.files.index(f)] for f in got[0]]
    np.testing.assert_array_equal(tcorpus.inverse_frequency_weights(labels),
                                  jcorpus.inverse_frequency_weights(labels))


def test_top_confusions_match_jax():
    rng = np.random.default_rng(1)
    y_true, y_pred = rng.integers(0, 4, 60), rng.integers(0, 4, 60)
    names = dict(enumerate("abcd"))
    for k in (1, 3, 8):
        assert tcorpus.top_confusions(y_true, y_pred, names, k=k) == \
            jcorpus.top_confusions(y_true, y_pred, names, k=k)


@pytest.mark.parametrize("use_roi,max_t,x_dim", [(True, 30, None),
                                                 (False, 20, 176)])
def test_dataset_matches_jax(corpus_dir, use_roi, max_t, x_dim):
    idx = tcorpus.scan_corpus(corpus_dir, verbose=False)
    l2i, _ = tcorpus.build_label_maps(idx.labels)
    got = tdataset.build_dataset(idx.files, l2i, max_t, use_roi, x_dim,
                                 device="cpu", labels=idx.labels)
    want = jdataset.build_device_dataset(idx.files, l2i, max_t, use_roi,
                                         x_dim, device=False,
                                         prefer_native=False,
                                         labels=idx.labels)
    np.testing.assert_array_equal(got.X.numpy(), want.X)
    np.testing.assert_array_equal(got.lengths.numpy(), want.lengths)
    np.testing.assert_array_equal(got.y.numpy(), want.y)
    assert got.labels == want.labels and got.max_t == max_t
    if use_roi:
        np.testing.assert_array_equal(got.roi.numpy(), want.roi)
    else:
        assert got.roi is None and want.roi is None
    rows = np.asarray([3, 0, 3, 7], np.int32)
    for a, b in zip(got.gather(rows), (want.X, want.lengths,
                                       want.roi, want.y)):
        if b is not None:
            np.testing.assert_array_equal(a.numpy(), b[rows])


@pytest.mark.parametrize("kw", [
    dict(), dict(weights=np.arange(1.0, 12.0)), dict(shuffle=False),
    dict(shuffle=False, pad=False), dict(drop_last=True),
], ids=["shuffle", "weighted", "sequential", "no-pad", "drop-last"])
def test_epoch_batches_match_jax(kw):
    got = list(tdataset.epoch_batches(11, 4, np.random.default_rng(9), **kw))
    want = list(jdataset.epoch_batches(11, 4, np.random.default_rng(9), **kw))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_dataset_lives_on_the_device_it_is_asked_for(corpus_dir):
    idx = tcorpus.scan_corpus(corpus_dir, verbose=False)
    l2i, _ = tcorpus.build_label_maps(idx.labels)
    ds = tdataset.build_dataset(idx.files[:3], l2i, 16, True, device="cpu")
    assert ds.X.device == torch.device("cpu") and ds.y.dtype == torch.int64
    with pytest.raises(ValueError, match="labels"):
        tdataset.build_dataset(idx.files[:3], l2i, 16, True, device="cpu",
                               labels=["yes"])
