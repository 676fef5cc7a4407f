"""Offline dataset evaluation (port of the JAX infer/evaluator.py
``evaluate_dataset``): the ``eval-dataset`` sweep.

The reference sweeps every clip through the model one at a time
(inactive/dataset_eval.py:44-73), printing the dataset accuracy, the
average confidence and the top-10 confusion pairs, with labels parsed from
the filenames. Here the sweep is batched and streamed: clips load in
bounded chunks (data/loader.py), so host memory stays O(chunk_size) whatever
the corpus size, and each batch goes through the Predictor in its serving
mode. ``evaluate_variant_dataset`` and ``evaluate_temporal_cnn`` sweep the
feature-only families clip by clip; ``evaluate_ctc_dataset`` is the CTC
family's sweep (``eval-ctc``), scored against the checkpoint's dictionary.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional, Union

import numpy as np
import torch

from ..core.schema import (fix_dim, load_clip, parse_filename_label,
                           sanitize_field)
from ..data.corpus import scan_corpus
from ..data.loader import load_corpus_arrays
from .predictor import Predictor

_ROADMAP = ("is not ported to silent_speech_tpu_torch yet (ROADMAP.md queue "
            "1: {})")


def _softmax(x: np.ndarray, axis=-1) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def _npz_label(path: str) -> str:
    """Read only the label entry of a clip, falling back to the filename
    label when the npz has none (core.schema.load_clip's tolerance)."""
    with np.load(path, allow_pickle=False) as z:
        if "label" in z.files:
            return str(z["label"])
    return parse_filename_label(path)


def evaluate_dataset(predictor: Predictor, clip_dir: str, *,
                     batch_size: int = 64, chunk_size: int = 256,
                     label_from_filename: bool = True, verbose: bool = True,
                     top_confusions: int = 10) -> dict:
    """Sweep ``clip_dir`` with the official model's live forward.

    Returns {accuracy, avg_conf, confusions, n}, as the reference report:
    dataset accuracy, average confidence, the top (true, pred) pairs. At
    most ``chunk_size`` padded clips are in host memory at a time."""
    index = scan_corpus(clip_dir, verbose=False)
    cfg = predictor.cfg
    chunk_size = max(chunk_size, batch_size)

    correct, total, conf_sum = 0, 0, 0.0
    cm: Counter = Counter()
    for cs in range(0, len(index.files), chunk_size):
        files = index.files[cs:cs + chunk_size]
        X, R, L, _ = load_corpus_arrays(files, predictor.max_t, cfg.x_dim,
                                        cfg.use_roi,
                                        roi_hw=(cfg.roi_h, cfg.roi_w))
        true_labels = [parse_filename_label(f) if label_from_filename
                       else _npz_label(f) for f in files]
        for s in range(0, len(X), batch_size):
            e = s + batch_size
            logits = predictor.predict_batch(
                X[s:e], L[s:e], None if R is None else R[s:e])
            probs = _softmax(logits)
            for i, pid in enumerate(probs.argmax(-1)):
                pred_word = predictor.id_to_label.get(int(pid), str(int(pid)))
                if label_from_filename:
                    # filenames hold the sanitized ('_' -> '-') form
                    pred_word = sanitize_field(pred_word)
                true_word = true_labels[s + i]
                cm[(true_word, pred_word)] += 1
                correct += int(pred_word == true_word)
                conf_sum += float(probs[i, pid])
                total += 1

    return _report(correct, total, conf_sum, cm, top_confusions, verbose)


def zscore(X: np.ndarray) -> np.ndarray:
    """Per-clip feature z-scoring of the legacy eval pipelines
    (inactive/dataset_eval.py:18-19)."""
    return (X - X.mean(0, keepdims=True)) / (X.std(0, keepdims=True) + 1e-6)


def _report(correct: int, total: int, conf_sum: float, cm: Counter,
            top: int, verbose: bool) -> dict:
    acc = correct / total if total else 0.0
    avg_conf = conf_sum / total if total else 0.0
    confusions = list(cm.most_common(top))
    if verbose:
        print("dataset acc:", acc)
        print("avg conf:", avg_conf)
        print("top confusions:", confusions)
    return dict(accuracy=acc, avg_conf=avg_conf, confusions=confusions,
                n=total)


def evaluate_variant_dataset(predictor, clip_dir: str, *,
                             label_from_filename: bool = True,
                             verbose: bool = True,
                             top_confusions: int = 10) -> dict:
    """The corpus sweep of the feature-only variant families (a
    ``VariantPredictor``): each clip predicted alone with the family's own
    preprocessing (fix_dim / z-score / deltas / trim), the reference report
    (inactive/dataset_eval.py:44-73)."""
    index = scan_corpus(clip_dir, verbose=False)
    correct = total = 0
    conf_sum = 0.0
    cm: Counter = Counter()
    for f in index.files:
        c = load_clip(f)
        pred_word, conf = predictor.predict_features(
            c.X.astype(np.float32), k=1)[0]
        if label_from_filename:
            pred_word = sanitize_field(pred_word)
        true_word = parse_filename_label(f) if label_from_filename \
            else c.label
        cm[(true_word, pred_word)] += 1
        correct += int(pred_word == true_word)
        conf_sum += float(conf)
        total += 1
    return _report(correct, total, conf_sum, cm, top_confusions, verbose)


def evaluate_temporal_cnn(model, d_in: int, id_to_word: dict[int, str],
                          clip_dir: str, *, verbose: bool = True) -> dict:
    """The legacy TemporalCNN sweep (inactive/dataset_eval.py:44-73): each
    z-scored, dim-fixed clip at its own length through ``model`` (a
    ``models.variants.TemporalCNN``) on its device, TF32 off."""
    from .predictor import full_f32

    device = next(model.parameters()).device
    index = scan_corpus(clip_dir, verbose=False)
    correct = total = 0
    conf_sum = 0.0
    cm: Counter = Counter()
    for f in index.files:
        X = zscore(fix_dim(load_clip(f).X.astype(np.float32), d_in))
        with torch.inference_mode(), full_f32():
            logits = model(torch.as_tensor(X[None], device=device))
        probs = _softmax(logits.cpu().numpy())[0]
        pid = int(probs.argmax())
        pred_word = sanitize_field(id_to_word.get(pid, str(pid)))
        true_word = parse_filename_label(f)
        cm[(true_word, pred_word)] += 1
        correct += int(pred_word == true_word)
        conf_sum += float(probs[pid])
        total += 1
    out = _report(correct, total, conf_sum, cm, 10, verbose)
    if verbose:
        print("model d_in:", d_in)
    return out


def evaluate_ctc_dataset(ckpt_path: str, clip_dir: str, *,
                         verbose: bool = True, chunk_words: int = 0,
                         batch_size: int = 64,
                         mesh_shape: Optional[dict] = None,
                         compute_dtype: str = "float32",
                         roi_impl: str = "auto", roi_variant: str = "tiled3",
                         gru_impl: str = "auto", matmul_precision: str = "",
                         device: Union[str, torch.device] = "cuda") -> dict:
    """Dictionary-scored CTC sweep over a corpus: accuracy and the top
    confusions (the ``eval-ctc`` command).

    The offline counterpart of the CTC trainer's validation
    (inactive/train_model.py:235-251) on any saved CTC checkpoint of either
    package: each clip with a ROI is trimmed and padded to the checkpoint's
    max_t, and the clips sweep in batches of ``batch_size`` through
    ``CTCDecoder.score_batch`` (one forward, one lattice a word chunk).
    The serving knobs are evaluate_dataset's; ``matmul_precision`` ''
    keeps the decoder's 'parity', 'default' / 'none' the caller's
    settings. ``mesh_shape`` raises: the sweep over a device mesh is not
    ported (ROADMAP.md queue 1, slice 7)."""
    from ..models.ctc_model import normalize_label
    from .ctc_decode import CTCDecoder, trim_pad

    if mesh_shape:
        raise NotImplementedError(
            f"mesh_shape={mesh_shape!r}: the CTC sweep over a device mesh "
            + _ROADMAP.format("slice 7, multi-GPU"))
    kw = {}
    if matmul_precision:
        kw["matmul_precision"] = (None if matmul_precision in
                                  ("default", "none") else matmul_precision)
    dec = CTCDecoder.from_checkpoint(
        ckpt_path, device=device, chunk_words=chunk_words,
        compute_dtype=compute_dtype, roi_impl=roi_impl,
        roi_variant=roi_variant, gru_impl=gru_impl, **kw)

    index = scan_corpus(clip_dir, verbose=False)
    correct = total = 0
    cm: Counter = Counter()
    batch: list = []

    def flush():
        nonlocal correct, total
        if not batch:
            return
        scores = dec.score_batch(np.stack([b[0] for b in batch]),
                                 np.stack([b[1] for b in batch]),
                                 np.asarray([b[2] for b in batch], np.int32))
        for (_, _, _, true), pred_i in zip(batch, scores.argmax(-1)):
            pred = normalize_label(dec.dict.words[int(pred_i)])
            cm[(true, pred)] += 1
            correct += int(pred == true)
            total += 1
        batch.clear()

    for f in index.files:
        c = load_clip(f).aligned()
        if c.roi is None:
            continue
        Xp, Rp, T = trim_pad(c.X, c.roi, dec.max_t, **dec.trim_kw)
        if T == 0:
            continue
        batch.append((Xp, Rp, T, normalize_label(c.label)))
        if len(batch) >= batch_size:
            flush()
    flush()
    acc = correct / total if total else 0.0
    if verbose:
        print("dataset acc:", acc)
        print("top confusions:", cm.most_common(10))
    return dict(accuracy=acc, confusions=cm.most_common(10), n=total)
