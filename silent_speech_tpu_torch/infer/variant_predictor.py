"""Predictors for the non-official model families (port of the JAX
infer/variant_predictor.py).

Dispatches on the ``model`` tag the legacy trainers' npz checkpoints carry
(train/legacy_loops.py), and loads the reference PyTorch checkpoints of
each generation (word_model.pt / word_model_5.pt schema variants,
inactive/dataset_eval.py:34-42, inactive/caden_record.py:138-148) straight
into the families' modules (models/variants.py), ``weights_only=True``.

Serving runs under the official Predictor's precision context
(``matmul_precision='parity'``: matmul and cuDNN TF32 off). The JAX
package pads the TemporalCNN's clips to buckets of 32 frames so a TPU
program compiles once; the port runs each clip at its own length, which
the masked forward computes bitwise.
"""

from __future__ import annotations

import contextlib
import types
from typing import Optional, Union

import numpy as np
import torch

from ..core.schema import fix_dim, pad_trim_time
from ..models import variants as V
from ..ops._kernels import IMPLS
from ..train.checkpoint import load_checkpoint
from .predictor import FULL_F32_PRECISIONS, full_f32, topk_from_logits

NO_MAX_T = 10 ** 6  # the families that take a clip at any length


def _load_pt(path: str, ckpt):
    return ckpt if ckpt is not None else torch.load(
        path, map_location="cpu", weights_only=True)


class VariantPredictor:
    """Clip predictor over a feature-only variant model on one torch
    device ('cuda' by default; the CPU must be asked for). ``gru_impl``:
    'auto' (K2 on a CUDA device, the plain scan on the CPU), 'kernel' or
    'plain', for the GRU families; ``matmul_precision``: 'parity' or
    'highest' (TF32 off), or None (the caller's settings)."""

    def __init__(self, model: V.Variant, id_to_label: dict[int, str],
                 d_in: int, max_t: int, *,
                 device: Union[str, torch.device] = "cuda",
                 zscore: bool = False, add_deltas: bool = False,
                 trim: Optional[dict] = None, summary_host: bool = False,
                 gru_impl: str = "auto",
                 matmul_precision: Optional[str] = "parity"):
        if gru_impl not in IMPLS:
            raise ValueError(f"gru_impl={gru_impl!r}: the port takes one of "
                             f"{IMPLS}")
        if matmul_precision is not None and \
                matmul_precision not in FULL_F32_PRECISIONS:
            raise ValueError(f"matmul_precision={matmul_precision!r}: the "
                             f"port takes {FULL_F32_PRECISIONS + (None,)}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but torch sees no CUDA device; "
                               "pass device='cpu' to predict on the CPU")
        self.model = model.to(self.device).eval()
        self.id_to_label = id_to_label
        self.d_in = d_in
        self.max_t = max_t
        self.zscore = zscore
        self.add_deltas = add_deltas
        self.trim = trim  # activity-trim config (unigru family)
        # summary_host: the (2D,) mean / std summary in numpy, as the trainer
        # makes it (train_5_quick.py:13-17)
        self.summary_host = summary_host
        self.matmul_precision = matmul_precision
        self._fwd_kw = ({"gru_impl": gru_impl}
                        if isinstance(model, V.GRUFamily) else {})
        # duck-typed model-config shim for the live app loops: the variant
        # models are feature-only
        self.cfg = types.SimpleNamespace(use_roi=False, roi_h=48, roi_w=96)

    @classmethod
    def from_checkpoint(cls, path: str, _loaded=None,
                        **kw) -> "VariantPredictor":
        """An npz checkpoint of a legacy trainer, either package's."""
        params, meta, _ = _loaded if _loaded is not None else \
            load_checkpoint(path)
        model = meta.get("model")
        if model == "reduced_bigru":
            i2l = {int(k): v for k, v in meta["id_to_label"].items()}
            return cls(V.ReducedBiGRU.from_jax_params(params), i2l,
                       int(meta["x_dim"]), int(meta["max_t"]), **kw)
        if model == "unigru":
            i2l = {int(k): v for k, v in meta["id_to_word"].items()}
            return cls(V.UniGRUClassifier.from_jax_params(params), i2l,
                       int(meta["d_target"]), int(meta["t_target"]),
                       zscore=True, add_deltas=bool(meta.get("use_deltas")),
                       trim=dict(meta.get("trim", {})), **kw)
        if model == "summary_mlp":
            i2l = {int(k): v for k, v in meta["id_to_label"].items()}
            return cls(V.SummaryMLP.from_jax_params(params), i2l,
                       int(meta["in_dim"]) // 2, NO_MAX_T, summary_host=True,
                       **kw)
        raise ValueError(f"unknown variant model tag: {model!r}")

    @classmethod
    def from_torch_reduced(cls, path: str, _ckpt=None,
                           **kw) -> "VariantPredictor":
        """Reference word_model_5.pt (inactive/train_reduced.py:250-257:
        model / id_to_label / input_dim / max_t), its head as ``head.0.*``
        or, as the caden demos name it, ``head.*``."""
        ckpt = _load_pt(path, _ckpt)
        i2l = {int(k): str(v) for k, v in ckpt["id_to_label"].items()}
        return cls(V.ReducedBiGRU.from_state_dict(ckpt["model"]), i2l,
                   int(ckpt["input_dim"]), int(ckpt["max_t"]), **kw)

    @classmethod
    def from_torch_gru_word(cls, path: str, _ckpt=None,
                            **kw) -> "VariantPredictor":
        """Reference GRUWordClassifier checkpoint (inactive/live_feed.py:
        29-50, :131-141): word_model_5.pt's top-level keys, a 2-layer
        BiGRU h=128 with a LayerNorm + MLP head (``gru.weight_ih_l1`` tells
        it apart)."""
        ckpt = _load_pt(path, _ckpt)
        i2l = {int(k): str(v) for k, v in ckpt["id_to_label"].items()}
        return cls(V.GRUWordClassifier.from_state_dict(ckpt["model"]), i2l,
                   int(ckpt["input_dim"]), int(ckpt["max_t"]), **kw)

    @classmethod
    def from_torch_unigru(cls, path: str, _ckpt=None,
                          **kw) -> "VariantPredictor":
        """Reference 1130pm word_model.pt (inactive/train_model_1130pm.py:
        230-241: model_state / d_in / id_to_word / t_target / d_target /
        use_deltas / trim)."""
        ckpt = _load_pt(path, _ckpt)
        i2l = {int(k): str(v) for k, v in ckpt["id_to_word"].items()}
        return cls(V.UniGRUClassifier.from_state_dict(ckpt["model_state"]),
                   i2l, int(ckpt["d_target"]), int(ckpt["t_target"]),
                   zscore=True, add_deltas=bool(ckpt.get("use_deltas")),
                   trim=dict(ckpt.get("trim", {})), **kw)

    @classmethod
    def from_torch_mlp(cls, path: str, _ckpt=None,
                       **kw) -> "VariantPredictor":
        """Reference quick-MLP checkpoint (inactive/train_5_quick.py:
        133-136: model_state / labels / in_dim; in_dim = 2 D, the mean +
        std summary)."""
        ckpt = _load_pt(path, _ckpt)
        i2l = {i: str(w) for i, w in enumerate(ckpt["labels"])}
        return cls(V.SummaryMLP.from_state_dict(ckpt["model_state"]), i2l,
                   int(ckpt["in_dim"]) // 2, NO_MAX_T, summary_host=True,
                   **kw)

    @classmethod
    def from_torch_temporal_cnn(cls, path: str, _ckpt=None,
                                **kw) -> "VariantPredictor":
        """Legacy word_model.pt with the TemporalCNN schema
        (inactive/dataset_eval.py:34-42: d_in / num_classes / model_state
        / id_to_word)."""
        ckpt = _load_pt(path, _ckpt)
        i2l = {int(k): str(v) for k, v in ckpt.get("id_to_word", {}).items()}
        if not i2l:
            # fail before the weights load: topk_from_logits indexes the map
            raise ValueError(
                f"{path} has no id_to_word map in its checkpoint: cannot "
                "name predictions (re-save the checkpoint with its label map)")
        return cls(V.TemporalCNN.from_state_dict(ckpt["model_state"]), i2l,
                   int(ckpt["d_in"]), NO_MAX_T, zscore=True, **kw)

    def preprocess(self, X: np.ndarray) -> np.ndarray:
        """The family's training-time preprocessing of one clip (T, D_any),
        in the trainer's order (train/legacy_loops._unigru_preprocess):
        fix_dim, then the activity trim to the target window (unigru) or
        the pad / trim to max_t, the z-score, the deltas and a second
        z-score; for the MLP the (2D,) mean / population-std summary."""
        X = fix_dim(np.asarray(X, np.float32), self.d_in)
        if self.trim is not None and self.max_t < NO_MAX_T:
            from ..train.legacy_loops import trim_by_activity

            X = trim_by_activity(
                X, self.max_t,
                margin=int(self.trim.get("margin", 2)),
                q=float(self.trim.get("q", 0.60)),
                min_keep=int(self.trim.get("min_keep", 6)))
        elif self.max_t < NO_MAX_T:
            X, _ = pad_trim_time(X, self.max_t)
        if self.zscore:
            X = (X - X.mean(0, keepdims=True)) / (X.std(0, keepdims=True)
                                                  + 1e-6)
        if self.add_deltas:
            d = np.zeros_like(X)
            d[1:] = X[1:] - X[:-1]
            X = np.concatenate([X, d], axis=1)
            X = (X - X.mean(0, keepdims=True)) / (X.std(0, keepdims=True)
                                                  + 1e-6)
        if self.summary_host:
            return np.concatenate([X.mean(0), X.std(0)]).astype(np.float32)
        return X

    def logits(self, X: np.ndarray) -> np.ndarray:
        """The model's logits (C,) for one clip (T, D_any), after
        :meth:`preprocess`."""
        x = self.preprocess(X)
        precision = (full_f32() if self.matmul_precision is not None
                     else contextlib.nullcontext())
        with torch.inference_mode(), precision:
            t = torch.as_tensor(x[None], device=self.device)
            return self.model(t, **self._fwd_kw)[0].float().cpu().numpy()

    def predict_features(self, X: np.ndarray, k: int = 3):
        """X: (T, D_any) -> the top-k (word, prob) pairs."""
        return topk_from_logits(self.logits(X), self.id_to_label, k)

    def predict_arrays(self, feats, roi, k: int = 3):
        """The Predictor interface (apps/live.py): the variant families are
        feature-only, so the ROI stack is ignored."""
        del roi
        return self.predict_features(np.asarray(feats, np.float32), k=k)
