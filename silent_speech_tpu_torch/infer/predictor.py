"""Clip prediction — the live-inference path (port of the JAX
infer/predictor.py, official family).

Reproduces live_infer_official.py's predict block (:338-359): truncate the
clip to max_t, run the live forward (no ROI standardization), return the
top-k (word, prob) list. Clips pad to bucketed lengths, as in the JAX
package, so the same inputs reach both packages' forwards.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..core.schema import Clip, pad_trim_time
from ..models.bigru import BiGRUClassifier, BiGRUConfig
from ..ops._kernels import IMPLS
from ..train.checkpoint import load_checkpoint

# 'parity' and 'highest' both mean full f32 on the card: TF32 is disallowed
# for CUDA matmuls and cuDNN convolutions during the forward (cuDNN defaults
# to TF32, about 1e-3 of drift). None leaves the caller's settings.
FULL_F32_PRECISIONS = ("parity", "highest")


def topk_from_logits(logits: np.ndarray, id_to_label: dict[int, str],
                     k: int = 3) -> list[tuple[str, float]]:
    """Softmax + top-k, formatted as the reference
    (live_infer_official.py:223-226)."""
    x = np.asarray(logits, dtype=np.float64).reshape(-1)
    x = x - x.max()
    p = np.exp(x)
    p /= p.sum()
    top = np.argsort(p)[::-1][:k]
    return [(id_to_label[int(i)], float(p[i])) for i in top]


def _bucket(T: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if T <= b:
            return b
    return buckets[-1]


@contextlib.contextmanager
def full_f32():
    """Disallow TF32 for CUDA matmuls and cuDNN; restore the caller's
    settings afterwards. The settings are process-wide."""
    matmul_prec = torch.get_float32_matmul_precision()
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(matmul_prec)
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


def _check_knobs(roi_impl, gru_impl, roi_variant, compute_dtype,
                 matmul_precision) -> None:
    for name, value, jax_only in (
            ("roi_impl", roi_impl, "'xla', 'grouped', 'pallas', 'fused'"),
            ("gru_impl", gru_impl, "'scan', 'pallas'")):
        if value not in IMPLS:
            raise ValueError(
                f"{name}={value!r} is not a value of the port; it takes one "
                f"of {IMPLS} (the JAX package's {jax_only} do not apply)")
    if roi_variant != "tiled3":
        raise ValueError(
            f"roi_variant={roi_variant!r}: the port's ROI CNN kernel "
            "implements 'tiled3' only (the int8 'tiled3_q8' mode is not "
            "ported yet)")
    if compute_dtype != "float32":
        raise ValueError(
            f"compute_dtype={compute_dtype!r}: the port serves 'float32' "
            "only (the bf16 mode is not ported yet)")
    if isinstance(matmul_precision, dict):
        raise ValueError(
            "per-site matmul_precision dicts are not ported: they wait for "
            "a drift measurement on the card; use 'parity', 'highest' or "
            "None")
    if matmul_precision is not None and \
            matmul_precision not in FULL_F32_PRECISIONS:
        raise ValueError(
            f"matmul_precision={matmul_precision!r}: the port takes "
            f"{FULL_F32_PRECISIONS + (None,)}")


@dataclasses.dataclass
class Predictor:
    """Clip predictor for the official model on one torch device.

    ``device`` is required; 'cuda' without a GPU raises. ``roi_impl`` and
    ``gru_impl``: 'auto' (the kernel on a CUDA device, the plain version on
    the CPU), 'kernel' or 'plain'."""

    model: BiGRUClassifier
    id_to_label: dict[int, str]
    device: Union[str, torch.device]
    max_t: int = 90
    min_frames: int = 5
    buckets: tuple[int, ...] = (16, 32, 64, 90)
    compute_dtype: str = "float32"
    roi_impl: str = "auto"
    roi_variant: str = "tiled3"
    gru_impl: str = "auto"
    matmul_precision: Union[None, str, dict] = "parity"

    def __post_init__(self):
        _check_knobs(self.roi_impl, self.gru_impl, self.roi_variant,
                     self.compute_dtype, self.matmul_precision)
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but torch sees no CUDA device")
        self.buckets = tuple(sorted(set(self.buckets) | {self.max_t}))
        self.model = self.model.to(self.device).eval()

    @property
    def cfg(self) -> BiGRUConfig:
        return self.model.cfg

    @classmethod
    def from_checkpoint(cls, path: str, _loaded=None, **kw) -> "Predictor":
        """Load an npz checkpoint written by either package."""
        params, meta, _ = _loaded if _loaded is not None else \
            load_checkpoint(path)
        # the widths the metadata does not carry come from the parameters'
        # shapes, as the JAX Predictor's forward takes them
        use_roi = bool(meta["use_roi"])
        cfg = BiGRUConfig(
            x_dim=int(meta["x_dim"]),
            num_classes=len(meta["labels"]),
            use_roi=use_roi,
            gru_layers=int(meta.get("gru_layers", 2)),
            hidden=int(params["gru"][0]["fwd"]["wh"].shape[0]),
            head_hidden=int(params["head"]["fc1"]["w"].shape[1]),
            roi_emb=(int(params["roi_cnn"]["fc"]["w"].shape[1]) if use_roi
                     else BiGRUConfig.roi_emb),
            roi_h=int(meta.get("roi_h", 48)),
            roi_w=int(meta.get("roi_w", 96)),
        )
        id_to_label = {int(k): v for k, v in meta["id_to_label"].items()}
        return cls(model=BiGRUClassifier.from_jax_params(params, cfg),
                   id_to_label=id_to_label, max_t=int(meta["max_t"]), **kw)

    @classmethod
    def from_torch_checkpoint(cls, path: str, _ckpt=None, **kw
                              ) -> "Predictor":
        """Load a reference-trained PyTorch checkpoint
        (live_infer_official.py:198-221 loader semantics, including the
        gru_layers-defaults-to-2 tolerance)."""
        ckpt = _ckpt if _ckpt is not None else torch.load(
            path, map_location="cpu", weights_only=True)
        cfg = BiGRUConfig(
            x_dim=int(ckpt["x_dim"]),
            num_classes=len(ckpt["labels"]),
            use_roi=bool(ckpt.get("use_roi", False)),
            gru_layers=int(ckpt.get("gru_layers", 2)),
        )
        model = BiGRUClassifier(cfg)
        model.load_state_dict(ckpt["model"], strict=True)
        id_to_label = {int(k): str(v) for k, v in ckpt["id_to_label"].items()}
        return cls(model=model.eval(), id_to_label=id_to_label,
                   max_t=int(ckpt["max_t"]), **kw)

    def _forward(self, X: np.ndarray, lengths: np.ndarray,
                 roi: Optional[np.ndarray]) -> torch.Tensor:
        precision = (full_f32() if self.matmul_precision is not None
                     else contextlib.nullcontext())
        with torch.inference_mode(), precision:
            X = torch.as_tensor(np.asarray(X, np.float32), device=self.device)
            L = torch.as_tensor(np.asarray(lengths), device=self.device)
            R = None if roi is None else torch.as_tensor(
                np.asarray(roi, np.uint8), device=self.device)
            return self.model.live_forward(X, L, R, roi_impl=self.roi_impl,
                                           gru_impl=self.gru_impl)

    def warmup(self, batch_sizes: Sequence[int] = (1,)) -> "Predictor":
        """Run every (bucket, batch) shape once, so the first real clip
        does not pay the kernel build or cuDNN's first-call setup."""
        for B in batch_sizes:
            for Tb in self.buckets:
                X = np.zeros((B, Tb, self.cfg.x_dim), np.float32)
                L = np.full((B,), min(self.min_frames, Tb), np.int32)
                R = (np.zeros((B, Tb, self.cfg.roi_h, self.cfg.roi_w),
                              np.uint8) if self.cfg.use_roi else None)
                self.predict_batch(X, L, R)
        return self

    def predict_arrays(self, feats: np.ndarray, roi: Optional[np.ndarray],
                       k: int = 3) -> list[tuple[str, float]]:
        """feats: (T, D); roi: (T, H, W) uint8 or None. Matches the
        reference predict block: truncate to max_t, zero-ROI when absent."""
        T = min(len(feats), self.max_t)
        if T < self.min_frames:
            raise ValueError(f"clip too short: {T} < {self.min_frames} frames")
        Tb = _bucket(T, self.buckets)
        X, _ = pad_trim_time(np.asarray(feats[:T], np.float32), Tb)
        if self.cfg.use_roi:
            if roi is None:
                R = np.zeros((1, Tb, self.cfg.roi_h, self.cfg.roi_w), np.uint8)
            else:
                R = pad_trim_time(np.asarray(roi[:T], np.uint8), Tb)[0][None]
        else:
            R = None
        logits = self.predict_batch(X[None], np.asarray([T], np.int32), R)
        return topk_from_logits(logits[0], self.id_to_label, k)

    def predict_clip(self, clip: Clip, k: int = 3) -> list[tuple[str, float]]:
        clip = clip.aligned() if self.cfg.use_roi else clip
        return self.predict_arrays(clip.X, clip.roi, k)

    def predict_batch(self, X: np.ndarray, lengths: np.ndarray,
                      roi: Optional[np.ndarray] = None) -> np.ndarray:
        """Batched logits (B, num_classes) for padded (B, T, D)
        [+ (B, T, H, W) uint8] arrays."""
        return self._forward(X, lengths, roi).cpu().numpy()


def load_predictor(path: str, **kw) -> Predictor:
    """Route a checkpoint to its predictor. The port serves the official
    family: reference ``.pt`` checkpoints with ``x_dim`` and npz
    checkpoints of the official model. Other families raise."""
    if path.endswith(".pt"):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        if not isinstance(ckpt, dict):
            raise ValueError(f"{path}: not a checkpoint dict")
        if "x_dim" in ckpt and "vocab" not in ckpt:
            return Predictor.from_torch_checkpoint(path, _ckpt=ckpt, **kw)
        raise NotImplementedError(
            f"{path}: only the official checkpoint family is ported so far; "
            f"this one (keys: {sorted(ckpt)}) is not yet ported")
    loaded = load_checkpoint(path)
    meta = loaded[1]
    if meta.get("vocab") or meta.get("model"):
        raise NotImplementedError(
            f"{path}: the {'CTC' if meta.get('vocab') else meta['model']} "
            "family is not yet ported")
    return Predictor.from_checkpoint(path, _loaded=loaded, **kw)
