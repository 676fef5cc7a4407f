"""The official and CTC trainers' and the dataset evaluator's settings and
the CLI's ``key=value`` overrides (copy of ``TrainConfig``,
``CTCTrainConfig``, ``EvalConfig``, ``serving_kwargs`` and
``apply_overrides`` from the JAX package's core/config.py, which the port
does not import).

Field names and defaults are the reference's CONSTANTS block
(train_model_official.py:20-47), so a JAX-package command line runs the port
unchanged. The knobs without a reference counterpart keep their JAX names;
the port's trainer raises on the values it does not implement
(train/loop.py says which).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence


@dataclasses.dataclass
class TrainConfig:
    """Official trainer settings (train_model_official.py:20-47)."""

    clip_dir: str = "clips_npz"
    out_path: str = "word_model_points_roi.ckpt"
    seed: int = 42
    val_frac: float = 0.15
    batch_size: int = 16
    epochs: int = 80
    lr: float = 3e-4
    patience: int = 12
    max_t: int = 90
    use_roi_if_present: bool = True
    roi_w: int = 96
    roi_h: int = 48
    # augmentation (train_model_official.py:41-43,144-152)
    noise_std: float = 0.01
    noise_prob: float = 0.7
    drop_frames_prob: float = 0.35
    drop_frames_max: int = 2
    # loss / optimization (train_model_official.py:405,438)
    label_smoothing: float = 0.05
    grad_clip_norm: float = 1.0
    # model (train_model_official.py:402)
    hidden: int = 192
    gru_layers: int = 2
    roi_emb: int = 32
    gru_dropout: float = 0.1
    head_dropout: float = 0.2
    # knobs of the JAX package (no reference counterpart)
    compute_dtype: str = "float32"
    # the port takes 'auto' (the ROI CNN kernels on a CUDA device, the
    # plain version on the CPU), 'kernel' or 'plain'
    roi_impl: str = "auto"
    roi_remat: bool = False
    # train steps per device dispatch in the JAX package; every value gives
    # the same trajectory there, and the port runs one step at a time
    steps_per_dispatch: int = 0
    mesh_shape: Optional[dict] = None
    host_data: bool = False
    checkpoint_format: str = "npz"
    async_checkpoint: bool = False


@dataclasses.dataclass
class CTCTrainConfig:
    """CTC trainer settings (inactive/train_model.py:10-29): the
    ``train-ctc`` command."""

    clip_dir: str = "clips_npz"
    out_path: str = "ctc_word_model_roi.ckpt"
    seed: int = 42
    val_frac: float = 0.15
    batch_size: int = 32
    epochs: int = 120
    lr: float = 1e-3
    patience: int = 6
    max_t: int = 80
    roi_w: int = 96
    roi_h: int = 48
    roi_emb: int = 32
    hidden: int = 192
    gru_layers: int = 3
    len_lambda: float = 0.02  # length-prior penalty (inactive/train_model.py:29)
    len_per_char: int = 5  # expected frames per character (inactive/train_model.py:247)
    # silence trimming (inactive/train_model.py:48-57)
    trim_open_idx: int = -3
    trim_thresh: float = 0.05
    trim_pad: int = 2
    # knobs of the JAX package (no reference counterpart): 'bfloat16' is
    # the bf16 training route (models/bigru.SequenceModel.encode)
    compute_dtype: str = "float32"
    # the port takes 'auto' (the ROI CNN kernels, forward and weight
    # gradients, on a CUDA device; the plain version on the CPU), 'kernel'
    # or 'plain' (train/step.resolve_roi_impl); the JAX package's
    # frames-per-step gate for 'auto' was measured on a TPU and does not
    # apply
    roi_impl: str = "auto"


@dataclasses.dataclass
class EvalConfig:
    """Offline dataset evaluation (inactive/dataset_eval.py): the
    ``eval-dataset`` command."""

    clip_dir: str = "clips_npz"
    ckpt_path: str = "word_model_points_roi.ckpt"
    batch_size: int = 64
    top_confusions: int = 10
    # serving knobs (no reference counterpart); the port's values
    # (infer/predictor.py): compute_dtype float32 | bfloat16, roi_impl and
    # gru_impl auto | kernel | plain, roi_variant tiled3 | tiled3_q8 | im2col
    compute_dtype: str = "float32"
    roi_impl: str = "auto"
    roi_variant: str = "tiled3"
    gru_impl: str = "auto"
    # "" = the Predictor default ("parity"); "default" / "none" = the
    # caller's matmul settings; "highest" = full f32, as "parity"
    matmul_precision: str = ""
    # data-parallel sweep over a device mesh: not ported (ROADMAP slice 7)
    mesh_shape: Optional[dict] = None


def serving_kwargs(cfg) -> dict:
    """Predictor serving kwargs from an EvalConfig.

    ``matmul_precision``: empty string defers to the Predictor default
    ('parity'); 'default'/'none' leave the caller's matmul settings;
    anything else passes through. ``mesh_shape`` raises: the multi-device
    sweep is not ported (ROADMAP.md, queue 1 slice 7)."""
    if getattr(cfg, "mesh_shape", None):
        raise NotImplementedError(
            f"mesh_shape={cfg.mesh_shape!r}: the data-parallel sweep over a "
            "device mesh is not ported to silent_speech_tpu_torch (ROADMAP.md "
            "queue 1, slice 7: multi-GPU)")
    kw = dict(compute_dtype=cfg.compute_dtype, roi_impl=cfg.roi_impl,
              roi_variant=getattr(cfg, "roi_variant", "tiled3"),
              gru_impl=cfg.gru_impl)
    if cfg.matmul_precision:
        kw["matmul_precision"] = (
            None if cfg.matmul_precision in ("default", "none")
            else cfg.matmul_precision
        )
    return kw


def parse_bool(key: str, raw: str) -> bool:
    """Strict CLI boolean: a typo ('ture') must not silently become False."""
    low = str(raw).lower()
    if low in ("1", "true", "yes", "on"):
        return True
    if low in ("0", "false", "no", "off"):
        return False
    raise ValueError(
        f"{key}={raw!r} is not a boolean (use true/false, 1/0, yes/no, on/off)"
    )


def _parse_dict_override(raw: str) -> dict:
    """Accept JSON ('{"data": 4, "model": 2}') or compact 'data:4,model:2'."""
    try:
        val = json.loads(raw)
        if not isinstance(val, dict):
            raise ValueError(f"expected a dict, got {type(val).__name__}")
        return val
    except json.JSONDecodeError:
        out = {}
        for part in raw.split(","):
            if ":" not in part:
                raise ValueError(
                    f"dict override must be JSON or k:v[,k:v...], got {raw!r}"
                )
            k, v = part.split(":", 1)
            out[k.strip()] = int(v)
        return out


def apply_overrides(cfg, overrides: Sequence[str]):
    """Apply ``key=value`` CLI overrides to a config dataclass in place.

    Dict-typed fields (``mesh_shape``) accept JSON or ``k:v,k:v``."""
    dict_fields = {
        f.name for f in dataclasses.fields(cfg)
        if f.type in ("Optional[dict]", "dict") or isinstance(f.default, dict)
    }
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override must be key=value, got {item!r}")
        key, raw = item.split("=", 1)
        if not hasattr(cfg, key):
            raise AttributeError(f"{type(cfg).__name__} has no field {key!r}")
        cur = getattr(cfg, key)
        if key in dict_fields or isinstance(cur, dict):
            val = _parse_dict_override(raw)
        elif isinstance(cur, bool):
            val = parse_bool(key, raw)
        elif isinstance(cur, int):
            val = int(raw)
        elif isinstance(cur, float):
            val = float(raw)
        else:
            val = raw
        setattr(cfg, key, val)
    return cfg
