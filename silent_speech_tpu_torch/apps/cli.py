"""Command-line entry point of the port (counterpart of the JAX apps/cli.py).

    python -m silent_speech_tpu_torch train clip_dir=<dir> out_path=<ckpt> \\
        [<TrainConfig field>=...] [device=cuda] [resume_from=<ckpt>] \\
        [metrics_path=<jsonl>]
    python -m silent_speech_tpu_torch eval-dataset ckpt_path=<ckpt> \\
        clip_dir=<dir> [<EvalConfig field>=...] [device=cuda]
    python -m silent_speech_tpu_torch predict ckpt_path=<ckpt> \\
        clip=<clip.npz|glob> [k=3] [device=cuda] [roi_impl=auto] \\
        [gru_impl=auto] [roi_variant=tiled3] [compute_dtype=float32] \\
        [matmul_precision=parity]
    python -m silent_speech_tpu_torch train-ctc clip_dir=<dir> \\
        out_path=<ckpt> [<CTCTrainConfig field>=...] [device=cuda]
    python -m silent_speech_tpu_torch eval-ctc ckpt_path=<ckpt> \\
        [clip_dir=clips_npz] [chunk_words=0] [batch_size=64] [device=cuda] \\
        [roi_impl=auto] [gru_impl=auto] [roi_variant=tiled3] \\
        [compute_dtype=float32] [matmul_precision=parity]
    python -m silent_speech_tpu_torch train-reduced|train-unigru|train-mlp \\
        clip_dir=<dir> out_path=<ckpt> [<ReducedConfig | UniGRUConfig |
        MLPQuickConfig field>=...] [device=cuda]
    python -m silent_speech_tpu_torch record [<RecorderConfig field>=...]
    python -m silent_speech_tpu_torch infer-live ckpt_path=<ckpt> \\
        [<InferConfig field>=...]
    python -m silent_speech_tpu_torch infer-gated ckpt_path=<ckpt> \\
        [<InferConfig or StreamConfig field>=...]
    python -m silent_speech_tpu_torch infer-stream ckpt_path=<ckpt> \\
        [cam_index=0] [gru_impl=auto] [<StreamConfig field>=...]
    python -m silent_speech_tpu_torch infer-ctc ckpt_path=<ckpt> \\
        [cam_index=0] [chunk_words=0] [predict_async=false] [serving knobs]

``train`` is the official trainer (train_model_official.py) with the JAX
CLI's ``TrainConfig`` overrides; ``device`` defaults to 'cuda' (the CPU
must be asked for with ``device=cpu``), and the options the port does not
implement raise (train/loop.py).

``eval-dataset`` is the offline corpus sweep (inactive/dataset_eval.py):
accuracy, average confidence and top confusions over every clip of
``clip_dir``, in batches of ``batch_size``, with the JAX CLI's
``EvalConfig`` fields; ``device`` defaults to 'cuda'. A variant family's
checkpoint (``load_predictor`` gives a ``VariantPredictor``) sweeps clip
by clip (``evaluate_variant_dataset``): ``batch_size`` does not apply.

``predict`` is the offline single-clip prediction, through
``load_predictor``: for the official family the live predict block
(live_infer_official.py:338-359) on recorded ``.npz`` clips; for a variant
family ``VariantPredictor.predict_features`` on each clip's features; for
a CTC checkpoint (its metadata has ``vocab``) the dictionary-scored decode
of each clip with a ROI (``CTCDecoder.score_clip``), its top ``k`` (word,
score) pairs. ``device`` defaults to 'cuda'.

``train-ctc`` is the CTC trainer (inactive/train_model.py) with the JAX
CLI's ``CTCTrainConfig`` overrides; ``eval-ctc`` its dictionary-scored
corpus sweep (accuracy and top confusions) on a CTC checkpoint of either
package, with the JAX CLI's keys; ``mesh_shape`` raises there (not
ported). ``device`` defaults to 'cuda' for both.

``train-reduced``, ``train-unigru`` and ``train-mlp`` are the legacy
trainers (inactive/train_reduced.py, train_model_1130pm.py,
train_5_quick.py; train/legacy_loops.py) with the JAX CLI's config
overrides; ``device`` defaults to 'cuda'.

The camera commands (slice 6, apps/record.py and apps/live.py): ``record``
the official recorder (record_landmarks_official.py), ``infer-live``
manual-toggle clips (live_infer_official.py), ``infer-gated``
openness-gated clips (inactive/live_lower_half.py), ``infer-stream`` the
sliding window or one GRU step a frame (inactive/live_feed.py),
``infer-ctc`` dictionary-scored CTC clips
(inactive/facial_landmark_detection.py). Each takes the JAX CLI's keys,
``model_path=<face_landmarker.task>``, ``device`` ('cuda' by default) and
``sim=N``: N frames of the headless harness (runtime/fakes.py: a synthetic
face track, openness bursts and 'r' pressed on frames 3 and N-8) instead
of a camera and mediapipe.

The serving knobs of eval-dataset, eval-ctc, predict and the camera
commands: ``roi_impl`` /
``gru_impl`` take 'auto', 'kernel' or 'plain'; ``roi_variant`` 'tiled3',
'tiled3_q8' (int8) or 'im2col'; ``compute_dtype`` 'float32' or
'bfloat16'; ``matmul_precision`` 'parity', 'highest' or 'none'. Other
values raise. Every other command of the JAX CLI (``record-timed``,
``status``, ``landmarks-view`` among them) prints "not yet ported" and
exits 2.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import sys
from typing import Optional, Sequence

import numpy as np

# commands of the JAX CLI that the port does not have yet
_NOT_PORTED = (
    "record-timed", "landmarks-view", "important-landmarks", "debug-npz",
    "export-torch", "status", "doctor", "bench",
)
# the legacy trainers: command -> (config class, trainer) in
# train/legacy_loops.py
_LEGACY = {"train-reduced": ("ReducedConfig", "train_reduced"),
           "train-unigru": ("UniGRUConfig", "train_unigru"),
           "train-mlp": ("MLPQuickConfig", "train_mlp_quick")}
_KNOBS = ("roi_impl", "gru_impl", "roi_variant", "compute_dtype")
# the camera commands (apps/record.py, apps/live.py): command -> (the
# configs whose fields it takes, its other keys)
_CAMERA = {"record": (("RecorderConfig",), ()),
           "infer-live": (("InferConfig",), ()),
           "infer-gated": (("InferConfig", "StreamConfig"), ()),
           "infer-stream": (("StreamConfig",),
                            ("ckpt_path", "cam_index", "gru_impl")),
           "infer-ctc": ((), ("ckpt_path", "cam_index", "chunk_words",
                              "predict_async", "matmul_precision") + _KNOBS)}
_PREDICT_KEYS = ("ckpt_path", "clip", "k", "device", "matmul_precision"
                 ) + _KNOBS
_TRAIN_EXTRA = ("device", "resume_from", "metrics_path")
_TRAIN_USAGE = ("usage: python -m silent_speech_tpu_torch train "
                "clip_dir=<dir> out_path=<ckpt> [<TrainConfig field>=...] "
                "[device=cuda|cpu] [resume_from=<ckpt>] "
                "[metrics_path=<jsonl>]")
_TRAIN_CTC_USAGE = ("usage: python -m silent_speech_tpu_torch train-ctc "
                    "clip_dir=<dir> out_path=<ckpt> [<CTCTrainConfig "
                    "field>=...] [device=cuda|cpu]")
_EVAL_CTC_KEYS = ("ckpt_path", "clip_dir", "chunk_words", "batch_size",
                  "mesh_shape", "matmul_precision", "device") + _KNOBS
_EVAL_CTC_USAGE = ("usage: python -m silent_speech_tpu_torch eval-ctc "
                   "ckpt_path=<ckpt> [clip_dir=clips_npz] [chunk_words=N] "
                   "[batch_size=64] [device=cuda|cpu] "
                   "[roi_impl=auto|kernel|plain] [gru_impl=auto|kernel|plain] "
                   "[roi_variant=tiled3|tiled3_q8|im2col] "
                   "[compute_dtype=float32|bfloat16] "
                   "[matmul_precision=parity|highest|none]")
_EVAL_USAGE = ("usage: python -m silent_speech_tpu_torch eval-dataset "
               "ckpt_path=<ckpt> clip_dir=<dir> [<EvalConfig field>=...] "
               "[device=cuda|cpu]")
_LEGACY_USAGE = ("usage: python -m silent_speech_tpu_torch {} clip_dir=<dir> "
                 "out_path=<ckpt> [<{} field>=...] [device=cuda|cpu]")
_USAGE = ("usage: python -m silent_speech_tpu_torch predict "
          "ckpt_path=<official, variant or CTC checkpoint> "
          "clip=<clip.npz|glob> "
          "[k=3] [device=cuda] "
          "[roi_impl=auto|kernel|plain] [gru_impl=auto|kernel|plain] "
          "[roi_variant=tiled3|tiled3_q8|im2col] "
          "[compute_dtype=float32|bfloat16] "
          "[matmul_precision=parity|highest|none]")


def _predict(kv: dict) -> int:
    from ..core.schema import load_clip
    from ..infer.ctc_decode import CTCDecoder
    from ..infer.predictor import load_predictor
    from ..infer.variant_predictor import VariantPredictor
    from ..train.checkpoint import load_checkpoint

    if "ckpt_path" not in kv or "clip" not in kv:
        print(_USAGE)
        return 2
    knobs = {key: kv[key] for key in _KNOBS if key in kv}
    if "matmul_precision" in kv:
        mp = kv["matmul_precision"]
        knobs["matmul_precision"] = None if mp.lower() == "none" else mp
    device = kv.get("device", "cuda")
    k = int(kv.get("k", 3))
    paths = sorted(glob.glob(kv["clip"])) or [kv["clip"]]
    path = kv["ckpt_path"]
    loaded = None if path.endswith(".pt") else load_checkpoint(path)
    if loaded is not None and loaded[1].get("vocab"):
        # the dictionary-scored CTC decode (the offline counterpart of
        # infer-ctc's predict block)
        dec = CTCDecoder.from_checkpoint(path, _loaded=loaded, device=device,
                                         **knobs)
        for p in paths:
            c = load_clip(p).aligned()
            if c.roi is None:
                print(f"{p}: no roi in clip; CTC scoring needs it")
                continue
            print(f"{p}: {dec.score_clip(c.X, c.roi)[:k]}")
        return 0
    pred = load_predictor(path, device=device, **knobs)
    for p in paths:
        c = load_clip(p)
        if isinstance(pred, VariantPredictor):
            top = pred.predict_features(c.X.astype(np.float32), k=k)
        else:
            top = pred.predict_clip(c, k=k)
        print(f"{p}: {top}")
    return 0


def _train(rest: list[str]) -> int:
    import dataclasses

    from ..core.config import TrainConfig, apply_overrides
    from ..train.loop import train

    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    bad = [a for a in rest if "=" not in a or a.partition("=")[0] not in
           fields | set(_TRAIN_EXTRA)]
    if bad:
        print(f"unknown arguments {bad}\n{_TRAIN_USAGE}")
        return 2
    kv = dict(a.split("=", 1) for a in rest)
    extra = {k: kv.pop(k) for k in _TRAIN_EXTRA if k in kv}
    cfg = apply_overrides(TrainConfig(), [f"{k}={v}" for k, v in kv.items()])
    train(cfg, resume_from=extra.get("resume_from"),
          metrics_path=extra.get("metrics_path"),
          device=extra.get("device", "cuda"))
    return 0


def _train_ctc(rest: list[str]) -> int:
    import dataclasses

    from ..core.config import CTCTrainConfig, apply_overrides
    from ..train.ctc_loop import train_ctc

    fields = {f.name for f in dataclasses.fields(CTCTrainConfig)}
    bad = [a for a in rest if "=" not in a or a.partition("=")[0] not in
           fields | {"device"}]
    if bad:
        print(f"unknown arguments {bad}\n{_TRAIN_CTC_USAGE}")
        return 2
    kv = dict(a.split("=", 1) for a in rest)
    device = kv.pop("device", "cuda")
    cfg = apply_overrides(CTCTrainConfig(),
                          [f"{k}={v}" for k, v in kv.items()])
    train_ctc(cfg, device=device)
    return 0


def _train_legacy(cmd: str, rest: list[str]) -> int:
    import dataclasses

    from ..core.config import apply_overrides
    from ..train import legacy_loops

    cfg_name, fn_name = _LEGACY[cmd]
    cfg_cls = getattr(legacy_loops, cfg_name)
    fields = {f.name for f in dataclasses.fields(cfg_cls)}
    bad = [a for a in rest if "=" not in a or a.partition("=")[0] not in
           fields | {"device"}]
    if bad:
        print(f"unknown arguments {bad}\n"
              + _LEGACY_USAGE.format(cmd, cfg_name))
        return 2
    kv = dict(a.split("=", 1) for a in rest)
    device = kv.pop("device", "cuda")
    cfg = apply_overrides(cfg_cls(), [f"{k}={v}" for k, v in kv.items()])
    getattr(legacy_loops, fn_name)(cfg, device=device)
    return 0


def _eval_ctc(rest: list[str]) -> int:
    from ..core.config import _parse_dict_override
    from ..infer.evaluator import evaluate_ctc_dataset

    bad = [a for a in rest if "=" not in a or a.partition("=")[0] not in
           _EVAL_CTC_KEYS]
    kv = dict(a.split("=", 1) for a in rest if "=" in a)
    if bad or "ckpt_path" not in kv:
        print(f"unknown arguments {bad}\n{_EVAL_CTC_USAGE}" if bad
              else _EVAL_CTC_USAGE)
        return 2
    evaluate_ctc_dataset(
        kv["ckpt_path"], kv.get("clip_dir", "clips_npz"),
        chunk_words=int(kv.get("chunk_words", 0)),
        batch_size=int(kv.get("batch_size", 64)),
        mesh_shape=(_parse_dict_override(kv["mesh_shape"])
                    if "mesh_shape" in kv else None),
        compute_dtype=kv.get("compute_dtype", "float32"),
        roi_impl=kv.get("roi_impl", "auto"),
        roi_variant=kv.get("roi_variant", "tiled3"),
        gru_impl=kv.get("gru_impl", "auto"),
        matmul_precision=kv.get("matmul_precision", ""),
        device=kv.get("device", "cuda"))
    return 0


def _eval_dataset(rest: list[str]) -> int:
    import dataclasses

    from ..core.config import EvalConfig, apply_overrides, serving_kwargs
    from ..infer.evaluator import evaluate_dataset, evaluate_variant_dataset
    from ..infer.predictor import load_predictor
    from ..infer.variant_predictor import VariantPredictor

    fields = {f.name for f in dataclasses.fields(EvalConfig)}
    bad = [a for a in rest if "=" not in a or a.partition("=")[0] not in
           fields | {"device"}]
    if bad:
        print(f"unknown arguments {bad}\n{_EVAL_USAGE}")
        return 2
    kv = dict(a.split("=", 1) for a in rest)
    device = kv.pop("device", "cuda")
    cfg = apply_overrides(EvalConfig(), [f"{k}={v}" for k, v in kv.items()])
    pred = load_predictor(cfg.ckpt_path, device=device, **serving_kwargs(cfg))
    if isinstance(pred, VariantPredictor):
        # the variant families predict clip by clip: batch_size does not
        # apply
        evaluate_variant_dataset(pred, cfg.clip_dir,
                                 top_confusions=cfg.top_confusions)
    else:
        evaluate_dataset(pred, cfg.clip_dir, batch_size=cfg.batch_size,
                         top_confusions=cfg.top_confusions)
    return 0


def _sim_context(sim_n: int):
    """The default simulation scenario of the JAX CLI: the face in range,
    openness bursts of 12 frames, 'r' pressed on frames 3 and sim_n - 8."""
    from ..runtime.fakes import NO_KEY, face_track, sim_session

    keys = [NO_KEY] * sim_n
    if sim_n >= 16:
        keys[3] = ord("r")
        keys[sim_n - 8] = ord("r")
    # openness square wave: speaking bursts for the gated and stream modes
    open_seq = [20.0 if (i // 12) % 2 == 1 else 6.0 for i in range(sim_n)]
    return sim_session(keys=keys, n_frames=sim_n,
                       faces=face_track(sim_n, open_seq=open_seq))


def _camera(cmd: str, rest: list[str]) -> int:
    from ..core import config
    from . import live, record

    classes, extra = _CAMERA[cmd]
    fields = {c: {f.name for f in dataclasses.fields(getattr(config, c))}
              for c in classes}
    kv = dict(a.split("=", 1) for a in rest if "=" in a)
    sim_n = int(kv.pop("sim", 0))
    run_kw = {"device": kv.pop("device", "cuda")}
    if "model_path" in kv:
        run_kw["model_path"] = kv.pop("model_path")
    allowed = set(extra).union(*fields.values())
    bad = [a for a in rest if "=" not in a] + [k for k in kv
                                               if k not in allowed]
    if bad or ("ckpt_path" in extra and "ckpt_path" not in kv):
        keys = " | ".join([f"<{c} field>" for c in classes] + list(extra))
        print((f"unknown arguments {bad}\n" if bad else "")
              + f"usage: python -m silent_speech_tpu_torch {cmd} [{keys}=...]"
              " [model_path=<face_landmarker.task>] [device=cuda|cpu] "
              "[sim=N]" + (" (ckpt_path is required)" if "ckpt_path" in
                           extra else ""))
        return 2
    # the gated command's thresholds and pipeline knobs are StreamConfig
    # fields (live_lower_half.py:143-151), the rest InferConfig's
    cfg = {c: config.apply_overrides(getattr(config, c)(), [
        f"{k}={v}" for k, v in kv.items() if k in fields[c]])
        for c in classes}
    with _sim_context(sim_n) if sim_n else contextlib.nullcontext():
        if cmd == "record":
            record.main(cfg["RecorderConfig"], **run_kw)
        elif cmd == "infer-live":
            live.infer_live(cfg["InferConfig"], **run_kw)
        elif cmd == "infer-gated":
            live.infer_gated(cfg["InferConfig"], cfg["StreamConfig"],
                             **run_kw)
        elif cmd == "infer-stream":
            live.infer_stream(kv["ckpt_path"], cfg["StreamConfig"],
                              cam_index=int(kv.get("cam_index", 0)),
                              gru_impl=kv.get("gru_impl", "auto"), **run_kw)
        else:
            live.infer_ctc(
                kv["ckpt_path"], cam_index=int(kv.get("cam_index", 0)),
                chunk_words=int(kv.get("chunk_words", 0)),
                predict_async=config.parse_bool(
                    "predict_async", kv.get("predict_async", "false")),
                matmul_precision=kv.get("matmul_precision", ""),
                **{k: kv[k] for k in _KNOBS if k in kv}, **run_kw)
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if not args or args[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if args else 2
    cmd, rest = args[0], args[1:]
    if cmd in _NOT_PORTED:
        print(f"{cmd}: not yet ported to silent_speech_tpu_torch (see "
              "ROADMAP.md); use python -m silent_speech_tpu")
        return 2
    if cmd == "train":
        return _train(rest)
    if cmd == "eval-dataset":
        return _eval_dataset(rest)
    if cmd == "train-ctc":
        return _train_ctc(rest)
    if cmd in _LEGACY:
        return _train_legacy(cmd, rest)
    if cmd == "eval-ctc":
        return _eval_ctc(rest)
    if cmd in _CAMERA:
        return _camera(cmd, rest)
    if cmd != "predict":
        print(f"unknown command {cmd!r}\n{_TRAIN_USAGE}\n{_EVAL_USAGE}\n"
              f"{_USAGE}\n{_TRAIN_CTC_USAGE}\n{_EVAL_CTC_USAGE}")
        return 2
    bad = [a for a in rest if "=" not in a
           or a.partition("=")[0] not in _PREDICT_KEYS]
    if bad:
        print(f"unknown arguments {bad}\n{_USAGE}")
        return 2
    return _predict(dict(a.split("=", 1) for a in rest))
