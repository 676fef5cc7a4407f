"""Command-line entry point of the port (counterpart of the JAX apps/cli.py).

    python -m silent_speech_tpu_torch train clip_dir=<dir> out_path=<ckpt> \\
        [<TrainConfig field>=...] [device=cuda] [resume_from=<ckpt>] \\
        [metrics_path=<jsonl>]
    python -m silent_speech_tpu_torch predict ckpt_path=<ckpt> \\
        clip=<clip.npz|glob> [k=3] [device=cuda] [roi_impl=auto] \\
        [gru_impl=auto] [matmul_precision=parity]

``train`` is the official trainer (train_model_official.py) with the JAX
CLI's ``TrainConfig`` overrides; ``device`` defaults to 'cuda' (the CPU
must be asked for with ``device=cpu``), and the options the port does not
implement raise (train/loop.py).

``predict`` is the offline single-clip prediction of the official family:
the live predict block (live_infer_official.py:338-359) on recorded
``.npz`` clips, through ``load_predictor``. ``device`` defaults to 'cuda';
``roi_impl`` / ``gru_impl`` take 'auto', 'kernel' or 'plain';
``matmul_precision`` takes 'parity', 'highest' or 'none'; the JAX CLI's
``roi_variant`` / ``compute_dtype`` are accepted and raise on any value the
port does not serve. Every other command of the JAX CLI prints "not yet
ported" and exits 2.
"""

from __future__ import annotations

import glob
import sys
from typing import Optional, Sequence

# commands of the JAX CLI that the port does not have yet
_NOT_PORTED = (
    "record", "record-timed", "train-ctc", "train-reduced",
    "train-unigru", "train-mlp", "infer-live", "infer-gated", "infer-stream",
    "eval-dataset", "eval-ctc", "landmarks-view", "important-landmarks",
    "infer-ctc", "debug-npz", "export-torch", "status", "doctor", "bench",
)
_KNOBS = ("roi_impl", "gru_impl", "roi_variant", "compute_dtype")
_PREDICT_KEYS = ("ckpt_path", "clip", "k", "device", "matmul_precision"
                 ) + _KNOBS
_TRAIN_EXTRA = ("device", "resume_from", "metrics_path")
_TRAIN_USAGE = ("usage: python -m silent_speech_tpu_torch train "
                "clip_dir=<dir> out_path=<ckpt> [<TrainConfig field>=...] "
                "[device=cuda|cpu] [resume_from=<ckpt>] "
                "[metrics_path=<jsonl>]")
_USAGE = ("usage: python -m silent_speech_tpu_torch predict "
          "ckpt_path=<path> clip=<clip.npz|glob> [k=3] [device=cuda] "
          "[roi_impl=auto|kernel|plain] [gru_impl=auto|kernel|plain] "
          "[matmul_precision=parity|highest|none]")


def _predict(kv: dict) -> int:
    from ..core.schema import load_clip
    from ..infer.predictor import load_predictor

    if "ckpt_path" not in kv or "clip" not in kv:
        print(_USAGE)
        return 2
    knobs = {key: kv[key] for key in _KNOBS if key in kv}
    if "matmul_precision" in kv:
        mp = kv["matmul_precision"]
        knobs["matmul_precision"] = None if mp.lower() == "none" else mp
    pred = load_predictor(kv["ckpt_path"], device=kv.get("device", "cuda"),
                          **knobs)
    k = int(kv.get("k", 3))
    for p in sorted(glob.glob(kv["clip"])) or [kv["clip"]]:
        print(f"{p}: {pred.predict_clip(load_clip(p), k=k)}")
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
    if cmd != "predict":
        print(f"unknown command {cmd!r}\n{_TRAIN_USAGE}\n{_USAGE}")
        return 2
    bad = [a for a in rest if "=" not in a
           or a.partition("=")[0] not in _PREDICT_KEYS]
    if bad:
        print(f"unknown arguments {bad}\n{_USAGE}")
        return 2
    return _predict(dict(a.split("=", 1) for a in rest))
