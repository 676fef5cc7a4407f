"""The official training pipeline, end to end (port of the JAX
train/loop.py, the per-step path).

Reproduces train_model_official.py main() (:315-508): corpus preflight,
modal-dim filter, stratified split, weighted sampling, Adam + CE(ls=0.05) +
grad clip, per-epoch validation with top-confusion reporting, best-val
checkpointing with the optimizer state, patience early stop and resume. The
console lines keep the reference's format. The corpus lives on the device
as padded tensors and each step gathers its batch there.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Union

import numpy as np
import torch

from ..core.config import TrainConfig
from ..data.augment import OFFICIAL_AUGMENT
from ..data.corpus import (build_label_maps, filter_modal_dim,
                           inverse_frequency_weights, scan_corpus,
                           split_by_label, top_confusions,
                           warn_mixed_idx_signatures)
from ..data.dataset import build_dataset, epoch_batches
from ..models.bigru import (COMPUTE_DTYPES, BiGRUClassifier, BiGRUConfig,
                            init_params)
from .checkpoint import load_checkpoint, reference_meta, save_checkpoint
from .metrics import MetricsLogger, profiler_trace
from .step import (StepConfig, eval_step, make_optimizer, resolve_roi_impl,
                   train_step)

_ROADMAP = "not ported to silent_speech_tpu_torch (see ROADMAP.md)"


def _check_config(cfg: TrainConfig) -> None:
    """Raise on the JAX trainer's options the port does not implement."""
    if cfg.steps_per_dispatch < 0:
        raise ValueError(
            f"steps_per_dispatch must be >= 0, got {cfg.steps_per_dispatch}")
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype={cfg.compute_dtype!r}: the port "
                         f"trains in {COMPUTE_DTYPES}")
    unported = [
        ("mesh_shape", cfg.mesh_shape, "multi-device training"),
        ("checkpoint_format", cfg.checkpoint_format != "npz"
         and cfg.checkpoint_format, "the orbax checkpoint backend"),
        ("async_checkpoint", cfg.async_checkpoint, "async (orbax) saves"),
        ("roi_remat", cfg.roi_remat, "ROI-CNN rematerialization (the "
         "kernel's backward recomputes the activations already)"),
    ]
    for name, value, what in unported:
        if value:
            raise NotImplementedError(f"{name}={value!r}: {what} is "
                                      f"{_ROADMAP}")
    resolve_roi_impl(cfg.roi_impl)


def params_numpy(model: torch.nn.Module) -> dict:
    """The JAX-layout parameter tree as host numpy arrays."""
    def to_np(t):
        if isinstance(t, dict):
            return {k: to_np(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to_np(v) for v in t]
        return t.detach().cpu().numpy().copy()
    return to_np(model.params_tree())


def train(
    cfg: TrainConfig,
    verbose: bool = True,
    resume_from: Optional[str] = None,
    metrics_path: Optional[str] = None,
    profile_dir: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
) -> dict:
    """Run the full official training pipeline on ``device`` ('cuda' by
    default; the CPU must be asked for). Returns best_acc, params (the best
    JAX-layout tree, numpy), meta, history and model_config.

    ``resume_from`` restores parameters, the Adam state, the epoch, the
    best validation accuracy and the patience counter from a checkpoint of
    either package; ``metrics_path`` streams JSONL metrics; ``profile_dir``
    receives a torch.profiler trace of the first epoch's training steps
    (train/metrics.profiler_trace). ``steps_per_dispatch`` is accepted and
    changes nothing: the JAX package pins that every value gives the same
    trajectory, and the port runs one step at a time.

    ``host_data``: the corpus stays in host memory and each step gathers its
    batch there and copies it to the device; the parameters follow the
    device-resident corpus's trajectory bitwise. ``compute_dtype=
    'bfloat16'``: the bf16 training route (models/bigru.SequenceModel.
    encode); the loss is f32, and the parameters and Adam's state stay
    f32."""
    _check_config(cfg)
    if cfg.host_data and cfg.steps_per_dispatch not in (0, 1) and verbose:
        print(f"steps_per_dispatch={cfg.steps_per_dispatch} ignored: the "
              "multi-step dispatch needs the device-resident dataset "
              "(host_data set); running per step")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch sees no CUDA device; "
                           "pass device='cpu' to train on the CPU")

    index = scan_corpus(cfg.clip_dir, verbose=verbose)
    index, x_dim = filter_modal_dim(index, verbose=verbose)
    warn_mixed_idx_signatures(index, verbose=verbose)

    label_to_id, id_to_label = build_label_maps(index.labels)
    num_classes = len(label_to_id)
    if verbose:
        print("Classes:", sorted(label_to_id))

    train_files, val_files = split_by_label(
        index.files, index.labels, cfg.val_frac, seed=cfg.seed, verbose=verbose
    )
    if verbose:
        print("Train clips:", len(train_files), "Val clips:", len(val_files))

    use_roi = cfg.use_roi_if_present and index.n_roi > 0
    if verbose:
        print("Using ROI in training." if use_roi else "Training WITHOUT ROI.")

    file_label = dict(zip(index.files, index.labels))
    train_ds, val_ds = (
        build_dataset(files, label_to_id, cfg.max_t, use_roi, x_dim,
                      roi_hw=(cfg.roi_h, cfg.roi_w),
                      device="cpu" if cfg.host_data else device,
                      labels=[file_label[f] for f in files])
        for files in (train_files, val_files))

    def gather(ds, idx):
        """A batch on the device: gathered there, or with host_data on the
        host and copied."""
        return tuple(None if t is None else t.to(device)
                     for t in ds.gather(idx))
    weights = inverse_frequency_weights(train_ds.labels)

    mcfg = BiGRUConfig(
        x_dim=x_dim, num_classes=num_classes, use_roi=use_roi,
        roi_emb=cfg.roi_emb, hidden=cfg.hidden, gru_layers=cfg.gru_layers,
        gru_dropout=cfg.gru_dropout, head_dropout=cfg.head_dropout,
        roi_h=cfg.roi_h, roi_w=cfg.roi_w,
    )
    scfg = StepConfig(
        model=mcfg,
        label_smoothing=cfg.label_smoothing,
        augment=dataclasses.replace(
            OFFICIAL_AUGMENT,
            noise_prob=cfg.noise_prob,
            noise_std=cfg.noise_std,
            drop_prob=cfg.drop_frames_prob,
            drop_max=cfg.drop_frames_max,
        ),
        roi_impl=cfg.roi_impl,
        compute_dtype=cfg.compute_dtype,
    )

    start_epoch, best_acc, bad = 1, 0.0, 0
    resumed_opt = None
    if resume_from is not None:
        r_params, r_meta, resumed_opt = load_checkpoint(resume_from)
        model = BiGRUClassifier.from_jax_params(r_params, mcfg)
        start_epoch = int(r_meta.get("epoch", 0)) + 1
        # the best-so-far bar and the patience counter carry over, or the
        # first epoch after a resume would replace a better checkpoint
        best_acc = float(r_meta.get("best_val_acc", 0.0))
        bad = int(r_meta.get("bad_epochs", 0))
        if verbose:
            print(f"Resumed from {resume_from} at epoch {start_epoch} "
                  f"(best val acc so far {best_acc:.3f})")
    else:
        init_gen = torch.Generator().manual_seed(cfg.seed)
        model = BiGRUClassifier.from_jax_params(init_params(mcfg, init_gen),
                                                mcfg)
    model = model.to(device)
    opt = make_optimizer(model, cfg.lr, cfg.grad_clip_norm)
    if resumed_opt is not None:
        opt.load_state_arrays(resumed_opt)

    sampler_rng = np.random.default_rng(cfg.seed)
    step_gen = torch.Generator(device=device).manual_seed(cfg.seed)
    meta = reference_meta(
        x_dim=x_dim, max_t=cfg.max_t, use_roi=use_roi,
        roi_w=cfg.roi_w, roi_h=cfg.roi_h,
        labels=sorted(label_to_id), label_to_id=label_to_id,
        id_to_label=id_to_label, seed=cfg.seed, gru_layers=cfg.gru_layers,
    )
    best_params = params_numpy(model)
    history = []
    mlog = MetricsLogger(metrics_path)

    for ep in range(start_epoch, cfg.epochs + 1):
        t0 = time.perf_counter()
        tr_loss = torch.zeros((), device=device)
        tr_acc = torch.zeros((), device=device)
        tr_n = 0
        # the trace stops even when a step fails mid-epoch, so a retry in
        # the same process can start another
        with profiler_trace(profile_dir if ep == start_epoch else None):
            for idx in epoch_batches(train_ds.n, cfg.batch_size, sampler_rng,
                                     weights=weights):
                Xb, Lb, Rb, yb = gather(train_ds, idx)
                with torch.profiler.record_function("train_step"):
                    m = train_step(model, opt, scfg, Xb, Lb, Rb, yb,
                                   step_gen)
                tr_loss += m["loss"] * len(idx)
                tr_acc += m["acc"] * len(idx)
                tr_n += len(idx)
        tr_loss = float(tr_loss) / max(1, tr_n)
        tr_acc = float(tr_acc) / max(1, tr_n)

        va_loss = va_acc = 0.0
        va_n = 0
        y_true_all, y_pred_all = [], []
        for idx in epoch_batches(val_ds.n, cfg.batch_size, sampler_rng,
                                 shuffle=False, pad=False):
            Xb, Lb, Rb, yb = gather(val_ds, idx)
            m = eval_step(model, scfg, Xb, Lb, Rb, yb)
            b = len(idx)
            va_loss += float(m["loss"]) * b
            va_acc += float(m["acc"]) * b
            va_n += b
            y_true_all.extend(yb.tolist())
            y_pred_all.extend(m["pred"].tolist())
        va_loss /= max(1, va_n)
        va_acc /= max(1, va_n)

        confs = top_confusions(y_true_all, y_pred_all, id_to_label, k=6)
        conf_str = (" | top confusions: " + ", ".join(confs)) if confs else ""
        dt = time.perf_counter() - t0
        if verbose:
            print(
                f"ep {ep:02d} | train loss {tr_loss:.4f} acc {tr_acc:.3f} | "
                f"val loss {va_loss:.4f} acc {va_acc:.3f}{conf_str} [{dt:.1f}s]"
            )
        history.append(
            dict(epoch=ep, train_loss=tr_loss, train_acc=tr_acc,
                 val_loss=va_loss, val_acc=va_acc, seconds=dt)
        )
        mlog.log(step=ep, train_loss=tr_loss, train_acc=tr_acc,
                 val_loss=va_loss, val_acc=va_acc, epoch_seconds=dt)

        if va_acc > best_acc:
            best_acc = va_acc
            bad = 0
            best_params = params_numpy(model)
            save_checkpoint(
                cfg.out_path, best_params,
                dict(meta, epoch=ep, best_val_acc=best_acc, bad_epochs=bad),
                opt_state_arrays=opt.state_arrays(),
            )
            if verbose:
                print(f"  saved {cfg.out_path} (best val acc {best_acc:.3f})")
        else:
            bad += 1
            if bad >= cfg.patience:
                if verbose:
                    print(f"Early stopping. Best val acc: {best_acc:.3f}")
                break

    mlog.close()
    if verbose:
        print("Done. Best val acc:", best_acc)
    return dict(best_acc=best_acc, params=best_params, meta=meta,
                history=history, model_config=mcfg)
