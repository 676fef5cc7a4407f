"""Legacy training pipelines, the reference's historical model generations
(port of the JAX train/legacy_loops.py).

Each keeps its source pipeline's preprocessing and optimization protocol:

- ``train_reduced``: 5 distinct words, 1-layer BiGRU(h=64) mean-pool, the
  rich augmentation set (time-warp/drop/noise/jitter [+ optional mixup]),
  Adam 1e-3 after a global-norm clip, ReduceLROnPlateau(factor .5,
  patience 10) on the host (inactive/train_reduced.py).
- ``train_unigru``: activity-quantile silence trimming, fix_dim to the max
  corpus dim, per-clip z-score, optional delta features, T_TARGET=32
  windows, uni-GRU(h=128) on the final hidden state, AdamW 3e-4 wd 1e-3
  (inactive/train_model_1130pm.py).
- ``train_mlp_quick``: clip -> [mean, std] summary, 3-layer MLP, 70/15/15
  stratified split with a held-out TEST evaluation of the best checkpoint
  (inactive/train_5_quick.py).

Every trainer runs on ``device`` ('cuda' by default; the CPU must be asked
for), keeps the corpus there as padded tensors and draws augmentation and
dropout from a ``torch.Generator`` on it. A step runs the plain GRU scan
under autograd (the GRU kernel has no backward, nor has the JAX package's);
each epoch's validation (batches of 64) runs the inference route: K2 on a
CUDA device, TF32 off. The checkpoints carry the JAX package's ``meta`` keys
and ``model`` tags, so both packages' ``VariantPredictor.from_checkpoint``
load them; the console lines are the JAX trainers'.
"""

from __future__ import annotations

import dataclasses
import os
from collections import Counter
from typing import Callable, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..core.schema import fix_dim, load_clip, pad_trim_time
from ..data.augment import REDUCED_AUGMENT, augment_batch, mixup
from ..data.corpus import (build_label_maps, scan_corpus, split_by_label,
                           stratified_split_3way)
from ..models import variants as V
from .checkpoint import save_checkpoint
from .loop import params_numpy
from .step import Optimizer

SELECTED_WORDS_5 = ["hello", "water", "thanks", "please", "apple"]


# ----------------------------------------------------------------------------
# shared plumbing
# ----------------------------------------------------------------------------


def _device(device: Union[str, torch.device]) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch sees no CUDA device; "
                           "pass device='cpu' to train on the CPU")
    return device


def _load_padded(files, label_to_id, max_t, x_dim=None):
    Xs, Ls, ys = [], [], []
    for f in files:
        c = load_clip(f)
        X = c.X if x_dim is None else fix_dim(c.X, x_dim)
        Xp, T = pad_trim_time(X, max_t)
        Xs.append(Xp)
        Ls.append(T)
        ys.append(label_to_id[c.label])
    return (np.stack(Xs).astype(np.float32), np.asarray(Ls, np.int32),
            np.asarray(ys, np.int32))


def soft_cross_entropy(logits: torch.Tensor,
                       target: torch.Tensor) -> torch.Tensor:
    """Mean of optax.softmax_cross_entropy: -sum(target * log_softmax)."""
    return -(target * torch.log_softmax(logits, dim=-1)).sum(-1).mean()


def legacy_step(opt: Optimizer, forward: Callable, X: torch.Tensor,
                target: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One step of a legacy trainer: ``forward(X)``'s logits against the
    (soft) targets (B, C), backward, the optimizer's clip and step. Returns
    the loss and the accuracy against the targets' argmax, on the device."""
    logits = forward(X)
    loss = soft_cross_entropy(logits, target)
    opt.zero_grad()
    loss.backward()
    opt.step()
    acc = (logits.detach().argmax(-1) == target.argmax(-1)).to(
        torch.float32).mean()
    return loss.detach(), acc


def _epoch_eval(model, X: torch.Tensor, y: torch.Tensor, batch=64) -> float:
    """Accuracy of the inference forward (K2 on a CUDA device, TF32 off)
    over the device tensors X, y in batches of ``batch``."""
    from ..infer.predictor import full_f32

    ok = torch.zeros((), dtype=torch.int64, device=X.device)
    with torch.no_grad(), full_f32():
        for s in range(0, len(X), batch):
            logits = model(X[s:s + batch])
            ok += (logits.argmax(-1) == y[s:s + batch]).sum()
    return int(ok) / max(1, len(X))


def reduced_optimizer(model, cfg: "ReducedConfig") -> Optimizer:
    """Adam after the global-norm clip (inactive/train_reduced.py:223)."""
    return Optimizer(model, cfg.lr, cfg.grad_clip_norm)


def unigru_optimizer(model, cfg: "UniGRUConfig") -> Optimizer:
    """AdamW after a global-norm clip of 1.0."""
    return Optimizer(model, cfg.lr, 1.0, weight_decay=cfg.weight_decay)


def mlp_optimizer(model, cfg: "MLPQuickConfig") -> Optimizer:
    """Adam, its clip out of reach (the JAX trainer's 1e9)."""
    return Optimizer(model, cfg.lr, 1e9)


# ----------------------------------------------------------------------------
# train_reduced (inactive/train_reduced.py)
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class ReducedConfig:
    clip_dir: str = "clips_npz"
    out_path: str = "word_model_5.ckpt"
    words: tuple = tuple(SELECTED_WORDS_5)
    seed: int = 42
    batch_size: int = 16
    epochs: int = 200
    lr: float = 1e-3
    max_t: int = 60
    hidden: int = 64
    use_mixup: bool = False
    mixup_alpha: float = 0.2
    val_frac: float = 0.15
    plateau_factor: float = 0.5
    plateau_patience: int = 10
    early_stop_patience: int = 40  # inactive/train_reduced.py:260-262
    grad_clip_norm: float = 1.0  # nn.utils.clip_grad_norm_ (:223)


def train_reduced(cfg: ReducedConfig = ReducedConfig(), verbose=True,
                  device: Union[str, torch.device] = "cuda") -> dict:
    device = _device(device)
    index = scan_corpus(cfg.clip_dir, verbose=False)
    keep = [i for i, lab in enumerate(index.labels) if lab in cfg.words]
    files = [index.files[i] for i in keep]
    labels = [index.labels[i] for i in keep]
    # console contract: inactive/train_reduced.py:158-189
    if verbose:
        print(f"Using {len(files)} clips from {len(set(labels))} words")
        print("Distribution:", dict(Counter(labels)))
    label_to_id, id_to_label = build_label_maps(labels)
    tr_files, va_files = split_by_label(files, labels, cfg.val_frac,
                                        seed=cfg.seed, verbose=False)
    if verbose:
        print(f"Train: {len(tr_files)}, Val: {len(va_files)}")
    Xtr, Ltr, ytr = _load_padded(tr_files, label_to_id, cfg.max_t)
    Xva, _, yva = _load_padded(va_files, label_to_id, cfg.max_t)
    d_in = Xtr.shape[-1]
    num_classes = len(label_to_id)
    if verbose:
        print(f"Input dim: {d_in}")

    model = V.ReducedBiGRU.init(torch.Generator().manual_seed(cfg.seed),
                                d_in, num_classes,
                                hidden=cfg.hidden).to(device)
    # Adam + global-norm clip with a host-controlled learning rate (the
    # ReduceLROnPlateau equivalent)
    opt = reduced_optimizer(model, cfg)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    put = lambda a: torch.as_tensor(a, device=device)
    Xtr_d, Ltr_d, ytr_d = put(Xtr), put(Ltr), put(ytr)
    Xva_d, yva_d = put(Xva), put(yva)

    def forward(X):
        # the reference mean-pools over the padding too
        # (GRUClassifier.forward, train_reduced.py:141-145): no lengths
        return model(X)

    sampler = np.random.default_rng(cfg.seed)
    best, best_params = 0.0, params_numpy(model)
    # two counters, as in the reference: the save / early-stop patience
    # (train_reduced.py:249,260-262) and ReduceLROnPlateau's own (torch
    # semantics: rel threshold 1e-4, reduce when bad > patience);
    # best_sched starts at -inf (torch's mode_worse for mode='max'), so
    # epoch 1 always improves it
    lr_now, bad_plateau, bad_stop = cfg.lr, 0, 0
    best_sched = float("-inf")
    meta = dict(x_dim=d_in, max_t=cfg.max_t, labels=sorted(label_to_id),
                label_to_id=label_to_id,
                id_to_label={str(k): v for k, v in id_to_label.items()},
                seed=cfg.seed, model="reduced_bigru", hidden=cfg.hidden)
    history = []
    out_name = os.path.basename(cfg.out_path)
    for ep in range(1, cfg.epochs + 1):
        order = put(sampler.permutation(len(Xtr)))
        ep_loss = torch.zeros((), device=device)
        ep_acc = torch.zeros((), device=device)
        nb = 0
        for s in range(0, len(Xtr), cfg.batch_size):
            idx = order[s:s + cfg.batch_size]
            X, lengths = augment_batch(gen, Xtr_d[idx], Ltr_d[idx],
                                       REDUCED_AUGMENT)
            y_soft = F.one_hot(ytr_d[idx].long(), num_classes).to(X.dtype)
            if cfg.use_mixup:
                X, y_soft = mixup(gen, X, y_soft, cfg.mixup_alpha)
            loss, tr_acc = legacy_step(opt, forward, X, y_soft)
            ep_loss += loss
            ep_acc += tr_acc
            nb += 1
        ep_loss, ep_acc = float(ep_loss) / max(1, nb), float(ep_acc) / max(
            1, nb)
        acc = _epoch_eval(model, Xva_d, yva_d)
        history.append(dict(epoch=ep, loss=ep_loss, val_acc=acc))
        if verbose:
            # per-epoch console contract (train_reduced.py:245)
            print(f"ep {ep:02d} | loss {ep_loss:.4f} | train {ep_acc:.3f} | "
                  f"val {acc:.3f} | lr {lr_now:.5f}")
        if acc > best:
            best, bad_stop = acc, 0
            best_params = params_numpy(model)
            save_checkpoint(cfg.out_path, best_params, meta)
            if verbose:
                print(f"  saved {out_name} (best)")
        else:
            bad_stop += 1
            if bad_stop >= cfg.early_stop_patience:
                if verbose:
                    print("Early stopping")
                break
        # ReduceLROnPlateau(mode='max'): improvement = acc > best*(1+1e-4);
        # reduce on the (patience+1)-th consecutive bad epoch
        if acc > best_sched * (1.0 + 1e-4):
            best_sched, bad_plateau = acc, 0
        else:
            bad_plateau += 1
            if bad_plateau > cfg.plateau_patience:
                lr_now *= cfg.plateau_factor
                opt.set_lr(lr_now)
                bad_plateau = 0
    if verbose:
        # final console contract (train_reduced.py:265-266)
        print(f"\nBest validation accuracy: {best:.3f}")
        print(f"Random baseline: {1 / num_classes:.3f}")
    return dict(best_acc=best, params=best_params, meta=meta, history=history)


# ----------------------------------------------------------------------------
# train_unigru (inactive/train_model_1130pm.py)
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class UniGRUConfig:
    clip_dir: str = "clips_npz"
    out_path: str = "word_model.ckpt"
    seed: int = 42
    batch_size: int = 64
    epochs: int = 60
    lr: float = 3e-4
    weight_decay: float = 1e-3
    t_target: int = 32
    margin: int = 2
    quantile: float = 0.60
    min_keep: int = 6
    use_deltas: bool = True
    hidden: int = 128
    train_frac: float = 0.8


def activity_from_X(X: np.ndarray) -> np.ndarray:
    """Openness channel when D is odd, else y-spread
    (inactive/train_model_1130pm.py:57-65)."""
    if X.shape[1] % 2 == 1:
        return X[:, -1].astype(np.float32)
    y = X[:, 1::2]
    return (y.max(axis=1) - y.min(axis=1)).astype(np.float32)


def trim_by_activity(X, t_target, margin=2, q=0.60, min_keep=6):
    a = activity_from_X(X)
    thr = float(np.quantile(a, q))
    active = np.where(a > thr)[0]
    if len(active) < min_keep:
        return pad_trim_time(X, t_target)[0]
    lo = max(int(active[0]) - margin, 0)
    hi = min(int(active[-1]) + margin + 1, X.shape[0])
    return pad_trim_time(X[lo:hi], t_target)[0]


def add_deltas(X: np.ndarray) -> np.ndarray:
    dX = np.zeros_like(X)
    dX[1:] = X[1:] - X[:-1]
    return np.concatenate([X, dX], axis=1)


def zscore_per_clip(X: np.ndarray) -> np.ndarray:
    # the one normalization shared with the legacy eval pipelines
    from ..infer.evaluator import zscore

    return zscore(X)


def _unigru_preprocess(files, cfg: UniGRUConfig, d_target, label_to_id):
    Xs, ys = [], []
    for f in files:
        c = load_clip(f)
        X = fix_dim(c.X.astype(np.float32), d_target)
        X = trim_by_activity(X, cfg.t_target, cfg.margin, cfg.quantile,
                             cfg.min_keep)
        X = zscore_per_clip(X)
        if cfg.use_deltas:
            X = zscore_per_clip(add_deltas(X))
        Xs.append(X)
        ys.append(label_to_id[c.label])
    return np.stack(Xs).astype(np.float32), np.asarray(ys, np.int32)


def train_unigru(cfg: UniGRUConfig = UniGRUConfig(), verbose=True,
                 device: Union[str, torch.device] = "cuda") -> dict:
    device = _device(device)
    index = scan_corpus(cfg.clip_dir, verbose=False)
    label_to_id, id_to_label = build_label_maps(index.labels)
    d_target = max(index.dims)
    # console contract: inactive/train_model_1130pm.py:162-171
    if verbose:
        print("Words:", sorted(label_to_id))
        print("Counts:", Counter(index.labels))
        print("Using d_target =", d_target)
    rng_py = np.random.default_rng(cfg.seed)
    order = rng_py.permutation(len(index.files))
    n_train = int(cfg.train_frac * len(order))
    tr_files = [index.files[i] for i in order[:n_train]]
    va_files = [index.files[i] for i in order[n_train:]]

    Xtr, ytr = _unigru_preprocess(tr_files, cfg, d_target, label_to_id)
    Xva, yva = _unigru_preprocess(va_files, cfg, d_target, label_to_id)
    d_in = Xtr.shape[-1]
    num_classes = len(label_to_id)

    model = V.UniGRUClassifier.init(torch.Generator().manual_seed(cfg.seed),
                                    d_in, num_classes,
                                    hidden=cfg.hidden).to(device)
    opt = unigru_optimizer(model, cfg)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    put = lambda a: torch.as_tensor(a, device=device)
    Xtr_d, ytr_d, Xva_d, yva_d = put(Xtr), put(ytr), put(Xva), put(yva)
    forward = lambda X: model(X, train=True, generator=gen)

    best, best_params = 0.0, params_numpy(model)
    meta = dict(d_in=d_in, num_classes=num_classes,
                word_to_id=label_to_id,
                id_to_word={str(k): v for k, v in id_to_label.items()},
                t_target=cfg.t_target, d_target=d_target,
                use_deltas=cfg.use_deltas,
                trim=dict(q=cfg.quantile, margin=cfg.margin,
                          min_keep=cfg.min_keep),
                seed=cfg.seed, model="unigru")
    history = []
    sampler = np.random.default_rng(cfg.seed)
    for ep in range(1, cfg.epochs + 1):
        order = put(sampler.permutation(len(Xtr)))
        ep_loss = torch.zeros((), device=device)
        ep_acc = torch.zeros((), device=device)
        nb = 0
        for s in range(0, len(Xtr), cfg.batch_size):
            idx = order[s:s + cfg.batch_size]
            target = F.one_hot(ytr_d[idx].long(), num_classes).to(
                torch.float32)
            loss, tr_acc = legacy_step(opt, forward, Xtr_d[idx], target)
            ep_loss += loss
            ep_acc += tr_acc
            nb += 1
        ep_loss, ep_acc = float(ep_loss) / max(1, nb), float(ep_acc) / max(
            1, nb)
        acc = _epoch_eval(model, Xva_d, yva_d)
        history.append(dict(epoch=ep, loss=ep_loss, val_acc=acc))
        if verbose:
            # per-epoch console contract (train_model_1130pm.py:227)
            print(f"ep {ep:03d} | loss {ep_loss:.4f} | train {ep_acc:.3f} | "
                  f"val {acc:.3f}")
        if acc > best:
            best = acc
            best_params = params_numpy(model)
            save_checkpoint(cfg.out_path, best_params, meta)
            if verbose:
                print(f"  saved {cfg.out_path} (best val {best:.3f})")
    if verbose:
        print("best val:", best)
    return dict(best_acc=best, params=best_params, meta=meta, history=history)


# ----------------------------------------------------------------------------
# train_mlp_quick (inactive/train_5_quick.py)
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class MLPQuickConfig:
    clip_dir: str = "clips_npz"
    out_path: str = "word_model_mlp.ckpt"
    seed: int = 42
    batch_size: int = 32
    epochs: int = 60
    lr: float = 1e-3
    train_frac: float = 0.70
    val_frac: float = 0.15


def train_mlp_quick(cfg: MLPQuickConfig = MLPQuickConfig(), verbose=True,
                    device: Union[str, torch.device] = "cuda") -> dict:
    device = _device(device)
    index = scan_corpus(cfg.clip_dir, verbose=False)
    label_to_id, id_to_label = build_label_maps(index.labels)
    # console contract: inactive/train_5_quick.py:64-66,98
    if verbose:
        by_label = Counter(index.labels)
        print("Label counts:")
        for lab in sorted(by_label):
            print(f"  {lab:7s}: {by_label[lab]}")
    tr_f, va_f, te_f = stratified_split_3way(
        index.files, index.labels, seed=cfg.seed,
        train_frac=cfg.train_frac, val_frac=cfg.val_frac)
    if verbose:
        print(f"Split sizes: train={len(tr_f)} val={len(va_f)} "
              f"test={len(te_f)}")

    def to_feats(files):
        feats, ys = [], []
        for f in files:
            c = load_clip(f)
            feats.append(np.concatenate([c.X.mean(0), c.X.std(0)]))
            ys.append(label_to_id[c.label])
        if not feats:  # tiny corpora can yield an empty test split
            d = 2 * load_clip(index.files[0]).D
            return np.zeros((0, d), np.float32), np.zeros((0,), np.int32)
        return np.stack(feats).astype(np.float32), np.asarray(ys, np.int32)

    Xtr, ytr = to_feats(tr_f)
    Xva, yva = to_feats(va_f)
    Xte, yte = to_feats(te_f)
    in_dim, num_classes = Xtr.shape[-1], len(label_to_id)

    model = V.SummaryMLP.init(torch.Generator().manual_seed(cfg.seed),
                              in_dim, num_classes).to(device)
    opt = mlp_optimizer(model, cfg)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    put = lambda a: torch.as_tensor(a, device=device)
    Xtr_d, ytr_d = put(Xtr), put(ytr)
    forward = lambda X: model(X, train=True, generator=gen)

    best, best_params = 0.0, params_numpy(model)
    meta = dict(in_dim=in_dim, labels=sorted(label_to_id),
                label_to_id=label_to_id,
                id_to_label={str(k): v for k, v in id_to_label.items()},
                seed=cfg.seed, model="summary_mlp")
    sampler = np.random.default_rng(cfg.seed)
    for ep in range(1, cfg.epochs + 1):
        order = put(sampler.permutation(len(Xtr)))
        ep_loss = torch.zeros((), device=device)
        nb = 0
        for s in range(0, len(Xtr), cfg.batch_size):
            idx = order[s:s + cfg.batch_size]
            target = F.one_hot(ytr_d[idx].long(), num_classes).to(
                torch.float32)
            ep_loss += legacy_step(opt, forward, Xtr_d[idx], target)[0]
            nb += 1
        acc = _epoch_eval(model, put(Xva), put(yva))
        if verbose:
            # per-epoch console contract (train_5_quick.py:129)
            print(f"ep {ep:02d} | train loss {float(ep_loss) / max(1, nb):.4f}"
                  f" | val acc {acc:.3f}")
        if acc > best:
            best = acc
            best_params = params_numpy(model)
            save_checkpoint(cfg.out_path, best_params, meta)
            if verbose:
                print(f"  saved {cfg.out_path} (best so far)")
    # the held-out TEST evaluation of the best checkpoint
    model.load_params_tree(best_params)
    test_acc = _epoch_eval(model, put(Xte), put(yte))
    if verbose:
        print(f"TEST acc: {test_acc:.3f}")
    return dict(best_acc=best, test_acc=test_acc, params=best_params,
                meta=meta)
