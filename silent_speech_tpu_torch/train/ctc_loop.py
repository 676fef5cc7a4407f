"""The CTC training pipeline, the open-vocabulary path (port of the JAX
train/ctc_loop.py).

Reproduces inactive/train_model.py main() (:192-272): the per-label split,
silence trimming, Adam on the CTC loss, a dictionary-scored validation
accuracy each epoch, a checkpoint at each new best with the CTC metadata
(vocab, blank_id, label_to_text, uniq_labels) and patience. The corpus
stays in host arrays (uint8 ROI) and each step copies its batch to the
device. Validation scores every dictionary word for every validation clip
in one batched forward and one lattice a word chunk
(``CTCDecoder.score_batch``) instead of the reference's loop over words.
"""

from __future__ import annotations

import random
import time
from collections import defaultdict
from typing import Union

import numpy as np
import torch

from ..core.config import CTCTrainConfig
from ..core.schema import load_clip
from ..data.corpus import scan_corpus
from ..infer.ctc_decode import CTCDecoder, Dictionary, trim_pad
from ..models import ctc_model
from ..models.bigru import COMPUTE_DTYPES
from ..ops.ctc import ctc_loss
from .checkpoint import save_checkpoint
from .loop import params_numpy
from .step import make_optimizer, resolve_roi_impl

# per-clip feature noise (inactive/train_model.py:77-80): a clip takes
# gaussian noise of this std on its valid frames with this probability
NOISE_PROB, NOISE_STD = 0.6, 0.01


def _load_ctc_arrays(files, label_to_text, cfg: CTCTrainConfig):
    """Load, trim and pad clips into stacked host arrays: X (N, max_t, D)
    f32, R (N, max_t, H, W) uint8, lengths, labels (N, L_max) int32, label
    lengths and the texts."""
    Xs, Rs, Ls, texts = [], [], [], []
    for f in files:
        c = load_clip(f).aligned()
        if c.roi is None:
            raise ValueError(f"CTC training requires ROI in every clip: {f}")
        if c.roi.shape[1:] != (cfg.roi_h, cfg.roi_w):
            raise ValueError(f"{f}: ROI {c.roi.shape[1:]}, the config's "
                             f"{(cfg.roi_h, cfg.roi_w)}")
        # the frames stay uint8: the ROI CNN normalizes (/255) on the
        # device, bitwise the reference collate division
        # (inactive/train_model.py:109), at a quarter of the copy
        Xp, Rp, T = trim_pad(c.X, c.roi, cfg.max_t,
                             open_idx=cfg.trim_open_idx,
                             thresh=cfg.trim_thresh, pad=cfg.trim_pad)
        Xs.append(Xp)
        Rs.append(Rp)
        Ls.append(T)
        texts.append(label_to_text[c.label])
    enc = [ctc_model.encode_text(t) for t in texts]
    ys = np.zeros((len(enc), max(len(e) for e in enc)), np.int32)
    ylens = np.zeros(len(enc), np.int32)
    for i, e in enumerate(enc):
        ys[i, :len(e)] = e
        ylens[i] = len(e)
    return (np.stack(Xs), np.stack(Rs), np.asarray(Ls, np.int32), ys, ylens,
            texts)


def feature_noise(X: torch.Tensor, lengths: torch.Tensor,
                  generator: torch.Generator) -> torch.Tensor:
    """The reference's per-clip feature noise: each clip, with probability
    NOISE_PROB, gets N(0, NOISE_STD) noise on its valid frames."""
    B, T = X.shape[:2]
    apply = torch.rand((B, 1, 1), generator=generator,
                       device=X.device) < NOISE_PROB
    valid = (torch.arange(T, device=X.device)[None, :, None]
             < lengths[:, None, None])
    noise = torch.randn(X.shape, generator=generator, device=X.device,
                        dtype=X.dtype) * NOISE_STD
    return torch.where(apply & valid, X + noise, X)


def ctc_train_step(model: ctc_model.BiGRUCTC, opt, X, R, L, y, ylen,
                   generator: torch.Generator, *, roi_impl: str = "auto",
                   compute_dtype: str = "float32") -> torch.Tensor:
    """One CTC train step on a batch on the model's device: feature noise,
    the training forward with dropout (both drawn from ``generator``), the
    CTC loss in f32, backward, Adam. Returns the loss (on the device)."""
    X = feature_noise(X, L, generator)
    lp = model(X, L, R, train=True, generator=generator, roi_impl=roi_impl,
               compute_dtype=compute_dtype)
    loss = ctc_loss(lp, L, y, ylen)
    opt.zero_grad()
    loss.backward()
    opt.step()
    return loss.detach()


def train_ctc(cfg: CTCTrainConfig, verbose: bool = True,
              device: Union[str, torch.device] = "cuda") -> dict:
    """Run the CTC training pipeline on ``device`` ('cuda' by default; the
    CPU must be asked for). Returns best_acc, params (the best JAX-layout
    tree, numpy), meta and history.

    On a CUDA device each step runs the ROI CNN kernel (K1) forward and its
    weight-gradient kernel (K3) under ``roi_impl='auto'``, and the plain
    GRU scan; the validation runs K1 and the GRU kernels (K2) with TF32
    off. ``compute_dtype='bfloat16'`` trains on the bf16 training route
    (the parameters and Adam's state stay f32); validation stays f32, as
    the JAX package's."""
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype={cfg.compute_dtype!r}: the port "
                         f"trains in {COMPUTE_DTYPES}")
    roi_impl = resolve_roi_impl(cfg.roi_impl)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch sees no CUDA device; "
                           "pass device='cpu' to train on the CPU")
    index = scan_corpus(cfg.clip_dir, verbose=False)
    uniq = sorted(set(index.labels))
    label_to_text = {lab: ctc_model.normalize_label(lab) for lab in uniq}
    dictionary = Dictionary.from_words(uniq)
    x_dim = load_clip(index.files[0]).D

    # per-label split (inactive/train_model.py:203-212)
    rng_py = random.Random(cfg.seed)
    by_lab = defaultdict(list)
    for f, lab in zip(index.files, index.labels):
        by_lab[lab].append(f)
    train_files, val_files = [], []
    for fs in by_lab.values():
        rng_py.shuffle(fs)
        n_val = max(1, int(len(fs) * cfg.val_frac))
        val_files += fs[:n_val]
        train_files += fs[n_val:]
    if not train_files:
        raise ValueError(
            f"no training clips after the per-label split "
            f"({len(index.files)} clips, val_frac={cfg.val_frac}): the "
            f"corpus is too small (every label's clips went to validation)")
    Xtr, Rtr, Ltr, ytr, yltr, _ = _load_ctc_arrays(train_files,
                                                   label_to_text, cfg)
    Xva, Rva, Lva, _, _, va_labels = _load_ctc_arrays(val_files,
                                                      label_to_text, cfg)

    params = ctc_model.init_params(
        x_dim, torch.Generator().manual_seed(cfg.seed), hidden=cfg.hidden,
        gru_layers=cfg.gru_layers, roi_emb=cfg.roi_emb)
    model = ctc_model.BiGRUCTC.from_jax_params(params, ctc_model.CTCConfig(
        x_dim=x_dim, hidden=cfg.hidden, gru_layers=cfg.gru_layers,
        roi_emb=cfg.roi_emb, roi_h=cfg.roi_h, roi_w=cfg.roi_w)).to(device)
    opt = make_optimizer(model, cfg.lr, grad_clip_norm=1e9)  # no clip
    step_gen = torch.Generator(device=device).manual_seed(cfg.seed)
    # the validation is a serving workload: the inference kernels, TF32
    # off, the checkpoint's length prior
    val_dec = CTCDecoder(model, dictionary, device=device, max_t=cfg.max_t,
                         len_lambda=cfg.len_lambda,
                         len_per_char=cfg.len_per_char, roi_impl=roi_impl)

    n = len(Xtr)
    sampler = np.random.default_rng(cfg.seed)
    best, bad = 0.0, 0
    best_params = params_numpy(model)
    meta = dict(
        x_dim=x_dim, max_t=cfg.max_t, vocab=ctc_model.VOCAB,
        blank_id=ctc_model.BLANK_ID, label_to_text=label_to_text,
        uniq_labels=uniq, exp_len=cfg.len_per_char, len_lambda=cfg.len_lambda,
        gru_layers=cfg.gru_layers, seed=cfg.seed,
        roi_h=cfg.roi_h, roi_w=cfg.roi_w,
    )
    put = lambda a: torch.as_tensor(a, device=device)
    history = []
    for ep in range(1, cfg.epochs + 1):
        t0 = time.perf_counter()
        order = sampler.permutation(n)
        ep_loss = torch.zeros((), device=device)
        nb = 0
        for s in range(0, n, cfg.batch_size):
            idx = order[s:s + cfg.batch_size]
            ep_loss += ctc_train_step(
                model, opt, put(Xtr[idx]), put(Rtr[idx]), put(Ltr[idx]),
                put(ytr[idx]), put(yltr[idx]), step_gen, roi_impl=roi_impl,
                compute_dtype=cfg.compute_dtype)
            nb += 1
        ep_loss = float(ep_loss) / max(1, nb)

        scores = val_dec.score_batch(Xva, Rva, Lva)
        ok = sum(ctc_model.normalize_label(uniq[int(i)]) == lab
                 for i, lab in zip(scores.argmax(-1), va_labels))
        acc = ok / max(1, len(Xva))
        dt = time.perf_counter() - t0
        if verbose:
            print(f"ep {ep:03d} | loss {ep_loss:.4f} | val acc {acc:.3f} "
                  f"[{dt:.1f}s]")
        history.append(dict(epoch=ep, loss=ep_loss, val_acc=acc))

        if acc > best:
            best, bad = acc, 0
            best_params = params_numpy(model)
            save_checkpoint(cfg.out_path, best_params, meta)
        else:
            bad += 1
            if bad >= cfg.patience:
                break

    if verbose:
        print("Best val acc:", best)
    return dict(best_acc=best, params=best_params, meta=meta, history=history)
