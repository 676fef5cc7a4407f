"""Batched augmentation on the device (port of the JAX data/augment.py).

The reference augments per item on the host (train_model_official.py:
144-152: gaussian noise p=0.7 sigma=0.01; drop 1-2 interior frames p=0.35
when T>12) and, in its richer variant (inactive/train_reduced.py:103-123),
time-warp, frame drop, noise and scale jitter, plus optional mixup. Here
each augmentation is a batched transform of the padded (B, T, D) features
with static shapes, as in the JAX package.

Every function is split in two: ``draw_*`` takes the random numbers from an
explicit ``torch.Generator`` on the batch's device, and ``apply_*`` is the
deterministic rest (masks, ranks, stable compaction, clamps), so the tests
can feed ``apply_*`` the draws that JAX's own keys make and compare. The
two packages draw different numbers from the same seed.

Frame dropping with static shapes: the kept frames move to the front in
their order (a stable argsort of the drop flags) and lengths shrink by the
drop count. Only the features are compacted, as in the JAX package; the ROI
keeps its frames and the shorter length masks its tail.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    noise_prob: float = 0.7
    noise_std: float = 0.01
    drop_prob: float = 0.35
    drop_max: int = 2
    drop_min_t: int = 12
    # official drops interior frames only (train_model_official.py:146-152);
    # train_reduced samples from all positions (:112-114)
    drop_interior_only: bool = True
    # the train_reduced set, off in the official recipe
    time_warp_prob: float = 0.0
    time_warp_lo: float = 0.8
    time_warp_hi: float = 1.2
    scale_jitter_prob: float = 0.0
    scale_jitter_lo: float = 0.95
    scale_jitter_hi: float = 1.05


OFFICIAL_AUGMENT = AugmentConfig()
REDUCED_AUGMENT = AugmentConfig(
    noise_prob=0.5, noise_std=0.015, drop_prob=0.3, drop_max=3, drop_min_t=15,
    drop_interior_only=False, time_warp_prob=0.5, scale_jitter_prob=0.3,
)


def _rand(shape, generator: torch.Generator, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device)


def _positions(T: int, device) -> torch.Tensor:
    return torch.arange(T, device=device)[None, :]


# ---------------------------------------------------------------- noise


def draw_noise(generator: torch.Generator, X: torch.Tensor, prob: float,
               std: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(apply (B, 1, 1) bool, noise (B, T, D)) for :func:`apply_noise`."""
    B = X.shape[0]
    apply = _rand((B, 1, 1), generator, X.device) < prob
    noise = torch.randn(X.shape, generator=generator, device=X.device,
                        dtype=X.dtype) * std
    return apply, noise


def apply_noise(X, lengths, apply, noise):
    """Add ``noise`` to the valid frames of the clips where ``apply``."""
    valid = _positions(X.shape[1], X.device)[..., None] < lengths[:, None, None]
    return torch.where(apply & valid, X + noise, X)


def add_noise(generator, X, lengths, prob: float, std: float):
    """Per-clip gaussian feature noise, masked to valid frames."""
    return apply_noise(X, lengths, *draw_noise(generator, X, prob, std))


# ---------------------------------------------------------- frame drops


def draw_drop(generator: torch.Generator, X: torch.Tensor,
              cfg: AugmentConfig):
    """(gate (B,) bool, k (B,) drops in [1, drop_max], scores (B, T)
    uniform) for :func:`apply_drop`."""
    B, T = X.shape[:2]
    gate = _rand((B,), generator, X.device) < cfg.drop_prob
    k = torch.randint(1, cfg.drop_max + 1, (B,), generator=generator,
                      device=X.device)
    scores = _rand((B, T), generator, X.device)
    return gate, k, scores


def apply_drop(X, lengths, gate, k, scores, cfg: AugmentConfig):
    """Drop the k lowest-scored eligible frames of each gated clip and
    compact. Returns (X', lengths')."""
    T = X.shape[1]
    lengths = lengths.to(torch.int64)
    gate = gate & (lengths > cfg.drop_min_t)
    k = torch.where(gate, k.to(torch.int64), torch.zeros_like(lengths))
    pos = _positions(T, X.device)
    if cfg.drop_interior_only:
        eligible = (pos >= 1) & (pos < (lengths - 1)[:, None])
    else:
        eligible = pos < lengths[:, None]
    # never more drops than eligible frames, and keep at least one frame
    k = torch.minimum(k, eligible.sum(dim=1))
    k = torch.clamp(torch.minimum(k, lengths - 1), min=0)
    scores = torch.where(eligible, scores, torch.full_like(scores, float("inf")))
    order = torch.argsort(scores, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    drop = rank < k[:, None]
    perm = torch.argsort(drop.to(torch.int32), dim=1, stable=True)
    Xc = torch.gather(X, 1, perm[..., None].expand_as(X))
    new_len = lengths - k
    Xc = torch.where((pos < new_len[:, None])[..., None], Xc,
                     torch.zeros_like(Xc))
    return Xc, new_len


def drop_frames(generator, X, lengths, cfg: AugmentConfig):
    """Drop 1..drop_max interior frames per clip (prob-gated), compacting."""
    return apply_drop(X, lengths, *draw_drop(generator, X, cfg), cfg)


# ------------------------------------------------------------ time warp


def draw_time_warp(generator: torch.Generator, X: torch.Tensor,
                   cfg: AugmentConfig):
    """(gate (B,) bool, scale (B,) in [lo, hi)) for
    :func:`apply_time_warp`."""
    B = X.shape[0]
    gate = _rand((B,), generator, X.device) < cfg.time_warp_prob
    u = _rand((B,), generator, X.device)
    scale = cfg.time_warp_lo + u * (cfg.time_warp_hi - cfg.time_warp_lo)
    return gate, scale


def apply_time_warp(X, lengths, gate, scale):
    """Resample each gated clip to int(len * scale) frames (at least 5),
    mapped over the original length and truncated to T
    (inactive/train_reduced.py:105-109). Returns (X', lengths')."""
    T = X.shape[1]
    lengths = lengths.to(torch.int64)
    gate = gate & (lengths > 10)
    warp_len = torch.clamp((lengths.to(torch.float32) * scale)
                           .to(torch.int64), min=5)
    warp_len = torch.where(gate, warp_len, lengths)
    new_len = torch.clamp(warp_len, 1, T)
    pos = _positions(T, X.device).to(torch.float32)
    denom = torch.clamp(warp_len - 1, min=1).to(torch.float32)[:, None]
    src = (pos * (lengths - 1)[:, None].to(torch.float32) / denom
           ).to(torch.int64)
    src = torch.clamp(src, 0, T - 1)
    Xw = torch.gather(X, 1, src[..., None].expand_as(X))
    valid = _positions(T, X.device) < new_len[:, None]
    Xw = torch.where(valid[..., None], Xw, torch.zeros_like(Xw))
    Xw = torch.where(gate[:, None, None], Xw, X)
    return Xw, new_len


def time_warp(generator, X, lengths, cfg: AugmentConfig):
    return apply_time_warp(X, lengths, *draw_time_warp(generator, X, cfg))


# --------------------------------------------------------- scale jitter


def draw_scale_jitter(generator: torch.Generator, X: torch.Tensor,
                      cfg: AugmentConfig):
    """(gate (B, 1, 1) bool, s (B, 1, 1) in [lo, hi)) for
    :func:`apply_scale_jitter`."""
    B = X.shape[0]
    gate = _rand((B, 1, 1), generator, X.device) < cfg.scale_jitter_prob
    u = _rand((B, 1, 1), generator, X.device)
    s = cfg.scale_jitter_lo + u * (cfg.scale_jitter_hi - cfg.scale_jitter_lo)
    return gate, s


def apply_scale_jitter(X, lengths, gate, s):
    valid = _positions(X.shape[1], X.device)[..., None] < lengths[:, None, None]
    return torch.where(gate & valid, X * s, X)


def scale_jitter(generator, X, lengths, cfg: AugmentConfig):
    return apply_scale_jitter(X, lengths,
                              *draw_scale_jitter(generator, X, cfg))


# ---------------------------------------------------------------- mixup


def draw_mixup(generator: torch.Generator, X: torch.Tensor, alpha: float):
    """(lam ~ Beta(alpha, alpha), perm of the batch) for
    :func:`apply_mixup`."""
    a = torch.full((2,), alpha, dtype=torch.float64, device=X.device)
    g = torch._standard_gamma(a, generator=generator)
    lam = (g[0] / (g[0] + g[1])).to(X.dtype)
    perm = torch.randperm(X.shape[0], generator=generator, device=X.device)
    return lam, perm


def apply_mixup(X, y_onehot, lam, perm):
    X_mix = lam * X + (1.0 - lam) * X[perm]
    y_mix = lam * y_onehot + (1.0 - lam) * y_onehot[perm]
    return X_mix, y_mix


def mixup(generator, X, y_onehot, alpha: float = 0.2):
    """Batch mixup (inactive/train_reduced.py:36-53) on features and soft
    labels. alpha <= 0 is the reference's no-mix fallback (lam = 1)."""
    if alpha <= 0:
        return X, y_onehot
    return apply_mixup(X, y_onehot, *draw_mixup(generator, X, alpha))


# -------------------------------------------------------------- compose


def augment_batch(generator: Optional[torch.Generator], X, lengths,
                  cfg: AugmentConfig):
    """The composed pipeline, in train_reduced's order (warp -> drop ->
    noise -> jitter); the official config runs noise and drop only.
    Returns (X', lengths')."""
    if cfg.time_warp_prob > 0:
        X, lengths = time_warp(generator, X, lengths, cfg)
    if cfg.drop_prob > 0:
        X, lengths = drop_frames(generator, X, lengths, cfg)
    if cfg.noise_prob > 0:
        X = add_noise(generator, X, lengths, cfg.noise_prob, cfg.noise_std)
    if cfg.scale_jitter_prob > 0:
        X = scale_jitter(generator, X, lengths, cfg)
    return X, lengths
