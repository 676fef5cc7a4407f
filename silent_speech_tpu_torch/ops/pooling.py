"""Temporal pooling (port of the JAX ops/pooling.py): the official model's
learned single-query attention pool (train_model_official.py:231-248) and
the mean pool of the variant families (inactive/train_reduced.py:142-145,
live_feed.py:47-50)."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9  # masked-score fill, matching the reference's masked_fill(-1e9)


def length_mask(lengths: torch.Tensor, T: int) -> torch.Tensor:
    """(B,) lengths -> (B, T) bool validity mask."""
    return (torch.arange(T, device=lengths.device)[None, :]
            < lengths[:, None])


def attn_pool(h: torch.Tensor, lengths: torch.Tensor, params: dict
              ) -> torch.Tensor:
    """Masked single-query attention pooling.

    h: (B, T, H); params: {'score': {'w': (H, 1), 'b': (1,)}}. Returns (B, H).
    """
    T = h.shape[1]
    score = params["score"]
    scores = (h @ score["w"].to(h.dtype) + score["b"].to(h.dtype)).squeeze(-1)
    scores = scores.masked_fill(~length_mask(lengths, T), NEG_INF)
    w = torch.softmax(scores, dim=1).unsqueeze(-1)
    return (h * w).sum(dim=1)


def masked_mean_pool(h: torch.Tensor,
                     lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over time. With ``lengths=None`` it averages all T positions
    (the reference mean-pool models average the padding too, kept for
    parity); with lengths, only the valid frames."""
    if lengths is None:
        return h.mean(dim=1)
    mask = length_mask(lengths, h.shape[1]).to(h.dtype)[..., None]
    return (h * mask).sum(dim=1) / mask.sum(dim=1).clamp(min=1.0)
