"""Temporal pooling (port of the JAX ops/pooling.py): the official model's
learned single-query attention pool (train_model_official.py:231-248)."""

from __future__ import annotations

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
