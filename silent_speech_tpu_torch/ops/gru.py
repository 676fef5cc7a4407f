"""Masked GRU scan (port of the JAX ops/gru.py) — the plain PyTorch version
of K2, the GRU sequence kernels (ops/cuda_gru.py: csrc/gru_proj.cu, then
csrc/gru_seq.cu over ``gru_recurrence``'s input).

Semantics, all as in the JAX package and PyTorch's
``pack_padded_sequence(..., enforce_sorted=False)``:

- gate order r, z, n::

      r = sigmoid(x W_ir + b_ir + h W_hr + b_hr)
      z = sigmoid(x W_iz + b_iz + h W_hz + b_hz)
      n = tanh(x W_in + b_in + r * (h W_hn + b_hn))
      h' = (1 - z) * n + z * h

- the carry is frozen at t >= length and outputs are zero there;
- the reverse direction flips each sequence within its valid length, runs
  the same forward scan and flips back.

Weights keep the JAX layout: wi (D, 3H), wh (H, 3H), bi / bh (3H,).
"""

from __future__ import annotations

from typing import Optional

import torch

from .nn import dropout


def flip_padded(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse each sequence within its valid length, leaving padding in
    place. x: (B, T, ...); lengths: (B,)."""
    T = x.shape[1]
    j = torch.arange(T, device=x.device)[None, :]
    L = lengths.to(device=x.device, dtype=j.dtype)[:, None]
    idx = torch.where(j < L, L - 1 - j, j)
    idx = idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand_as(x)
    return torch.gather(x, 1, idx)


def gru_cell_step(h: torch.Tensor, xp_t: torch.Tensor, wh: torch.Tensor,
                  bh: torch.Tensor) -> torch.Tensor:
    """One GRU step given the input projection ``xp_t = x W_i + b_i``.

    h: (B, H); xp_t: (B, 3H); wh: (H, 3H); bh: (3H,). Returns the new h."""
    hp = h @ wh + bh
    xr, xz, xn = xp_t.chunk(3, dim=-1)
    hr, hz, hn = hp.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def gru_recurrence(xp: torch.Tensor, lengths: torch.Tensor,
                   wh: torch.Tensor, bh: torch.Tensor,
                   h0: Optional[torch.Tensor] = None):
    """The masked recurrence over the input projection ``xp = x W_i + b_i``
    (B, T, 3H); wh (H, 3H), bh (3H,). Returns (outputs (B, T, H) zero past
    each length, h_last (B, H))."""
    B, T, _ = xp.shape
    H = wh.shape[0]
    h = xp.new_zeros((B, H)) if h0 is None else h0
    L = lengths.to(xp.device)
    ys = []
    for t in range(T):
        h_new = gru_cell_step(h, xp[:, t], wh, bh)
        valid = (L > t)[:, None]
        h = torch.where(valid, h_new, h)  # freeze the carry past the end
        ys.append(torch.where(valid, h, torch.zeros_like(h)))
    y = torch.stack(ys, dim=1) if ys else xp.new_zeros((B, 0, H))
    return y, h


def gru_layer_single_direction(
    x: torch.Tensor,
    lengths: torch.Tensor,
    params: dict,
    *,
    reverse: bool = False,
    h0: Optional[torch.Tensor] = None,
):
    """Run one GRU direction over a padded batch.

    x: (B, T, D); lengths: (B,); params: {'wi', 'wh', 'bi', 'bh'}, cast to
    x's type (the bf16 training route runs the scan in bf16). Returns
    (outputs (B, T, H) zero past each length, h_last (B, H))."""
    if reverse:
        x = flip_padded(x, lengths)
    p = {k: v.to(x.dtype) for k, v in params.items()}  # x's type, as JAX
    xp = x @ p["wi"] + p["bi"]  # (B, T, 3H), hoisted out of the loop
    y, h = gru_recurrence(xp, lengths, p["wh"], p["bh"], h0)
    if reverse:
        y = flip_padded(y, lengths)
    return y, h


def bigru(x: torch.Tensor, lengths: torch.Tensor, layers: list[dict], *,
          bidirectional: bool = True, dropout_rate: float = 0.0,
          train: bool = False,
          generator: Optional[torch.Generator] = None):
    """Stacked (bi)directional GRU over a padded batch. In train mode,
    inverted dropout follows every layer but the last, as in
    ``nn.GRU(dropout=...)`` (train_model_official.py:261-267), with masks
    drawn from ``generator``.

    ``layers``: per-layer dicts {'fwd': {...}, 'bwd': {...}}.
    Returns (outputs (B, T, H * dirs), h_last (B, layers * dirs * H))."""
    out = x
    finals = []
    for li, lp in enumerate(layers):
        y_f, h_f = gru_layer_single_direction(out, lengths, lp["fwd"])
        if bidirectional:
            y_b, h_b = gru_layer_single_direction(out, lengths, lp["bwd"],
                                                  reverse=True)
            out = torch.cat([y_f, y_b], dim=-1)
            finals.extend([h_f, h_b])
        else:
            out = y_f
            finals.append(h_f)
        if li < len(layers) - 1:
            out = dropout(out, dropout_rate, generator, train)
    return out, torch.cat(finals, dim=-1)
