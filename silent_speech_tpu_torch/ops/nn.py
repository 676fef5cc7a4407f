"""Small neural-net building blocks on tensors (port of the JAX ops/nn.py).

The public functions keep the JAX package's layouts, so the tests can feed
both the same parameter dicts: NHWC activations with HWIO conv kernels, NWC
activations with WIO 1-D conv kernels, and dense weights stored (in, out).
Inside, the convolutions and pool run as ``F.conv2d`` / ``F.conv1d`` /
``F.max_pool2d`` on channels-last views, which costs no copy.

Initializers reproduce PyTorch's defaults (uniform +-1/sqrt(fan_in)) and
draw from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

# ----------------------------------------------------------------------------
# initializers (PyTorch-default equivalents, explicit generator)
# ----------------------------------------------------------------------------


def uniform_init(shape, bound: float, generator: torch.Generator,
                 dtype=torch.float32) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, dtype=dtype)
    return (2.0 * u - 1.0) * bound


def linear_init(d_in: int, d_out: int, generator: torch.Generator) -> dict:
    """nn.Linear default init: U(+-1/sqrt(fan_in)) for weight and bias."""
    bound = 1.0 / math.sqrt(d_in)
    return {"w": uniform_init((d_in, d_out), bound, generator),
            "b": uniform_init((d_out,), bound, generator)}


def conv_init(kh: int, kw: int, c_in: int, c_out: int,
              generator: torch.Generator) -> dict:
    """nn.Conv2d default init, HWIO layout."""
    bound = 1.0 / math.sqrt(c_in * kh * kw)
    return {"w": uniform_init((kh, kw, c_in, c_out), bound, generator),
            "b": uniform_init((c_out,), bound, generator)}


def conv1d_init(kw: int, c_in: int, c_out: int,
                generator: torch.Generator) -> dict:
    """nn.Conv1d default init, WIO layout."""
    bound = 1.0 / math.sqrt(c_in * kw)
    return {"w": uniform_init((kw, c_in, c_out), bound, generator),
            "b": uniform_init((c_out,), bound, generator)}


def gru_dir_init(d_in: int, hidden: int, generator: torch.Generator) -> dict:
    """One GRU direction: nn.GRU default init U(+-1/sqrt(H)) on all tensors."""
    bound = 1.0 / math.sqrt(hidden)
    return {"wi": uniform_init((d_in, 3 * hidden), bound, generator),
            "wh": uniform_init((hidden, 3 * hidden), bound, generator),
            "bi": uniform_init((3 * hidden,), bound, generator),
            "bh": uniform_init((3 * hidden,), bound, generator)}


def layer_norm_init(dim: int) -> dict:
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


# ----------------------------------------------------------------------------
# applications
# ----------------------------------------------------------------------------


def dense(x: torch.Tensor, p: dict) -> torch.Tensor:
    """x @ w + b with w stored (in, out), in x's type."""
    return x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)


def layer_norm(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, matching nn.LayerNorm (biased variance)."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * p["scale"].to(x.dtype)
            + p["bias"].to(x.dtype))


def conv2d_nhwc(x: torch.Tensor, p: dict) -> torch.Tensor:
    """3x3-style SAME conv, stride 1. x: (N, H, W, C); kernel HWIO; no bias
    where ``p`` has no 'b'."""
    kh, kw = p["w"].shape[:2]
    y = F.conv2d(x.permute(0, 3, 1, 2), p["w"].permute(3, 2, 0, 1),
                 p.get("b"), padding=(kh // 2, kw // 2))
    return y.permute(0, 2, 3, 1)


def conv1d_nwc(x: torch.Tensor, p: dict) -> torch.Tensor:
    """SAME 1-D conv, stride 1. x: (N, W, C); kernel WIO (kw, C, C_out).
    An even kw pads one more position after than before, as XLA's SAME."""
    y = F.conv1d(x.transpose(1, 2), p["w"].permute(2, 1, 0),
                 p["b"].to(x.dtype), padding="same")
    return y.transpose(1, 2)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pool on NHWC, floor mode like nn.MaxPool2d(2)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator], train: bool
            ) -> torch.Tensor:
    """Inverted dropout: keep each element with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate). The mask is drawn from
    ``generator`` on ``x``'s device."""
    if not train or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs a generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))
