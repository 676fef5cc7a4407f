"""The bars that hold the 3xTF32 kernels' results, shared by the probes'
checks (ops/cuda_bwd_dots, ops/cuda_layout_micro, ops/cuda_mm_rate) and
chip_smoke.py's K2p reading: TF32 rounding as the kernels' split rounds,
the bars' constants and a result's share of a bar.

Against the f32 plain version, a kernel's element of n products summed in
another order lies within BAR_DEPTH sqrt(n) 2^-24 A (A: the element's sum
of |terms|): a random walk of n roundings, each at most 2^-24 of a partial
sum under A, stays within sqrt(n) 2^-24 A. Against the float64 version,
a 3xTF32 element lies within 2^-24 (BAR64_TERMS A + steps / 2 |ref|)
(:func:`bar64`, derived in ``cuda_bwd_dots.compare``), which one TF32 pass
(:func:`tf32_round` on both operands) misses where that derivation says.
"""

from __future__ import annotations

import torch

BAR_DEPTH = 4
BAR64_TERMS = 32


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as the kernels' split rounds (csrc/mma_tf32.cuh ``tf32``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def bar64(ref: torch.Tensor, absolute: torch.Tensor,
          steps: float = 1) -> torch.Tensor:
    """The float64 bar of a 3xTF32 result: 2^-24 (BAR64_TERMS A + steps / 2
    |ref|), ref the float64 value, A (``absolute``) its sum of |terms|,
    ``steps`` the step sums added in f32 after the products."""
    return 2.0 ** -24 * (BAR64_TERMS * absolute + steps / 2 * ref.abs())


def shares(got: torch.Tensor, want: torch.Tensor, bar: torch.Tensor,
           tag: str = "") -> dict:
    """The largest |got - want| (``max_abs_err<tag>``) and its largest
    share of ``bar`` element by element (``share_of_bar<tag>``; infinite
    where got holds a value that is not finite, and over 1 wherever the
    bar is 0 and got is off)."""
    err = (got - want).abs()
    share = (err / bar.clamp(min=1e-30)).max().item() if err.numel() else 0.0
    if not bool(torch.isfinite(got).all()):
        share = float("inf")
    return {"max_abs_err" + tag: err.max().item() if err.numel() else 0.0,
            "share_of_bar" + tag: share}
