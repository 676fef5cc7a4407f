"""Probe: both directions of a GRU layer in one kernel, as two independent
chains, the projections fused (port of scripts/proto_gru4.py).

    python -m silent_speech_tpu_torch.scripts.proto_gru4 [B] [T] \\
        [device=cuda] [iters=100]

The dual-chain kernel (csrc/gru_proto.cu) runs both directions of a layer
in one launch, each chain as thread-block clusters of K2's recurrence that
keep Wh and their units' columns of Wi in shared memory and project each
chunk of ``k_steps`` steps on the tensor cores before its steps. As the TPU
kernel it takes x and flip_padded(x) and returns the backward direction's
output in the flipped order, which the host flips back. ``bf16_mm`` rounds
x, Wi, h and Wh for the products.

The variant table sweeps the card's knobs: ``batch_tile`` (rows a
cluster) and ``k_steps`` (steps a chunk), by default the kernel's plan.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import torch

from ..infer.predictor import full_f32
from ..ops.cuda_gru_proto import DUAL_VMEM_MB, gru_layer_dual
from ..ops.gru import flip_padded
from . import bench_gru as harness

__all__ = ["gru_layer_dual", "bigru_dual", "main"]


def bigru_dual(x: torch.Tensor, lengths: torch.Tensor, layers: list, *,
               batch_tile: Optional[int] = None,
               k_steps: Optional[int] = None, bf16_mm: bool = False,
               vmem_mb: int = DUAL_VMEM_MB, impl: str = "auto"
               ) -> torch.Tensor:
    """Stacked biGRU, one dual-chain launch a layer
    (proto_gru4.py::bigru_dual). Returns (B, T, 2H)."""
    out = x
    for lp in layers:
        y_f, y_b_rev = gru_layer_dual(
            out, flip_padded(out, lengths), lengths, lp["fwd"], lp["bwd"],
            batch_tile=batch_tile, k_steps=k_steps, bf16_mm=bf16_mm,
            vmem_mb=vmem_mb, impl=impl)
        out = torch.cat([y_f, flip_padded(y_b_rev, lengths)], dim=-1)
    return out


# (name, knobs); each fits a block's shared memory at D=384, H=192 (the
# second layer; ops/cuda_gru_proto.dual_geometry); no batch_tile: the
# kernel's plan
VARIANTS = [
    ("dual plan", {}),
    ("dual k8 plan", {"k_steps": 8}),
    ("dual k4 plan", {"k_steps": 4}),
    ("dual k2 bt16", {"k_steps": 2, "batch_tile": 16}),
    ("dual k4 bt8", {"k_steps": 4, "batch_tile": 8}),
    ("dual k1 bt28", {"k_steps": 1, "batch_tile": 28}),
    ("dual k8 bt1", {"k_steps": 8, "batch_tile": 1}),
    ("dual k32 bt1", {"k_steps": 32, "batch_tile": 1}),
    ("dual plan bf16", {"bf16_mm": True}),
]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = harness.parse_args(sys.argv[1:] if argv is None else argv)
    pb = harness.make_problem(args.B, args.T, args.device)
    harness.header(args)
    x, L, layers = pb
    with torch.no_grad(), full_f32():
        stack = harness.baselines(pb) + [
            (name, lambda kw=kw: bigru_dual(x, L, layers, **kw))
            for name, kw in VARIANTS]
        rows = harness.run_table("stack", stack, harness.scan_stack(pb),
                                 args)
    return harness.report("proto_gru4", args, rows)


if __name__ == "__main__":
    main()
