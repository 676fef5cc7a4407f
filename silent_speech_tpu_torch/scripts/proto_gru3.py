"""Probe: the GRU input projection fused in the kernel, one launch a
direction (port of scripts/proto_gru3.py).

    python -m silent_speech_tpu_torch.scripts.proto_gru3 [B] [T] \\
        [device=cuda] [iters=100]

The TPU kernel of this probe (proto_gru3.py::_gru_fusedproj_kernel) is the
prototype that became K2 (ops/pallas_gru.py::_gru_fusedproj_kernel), and it
computes K2's function. Its counterpart here is K2's one-direction pair
of launches (ops/cuda_gru.gru_sequence: csrc/gru_proj.cu, then
csrc/gru_seq.cu): no kernel of its own. As in the JAX script the backward
direction flips its input and output on the host (``flip_padded``) around
a forward call, where K2's own ``bigru_kernel`` reverses inside the
recurrence and runs both directions in each launch; the table holds the
two against each other.

K2 has no knobs: it picks its batch tile from the shapes and the card
(``cuda_gru.plan``) and reads one step of input at a time, so
``batch_tile`` takes None, ``k_steps`` 1 and ``vmem_mb`` (a Mosaic VMEM
limit) 0, and other values raise; K2 has no bf16 build, so
``bf16_mm=True`` raises (proto_gru4's dual-chain kernel has one).
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import torch

from ..infer.predictor import full_f32
from ..ops import cuda_gru
from ..ops.gru import flip_padded
from . import bench_gru as harness

def _check_knobs(batch_tile: Optional[int], k_steps: int, bf16_mm: bool,
                 vmem_mb: int) -> None:
    for name, value, only in (("batch_tile", batch_tile, None),
                              ("k_steps", k_steps, 1),
                              ("vmem_mb", vmem_mb, 0),
                              ("bf16_mm", bf16_mm, False)):
        if value != only:
            raise ValueError(
                f"{name}={value!r}: this probe runs K2's one-direction "
                f"launches, which take only {name}={only!r} (the batch tile "
                "from the shapes, one step read at a time, f32; no VMEM "
                "limit on the card)")


def gru_sequence_fusedproj(x: torch.Tensor, lengths: torch.Tensor,
                           wi: torch.Tensor, bi: torch.Tensor,
                           wh: torch.Tensor, bh: torch.Tensor, *,
                           batch_tile: Optional[int] = None,
                           k_steps: int = 1, bf16_mm: bool = False,
                           vmem_mb: int = 0, impl: str = "auto"
                           ) -> torch.Tensor:
    """One GRU direction with the projection in the kernel
    (proto_gru3.py::gru_sequence_fusedproj): K2's one-direction launches.
    x: (B, T, D), already flipped for the reverse direction. Returns
    (B, T, H)."""
    _check_knobs(batch_tile, k_steps, bf16_mm, vmem_mb)
    return cuda_gru.gru_sequence(x, lengths, wi, bi, wh, bh, impl=impl)


def gru_layer_fusedproj(x: torch.Tensor, lengths: torch.Tensor,
                        params: dict, *, reverse: bool = False,
                        batch_tile: Optional[int] = None, k_steps: int = 1,
                        bf16_mm: bool = False, vmem_mb: int = 0,
                        impl: str = "auto") -> torch.Tensor:
    """One direction, flipping on the host for ``reverse``
    (proto_gru3.py::gru_layer_fusedproj)."""
    if reverse:
        x = flip_padded(x, lengths)
    y = gru_sequence_fusedproj(
        x, lengths, params["wi"], params["bi"], params["wh"], params["bh"],
        batch_tile=batch_tile, k_steps=k_steps, bf16_mm=bf16_mm,
        vmem_mb=vmem_mb, impl=impl)
    return flip_padded(y, lengths) if reverse else y


def bigru_fusedproj(x: torch.Tensor, lengths: torch.Tensor, layers: list, *,
                    batch_tile: Optional[int] = None, k_steps: int = 1,
                    bf16_mm: bool = False, vmem_mb: int = 0,
                    impl: str = "auto") -> torch.Tensor:
    """Stacked biGRU, one launch a direction
    (proto_gru3.py::bigru_fusedproj). Returns (B, T, 2H)."""
    kw = dict(batch_tile=batch_tile, k_steps=k_steps, bf16_mm=bf16_mm,
              vmem_mb=vmem_mb, impl=impl)
    out = x
    for lp in layers:
        out = torch.cat([gru_layer_fusedproj(out, lengths, lp["fwd"], **kw),
                         gru_layer_fusedproj(out, lengths, lp["bwd"],
                                             reverse=True, **kw)], dim=-1)
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = harness.parse_args(sys.argv[1:] if argv is None else argv)
    pb = harness.make_problem(args.B, args.T, args.device)
    harness.header(args)
    x, L, layers = pb
    with torch.no_grad(), full_f32():
        stack = harness.baselines(pb) + [
            ("fusedproj (K2 a direction)",
             lambda: bigru_fusedproj(x, L, layers))]
        rows = harness.run_table("stack", stack, harness.scan_stack(pb),
                                 args)
    return harness.report("proto_gru3", args, rows)


if __name__ == "__main__":
    main()
