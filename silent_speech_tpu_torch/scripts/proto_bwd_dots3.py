"""Probe: the rate of the lhs-transposed dot on operands that stay put
(port of scripts/proto_bwd_dots3.py).

    python -m silent_speech_tpu_torch.scripts.proto_bwd_dots3 [STEPS] \\
        [device=cuda] [iters=5]

For each of the JAX script's (M, K, N) shapes, p (M, K) and dy (M, N),
then pk (K, M), from one ``default_rng(0)`` in its loop's order; STEPS
(512) steps each add the product anew, the operands the same in every step
(ops/cuda_bwd_dots.py, csrc/bwd_dots.cu):

- ``tt``: out (K, N) = the sum over the steps of p^T dy (``bwd_dot_tt``
  with one m = M row tile);
- ``nn``: out (K, N) = the sum over the steps of pk @ dy, the same
  multiply-adds in the normal form (``bwd_dot_nn``).

The kernels compute every step's product (none is hoisted out of the
loop); a row's time under its bound would show one that was not. The
library row is one ``torch.addmm`` with ``alpha=STEPS`` (p.T @ dy or
pk @ dy, computed once and scaled); one ``torch.matmul`` (p.T @ dy) at
the same (M, K, N) gives a product's rate beside it. Each row also gives its time a
step (the JAX script's us/step). Each row is checked and timed as
proto_bwd_dots's (``proto_bwd_dots.dot_row``); the last line is one JSON
object with the rows. ``vmem_limit_bytes`` has no counterpart on the card.
On the CPU (``device=cpu``) a run is a check of the code through the plain
versions, timed by the host clock, not a measurement; without a CUDA
device it raises unless ``device=cpu`` is given.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import numpy as np
import torch

from ..infer.predictor import full_f32
from ..ops import cuda_bwd_dots as bd
from . import proto_bwd_dots
from . import proto_parity_cnn as harness

ITERS = 5  # proto_bwd_dots3.py:64
SHAPES = ((384, 512, 256), (384, 104, 256), (384, 256, 512))  # (M, K, N)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = proto_bwd_dots.parse(sys.argv[1:] if argv is None else argv,
                                "proto_bwd_dots3", 1, bd.STEPS, ITERS)
    steps, dev = args.N, args.device
    print(f"proto_bwd_dots3: {steps} steps, f32 in, f32 sums, on "
          f"{harness.device_name(dev)}", flush=True)
    rng = np.random.default_rng(0)
    out = []
    with torch.no_grad(), full_f32():
        for M, K, N in SHAPES:
            p, dy = bd.draw(rng, (M, K), dev), bd.draw(rng, (M, N), dev)
            one = (lambda: torch.matmul(p.T, dy), M * K * N)
            out.append(proto_bwd_dots.dot_row(
                f"tt_{M}x{K}x{N}", "tt", p, dy, args, (M, M, K, N), m=M,
                steps=steps, one_matmul=one))
            pk = bd.draw(rng, (K, M), dev)
            out.append(proto_bwd_dots.dot_row(
                f"nn_{M}x{K}x{N}", "nn", pk, dy, args, (M, K, N),
                steps=steps, one_matmul=one))
            for r in out[-2:]:
                r["us_per_step"] = r["ms"] * 1e3 / steps
    return harness.report("proto_bwd_dots3", args, out, steps=steps)


if __name__ == "__main__":
    main()
