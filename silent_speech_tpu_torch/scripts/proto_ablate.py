"""Probe: the stages of the parity conv1 + pool1 kernel, timed one by one
(port of scripts/proto_ablate.py).

    python -m silent_speech_tpu_torch.scripts.proto_ablate [N] \\
        [device=cuda] [iters=30]

The kernel of proto_parity_cnn (csrc/roi_parity.cu) takes a stop template
parameter; each of the JAX script's modes runs the point of the CUDA design
that answers the same question, in the JAX script's order
(ops/cuda_parity_cnn.ABLATION_MODES): ``io_only`` the frames' bytes into
the zero-haloed shared-memory image and every output stored once;
``widen_only`` + the u8 -> f32 widen (each warp's patch fragments formed
from the image); ``halo_only`` + the weights' hi / lo planes in shared
memory; ``no_dot`` + the chunk loop and the epilogue over fragment values
in place of the products; ``full`` + the products on the tensor cores,
the kernel itself. The modes about the TPU's lane alignment and
its patch buffer (``halo_aligned``, ``no_patch``, ``patch_aligned``) print
one row that says why the card's design has no such stage. The inputs are
the JAX script's: random class arrays and random (unpacked) WE, WO, bias.
The stops write values of no meaning ("wrong results OK"); ``full`` is held
against the plain version at max|err| / max|ref| <= 1e-6. On the CPU only
``full`` runs (the plain version): the stops exist only in the kernel.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import numpy as np
import torch

from ..infer.predictor import full_f32
from ..ops import cuda_parity_cnn as pc
from . import proto_parity_cnn as harness

REL_TOL = 1e-6  # full vs plain, random weights: f32 sums in two orders


def make_inputs(N: int, device: torch.device):
    """The JAX script's draws: four (N*12, 96) class arrays, WE, WO
    (104, 128) and bias (1, 384), standard normal, from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    xs = [rng.integers(0, 256, (N * pc.HQ, pc.W1), dtype=np.uint8)
          for _ in range(4)]
    WE = rng.standard_normal((pc.KP, 128)).astype(np.float32)
    WO = rng.standard_normal((pc.KP, 128)).astype(np.float32)
    bias = rng.standard_normal((1, 384)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (*xs, WE, WO, bias)]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = harness.parse_args(sys.argv[1:] if argv is None else argv,
                              "proto_ablate")
    inputs = make_inputs(args.N, args.device)
    harness.header(args, "proto_ablate")
    on_card = args.device.type == "cuda"
    rows = []
    with torch.no_grad(), full_f32():
        ref = pc.parity_halves_plain(inputs[:4], *inputs[4:])
        scale = max(r.abs().max().item() for r in ref)
        for mode in pc.JAX_MODES:
            if mode in pc.NO_COUNTERPART:
                note = f"no counterpart: {pc.NO_COUNTERPART[mode]}"
                print(f"{mode:>34s}: {note}", flush=True)
                rows.append({"name": mode, "ms": None, "note": note})
                continue
            if mode != "full" and not on_card:
                note = "a stop of the CUDA kernel: not run on the cpu"
                print(f"{mode:>34s}: {note}", flush=True)
                rows.append({"name": mode, "ms": None, "note": note})
                continue
            fn = lambda mode=mode: pc.run(*inputs, mode=mode)
            err = None
            if mode == "full":
                err = max(harness.max_err(g, r) for g, r in zip(fn(), ref))
                harness.check("full vs plain (relative)", err / scale,
                              REL_TOL)
            rows.append(harness.row(mode, fn, args, err))
    return harness.report("proto_ablate", args, rows, rel_tol=REL_TOL)


if __name__ == "__main__":
    main()
