"""Probe: layout primitives on (768, 768) f32 blocks (port of
scripts/mosaic_micro.py).

    python -m silent_speech_tpu_torch.scripts.mosaic_micro [STEPS] \\
        [device=cuda] [iters=30]

One row a body of the JAX script, with its name (ops/cuda_layout_micro.py,
csrc/layout_micro.cu): copy, the row-pair max, the lane and row rolls with
a max, every second row, the transpose, six unaligned 18-lane slices, six
aligned 128-lane slices, and a (768, 512) x (512, 128) product beside a
copy, over STEPS (512) blocks of x, standard normal from ``default_rng(0)``
(1.208 GB at 512 steps). On the card each body's kernel is first held
against its plain version (bitwise, but the product: its copied lanes
bitwise, the product within 4 sqrt(512) 2^-24 of each element's sum of
|terms| and within a float64 bar, ``cuda_layout_micro.compare_product``;
the unaligned body on the lanes it writes, and zeros in the rest); a row
gives its device time with the L2 evicted before each call
(``proto_parity_cnn.device_ms``, cold: the bytes bound every body, the
product's too at the rate of its 3xTF32 route), its share of the bound,
its plain version's time and, where one torch call computes the body,
that call's time (the product: of its product part; beside it the two
calls that do the body's work, ``library_ms_same_work``). The
unaligned body writes zeros where the JAX body leaves its lanes unwritten.
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
from ..ops import cuda_layout_micro as lm
from . import proto_parity_cnn as harness

ITERS = 30  # mosaic_micro.py:23


def check_body(body: str, x: torch.Tensor) -> float:
    """The body's kernel against its plain version on x's device (module
    docstring); returns the largest difference, raising over the bar."""
    got = lm.layout(body, x, impl="kernel")
    if body == lm.MATMUL:
        return lm.compare_product(got, x)["max_abs_err"]
    want = lm.layout_plain(body, x)
    if body == "unaligned_18lane_x6":
        lanes = torch.from_numpy(lm.WRITTEN).to(x.device)
        rest = torch.ones(lm.L, dtype=torch.bool, device=x.device)
        rest[lanes] = False
        ok = torch.equal(got[:, lanes], want[:, lanes]) and \
            not got[:, rest].any()
    else:
        ok = torch.equal(got, want)
    if not ok:
        raise RuntimeError(f"{body}: not bitwise the plain version")
    return 0.0


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = harness.parse_args(sys.argv[1:] if argv is None else argv,
                              "mosaic_micro", n_default=lm.STEPS, n_step=1,
                              iters_default=ITERS)
    steps, dev = args.N, args.device
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((steps * lm.R, lm.L))
                         .astype(np.float32)).to(dev)
    print(f"mosaic_micro: {steps} steps of ({lm.R}, {lm.L}) f32 "
          f"({x.numel() * 4 / 1e9:.3f} GB) on {harness.device_name(dev)}",
          flush=True)
    rows, ms_by = [], {}
    cuda = dev.type == "cuda"
    with torch.no_grad(), full_f32():
        for body in lm.BODIES:
            err = check_body(body, x) if cuda else None
            b_ms, b_by = harness.bound_ms(lm.macs(body, steps),
                                          lm.bytes_moved(body, steps),
                                          lm.rate(body))
            fn = lambda body=body: lm.layout(body, x)
            lib = lambda body=body: lm.library(body, x)
            cold = b_by == "bytes"
            ms = harness.timed_ms(fn, args, cold)
            plain_ms = harness.timed_ms(
                lambda body=body: lm.layout_plain(body, x), args, cold)
            lib_ms = harness.device_ms(lib, args, cold) \
                if cuda and lib() is not None else None
            tail = "" if lib_ms is None else f", library {lib_ms:.4f} ms"
            row = {"name": body, "ms": ms, "bound_ms": b_ms,
                   "bound_by": b_by, "plain_ms": plain_ms,
                   "library_ms": lib_ms, "max_abs_err": err}
            if cuda and body == lm.MATMUL:
                row["library_ms_same_work"] = harness.device_ms(
                    lambda: lm.library_same_work(x), args, cold)
                tail += (" (the product part; with the copy of the other "
                         f"lanes {row['library_ms_same_work']:.4f} ms)")
            print(f"{body:>22}: {ms:8.4f} ms / {steps} steps, "
                  f"{b_ms / ms:6.1%} of its bound {b_ms:.4f} ms ({b_by}), "
                  f"plain {plain_ms:.4f} ms{tail}", flush=True)
            ms_by[body] = ms
            rows.append(row)
    return harness.report("mosaic_micro", args, rows, ms=ms_by)


if __name__ == "__main__":
    main()
