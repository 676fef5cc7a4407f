"""Probe: the dot rate of f32, bf16 and int8 chains at the ROI CNN kernel's
tile shapes (port of scripts/probe_int8.py).

    python -m silent_speech_tpu_torch.scripts.probe_int8 [GRID] \\
        [device=cuda] [iters=50]

For each K (384, 512), each mode runs ``build(mode, K)``: GRID (256) steps of a serial
chain of 14 (384, K) x (K, K) products, seeded from the step's uint8 block
(ops/cuda_dot_chain.py, csrc/dot_chain.cu): ``f32`` as 3xTF32 and
``bf16`` on wgmma, ``int8`` (s8 x s8 -> s32, re-narrowed by ``>> 7``
between products) and ``int8i`` (14 independent s8 products summed in s32)
on s8 wgmma with W^T held in shared memory for the life of a persistent
block (at K=512 half of it in each block of a pair). W is defined (``cuda_dot_chain.make_weights``),
where the TPU kernel's was never written. On the card each mode's kernel is
first held against its plain version (``cuda_dot_chain.check``: bitwise
for the int modes, the timed instantiation bitwise the checked one); then
a row gives its device time (the host's launches held out,
``proto_parity_cnn.device_ms``), its rate in T MAC/s, its share of the
card's bound for its type, its speed against f32, and the times of the
plain version and of the chain as 14 library GEMMs
(``cuda_dot_chain.library``, on the card only). The last line is one JSON
object with the JAX script's keys (``<mode>_k<K>``: ms) and the rows. On
the CPU (``device=cpu``) a run is a check of the code through
the plain versions, timed by the host clock, not a measurement; without a
CUDA device it raises unless ``device=cpu`` is given.
"""

from __future__ import annotations

import sys
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..infer.predictor import full_f32
from ..ops import cuda_dot_chain as dc
from . import proto_parity_cnn as harness

ITERS = 50  # probe_int8.py:54
# the bound's rate (proto_parity_cnn.PEAK_OPS): f32 at the f32 FMAs and
# 3xTF32 together, 232 TFLOP/s
PEAK_KIND = {"f32": "f32_3xtf32", "bf16": "bf16", "int8": "int8",
             "int8i": "int8"}


def build(mode: str, K: int, x: torch.Tensor) -> Callable[[], torch.Tensor]:
    """The call of ``build(mode, K)`` on x: the kernel (or, on the CPU, its
    plain version) with the port's defined W, packed once."""
    w = dc.make_weights(mode, K).to(x.device)
    packed = dc.pack_weights(w, mode) if x.is_cuda else None
    return lambda: dc.dot_chain(x, w, mode, packed=packed)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = harness.parse_args(sys.argv[1:] if argv is None else argv,
                              "probe_int8", n_default=dc.GRID, n_step=1,
                              iters_default=ITERS)
    grid, dev = args.N, args.device
    cuda = dev.type == "cuda"
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (grid * 8, 128),
                                      dtype=np.uint8)).to(dev)
    print(f"probe_int8: grid={grid} on {harness.device_name(dev)}",
          flush=True)
    out, rows = {}, []
    with torch.no_grad(), full_f32():
        for K in dc.KS:
            macs = dc.macs(grid, K)
            print(f"== chained (M={dc.M}, K={K})x(K, K) dots, DEPTH="
                  f"{dc.DEPTH}, grid={grid} ({macs / 1e9:.0f} G MACs) ==",
                  flush=True)
            base = None
            for mode in dc.MODES:
                w = dc.make_weights(mode, K).to(dev)
                err = share = lib_ms = None
                if cuda:
                    c = dc.check(x, w, mode, packed=dc.pack_weights(w, mode))
                    err, share = c["max_abs_err"], c["share_of_bar"]
                    lib_ms = harness.device_ms(
                        lambda: dc.library(x, w, mode), args)
                ms = harness.timed_ms(build(mode, K, x), args)
                plain_ms = harness.timed_ms(
                    lambda: dc.output_of(dc.chain_plain(x, w, mode)), args)
                rate = macs / (ms * 1e-3) / 1e12
                b_ms, b_by = harness.bound_ms(
                    macs, dc.bytes_moved(grid, K, mode), PEAK_KIND[mode])
                note = "" if base is None else f"  ({base / ms:.2f}x vs f32)"
                if mode == "f32":
                    base = ms
                print(f"  {mode:6s}: {ms:8.4f} ms  {rate:7.2f} T MAC/s  "
                      f"{b_ms / ms:6.1%} of its {PEAK_KIND[mode]} bound "
                      f"{b_ms:.4f} ms{note}; plain {plain_ms:.4f} ms"
                      + ("" if lib_ms is None else
                         f", library {lib_ms:.4f} ms"), flush=True)
                out[f"{mode}_k{K}"] = ms
                rows.append({"name": f"{mode}_k{K}", "ms": ms,
                             "t_macs": rate, "bound_ms": b_ms,
                             "bound_by": b_by, "plain_ms": plain_ms,
                             "library_ms": lib_ms, "max_abs_err": err,
                             "share_of_bar": share})
    return harness.report("probe_int8", args, rows, **out)


if __name__ == "__main__":
    main()
