"""Probe: the byte ladder of the ROI CNN kernel's input front (port of
scripts/probe_front.py).

    python -m silent_speech_tpu_torch.scripts.probe_front [N] \\
        [device=cuda] [iters=30]

Micro-kernels (csrc/roi_front_probe.cu, ops/cuda_front_probe.py) read as
a cumulative ladder on K1's persistent geometry, one for every rung (one
wave of 288-thread blocks walking the frames, each frame brought into a
ring of 7 shared-memory slots by a TMA bulk copy, beside two (50 x 98)
haloed images in shared memory), so that each rung's delta is its work:
``dma_ring`` the load alone; ``widen`` + u8 -> f32 and /255 (bitwise K1's
division); ``front`` + the zero-haloed shared-memory store (the live
front); ``front_std`` + K1's per-frame standardization (the training
front). Then, at K1's first geometry (one 288-thread block a frame, one
16-byte load a thread): ``dma`` at 1, 2 and 4 frames a block (the
counterparts of F_TILE 16, 32, 64): flat times mean a bandwidth-bound
stream, times that grow with the block count a per-block latency floor; the
overlap pair, A the live front then a chain of FMAs as long as K1's
arithmetic a frame, B the chain alone: A - B is what the front costs
beside K1-sized arithmetic. Every stage's
per-block values are held against their plain version. The micro-kernels
run for tens of microseconds, less than the host takes to launch a call,
so a row's ``ms`` is the device time of a call with the host's launches
held out (``proto_parity_cnn.device_ms``), with the L2 evicted before each
call where the bound is the bytes from device memory (37.75 MB fits the
50 MB L2): every rung but the overlap pair, bound by its FMAs. Last, the
cross-reference rows: K1 itself, ``debug_stop='load'`` and
``debug_stop='norm'`` (ops/cuda_cnn.roi_cnn_fused; the stops cold), on the
same frames, and one JSON line like the JAX script's.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import numpy as np
import torch

from ..infer.predictor import full_f32
from ..ops import cuda_cnn
from ..ops import cuda_front_probe as fp
from . import proto_parity_cnn as harness

def check_stage(stage: str, x: torch.Tensor, F: int = 1) -> float:
    """The stage's per-block values against the plain version; returns the
    largest difference, raising over the bar (ops/cuda_front_probe.bar)."""
    got = fp.probe(stage, x, F).cpu()
    want = fp.probe_plain(stage, x.cpu(), F)
    err = (got.double() - want.double()).abs()
    bad = err > fp.bar(stage, x.cpu(), F).double()
    if bad.any():
        raise RuntimeError(f"{stage} F={F}: {int(bad.sum())} blocks off the "
                           f"plain version (largest difference "
                           f"{err.max().item():.3e})")
    return err.max().item()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = harness.parse_args(sys.argv[1:] if argv is None else argv,
                              "probe_front")
    dev, N = args.device, args.N
    rng = np.random.default_rng(0)
    roi_np = rng.integers(0, 256, (N, 48, 96), dtype=np.uint8)
    roi = torch.from_numpy(roi_np).to(dev)
    x_in = roi.reshape(N * fp.HQ, 4 * fp.W0)
    mb = x_in.numel() / 1e6
    harness.header(args, "probe_front")
    out, rows = {}, []

    def rung(name: str, stage: str, x: torch.Tensor, F: int = 1,
             stream_bytes: int = 0) -> float:
        """stream_bytes: the bytes from device memory that bound the rung
        (timed cold, with its GB/s); 0 for the FMA-bound overlap pair."""
        err = check_stage(stage, x, F)
        r = harness.row(name, lambda: fp.probe(stage, x, F), args, err,
                        cold=bool(stream_bytes))
        if stream_bytes and dev.type == "cuda":
            print(f"{'':>34s}  cold L2: {stream_bytes / r['ms'] / 1e6:.1f} "
                  "GB/s of u8", flush=True)
        rows.append(r)
        out[name] = r["ms"]
        return r["ms"]

    print(f"== front ladder ({N} frames, {mb:.2f} MB u8 in, K1's persistent "
          f"blocks of 288 threads, a ring of {fp.RING_SLOTS} frames each) ==",
          flush=True)
    for stage in fp.LADDER:
        rung(stage, stage, x_in, stream_bytes=x_in.numel())
    print(f"== dma vs frames a block (the same {mb:.2f} MB stream; K1's "
          f"first geometry, a block of 288 threads a frame) ==", flush=True)
    for F in fp.DMA_FRAMES:
        rung(f"dma_f{F}", "dma", x_in, F, stream_bytes=x_in.numel())
    print(f"== overlap A/B (a chain of {fp.CHAIN_ACC} x {fp.CHAIN_LEN} FMAs a "
          f"thread: K1's multiply-adds a frame) ==", flush=True)
    x_small = torch.from_numpy(
        rng.integers(0, 256, (N, 4), dtype=np.uint8)).to(dev)
    ms_a = rung("overlap_a", "overlap_a", x_in)
    ms_b = rung("overlap_b", "overlap_b", x_small)
    print(f"{'A - B (front beside the chain)':>34s}: {ms_a - ms_b:9.4f} ms",
          flush=True)

    conv = lambda *s: {
        "w": torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                              * np.float32(0.1)).to(dev),
        "b": torch.from_numpy(rng.standard_normal(s[-1:])
                              .astype(np.float32)).to(dev)}
    params = {"conv0": conv(3, 3, 1, 8), "conv1": conv(3, 3, 8, 16),
              "conv2": conv(3, 3, 16, 24), "fc": conv(24, 32)}
    flat = cuda_cnn.flat_weights(params)
    print("== cross-reference: K1 and its debug stops ==", flush=True)
    for stop, tag in ((None, "full"), ("load", "stop=load"),
                      ("norm", "stop=norm")):
        name = f"k1_{tag}"
        if stop is not None and dev.type != "cuda":
            note = "a stop of the CUDA kernel: not run on the cpu"
            print(f"{name:>34s}: {note}", flush=True)
            rows.append({"name": name, "ms": None, "note": note})
            continue
        fn = lambda stop=stop: cuda_cnn.roi_cnn_fused(
            roi, params, flat=flat, debug_stop=stop)
        with torch.no_grad(), full_f32():
            got = fn()
            if stop is None:
                want = cuda_cnn.roi_cnn_plain(roi, params)
            else:
                want = cuda_cnn.roi_cnn_debug_plain(roi, params, False, stop)
        err = harness.max_err(got, want)
        rows.append(harness.row(name, fn, args, err, cold=stop is not None))
        out[name] = rows[-1]["ms"]
    return harness.report("probe_front", args, rows, ms=out)


if __name__ == "__main__":
    main()
