"""Probe: the whole TinyROICNN with the parity conv1 + pool1 kernel in front
(port of scripts/proto_parity_e2e.py).

    python -m silent_speech_tpu_torch.scripts.proto_parity_e2e [N] \\
        [device=cuda] [iters=30]

The kernel writes one (N*12, 768) array whose row-major reshape is pooled1
(N, 24, 48, 8), and a plain back half follows (conv 8->16 + ReLU + pool,
conv 16->24 + ReLU, the mean, the fc: ``roi_cnn_parity``). The weights are
the official model's TinyROICNN, random from a seed, carried through the
port's converter (``BiGRUClassifier.from_jax_params``). The rows: K1, the
fused CNN kernel the port serves with (the "shipped" path); the plain CNN
in f32 and in bf16 (the counterparts of the script's "grouped" rows: the
grouped convolutions compute the plain ones bitwise); the parity path in
f32 and in bf16 (pooled1 cast to bf16 and the back half in bf16, the mean
and the fc in f32). Bars: f32 rows within 1e-4 of the plain f32 CNN
(proto_parity_e2e.py:165), bf16 rows within 2e-2 (the bar the script gives
a bf16 path).
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import numpy as np
import torch

from ..infer.predictor import full_f32
from ..models.bigru import BiGRUClassifier, BiGRUConfig, init_params
from ..ops import cuda_cnn
from ..ops import cuda_parity_cnn as pc
from ..ops.nn import conv2d_nhwc, max_pool_2x2
from . import proto_parity_cnn as harness

TOL_BF16 = 2e-2


def tiny_roi_cnn(seed: int = 0) -> dict:
    """The official model's TinyROICNN parameters (JAX layout), random from
    ``seed``, through the port's JAX-params converter."""
    cfg = BiGRUConfig(x_dim=180, num_classes=10, use_roi=True)
    model = BiGRUClassifier.from_jax_params(
        init_params(cfg, torch.Generator().manual_seed(seed)), cfg)
    with torch.no_grad():
        return {k: {n: t.detach().clone() for n, t in v.items()}
                for k, v in model.params_tree()["roi_cnn"].items()}


def roi_cnn_plain_dtype(cnn: dict, roi_u8: torch.Tensor,
                        dtype: torch.dtype) -> torch.Tensor:
    """The plain CNN with the frames / 255 (f32) cast to ``dtype`` and the
    three convs in ``dtype``, the mean and the fc in f32: the counterpart of
    the script's ``grouped_bf16`` (roi_cnn_grouped of the frames in bf16)."""
    x = (roi_u8.to(torch.float32) / 255.0).to(dtype)[..., None]
    for key, pool in (("conv0", True), ("conv1", True), ("conv2", False)):
        x = torch.relu(conv2d_nhwc(x, {"w": cnn[key]["w"].to(dtype),
                                       "b": cnn[key]["b"].to(dtype)}))
        x = max_pool_2x2(x) if pool else x
    feat = x.to(torch.float32).mean(dim=(1, 2))
    return feat @ cnn["fc"]["w"] + cnn["fc"]["b"]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = harness.parse_args(sys.argv[1:] if argv is None else argv,
                              "proto_parity_e2e")
    dev = args.device
    cnn = {k: {n: t.to(dev) for n, t in v.items()}
           for k, v in tiny_roi_cnn().items()}
    WE, WO, bias = (t.to(dev) for t in pc.pack_parity_conv1(
        cnn["conv0"]["w"].cpu(), cnn["conv0"]["b"].cpu()))
    rng = np.random.default_rng(0)
    roi = torch.from_numpy(
        rng.integers(0, 256, (args.N, 48, 96), dtype=np.uint8)).to(dev)
    harness.header(args, "proto_parity_e2e")
    flat = cuda_cnn.flat_weights(cnn)
    variants = {
        "K1 roi_cnn_fused (shipped)": (
            lambda: cuda_cnn.roi_cnn_fused(roi, cnn, flat=flat), harness.TOL),
        "plain f32": (lambda: cuda_cnn.roi_cnn_plain(roi, cnn), harness.TOL),
        "parity f32": (lambda: pc.roi_cnn_parity(cnn, roi, WE, WO, bias),
                       harness.TOL),
        "plain bf16": (lambda: roi_cnn_plain_dtype(cnn, roi, torch.bfloat16),
                       TOL_BF16),
        "parity bf16": (lambda: pc.roi_cnn_parity(
            cnn, roi, WE, WO, bias, compute_dtype=torch.bfloat16), TOL_BF16),
    }
    with torch.no_grad(), full_f32():
        want = cuda_cnn.roi_cnn_plain(roi, cnn)
        rows = []
        for name, (fn, tol) in variants.items():
            err = harness.max_err(fn(), want)
            harness.check(f"{name} vs plain f32", err, tol)
            rows.append(harness.row(name, fn, args, err))
    return harness.report("proto_parity_e2e", args, rows, tol=harness.TOL,
                          tol_bf16=TOL_BF16)


if __name__ == "__main__":
    main()
