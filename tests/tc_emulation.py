"""The ROI CNN kernels' tensor-core arithmetic, emulated on the CPU.

csrc/roi_cnn.cu (the forward) and csrc/roi_cnn_bwd.cu (its weight
gradients) run their GEMM-shaped products as 3xTF32 on m16n8k8 TF32 MMAs:
each operand x is split as hi = tf32(x), lo = tf32(x - hi), both rounded to
nearest with ties away from zero (``cvt.rna.tf32.f32``), and a product is
hi*hi + hi*lo + lo*hi with f32 accumulation. Here the products are formed
from those values and summed in float64 (a product of two TF32 values is
exact there), then rounded to f32 where the kernel keeps an f32 result;
``passes=1`` forms hi*hi alone, one TF32 pass. Shared by
tests/test_torch_roi_cnn_tc.py and tests/test_torch_roi_cnn_bwd_tc.py;
:func:`step_product` is the matrix-product mainloop's arithmetic, MMA by
MMA (the backward dots, nt and LP's product: tests/test_torch_bwd_dots_tc.py,
tests/test_torch_nt_lp_tc.py).
"""

import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_input, conv2d_weight

from silent_speech_tpu_torch.ops import cuda_cnn
from silent_speech_tpu_torch.ops.nn import conv2d_nhwc

# max |d| / max |ref| for each gradient tensor (tests/test_fused_train.py,
# chip_smoke.py BAR_K3)
BAR_K3 = 5e-5


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero: half a TF32 ulp added to the magnitude bits, the 13 low bits
    cleared (the sign bit is untouched)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)  # x - hi is exact in f32


def tc_product(a: torch.Tensor, b: torch.Tensor, fn, passes: int
               ) -> torch.Tensor:
    """fn(a, b), bilinear, formed as the tensor cores form it from f32
    ``a`` and ``b``: hi*hi + hi*lo + lo*hi (``passes=3``) or hi*hi, in
    float64."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    out = fn(ah.double(), bh.double())
    if passes == 3:
        out = out + fn(ah.double(), bl.double()) + fn(al.double(), bh.double())
    return out


def conv_tc(x: torch.Tensor, w: torch.Tensor, passes: int) -> torch.Tensor:
    """SAME conv of f32 x (N, H, W, Ci) by HWIO w as the tensor cores form
    it, then f32."""
    return tc_product(x, w, lambda a, b: conv2d_nhwc(a, {"w": b}),
                      passes).float()


def _oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW


def weight_grads_tc(roi_u8: torch.Tensor, p: dict, dE: torch.Tensor,
                    standardize: bool, passes: int) -> torch.Tensor:
    """The gradient of sum(out * dE) with respect to the kernels' flat
    weight buffer (float64, cuda_cnn.flat_weights' layout), as the backward
    kernel forms it: the forward with conv2 and conv3 as :func:`tc_product`
    (conv1, the pools, biases, ReLUs, mean and fc in f32); d conv3 = the
    ReLU mask x dfs, dfs = dfeat / 288 (f32), so, frame by frame, dW3 = dfs
    x :func:`tc_product` of p2 and the mask (exact in TF32) and the
    transposed conv3 the mask's :func:`tc_product` with dfs x W3 (f32); dW2
    and the transposed conv2 as :func:`tc_product`, d conv2 and d conv1
    routed to each 2x2 window's first max (torch's max_pool2d indices),
    d pool2 and d pool1 rounded to f32 where the kernel keeps them; dW1, the
    biases and the fc in float64 (the kernel's f32 FMA chains)."""
    f32, f64 = torch.float32, torch.float64
    w1, w2, w3 = (_oihw(p[k]["w"]) for k in ("conv0", "conv1", "conv2"))
    b1, b2, b3 = (p[k]["b"].view(1, -1, 1, 1) for k in
                  ("conv0", "conv1", "conv2"))
    x = cuda_cnn.preprocess_roi(roi_u8, standardize).unsqueeze(1)  # NCHW
    conv = lambda a, b: F.conv2d(a, b, padding=1)
    m1, i1 = F.max_pool2d(conv(x, w1), 2, return_indices=True)
    p1 = torch.relu(m1 + b1)
    c2 = tc_product(p1, w2, conv, passes).float()
    m2, i2 = F.max_pool2d(c2, 2, return_indices=True)
    p2 = torch.relu(m2 + b2)
    z3 = tc_product(p2, w3, conv, passes).float() + b3
    feat = torch.relu(z3).mean(dim=(2, 3))
    dfs = (dE @ p["fc"]["w"].t()) / 288.0  # (N, 24)
    mask = (z3 > 0).to(f32)
    dw3, g2 = 0, []
    for n in range(x.shape[0]):
        a, m, d = p2[n:n + 1], mask[n:n + 1], dfs[n].view(-1, 1, 1, 1)
        dw3 = dw3 + (tc_product(a, m, lambda a, g: conv2d_weight(
            a, w3.shape, g, padding=1), passes).float() * d).to(f64)
        g2.append(tc_product(m, d * w3, lambda g, w: conv2d_input(
            a.shape, w, g, padding=1), passes).float())
    g2 = torch.cat(g2) * (p2 > 0)
    d2 = F.max_unpool2d(g2, i2, 2, output_size=c2.shape[-2:])
    dw2 = tc_product(p1, d2, lambda a, g: conv2d_weight(
        a, w2.shape, g, padding=1), passes)
    g1 = tc_product(d2, w2, lambda g, w: conv2d_input(
        p1.shape, w, g, padding=1), passes).float() * (p1 > 0)
    d1 = F.max_unpool2d(g1, i1, 2, output_size=x.shape[-2:])
    dw1 = conv2d_weight(x.to(f64), w1.shape, d1.to(f64), padding=1)
    parts = [dw1, g1.to(f64).sum((0, 2, 3)), dw2, g2.to(f64).sum((0, 2, 3)),
             dw3, (mask.sum((2, 3)) * dfs).to(f64).sum(0),
             (dE.to(f64).t() @ feat.to(f64)), dE.to(f64).sum(0)]
    return torch.cat([t.reshape(-1) for t in parts])


def step_product(a, b, passes=3, chunk=32):
    """a (Mo, c) @ b (c, No) as one step of the kernel forms it: chunks of
    ``chunk`` contraction rows, each summed from zero in 8-deep slices, a slice
    adding lo*hi, hi*lo and hi*hi (or hi*hi alone), one rounding an MMA;
    the chunks' sums added in f32."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    pairs = ((al, bh), (ah, bl), (ah, bh)) if passes == 3 else ((ah, bh),)
    step = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for c0 in range(0, a.shape[1], chunk):
        d = torch.zeros_like(step)
        for k in range(c0, min(c0 + chunk, a.shape[1]), 8):
            for x, y in pairs:
                d = (d.double() + x[:, k:k + 8].double()
                     @ y[k:k + 8].double()).float()
        step = step + d
    return step
