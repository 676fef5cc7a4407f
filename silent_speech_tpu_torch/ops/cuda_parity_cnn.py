"""The parity-packed conv1 + pool1 kernel of the CNN-front prototypes
(csrc/roi_parity.cu) and its plain PyTorch version: the port of the Pallas
kernels of scripts/proto_parity_cnn.py (``conv1pool1_parity``),
scripts/proto_parity_e2e.py (``conv1pool1``, ``roi_cnn_parity``) and
scripts/proto_ablate.py (``run``), which share one kernel body.

The function (for any packed or unpacked WE, WO and bias, as the TPU kernel
computes it): the frame's 48x96 uint8 image comes as four row classes
``x_c`` (rows h = 4k + c), is widened to f32 without scaling (the packing
folds /255 in), and for each output row k, class c and 32-wide tile j the
104-long patch (three dy rows of the 34 haloed input columns [32j - 1,
32j + 32], two zero lanes) is multiplied by WE and by WO (104, 128); the
output is ``relu(max over the class pair of max(patch WE, patch WO) +
bias)``, classes (0, 1) giving pooled row m = 2k and (2, 3) m = 2k + 1, in
lanes (q, co), q = 16j + t the pooled column. With the packing of
:func:`pack_parity_conv1` that is conv 1->8 (3x3 SAME) of x / 255, + b,
ReLU and 2x2 max pool (:func:`ref_conv1pool1`).

The wrappers keep the JAX names and argument order; ``impl`` replaces
``interpret`` (see ``ops._kernels``). The JAX grid is ``N // 16`` frames a
step, so frames past the last multiple of 16 are never written there; the
port raises when N % 16 != 0 instead.

On the card the products run on the tensor cores (csrc/roi_parity.cu:
wgmma TF32, the patch exact in TF32 and W split into hi + lo, two passes,
each 32-deep chunk from zero and the chunks added in f32); the plain
version forms them as f32 matrix products (:func:`parity_patches` @ W,
then :func:`pool_halves`).

proto_ablate's stages are the kernel's STOP template parameter. The JAX
modes map onto the points of the CUDA design that answer the same
question (:data:`ABLATION_MODES`); the three that ask about the TPU's lane
alignment or its patch buffer, which the card's design does not have, raise
(:data:`NO_COUNTERPART`). The stops write values of no meaning (the JAX
script's "wrong results OK"); ``full`` is the split kernel itself.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _kernels
from .nn import conv2d_nhwc, max_pool_2x2

F_STEP, HQ, W1, KP = 16, 12, 96, 104  # the JAX scripts' F, HQ, W1, KP
HALF = 384  # lanes of one m-parity half: 48 pooled w x 8 channels

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P,      # x0..x3
         _P, _P, _P,          # we, wo, bias
         _P, _P,              # out0, out1
         _I, _I, _I, _I,      # n, layout, stop, grid
         _P]                  # stream
# one launch function, three counts: the split outputs (proto_parity_cnn),
# the one-array output (proto_parity_e2e) and the ablation (proto_ablate)
PARITY = _kernels.Kernel("conv1pool1_parity", "roi_parity_forward", _ARGS)
PARITY_ONE = _kernels.Kernel("conv1pool1", "roi_parity_forward", _ARGS)
ABLATE = _kernels.Kernel("parity_ablate", "roi_parity_forward", _ARGS)
# the kernel's controls, split layout, card only: one tensor-core sum over
# all K in place of 32-deep chunks added in f32; W_hi's pass alone (one
# TF32 pass: another function)
CONTROL = _kernels.Kernel("parity_control", "roi_parity_forward", _ARGS)
CONTROLS = {"one_sum": 5, "one_pass": 6}
_SPLIT, _ONE = 0, 1

# JAX mode -> the kernel's stop, in ladder order: block I/O (the frames'
# bytes copied into the zero-haloed shared-memory image, every output
# stored once), + the u8 -> f32 widen (each warp's patch fragments formed
# from that image: the implicit im2col), + the weights' hi / lo planes made
# in shared memory (the image's halo is io_only's already), + the chunk
# loop and the epilogue with fragment values in place of the products
# (what the products cost is full - no_dot), + the products
ABLATION_MODES = {"io_only": 0, "widen_only": 1, "halo_only": 2,
                  "no_dot": 3, "full": 4}
NO_COUNTERPART = {
    "halo_aligned": "the TPU mode moves the halo's 96 lanes from [1:97] to "
                    "the 128-lane-aligned [0:96]; the card's image rows "
                    "hold their 96 bytes 4-byte aligned by construction",
    "no_patch": "the TPU mode skips the copy of the (M, 104) patch buffer; "
                "the card's kernel has no patch buffer: each warp forms "
                "its patch fragments from the haloed image directly "
                "(their cost is widen_only - io_only)",
    "patch_aligned": "the TPU mode copies 32-lane (aligned) dy slices into "
                     "the patch instead of 34-lane ones; the card's kernel "
                     "copies no patch",
}
# JAX proto_ablate.py's order of the modes
JAX_MODES = ("io_only", "widen_only", "halo_aligned", "halo_only",
             "no_patch", "no_dot", "patch_aligned", "full")


# ------------------------------------------------------------ packing


def pack_parity_conv1(k, b, scale: float = 1.0 / 255.0):
    """k: (3, 3, 1, 8) HWIO, b: (8,) (numpy or CPU tensors) -> (WE, WO,
    bias) f32 tensors, (104, 128), (104, 128), (1, 384): the packing of
    proto_parity_cnn.py:44 and proto_parity_e2e.py:30, bitwise.

    Patch lane dy*34 + (w - 32j) + dx for the window [32j - 1, 32j + 32];
    column t*8 + co is conv output w = 32j + 2t (WE) or 2t + 1 (WO). /255
    is folded in (conv is linear)."""
    k = np.asarray(k, np.float32) * scale
    b = np.asarray(b, np.float32)
    WE = np.zeros((KP, 128), np.float32)
    WO = np.zeros((KP, 128), np.float32)
    for t in range(16):
        for co in range(8):
            col = t * 8 + co
            for dy in range(3):
                for dx in range(3):
                    WE[dy * 34 + 2 * t + dx, col] = k[dy, dx, 0, co]
                    WO[dy * 34 + 2 * t + 1 + dx, col] = k[dy, dx, 0, co]
    bias = np.tile(b, 48)[None, :]  # (1, 384): per (q, co) lane
    return torch.from_numpy(WE), torch.from_numpy(WO), torch.from_numpy(bias)


# ------------------------------------------------------- plain versions


def split_classes(roi_u8: torch.Tensor) -> list[torch.Tensor]:
    """(N, 48, 96) uint8 -> the four row classes ``roi[:, c::4]``, each
    (N, 12, 96), contiguous."""
    return [roi_u8[:, c::4].contiguous() for c in range(4)]


def parity_patches(xs) -> torch.Tensor:
    """The four class arrays (each N*12 rows of 96 uint8, any leading
    shape) -> the 104-long patches (N, 48, 3, 104) f32, image row h, tile
    j: the frame's values widened without scaling, zeros outside it and in
    lanes 102 and 103."""
    x = torch.stack([t.reshape(-1, HQ, W1) for t in xs], dim=2)
    N = x.shape[0]
    img = x.reshape(N, 4 * HQ, W1).to(torch.float32)
    xp = torch.nn.functional.pad(img, (1, 1, 1, 1))  # (N, 50, 98)
    rows = torch.stack([xp[:, dy:dy + 4 * HQ] for dy in range(3)], dim=2)
    tiles = torch.stack([rows[..., 32 * j:32 * j + 34] for j in range(3)],
                        dim=2)                       # (N, 48, j, dy, 34)
    return torch.nn.functional.pad(tiles.reshape(N, 4 * HQ, 3, 102),
                                   (0, KP - 102))    # (N, 48, 3, 104)


def pool_halves(ye: torch.Tensor, yo: torch.Tensor, bias: torch.Tensor
                ) -> tuple[torch.Tensor, ...]:
    """The patches' products with WE and WO, (N, 48, 3, 128) each ->
    the m-even and m-odd halves (N*12, 384): the max over WE / WO, then
    over the class pair, + bias, ReLU."""
    N = ye.shape[0]
    m = torch.maximum(ye, yo).reshape(N, HQ, 4, 3, 128)
    b = bias.reshape(1, 1, 3, 128)
    return tuple(torch.relu(torch.maximum(m[:, :, ca], m[:, :, cb]) + b)
                 .reshape(N * HQ, HALF) for ca, cb in ((0, 1), (2, 3)))


def parity_halves_plain(xs, WE: torch.Tensor, WO: torch.Tensor,
                        bias: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The plain version: the four class arrays (each N*12 rows of 96
    uint8, any leading shape) -> the m-even and m-odd halves, each
    (N*12, 384) f32, through the 104-long patches and WE, WO as the TPU
    kernel computes them."""
    patch = parity_patches(xs)
    return pool_halves(patch @ WE, patch @ WO, bias)


def pooled1_from_quadrants(qs, N: int) -> torch.Tensor:
    """2x (N*12, 384) m-parity halves -> (N, 24, 48, 8) by stack + reshape
    (proto_parity_cnn.py:160)."""
    me, mo = (q.reshape(N, HQ, 48, 8) for q in qs)
    return torch.stack([me, mo], dim=2).reshape(N, 24, 48, 8)


def ref_conv1pool1(roi_u8: torch.Tensor, k: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """Plain conv1 + pool1: conv 3x3 SAME of roi / 255 with k (HWIO) + b,
    ReLU, 2x2 max pool. (N, 48, 96) uint8 -> (N, 24, 48, 8) f32
    (proto_parity_cnn.py:170)."""
    x = roi_u8.to(torch.float32)[..., None] / 255.0
    return max_pool_2x2(torch.relu(conv2d_nhwc(x, {"w": k, "b": b})))


# ------------------------------------------------------------- kernels


def _check_inputs(xs, WE, WO, bias) -> int:
    """Raises on what the kernel does not take; returns N."""
    M = xs[0].shape[0] * (HQ if xs[0].ndim == 3 else 1)
    for t in xs:
        if t.dtype != torch.uint8 or t.numel() != M * W1 or \
                t.shape[-1] != W1 or t.device != xs[0].device:
            raise ValueError(f"x0..x3 must be {M} rows of {W1} uint8 on one "
                             f"device, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
    if M % HQ:
        raise ValueError(f"{M} class rows are not whole frames of {HQ}")
    N = M // HQ
    if N % F_STEP:
        raise ValueError(
            f"N={N} frames: the TPU kernel runs N // {F_STEP} steps of "
            f"{F_STEP} frames and leaves the last N % {F_STEP} unwritten; "
            f"the port takes N a multiple of {F_STEP}")
    for name, t, shape in (("WE", WE, (KP, 128)), ("WO", WO, (KP, 128)),
                           ("bias", bias, (1, HALF))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {shape} f32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    return N


def _launch(kernel: _kernels.Kernel, xs, WE, WO, bias, layout: int,
            stop: int) -> list[torch.Tensor]:
    dev = xs[0].device
    for t in (WE, WO, bias):
        if t.device != dev:
            raise ValueError(f"WE, WO and bias must be on {dev}, got {t.device}")
    xs = [t.contiguous() for t in xs]
    if any(t.data_ptr() % 16 for t in xs):
        raise ValueError("x0..x3 must be 16-byte aligned")
    WE, WO, bias = WE.contiguous(), WO.contiguous(), bias.contiguous()
    M = xs[0].numel() // W1
    if layout == _ONE:
        outs = [torch.empty((M, 2 * HALF), dtype=torch.float32, device=dev)]
    else:
        outs = [torch.empty((M, HALF), dtype=torch.float32, device=dev)
                for _ in range(2)]
    if M:
        grid = torch.cuda.get_device_properties(dev).multi_processor_count
        kernel.launch(*map(_kernels.ptr, xs), _kernels.ptr(WE),
                      _kernels.ptr(WO), _kernels.ptr(bias),
                      _kernels.ptr(outs[0]), _kernels.ptr(outs[-1]),
                      M // HQ, layout, stop, grid, _kernels.stream_ptr(dev))
    return outs


def conv1pool1_parity(x0, x1, x2, x3, WE, WO, bias, *, impl: str = "auto"):
    """x{c}: (N, 12, 96) uint8, rows h = 4k + c. Returns the two m-parity
    halves [(N*12, 384), (N*12, 384)] f32, lanes (q, co)
    (proto_parity_cnn.py:132)."""
    xs = (x0, x1, x2, x3)
    _check_inputs(xs, WE, WO, bias)
    if not _kernels.use_kernel(impl, x0):
        return list(parity_halves_plain(xs, WE, WO, bias))
    return _launch(PARITY, xs, WE, WO, bias, _SPLIT, ABLATION_MODES["full"])


def conv1pool1(x0, x1, x2, x3, WE, WO, bias, *, impl: str = "auto",
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x{c}: (N*12, 96) uint8. Returns pooled1 (N, 24, 48, 8) in
    ``out_dtype``: the kernel's one (N*12, 768) f32 array (m-even lanes
    [0, 384), m-odd [384, 768) of row n*12 + k), reshaped for free, then
    cast as the JAX function casts after its kernel
    (proto_parity_e2e.py:84)."""
    xs = (x0, x1, x2, x3)
    N = _check_inputs(xs, WE, WO, bias)
    if not _kernels.use_kernel(impl, x0):
        out = torch.cat(parity_halves_plain(xs, WE, WO, bias), dim=1)
    else:
        out = _launch(PARITY_ONE, xs, WE, WO, bias, _ONE,
                      ABLATION_MODES["full"])[0]
    return out.to(out_dtype).reshape(N, 24, 48, 8)


def run(x0, x1, x2, x3, WE, WO, bias, mode: str = "full", *,
        impl: str = "auto"):
    """proto_ablate.py's ``run``: the split kernel truncated after the
    stage ``mode`` (:data:`ABLATION_MODES`). x{c}: (N*12, 96) uint8.
    Returns [out_even, out_odd], (N*12, 384) f32; ``full`` is
    :func:`conv1pool1_parity`'s kernel. The stops exist only in the kernel:
    on a CPU tensor (or with ``impl='plain'``) only ``full`` runs, as the
    plain version."""
    if mode in NO_COUNTERPART:
        raise ValueError(f"mode {mode!r} has no counterpart on the card: "
                         f"{NO_COUNTERPART[mode]}")
    if mode not in ABLATION_MODES:
        raise ValueError(f"unknown mode {mode!r}; the port takes "
                         f"{tuple(ABLATION_MODES)}")
    xs = (x0, x1, x2, x3)
    _check_inputs(xs, WE, WO, bias)
    if not _kernels.use_kernel(impl, x0):
        if mode != "full":
            raise ValueError(f"mode {mode!r} is a stop of the CUDA kernel "
                             "and has no plain version; run it on a CUDA "
                             "tensor")
        return list(parity_halves_plain(xs, WE, WO, bias))
    return _launch(ABLATE, xs, WE, WO, bias, _SPLIT, ABLATION_MODES[mode])


def control(x0, x1, x2, x3, WE, WO, bias, which: str):
    """The split kernel with its products formed as :data:`CONTROLS`
    ``which`` says, on CUDA tensors only. Returns [out_even, out_odd]."""
    if which not in CONTROLS:
        raise ValueError(f"unknown control {which!r}: {tuple(CONTROLS)}")
    xs = (x0, x1, x2, x3)
    _check_inputs(xs, WE, WO, bias)
    _kernels.use_kernel("kernel", x0)
    return _launch(CONTROL, xs, WE, WO, bias, _SPLIT, CONTROLS[which])


# ------------------------------------------------------ the whole CNN


def roi_cnn_parity(cnn: dict, roi_u8: torch.Tensor, WE, WO, bias, *,
                   group: int = 16, impl: str = "auto",
                   compute_dtype: torch.dtype = torch.float32
                   ) -> torch.Tensor:
    """Full TinyROICNN, live normalization (/255): the parity front, then
    the plain back half in ``compute_dtype`` (conv 8->16 + ReLU + pool,
    conv 16->24 + ReLU), the mean and the fc in f32
    (proto_parity_e2e.py:104). ``cnn``: the TinyROICNN parameters in the
    JAX layout (``TinyROICNN.params_tree()``); (N, 48, 96) uint8 ->
    (N, emb) f32.

    ``group`` keeps the JAX function's divisibility check (N % group == 0)
    and has no other effect: the JAX back half's grouped convolutions are
    bitwise the per-frame ones (ops/grouped_cnn.py:1-21)."""
    n = roi_u8.shape[0]
    if group < 1 or n % group:
        raise ValueError(f"group={group} must divide N={n}")
    parts = [roi_u8[:, c::4].reshape(n * HQ, W1) for c in range(4)]
    pooled1 = conv1pool1(*parts, WE, WO, bias, impl=impl,
                         out_dtype=compute_dtype)
    cd = compute_dtype
    conv = lambda h, key: torch.relu(conv2d_nhwc(h, {
        "w": cnn[key]["w"].to(cd), "b": cnn[key]["b"].to(cd)}))
    h = max_pool_2x2(conv(pooled1, "conv1"))
    h = conv(h, "conv2")
    feat = h.to(torch.float32).mean(dim=(1, 2))
    return feat @ cnn["fc"]["w"].to(torch.float32) + \
        cnn["fc"]["b"].to(torch.float32)
