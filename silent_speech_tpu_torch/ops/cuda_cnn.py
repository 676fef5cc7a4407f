"""Fused TinyROICNN: the CUDA kernels (csrc/roi_cnn.cu, the forward in f32
and its bf16 build; csrc/roi_cnn_bwd.cu, the weight gradients) and their
plain PyTorch versions (port of the JAX ops/pallas_cnn2.py ``roi_cnn_fused``,
``compute_dtype`` float32 and bfloat16, and ops/pallas_cnn2_grad.py
``roi_cnn_fused_train``).

Both compute, per frame, (48, 96) uint8 -> /255 -> optional per-frame
standardize (ddof=1, std >= 1e-6; the training-path normalization of
train_model_official.py:286-291) -> conv 1->8, ReLU, pool -> conv 8->16,
ReLU, pool -> conv 16->24, ReLU -> mean -> fc -> (emb,) f32.

``params`` is the TinyROICNN parameter dict in the JAX package's layout:
``{'conv0' | 'conv1' | 'conv2': {'w': HWIO, 'b'}, 'fc': {'w': (24, emb),
'b'}}`` (``TinyROICNN.params_tree()`` gives it as views of the module's
parameters). The kernels read the weights from one flat f32 buffer on the
device (:func:`flat_weights`). For inference build it once per set of
weights and pass it as ``flat``, as ``BiGRUClassifier.kernel_weights()``
does; in training :func:`roi_cnn_fused_train` builds it each step from the
parameters, differentiably, so that the backward kernel's flat gradient
reaches the module's parameters through autograd.

The bf16 mode (:func:`roi_cnn_bf16`, serving only) stores the activations
and the three convs' weights in bf16 and accumulates in f32, rounding where
the Pallas kernel rounds; :func:`roi_cnn_bf16_plain` lists the points.

The forward kernel (csrc/roi_cnn.cu) runs conv2 and conv3 on the tensor
cores (3xTF32 in f32, bf16 in the bf16 build) in persistent blocks, one
wave of them, each packing the flat weights into shared memory once and
walking frames; :func:`plan` reports the wave the kernel sizes itself to
on a card. The backward kernel (csrc/roi_cnn_bwd.cu) recomputes each
frame's forward through the forward's own stage code
(csrc/roi_cnn_stages.cuh), so its pool argmaxes and ReLU masks are those
of the forward that made the loss, and forms the GEMM-shaped gradient
products as 3xTF32 on the tensor cores, in persistent blocks of its own
wave (:func:`bwd_plan`) and a fixed summation order;
its check instantiation (:func:`roi_cnn_bwd_entry`; ops/cuda_cnn_check.py
holds the checks) also writes the means it recomputed and its route.

``roi_cnn_fused(..., debug_stop=...)`` runs the f32 kernel truncated after a
stage (:data:`DEBUG_STOPS`), the port of the Pallas kernel's perf-debug knob
``_DEBUG_STOP_AFTER`` (ops/pallas_cnn2.py:78), an explicit argument where
JAX sets a module global. The stops exist only in the kernel; each row of
the output holds three moments of what the stage computed
(:func:`stage_moments`), which :func:`roi_cnn_debug_plain` gives for a
check.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _kernels
from .nn import conv2d_nhwc, dense, max_pool_2x2

ROI_H, ROI_W = 48, 96  # the geometry the kernel is written for
CHANNELS = (8, 16, 24)
MAX_EMB = 64  # csrc/roi_cnn.cu MAX_EMB

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = _kernels.Kernel(
    "roi_cnn", "roi_cnn_forward",
    [_P, _P, _P,      # roi, flat, out
     _I, _I, _I,      # n, emb, standardize
     _P])             # stream
BF16_KERNEL = _kernels.Kernel(
    "roi_cnn_bf16", "roi_cnn_bf16_forward",
    [_P, _P, _P, _I, _I, _I, _P])  # as KERNEL
DEBUG_KERNEL = _kernels.Kernel(
    "roi_cnn_debug", "roi_cnn_debug_forward",
    [_P, _P, _P, _I, _I, _I,  # as KERNEL, then
     _I, _P])                 # stop, stream
# _DEBUG_STOP_AFTER's values (pallas_cnn2.py:427, :437, :503, :575, :632)
# and the kernel's STOP for each
DEBUG_STOPS = {"load": 1, "norm": 2, "conv1": 3, "conv2": 4, "conv3": 5}
POS_PERIOD = 31  # the index weight of stage_moments: i % 31
BWD_KERNEL = _kernels.Kernel(
    "roi_cnn_bwd", "roi_cnn_backward",
    [_P, _P, _P,      # roi, dE, flat
     _P, _P,          # partial sums, out
     _I, _I, _I, _I,  # n, emb, standardize, blocks
     _P])             # stream
# the backward kernel's check instantiation (ops/cuda_cnn_check.py)
BWD_CHECK_KERNEL = _kernels.Kernel(
    "roi_cnn_bwd_check", "roi_cnn_backward_check",
    [_P, _P, _P, _P, _P,  # as BWD_KERNEL, then
     _P, _P,              # feat (n, 24) f32, route (n, ROUTE_BYTES) uint8
     _I,                  # stop
     _I, _I, _I, _I, _P])
# its stops (csrc/roi_cnn_bwd.cu Stop): each frame ends after the
# recompute, after fc, dW3 and db3, after d p2 and db2, or after dW2
BWD_STOPS = {"forward": 1, "dw3": 2, "dp2": 3, "dw2": 4}


class Plan(NamedTuple):
    """A persistent kernel's launch on a card, as the kernel sizes it
    (``roi_cnn_plan`` in csrc/roi_cnn.cu, ``roi_cnn_bwd_plan`` in
    csrc/roi_cnn_bwd.cu): ``threads`` and ``smem`` bytes a block,
    ``blocks_per_sm`` resident at once
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), ``sms`` and the
    ``wave``: the grid of a launch of at least ``wave`` frames (a smaller
    launch takes one block a frame)."""

    threads: int
    smem: int
    blocks_per_sm: int
    sms: int
    wave: int


def _ask_plan(symbol: str, args: tuple, n_out: int, device) -> list:
    device = torch.device("cuda" if device is None else device)
    lib = _kernels.library()
    fn = getattr(lib, symbol)
    fn.argtypes = [_I] * len(args) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * n_out)()
    with torch.cuda.device(device):
        err = fn(*args, out)
    if err:
        raise RuntimeError(f"{symbol}{args}: CUDA error {err}: "
                           f"{lib.sst_cuda_error_string(err).decode()}")
    return list(out)


def plan(bf16: bool = False, device=None) -> Plan:
    """The forward kernel's launch (the f32 build, or the bf16 build) on a
    card, the current one by default, as the kernel sizes it (card only;
    ``roi_cnn_plan`` asks the card once per device and build)."""
    return Plan(*_ask_plan("roi_cnn_plan", (int(bool(bf16)),), 5, device))


def bwd_plan(device=None) -> Plan:
    """The backward kernel's launch on a card, the current one by default,
    as ``roi_cnn_bwd_plan`` in csrc/roi_cnn_bwd.cu sizes it (card only; it
    asks the card once per device)."""
    return Plan(*_ask_plan("roi_cnn_bwd_plan", (), 5, device))


def standardize_frames(r: torch.Tensor) -> torch.Tensor:
    """Per-frame mean/std standardization over the trailing (H, W) axes
    (torch-std ddof=1, std clamped at 1e-6)."""
    n = r.shape[-1] * r.shape[-2]
    mu = r.mean(dim=(-1, -2), keepdim=True)
    var = (r - mu).square().sum(dim=(-1, -2), keepdim=True) / (n - 1)
    std = torch.clamp(torch.sqrt(var), min=1e-6)
    return (r - mu) / std


def preprocess_roi(roi_u8: torch.Tensor, standardize: bool,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 (..., H, W) -> ``dtype`` /255, optionally per-frame standardized
    (``standardize=False`` is the live path, live_infer_official.py:126)."""
    r = roi_u8.to(dtype) / 255.0
    return standardize_frames(r) if standardize else r


def roi_cnn_plain(roi_u8: torch.Tensor, params: dict,
                  standardize: bool = False) -> torch.Tensor:
    """Plain PyTorch version: (N, H, W) uint8 -> (N, emb), in the
    parameters' dtype (f32; float64 gives a reference for the kernels'
    sums)."""
    x = preprocess_roi(roi_u8, standardize,
                       params["fc"]["w"].dtype).unsqueeze(-1)  # (N, H, W, 1)
    x = max_pool_2x2(torch.relu(conv2d_nhwc(x, params["conv0"])))
    x = max_pool_2x2(torch.relu(conv2d_nhwc(x, params["conv1"])))
    x = torch.relu(conv2d_nhwc(x, params["conv2"]))
    return dense(x.mean(dim=(1, 2)), params["fc"])


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (nearest even) and held in f32."""
    return t.to(torch.bfloat16).to(torch.float32)


def roi_cnn_bf16_plain(roi_u8: torch.Tensor, params: dict,
                       standardize: bool = False) -> torch.Tensor:
    """Plain version of the bf16 mode: (N, H, W) uint8 -> (N, emb) f32.

    bf16 values held in f32, every sum in f32 (a bf16 x bf16 product is
    exact in f32), rounded to bf16 where the Pallas kernel rounds
    (ops/pallas_cnn2.py:436, :492-501, :557, :573, :969-1036): the input
    x * (1/255) (standardized when asked) and the three convs' weights;
    conv1's pooled sum, then that plus bf16(b1), before the ReLU; conv2's
    pooled sum + b2 after the ReLU. conv3 + b3, ReLU, the mean and the fc
    stay f32."""
    f32 = torch.float32
    x = roi_u8.to(f32) * torch.tensor(1.0 / 255.0, dtype=f32)
    if standardize:
        x = standardize_frames(x)
    x = round_bf16(x).unsqueeze(-1)  # (N, H, W, 1)
    conv = lambda x, k: conv2d_nhwc(x, {"w": round_bf16(params[k]["w"])})
    y = round_bf16(max_pool_2x2(conv(x, "conv0")))
    y = torch.relu(round_bf16(y + round_bf16(params["conv0"]["b"])))
    y = max_pool_2x2(conv(y, "conv1"))
    y = round_bf16(torch.relu(y + params["conv1"]["b"]))
    y = torch.relu(conv(y, "conv2") + params["conv2"]["b"])
    return dense(y.mean(dim=(1, 2)), params["fc"])


def stage_moments(v: torch.Tensor, absolute: bool = False) -> torch.Tensor:
    """(rows, K) values, each row in the order of a kernel's buffer ->
    (rows, 3) f32: the sum, the sum of squares and the sum weighted by the
    index, (i % 31) v_i, summed in float64. The sum of a standardized image
    is about 0 whatever scale it has; the squares see the scale and the
    weights a misplaced value. ``absolute``: the same moments of |v|, the
    scale of a bar."""
    v = v.double()
    if absolute:
        v = v.abs()
    w = torch.arange(v.shape[1], device=v.device) % POS_PERIOD
    return torch.stack([v.sum(dim=1), v.square().sum(dim=1),
                        (v * w).sum(dim=1)], dim=1).to(torch.float32)


def _haloed(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, C * (H + 2) * (W + 2)): the zero-haloed CHW
    planes of the kernel's shared memory, flat."""
    return torch.nn.functional.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1)
                                   ).flatten(1)


def roi_cnn_debug_plain(roi_u8: torch.Tensor, params: dict,
                        standardize: bool, stop: str,
                        absolute: bool = False) -> torch.Tensor:
    """What the kernel's debug stop ``stop`` writes: (N, emb), entry j of a
    row the frame's :func:`stage_moments` j % 3 of the stage's values in
    the order of the kernel's buffer: the input / 255 (``load``, before any
    standardization; H x W), the haloed normalized image (``norm``), the
    haloed CHW pooled maps of conv1 and conv2 (``conv1``, ``conv2``), the
    CHW ReLU outputs of conv3 (``conv3``). The stages in the parameters'
    dtype; ``absolute`` as in :func:`stage_moments`."""
    if stop not in DEBUG_STOPS:
        raise ValueError(f"unknown debug_stop {stop!r}; the kernel takes "
                         f"{tuple(DEBUG_STOPS)}")
    dtype = params["fc"]["w"].dtype
    x = preprocess_roi(roi_u8, standardize and stop != "load", dtype)
    x = x.unsqueeze(-1)  # (N, H, W, 1)
    if stop not in ("load", "norm"):
        x = max_pool_2x2(torch.relu(conv2d_nhwc(x, params["conv0"])))
        if stop != "conv1":
            x = max_pool_2x2(torch.relu(conv2d_nhwc(x, params["conv1"])))
            if stop == "conv3":
                x = torch.relu(conv2d_nhwc(x, params["conv2"]))
    if stop == "load":
        flat = x.flatten(1)
    elif stop == "conv3":
        flat = x.permute(0, 3, 1, 2).flatten(1)
    else:
        flat = _haloed(x)
    m = stage_moments(flat, absolute)
    emb = params["fc"]["b"].shape[0]
    return m[:, torch.arange(emb, device=m.device) % 3].contiguous()


def roi_cnn_train_plain(roi_u8: torch.Tensor, params: dict,
                        standardize: bool = True) -> torch.Tensor:
    """Plain version of the training CNN: :func:`roi_cnn_plain`, which
    autograd differentiates with respect to the parameters only (the uint8
    frames are data)."""
    return roi_cnn_plain(roi_u8, params, standardize)


def n_weights(emb: int) -> int:
    """Length of the kernels' flat weight buffer for a given embedding."""
    return sum(9 * i * o + o for i, o in zip((1,) + CHANNELS[:-1],
                                             CHANNELS)) + 25 * emb


def flat_weights(params: dict) -> torch.Tensor:
    """The kernels' weight buffer: conv w (OIHW) and b for the three convs,
    then fc w (emb, 24) and b, as one contiguous f32 vector on the
    parameters' device. It is a ``torch.cat`` of views of ``params``, so
    autograd carries a gradient of the buffer back to them; build it under
    ``torch.no_grad()`` where none is wanted."""
    parts = []
    for key, c_in, c_out in zip(("conv0", "conv1", "conv2"),
                                (1,) + CHANNELS[:-1], CHANNELS):
        w, b = params[key]["w"], params[key]["b"]
        if tuple(w.shape) != (3, 3, c_in, c_out):
            raise ValueError(f"{key}: expected HWIO {(3, 3, c_in, c_out)}, "
                             f"got {tuple(w.shape)}")
        parts += [w.permute(3, 2, 0, 1).reshape(-1), b.reshape(-1)]
    fc_w = params["fc"]["w"]
    if fc_w.ndim != 2 or fc_w.shape[0] != CHANNELS[-1]:
        raise ValueError(f"fc: expected ({CHANNELS[-1]}, emb), got "
                         f"{tuple(fc_w.shape)}")
    parts += [fc_w.t().reshape(-1), params["fc"]["b"].reshape(-1)]
    return torch.cat(parts).to(torch.float32)


def flat_weights_bf16(params: dict) -> torch.Tensor:
    """The bf16 build's weight buffer: :func:`flat_weights` with the three
    convs' weights and conv1's bias rounded to bf16 (the values the Pallas
    kernel casts, ops/pallas_cnn2.py:477,1036-1037); b2, b3 and the fc
    stay f32."""
    flat = flat_weights(params)
    n1 = 9 * CHANNELS[0] + CHANNELS[0]          # conv1 w, b
    n2 = 9 * CHANNELS[0] * CHANNELS[1]          # conv2 w
    n3 = 9 * CHANNELS[1] * CHANNELS[2]          # conv3 w
    o2, o3 = n1, n1 + n2 + CHANNELS[1]
    for lo, hi in ((0, n1), (o2, o2 + n2), (o3, o3 + n3)):
        flat[lo:hi] = round_bf16(flat[lo:hi])
    return flat


def _check_frames(roi_u8: torch.Tensor) -> None:
    if roi_u8.dtype != torch.uint8 or roi_u8.ndim != 3:
        raise ValueError(f"roi_u8 must be (N, H, W) uint8, got "
                         f"{tuple(roi_u8.shape)} {roi_u8.dtype}")


def _check_kernel_inputs(roi_u8: torch.Tensor, flat: torch.Tensor,
                         emb: int) -> None:
    if tuple(roi_u8.shape[1:]) != (ROI_H, ROI_W):
        raise ValueError(f"the ROI CNN kernel takes {ROI_H}x{ROI_W} frames, "
                         f"got {tuple(roi_u8.shape[1:])}; use impl='plain'")
    if not roi_u8.is_contiguous() or roi_u8.data_ptr() % 16:
        raise ValueError("roi_u8 must be contiguous and 16-byte aligned")
    if not 1 <= emb <= MAX_EMB:
        raise ValueError(f"emb must be in [1, {MAX_EMB}], got {emb}")
    nw = n_weights(emb)
    if flat.device != roi_u8.device or flat.dtype != torch.float32 or \
            not flat.is_contiguous() or flat.numel() != nw:
        raise ValueError(f"flat must be {nw} contiguous f32 on "
                         f"{roi_u8.device} (flat_weights), got "
                         f"{flat.numel()} {flat.dtype} on {flat.device}")


def _forward_kernel(roi_u8: torch.Tensor, flat: torch.Tensor, emb: int,
                    standardize: bool, kernel: _kernels.Kernel = KERNEL
                    ) -> torch.Tensor:
    _check_kernel_inputs(roi_u8, flat, emb)
    N = roi_u8.shape[0]
    out = torch.empty((N, emb), dtype=torch.float32, device=roi_u8.device)
    if N:
        kernel.launch(_kernels.ptr(roi_u8), _kernels.ptr(flat),
                      _kernels.ptr(out), N, emb, int(standardize),
                      _kernels.stream_ptr(roi_u8.device))
    return out


def _check_params(roi_u8: torch.Tensor, params: dict) -> int:
    fc_b = params["fc"]["b"]
    if fc_b.dtype != torch.float32 or fc_b.device != roi_u8.device:
        raise ValueError(f"params must be f32 on {roi_u8.device}, got "
                         f"{fc_b.dtype} on {fc_b.device}")
    return fc_b.shape[0]


def _check_debug_stop(debug_stop: Optional[str]) -> None:
    if debug_stop is not None and debug_stop not in DEBUG_STOPS:
        raise ValueError(f"unknown debug_stop {debug_stop!r}; the kernel "
                         f"takes None or one of {tuple(DEBUG_STOPS)}")


def roi_cnn_fused(roi_u8: torch.Tensor, params: dict, *,
                  standardize: bool = False, impl: str = "auto",
                  flat: Optional[torch.Tensor] = None,
                  debug_stop: Optional[str] = None) -> torch.Tensor:
    """roi_u8: (N, 48, 96) uint8 -> embeddings (N, emb) f32 (inference: no
    gradient reaches ``params`` through the kernel).

    ``impl`` as in ``ops._kernels``: 'auto' launches the kernel for a CUDA
    tensor and runs :func:`roi_cnn_plain` for a CPU tensor. ``flat`` is
    :func:`flat_weights` of ``params``, built once by the caller; without
    it every launch builds it anew. ``debug_stop`` (:data:`DEBUG_STOPS`)
    runs the kernel truncated after that stage; it has no plain route and
    raises unless the kernel runs."""
    _check_frames(roi_u8)
    _check_debug_stop(debug_stop)
    if not _kernels.use_kernel(impl, roi_u8):
        if debug_stop is not None:
            raise ValueError(
                f"debug_stop={debug_stop!r} is a stop of the CUDA kernel: it "
                f"needs a CUDA tensor and impl 'auto' or 'kernel', got "
                f"impl={impl!r} on {roi_u8.device}")
        return roi_cnn_plain(roi_u8, params, standardize)
    emb = _check_params(roi_u8, params)
    if flat is None:
        with torch.no_grad():
            flat = flat_weights(params)
    if debug_stop is None:
        return _forward_kernel(roi_u8, flat, emb, standardize)
    _check_kernel_inputs(roi_u8, flat, emb)
    out = torch.empty((roi_u8.shape[0], emb), dtype=torch.float32,
                      device=roi_u8.device)
    if roi_u8.shape[0]:
        DEBUG_KERNEL.launch(_kernels.ptr(roi_u8), _kernels.ptr(flat),
                            _kernels.ptr(out), roi_u8.shape[0], emb,
                            int(standardize), DEBUG_STOPS[debug_stop],
                            _kernels.stream_ptr(roi_u8.device))
    return out


def roi_cnn_bf16(roi_u8: torch.Tensor, params: dict, *,
                 standardize: bool = False, impl: str = "auto",
                 flat: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The bf16 mode: roi_u8 (N, 48, 96) uint8 -> (N, emb) f32, through the
    bf16 build of the forward kernel ('auto' on a CUDA tensor, or
    'kernel') or :func:`roi_cnn_bf16_plain`. ``flat`` is
    :func:`flat_weights_bf16` of ``params``, built once by the caller."""
    _check_frames(roi_u8)
    if not _kernels.use_kernel(impl, roi_u8):
        return roi_cnn_bf16_plain(roi_u8, params, standardize)
    emb = _check_params(roi_u8, params)
    if flat is None:
        with torch.no_grad():
            flat = flat_weights_bf16(params)
    return _forward_kernel(roi_u8, flat, emb, standardize, BF16_KERNEL)


def _backward_kernel(roi_u8: torch.Tensor, dE: torch.Tensor,
                     flat: torch.Tensor, standardize: bool,
                     check: Optional[tuple] = None) -> torch.Tensor:
    """The backward kernel, or with ``check`` = (feat or None, route or
    None, stop) its check instantiation."""
    _check_frames(roi_u8)
    if not roi_u8.is_cuda:
        raise ValueError(f"the ROI CNN backward kernel needs a CUDA tensor, "
                         f"got one on {roi_u8.device}")
    N, emb = roi_u8.shape[0], dE.shape[-1]
    _check_kernel_inputs(roi_u8, flat, emb)
    if dE.shape != (N, emb) or dE.dtype != torch.float32 or \
            dE.device != roi_u8.device:
        raise ValueError(f"dE must be ({N}, {emb}) f32 on {roi_u8.device}, "
                         f"got {tuple(dE.shape)} {dE.dtype} on {dE.device}")
    dE = dE.contiguous()
    blocks = max(1, min(N, bwd_plan(roi_u8.device).wave))
    partial = torch.empty((blocks, flat.numel()), dtype=torch.float32,
                          device=roi_u8.device)
    out = torch.empty_like(flat)
    args = (_kernels.ptr(roi_u8), _kernels.ptr(dE), _kernels.ptr(flat),
            _kernels.ptr(partial), _kernels.ptr(out))
    tail = (N, emb, int(standardize), blocks,
            _kernels.stream_ptr(roi_u8.device))
    if check is None:
        BWD_KERNEL.launch(*args, *tail)
    else:
        feat, raw, stop = check
        BWD_CHECK_KERNEL.launch(*args, *(ctypes.c_void_p(0) if t is None
                                         else _kernels.ptr(t)
                                         for t in (feat, raw)), stop, *tail)
    return out


def roi_cnn_weight_grads(roi_u8: torch.Tensor, dE: torch.Tensor,
                         flat: torch.Tensor, *,
                         standardize: bool) -> torch.Tensor:
    """The backward kernel: the gradient of sum(out * dE) with respect to
    the flat weight buffer, where out is the forward of ``roi_u8`` with
    ``flat``. roi_u8: (N, 48, 96) uint8 on a CUDA device; dE: (N, emb) f32.
    Returns a vector shaped as ``flat``."""
    return _backward_kernel(roi_u8, dE, flat, standardize)


def roi_cnn_bwd_entry(roi_u8: torch.Tensor, dE: torch.Tensor,
                      flat: torch.Tensor, standardize: bool,
                      feat: Optional[torch.Tensor] = None,
                      route: Optional[torch.Tensor] = None,
                      stop: Optional[str] = None) -> torch.Tensor:
    """:func:`roi_cnn_weight_grads` through the backward kernel's check
    instantiation, which writes each frame's recomputed conv3 means to
    ``feat`` ((N, 24) f32) and its route to ``route`` ((N, ROUTE_BYTES)
    uint8, ops/cuda_cnn_check.py), each unless None, and with ``stop``
    (:data:`BWD_STOPS`) ends each frame there, to time the stages: it then
    returns the gradient entries of the stages done, bitwise those of
    :func:`roi_cnn_weight_grads`, and zeros elsewhere."""
    if stop is not None and stop not in BWD_STOPS:
        raise ValueError(f"unknown stop {stop!r}; the kernel takes "
                         f"{tuple(BWD_STOPS)}")
    return _backward_kernel(roi_u8, dE, flat, standardize,
                            (feat, route, BWD_STOPS.get(stop, 0)))


class _FusedTrain(torch.autograd.Function):
    """Forward: the forward kernel; backward: the weight-gradient kernel.
    The frames get no gradient."""

    @staticmethod
    def forward(ctx, roi_u8, flat, emb, standardize):
        ctx.standardize = standardize
        ctx.save_for_backward(roi_u8, flat)
        return _forward_kernel(roi_u8, flat, emb, standardize)

    @staticmethod
    def backward(ctx, dE):
        roi_u8, flat = ctx.saved_tensors
        dflat = None
        if ctx.needs_input_grad[1]:
            dflat = roi_cnn_weight_grads(roi_u8, dE.to(torch.float32), flat,
                                         standardize=ctx.standardize)
        return None, dflat, None, None


def roi_cnn_fused_train(roi_u8: torch.Tensor, params: dict, *,
                        standardize: bool = True, impl: str = "auto",
                        debug_stop: Optional[str] = None) -> torch.Tensor:
    """Differentiable fused TinyROICNN: (N, 48, 96) uint8 -> (N, emb) f32.

    On a CUDA tensor ('auto' or 'kernel') the forward is the forward kernel
    and the backward the weight-gradient kernel, on a flat weight buffer
    built from ``params`` by ``torch.cat`` (autograd maps its gradient back
    to the parameters); on a CPU tensor, or with 'plain', it is
    :func:`roi_cnn_train_plain`. Only the reference 48x96 ROI is taken.
    ``debug_stop`` is accepted only as None: the stops have no backward."""
    _check_frames(roi_u8)
    if debug_stop is not None:
        raise ValueError(f"debug_stop={debug_stop!r}: the forward kernel's "
                         "debug stops have no backward; the training CNN "
                         "takes only debug_stop=None")
    if tuple(roi_u8.shape[1:]) != (ROI_H, ROI_W):
        raise ValueError(
            f"the training ROI CNN takes only the reference {ROI_H}x{ROI_W} "
            f"ROI, got {tuple(roi_u8.shape[1:])}")
    if not _kernels.use_kernel(impl, roi_u8):
        return roi_cnn_train_plain(roi_u8, params, standardize)
    emb = _check_params(roi_u8, params)
    return _FusedTrain.apply(roi_u8, flat_weights(params), emb, standardize)
