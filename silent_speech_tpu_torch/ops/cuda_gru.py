"""GRU sequence: the CUDA kernel (csrc/gru_seq.cu) and its plain PyTorch
version (port of the JAX ops/pallas_gru.py).

``gru_sequence`` / ``gru_layer`` / ``bigru_kernel`` keep the signatures of
``gru_sequence_pallas`` / ``gru_layer_pallas`` / ``bigru_pallas`` without
the TPU tiling knobs, plus ``impl`` (see ``ops._kernels``). The plain
version is the masked scan of ``ops/gru.py``. The kernel runs the reverse
direction in-kernel (no flip_padded gathers) and both directions of a
bidirectional layer in one launch.
"""

from __future__ import annotations

import ctypes

import torch

from . import _kernels
from . import gru as gru_ops

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = _kernels.Kernel(
    "gru_seq", "gru_seq_forward",
    [_P, _P,                       # x, lengths
     _P, _P, _P, _P, _I,           # direction 0: wi, bi, wh, bh, reverse
     _P, _P, _P, _P, _I,           # direction 1
     _I, _P,                       # ndir, y
     _I, _I, _I, _I, _I,           # B, T, D, H, ldy
     _P])                          # stream
MAX_HIDDEN = 1024  # one thread per hidden unit


def _launch(x: torch.Tensor, lengths: torch.Tensor,
            dirs: list[tuple[dict, bool]], y: torch.Tensor) -> None:
    """Launch the kernel for 1 or 2 directions writing the column blocks of
    y (B, T, len(dirs) * H)."""
    B, T, D = x.shape
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous f32, got {x.dtype}"
                         f"{'' if x.is_contiguous() else ' (strided)'}")
    if lengths.shape != (B,):
        raise ValueError(f"lengths must be ({B},), got {tuple(lengths.shape)}")
    H = dirs[0][0]["wh"].shape[0]
    if not 1 <= H <= MAX_HIDDEN:
        raise ValueError(f"hidden size must be in [1, {MAX_HIDDEN}], got {H}")
    lens = lengths.to(device=x.device, dtype=torch.int32).contiguous()
    args = []
    keep = [lens]  # every buffer stays referenced until the launch returns
    for p, reverse in dirs:
        ws = []
        for key, shape in (("wi", (D, 3 * H)), ("bi", (3 * H,)),
                           ("wh", (H, 3 * H)), ("bh", (3 * H,))):
            w = p[key]
            if tuple(w.shape) != shape or w.dtype != torch.float32 \
                    or w.device != x.device:
                raise ValueError(f"{key}: expected f32 {shape} on {x.device},"
                                 f" got {w.dtype} {tuple(w.shape)} on "
                                 f"{w.device}")
            ws.append(w.contiguous())
        keep += ws
        args += [_kernels.ptr(w) for w in ws] + [int(reverse)]
    if len(dirs) == 1:  # the second direction's arguments go unread
        args += args
    KERNEL.launch(_kernels.ptr(x), _kernels.ptr(lens), *args, len(dirs),
                  _kernels.ptr(y), B, T, D, H, y.shape[-1],
                  _kernels.stream_ptr(x.device))


def gru_sequence(x: torch.Tensor, lengths: torch.Tensor, wi: torch.Tensor,
                 bi: torch.Tensor, wh: torch.Tensor, bh: torch.Tensor, *,
                 reverse: bool = False, impl: str = "auto") -> torch.Tensor:
    """One GRU direction over a padded batch.

    x: (B, T, D) f32; lengths: (B,); wi: (D, 3H); bi: (3H,); wh: (H, 3H);
    bh: (3H,). Returns y (B, T, H), zero at t >= length."""
    p = {"wi": wi, "bi": bi, "wh": wh, "bh": bh}
    if not _kernels.use_kernel(impl, x):
        return gru_ops.gru_layer_single_direction(x, lengths, p,
                                                  reverse=reverse)[0]
    B, T, _ = x.shape
    y = torch.empty((B, T, wh.shape[0]), dtype=torch.float32, device=x.device)
    if B and T:
        _launch(x, lengths, [(p, reverse)], y)
    return y


def gru_layer(x: torch.Tensor, lengths: torch.Tensor, params: dict, *,
              reverse: bool = False, impl: str = "auto") -> torch.Tensor:
    """Drop-in for ops.gru.gru_layer_single_direction (outputs only)."""
    return gru_sequence(x, lengths, params["wi"], params["bi"], params["wh"],
                        params["bh"], reverse=reverse, impl=impl)


def bigru_kernel(x: torch.Tensor, lengths: torch.Tensor, layers: list[dict],
                 *, bidirectional: bool = True, impl: str = "auto"
                 ) -> torch.Tensor:
    """Stacked (bi)GRU (inference). One launch per layer, both directions
    writing the two halves of the (B, T, 2H) layer output."""
    if not _kernels.use_kernel(impl, x):
        return gru_ops.bigru(x, lengths, layers,
                             bidirectional=bidirectional)[0]
    out = x
    for lp in layers:
        dirs = [(lp["fwd"], False)]
        if bidirectional:
            dirs.append((lp["bwd"], True))
        B, T, _ = out.shape
        H = lp["fwd"]["wh"].shape[0]
        y = torch.empty((B, T, len(dirs) * H), dtype=torch.float32,
                        device=x.device)
        if B and T:
            _launch(out, lengths, dirs, y)
        out = y
    return out
