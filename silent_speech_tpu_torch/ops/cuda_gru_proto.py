"""The GRU design probes' kernels (csrc/gru_proto.cu) and their plain
PyTorch versions: the port of the Pallas kernels of scripts/proto_gru2.py
(``gru_sequence_kstep``, ``gru_sequence_kstep_2w``) and scripts/proto_gru4.py
(``gru_layer_dual``).

The wrappers keep the JAX scripts' names and argument order. ``impl``
replaces ``interpret`` (see ``ops._kernels``). The knobs:

- ``batch_tile``: rows per thread block, a template parameter of the
  kernels: 1, 2, 4, 8 or 16 for the recurrence kernel, 1, 2, 4 or 8 for the
  dual-chain kernel. As on the TPU the tile is ``min(batch_tile, rows)``,
  rounded up to one of those. The TPU's tiles (128, 256, 512) raise.
- ``k_steps``: timesteps of input staged in shared memory at a time (any
  value >= 1 whose stage fits in a block's shared memory, with the bf16
  weights where the kernel keeps them there; see :func:`rec_smem_bytes`,
  :func:`dual_smem_bytes`).
- ``vmem_mb`` (dual): a Mosaic VMEM limit with no counterpart on the card
  (a launch sizes its shared memory itself); any value but the default
  raises.
- ``bf16_mm``: round the matmul operands to bf16 where the TPU kernels do
  (h and Wh; in the dual kernel also x and Wi); products are exact in f32
  and sums are f32.

In f32 the result does not depend on ``batch_tile`` or ``k_steps``: every
row's sums are taken in the same order whatever the tile.

The kernels have no backward; a launch on tensors that autograd would
differentiate raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _kernels
from .cuda_gru import MAX_HIDDEN

_P = ctypes.c_void_p
_I = ctypes.c_int
_REC_ARGS = [_P, _P, _P, _P, _P,          # xp, lengths, wh, bh, y
             _I, _I, _I, _I,              # rows_per_set, nsets, T, H
             _I, _I, _I, _P]              # batch_tile, k_steps, bf16, stream
# one launch function, two counts: one weight set (proto_gru2.py:100) and
# the two directions stacked along the batch (proto_gru2.py:229)
KSTEP = _kernels.Kernel("gru_kstep", "gru_rec_forward", _REC_ARGS)
KSTEP_2W = _kernels.Kernel("gru_kstep_2w", "gru_rec_forward", _REC_ARGS)
DUAL = _kernels.Kernel(
    "gru_dual", "gru_dual_forward",
    [_P, _P, _P,                          # x, x_flip, lengths
     _P, _P, _P, _P, _P, _P, _P, _P,      # fwd wi, bi, wh, bh; bwd the same
     _P, _P,                              # y_f, y_b
     _I, _I, _I, _I,                      # B, T, D, H
     _I, _I, _I, _P])                     # batch_tile, k_steps, bf16, stream

REC_TILES = (1, 2, 4, 8, 16)
DUAL_TILES = (1, 2, 4, 8)
# a block's shared memory (232,448 bytes on the H100) less room for the
# kernels' static arrays
SMEM_LIMIT = 232_448 - 128
DUAL_VMEM_MB = 64  # proto_gru4.py's default, the only value the port takes


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def rec_smem_bytes(H: int, tile: int, k_steps: int, bf16_mm: bool) -> int:
    """Shared memory of one recurrence block: Wh rounded to bf16 (bf16
    only), the carry (tile x H f32) and the stage (k_steps x tile x 3H
    f32)."""
    return ((_align16(6 * H * H) if bf16_mm else 0) + 4 * tile * H
            + 4 * k_steps * tile * 3 * H)


def dual_smem_bytes(D: int, H: int, tile: int, k_steps: int) -> int:
    """Shared memory of one dual-chain block: both chains' stages
    (k_steps x tile x D f32 each) and carries (tile x H f32 each)."""
    return 2 * 4 * (k_steps * tile * D + tile * H)


def _tile(batch_tile: int, rows: int, tiles: tuple) -> int:
    """The rows per block: ``min(batch_tile, rows)`` rounded up to a tile
    the kernel has. Raises on a tile it does not have."""
    if batch_tile not in tiles:
        raise ValueError(
            f"batch_tile={batch_tile!r}: the kernel runs {tiles} rows per "
            "thread block (the TPU's batch tiles do not carry over)")
    return next(t for t in tiles if t >= min(batch_tile, max(rows, 1)))


def _check_k_steps(k_steps: int) -> None:
    if not isinstance(k_steps, int) or k_steps < 1:
        raise ValueError(f"k_steps={k_steps!r}: timesteps staged at a time, "
                         "an int >= 1")


def _cast(a: torch.Tensor, bf16_mm: bool) -> torch.Tensor:
    """The TPU kernels' ``cast``: round to bf16 and back to f32."""
    return a.to(torch.bfloat16).float() if bf16_mm else a


def _check_launch(tensors, what: str) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"the {what} kernel has no backward: run it under "
            "torch.no_grad() / torch.inference_mode()")
    for t in tensors:
        if t.dtype != torch.float32 or not t.is_cuda:
            raise ValueError(f"{what}: every tensor must be f32 on the "
                             f"device, got {t.dtype} on {t.device}")


# ------------------------------------------------- recurrence (P2a, P2b)


def gru_recurrence_plain(xp: torch.Tensor, lengths: torch.Tensor,
                         wh: torch.Tensor, bh: torch.Tensor,
                         bf16_mm: bool = False) -> torch.Tensor:
    """The plain version: one direction's masked GRU recurrence over the
    projection ``xp = x Wi + bi``; h and Wh rounded to bf16 for the product
    under ``bf16_mm``. xp (B, T, 3H), lengths (B,), wh (H, 3H), bh (3H,).
    Returns y (B, T, H), zero at t >= length."""
    B, T, _ = xp.shape
    H = wh.shape[0]
    w = _cast(wh, bf16_mm)
    h = xp.new_zeros((B, H))
    L = lengths.to(xp.device)[:, None]
    ys = []
    for t in range(T):
        hp = _cast(h, bf16_mm) @ w + bh
        xr, xz, xn = xp[:, t].chunk(3, dim=-1)
        hr, hz, hn = hp.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        valid = L > t
        h = torch.where(valid, (1.0 - z) * n + z * h, h)
        ys.append(torch.where(valid, h, torch.zeros_like(h)))
    if not ys:
        return xp.new_zeros((B, 0, H))
    return torch.stack(ys, dim=1)


def _recurrence(kernel: _kernels.Kernel, xp: torch.Tensor,
                lengths: torch.Tensor, wh: torch.Tensor, bh: torch.Tensor,
                rows_per_set: int, batch_tile: int, k_steps: int,
                bf16_mm: bool, impl: str) -> torch.Tensor:
    """Rows [s * rows_per_set, (s + 1) * rows_per_set) of xp take weight
    set s of wh (S, H, 3H) and bh (S, 3H)."""
    S, H = wh.shape[0], wh.shape[1]
    B, T, H3 = xp.shape
    if wh.shape != (S, H, 3 * H) or bh.shape != (S, 3 * H) or H3 != 3 * H \
            or B != S * rows_per_set or lengths.shape != (B,):
        raise ValueError(
            f"shapes: xp {tuple(xp.shape)}, lengths {tuple(lengths.shape)}, "
            f"wh {tuple(wh.shape)}, bh {tuple(bh.shape)} for {S} weight "
            f"set(s) of {rows_per_set} rows")
    tile = _tile(batch_tile, rows_per_set, REC_TILES)
    _check_k_steps(k_steps)
    smem = rec_smem_bytes(H, tile, k_steps, bf16_mm)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"batch_tile={batch_tile} (tile {tile}), k_steps={k_steps}, "
            f"bf16_mm={bf16_mm} at H={H} needs {smem} bytes of shared "
            f"memory, over the block's {SMEM_LIMIT}: lower k_steps or "
            "batch_tile")
    if not _kernels.use_kernel(impl, xp):
        R = rows_per_set
        return torch.cat([gru_recurrence_plain(
            xp[s * R:(s + 1) * R], lengths[s * R:(s + 1) * R], wh[s], bh[s],
            bf16_mm) for s in range(S)])
    if not 1 <= H <= MAX_HIDDEN:
        raise ValueError(f"hidden size must be in [1, {MAX_HIDDEN}], got {H}")
    _check_launch((xp, wh, bh), "recurrence")
    if not xp.is_contiguous():
        raise ValueError("xp must be contiguous")
    wh, bh = wh.contiguous(), bh.contiguous()
    lens = lengths.to(device=xp.device, dtype=torch.int32).contiguous()
    y = torch.empty((B, T, H), dtype=torch.float32, device=xp.device)
    if B and T:
        kernel.launch(_kernels.ptr(xp), _kernels.ptr(lens), _kernels.ptr(wh),
                      _kernels.ptr(bh), _kernels.ptr(y), rows_per_set, S, T,
                      H, tile, k_steps, int(bf16_mm),
                      _kernels.stream_ptr(xp.device))
    return y


def gru_sequence_kstep(xp: torch.Tensor, lengths: torch.Tensor,
                       wh: torch.Tensor, bh: torch.Tensor, *,
                       batch_tile: int = 8, k_steps: int = 8,
                       bf16_mm: bool = False, impl: str = "auto"
                       ) -> torch.Tensor:
    """One GRU direction's recurrence over a precomputed projection
    (proto_gru2.py::gru_sequence_kstep).

    xp: (B, T, 3H) f32, ``x Wi + bi``; lengths: (B,); wh: (H, 3H); bh:
    (3H,). Returns y (B, T, H) f32, zero at t >= length. ``batch_tile``:
    rows per block (1, 2, 4, 8, 16); ``k_steps``: steps of xp staged in
    shared memory at a time; ``bf16_mm``: h and Wh rounded to bf16 for the
    product, Wh kept in shared memory for the whole sequence."""
    return _recurrence(KSTEP, xp, lengths, wh[None], bh[None], xp.shape[0],
                       batch_tile, k_steps, bf16_mm, impl)


def gru_sequence_kstep_2w(xp: torch.Tensor, lengths: torch.Tensor,
                          wh2: torch.Tensor, bh2: torch.Tensor, *,
                          batch_tile: int = 8, k_steps: int = 8,
                          bf16_mm: bool = False, impl: str = "auto"
                          ) -> torch.Tensor:
    """:func:`gru_sequence_kstep` over 2B' stacked rows: rows [0, B') take
    wh2[0], bh2[0] and rows [B', 2B') wh2[1], bh2[1]
    (proto_gru2.py::gru_sequence_kstep_2w). One launch; a block never
    straddles the two sets. xp: (2B', T, 3H); wh2: (2, H, 3H); bh2:
    (2, 3H)."""
    if xp.shape[0] % 2:
        raise ValueError(f"xp stacks two halves; got {xp.shape[0]} rows")
    return _recurrence(KSTEP_2W, xp, lengths, wh2, bh2, xp.shape[0] // 2,
                       batch_tile, k_steps, bf16_mm, impl)


# ------------------------------------------------------ dual chain (P4)


def gru_layer_dual_plain(x: torch.Tensor, x_flip: torch.Tensor,
                         lengths: torch.Tensor, pf: dict, pb: dict,
                         bf16_mm: bool = False
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the dual-chain kernel: each direction's
    projection ``cast(x) cast(Wi) + bi`` then its recurrence."""
    ys = []
    for xx, p in ((x, pf), (x_flip, pb)):
        xp = _cast(xx, bf16_mm) @ _cast(p["wi"], bf16_mm) + p["bi"]
        ys.append(gru_recurrence_plain(xp, lengths, p["wh"], p["bh"],
                                       bf16_mm))
    return ys[0], ys[1]


def gru_layer_dual(x: torch.Tensor, x_flip: torch.Tensor,
                   lengths: torch.Tensor, pf: dict, pb: dict, *,
                   batch_tile: int = 8, k_steps: int = 8,
                   bf16_mm: bool = False, vmem_mb: int = DUAL_VMEM_MB,
                   impl: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """Both directions of one GRU layer in one launch, the projections
    fused (proto_gru4.py::gru_layer_dual).

    x: (B, T, D) f32; x_flip: flip_padded(x, lengths); pf, pb: {'wi' (D, 3H),
    'bi' (3H,), 'wh' (H, 3H), 'bh' (3H,)}. Returns (y_fwd, y_bwd in the
    flipped order), each (B, T, H). ``batch_tile``: rows per block (1, 2,
    4, 8); ``k_steps``: steps of x and x_flip staged in shared memory at a
    time; ``bf16_mm``: x, Wi, h and Wh rounded to bf16 for the products."""
    if vmem_mb != DUAL_VMEM_MB:
        raise ValueError(
            f"vmem_mb={vmem_mb!r}: a Mosaic VMEM limit with no counterpart "
            "on the card (the launch sizes its shared memory itself); the "
            f"port takes only the default {DUAL_VMEM_MB}")
    B, T, D = x.shape
    H = pf["wh"].shape[0]
    want = {"wi": (D, 3 * H), "bi": (3 * H,), "wh": (H, 3 * H),
            "bh": (3 * H,)}
    if x_flip.shape != x.shape or lengths.shape != (B,) or any(
            tuple(p[k].shape) != s for p in (pf, pb) for k, s in want.items()):
        raise ValueError(f"shapes: x {tuple(x.shape)}, x_flip "
                         f"{tuple(x_flip.shape)}, lengths "
                         f"{tuple(lengths.shape)}, weights as {want}")
    tile = _tile(batch_tile, B, DUAL_TILES)
    _check_k_steps(k_steps)
    smem = dual_smem_bytes(D, H, tile, k_steps)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"batch_tile={batch_tile} (tile {tile}), k_steps={k_steps} at "
            f"D={D}, H={H} needs {smem} bytes of shared memory, over the "
            f"block's {SMEM_LIMIT}: lower k_steps or batch_tile")
    if not _kernels.use_kernel(impl, x):
        return gru_layer_dual_plain(x, x_flip, lengths, pf, pb, bf16_mm)
    if not 1 <= H <= MAX_HIDDEN:
        raise ValueError(f"hidden size must be in [1, {MAX_HIDDEN}], got {H}")
    ws = [p[k].contiguous() for p in (pf, pb)
          for k in ("wi", "bi", "wh", "bh")]
    _check_launch([x, x_flip] + ws, "dual-chain")
    if not (x.is_contiguous() and x_flip.is_contiguous()):
        raise ValueError("x and x_flip must be contiguous")
    lens = lengths.to(device=x.device, dtype=torch.int32).contiguous()
    y_f = torch.empty((B, T, H), dtype=torch.float32, device=x.device)
    y_b = torch.empty_like(y_f)
    if B and T:
        DUAL.launch(_kernels.ptr(x), _kernels.ptr(x_flip), _kernels.ptr(lens),
                    *map(_kernels.ptr, ws), _kernels.ptr(y_f),
                    _kernels.ptr(y_b), B, T, D, H, tile, k_steps,
                    int(bf16_mm), _kernels.stream_ptr(x.device))
    return y_f, y_b
