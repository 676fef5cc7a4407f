"""The GRU design probes' kernels (csrc/gru_proto.cu) and their plain
PyTorch versions: the port of the Pallas kernels of scripts/proto_gru2.py
(``gru_sequence_kstep``, ``gru_sequence_kstep_2w``) and scripts/proto_gru4.py
(``gru_layer_dual``).

Both run on K2's cluster recurrence (csrc/gru_cluster.cuh): a thread-block
cluster of C blocks a (weight set or chain, tile of rows), each block's
slice of Wh in shared memory for all steps, read from the caller's (H, 3H)
at every launch, h exchanged through distributed shared memory. The dual
kernel's blocks also hold their units' columns of Wi and project each chunk
of ``k_steps`` steps on the tensor cores (3xTF32; one exact pass on bf16
values under ``bf16_mm``) before its steps.

The wrappers keep the JAX scripts' names and argument order. ``impl``
replaces ``interpret`` (see ``ops._kernels``). The knobs:

- ``batch_tile``: rows a cluster, one of :data:`TILES` (1, 2 and 4 n up to
  64); ``None`` (the default) takes the kernel's plan: of the tiles that
  fit, the smallest whose clusters take the fewest waves on the card
  (:func:`rec_plan`, :func:`dual_plan`; mirrored on the CPU by
  :func:`choose_tile`). As on the TPU a given tile is
  ``min(batch_tile, rows)``, rounded up to one of :data:`TILES`. The TPU's
  tiles (128, 256, 512) raise.
- ``k_steps``: steps a chunk. The dual kernel projects ``min(k_steps, T)``
  steps of x at a time, before the chunk's steps; ``None`` (its default)
  takes the plan's chunk (:func:`choose_chunk`). The
  recurrence loads xp one step ahead and has no chunk, so there
  ``k_steps`` is checked (an int >= 1) and has no other effect.
- ``vmem_mb`` (dual): a Mosaic VMEM limit with no counterpart on the card
  (a launch sizes its shared memory itself); any value but the default
  raises.
- ``bf16_mm``: round the matmul operands to bf16 where the TPU kernels do
  (h and Wh; in the dual kernel also x and Wi); products are exact in f32
  and sums are f32. The recurrence's blocks then hold Wh as bf16, half
  the f32 slice, so its plan takes smaller clusters (2 at H=192); the dual
  kernel's hold the rounded weights as f32.

A launch whose block does not fit the H100's shared memory raises
(:func:`rec_geometry`, :func:`dual_geometry`). In f32 the result does not
depend on ``batch_tile`` or ``k_steps``: every row's sums are taken in the
same order whatever the tile and the chunk.

The kernels have no backward; a launch on tensors that autograd would
differentiate raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Union

import torch

from . import _kernels
from .cuda_gru import MAX_HIDDEN

_P = ctypes.c_void_p
_I = ctypes.c_int
_REC_ARGS = [_P, _P, _P, _P, _P,          # xp, lengths, wh, bh, y
             _I, _I, _I, _I,              # rows_per_set, nsets, T, H
             _I, _I, _P]                  # batch_tile, bf16, stream
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

# the timing stop (gru_dual_stop): the dual kernel with its chunks'
# projections (bit 0) or its recurrent products (bit 1) left out
DUAL_STOP = _kernels.Kernel("gru_dual_stop", "gru_dual_stop",
                            DUAL.argtypes[:-1] + [_I, _P])
STOPS = {"all": 0, "no_projection": 1, "no_product": 2, "neither": 3}

# rows a cluster the kernels take (csrc/gru_proto.cu tile_ok): K2's tiles
# up to 64
TILES = (1, 2) + tuple(range(4, 65, 4))
SMEM_LIMIT = 232_448  # a block's dynamic shared memory on the H100
DUAL_VMEM_MB = 64  # proto_gru4.py's default, the only value the port takes

# csrc/gru_cluster.cuh's layout, which the geometry below mirrors: KS lanes
# share a unit in the split body (tiles 1, 2), units padded to UW a warp,
# H to KQ; the tiled body (tiles 4 n) TR rows a thread, TV units, at most
# _tile_threads(TV) threads; the dual kernel's Wi slice [Dp][WLD] (Dp = D
# up to PK) and chunk of xp [K BT][3 Up], at least KS Up threads; its
# plan's chunks CHUNKS
KS, UW, KQ, TR, MAX_THREADS = 4, 8, 16, 4, 512
PK, CHUNKS = 32, (8, 4, 2)
SLICE_TARGET = 128 << 10  # C: the smallest cluster whose slices fit this


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _tile_threads(tv: int) -> int:
    return 256 if tv == 4 else 512


def _tile_block(nrg: int, nug: int) -> int:
    wr = 4 if nrg >= 4 else 2 if nrg >= 2 else 1
    return 32 * _ceil(nrg, wr) * _ceil(nug, 32 // wr)


def _tile_units(bt: int, up: int) -> int:
    for tv in (1, 2, 4):
        if _tile_block(bt // TR, up // tv) <= _tile_threads(tv):
            return tv
    return 0


def cluster_of(H: int, D: Optional[int] = None,
               bf16_mm: bool = False) -> int:
    """C, the blocks a cluster: the smallest of 1, 2, 4, 8 whose Wh slice
    (bf16 in the recurrence under ``bf16_mm``, else f32; and the dual
    kernel's Wi slice, D x 3 Up f32, when ``D`` is given) is at most
    SLICE_TARGET bytes, else 8 (at H=192: 4 for the recurrence, 2 under
    bf16_mm; 8 for the dual kernel at D=180)."""
    elem = 2 if bf16_mm and D is None else 4
    for C in (1, 2, 4):
        up = _ceil(_ceil(H, C), UW) * UW
        nbytes = _ceil(H, KQ) * KQ * 3 * up * elem
        if D is not None:
            nbytes += D * 3 * up * 4
        if nbytes <= SLICE_TARGET:
            return C
    return 8


class Geometry(NamedTuple):
    """A launch's block as csrc/gru_cluster.cuh lays it out: ``C`` blocks a
    cluster, ``U`` units a block (``Up`` padded to whole warps), H padded to
    ``Hk``, ``BT`` rows a cluster, ``threads`` and ``smem`` bytes a
    block."""

    C: int
    U: int
    Up: int
    Hk: int
    BT: int
    threads: int
    smem: int


def _geometry(H: int, tile: int, D: Optional[int], k_steps: int,
              bf16_mm: bool) -> Optional[Geometry]:
    elem = 2 if bf16_mm and D is None else 4  # Wh's bytes a value
    C = cluster_of(H, D, bf16_mm)
    U = _ceil(H, C)
    Up, Hk = _ceil(U, UW) * UW, _ceil(H, KQ) * KQ
    if tile <= 2:
        threads, cap = KS * Up, MAX_THREADS
    elif tile % TR == 0 and _tile_units(tile, Up):
        tv = _tile_units(tile, Up)
        threads, cap = _tile_block(tile // TR, Up // tv), _tile_threads(tv)
    else:
        return None
    smem = Hk * 3 * Up * elem + 2 * tile * Hk * 4 + _ceil(tile, 4) * 16
    if D is not None:
        dp = _ceil(D, PK) * PK
        wld = 3 * Up + (8 - 3 * Up) % 32
        smem += 4 * (dp * wld + k_steps * tile * 3 * Up)
        threads = max(threads, KS * Up)
    if threads > cap:
        return None
    return Geometry(C, U, Up, Hk, tile, threads, smem)


def rec_geometry(H: int, tile: int,
                 bf16_mm: bool = False) -> Optional[Geometry]:
    """The recurrence kernel's block for a tile (None: a tile the kernel
    does not have); its ``smem`` may exceed SMEM_LIMIT."""
    return _geometry(H, tile, None, 1, bf16_mm)


def dual_geometry(D: int, H: int, tile: int, k_steps: int,
                  bf16_mm: bool = False) -> Optional[Geometry]:
    """The dual kernel's block for a tile and ``k_steps`` steps a chunk
    (pass min(k_steps, T)): at least KS Up threads (Up / 8 warps to
    project)."""
    return _geometry(H, tile, D, k_steps, bf16_mm)


def rec_smem_bytes(H: int, tile: int, bf16_mm: bool = False) -> int:
    """Shared memory of one recurrence block: the Wh slice (Hk x 3 Up f32,
    bf16 under bf16_mm), h double-buffered (2 x tile x Hk f32) and the
    tile's lengths."""
    return rec_geometry(H, tile, bf16_mm).smem


def dual_smem_bytes(D: int, H: int, tile: int, k_steps: int,
                    bf16_mm: bool = False) -> int:
    """Shared memory of one dual-chain block: the recurrence's (Wh f32),
    the Wi slice (Dp x WLD f32) and the chunk's projection (k_steps x tile
    x 3 Up f32)."""
    return dual_geometry(D, H, tile, k_steps, bf16_mm).smem


def _choose(rows: int, sets: int,
            geometry: Callable[[int], Optional[Geometry]],
            clusters: Union[int, Callable[[Geometry], int]]
            ) -> tuple[Optional[Geometry], int]:
    best, best_waves = None, 0
    for tile in TILES:
        g = geometry(tile)
        if g is None or g.smem > SMEM_LIMIT:
            continue
        cap = clusters(g) if callable(clusters) else clusters
        if cap < 1:
            continue
        waves = _ceil(_ceil(rows, tile) * sets, cap)
        if best is not None and waves >= best_waves:
            continue
        best, best_waves = g, waves
        if waves <= 1:
            break
    return best, best_waves


def choose_tile(rows: int, sets: int,
                geometry: Callable[[int], Optional[Geometry]],
                clusters: Union[int, Callable[[Geometry], int]]) -> Geometry:
    """The plan's tile (csrc/gru_proto.cu plan_tiles): of the TILES that fit
    (``geometry(tile)`` within SMEM_LIMIT), the smallest whose ceil(rows /
    tile) x sets clusters take the fewest waves of ``clusters`` (the card's
    co-resident clusters of that block, a number or a function of the
    geometry: cudaOccupancyMaxActiveClusters on the card). Raises if none
    fits."""
    best, _ = _choose(rows, sets, geometry, clusters)
    if best is None:
        raise ValueError("no tile's block fits the H100's shared memory "
                         f"({SMEM_LIMIT} bytes)")
    return best


def choose_chunk(B: int, D: int, H: int, T: int,
                 clusters: Union[int, Callable[[Geometry, int], int]],
                 bf16_mm: bool = False) -> tuple[Geometry, int]:
    """The dual kernel's plan without a given chunk (make_plan): of CHUNKS
    (at most T, or the last), the largest whose best tile
    (:func:`choose_tile`, two chains of B rows) takes the fewest waves.
    ``clusters``: a number or a function of (geometry, chunk). Returns
    (geometry, chunk)."""
    best, best_waves, best_k = None, 0, 0
    for k in CHUNKS:
        if k > T and k > CHUNKS[-1]:
            continue
        cap = clusters if not callable(clusters) else \
            (lambda g, k=k: clusters(g, k))
        g, waves = _choose(
            B, 2, lambda t: dual_geometry(D, H, t, k, bf16_mm), cap)
        if g is not None and (best is None or waves < best_waves):
            best, best_waves, best_k = g, waves, k
    if best is None:
        raise ValueError("no tile's block fits the H100's shared memory "
                         f"({SMEM_LIMIT} bytes)")
    return best, best_k


class ProbePlan(NamedTuple):
    """A probe kernel's launch on the card (csrc/gru_proto.cu's
    gru_rec_plan / gru_dual_plan): :class:`Geometry`'s fields, the chunk
    ``K`` (the dual kernel's steps a chunk; 0 for the recurrence), the
    ``blocks`` of the grid, the ``clusters`` of that block the card runs at
    once and the ``waves`` the grid takes."""

    C: int
    U: int
    Up: int
    Hk: int
    BT: int
    K: int
    smem: int
    threads: int
    blocks: int
    clusters: int
    waves: int


@functools.lru_cache(maxsize=256)
def _plan(device: int, symbol: str, args: tuple) -> ProbePlan:
    lib = _kernels.library()
    fn = getattr(lib, symbol)
    fn.argtypes = [_I] * len(args) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 11)()
    with torch.cuda.device(device):
        err = fn(*args, out)
    if err:
        raise RuntimeError(f"{symbol}{args}: CUDA error {err}: "
                           f"{lib.sst_cuda_error_string(err).decode()}")
    return ProbePlan(*out)


def _device_index(device) -> int:
    device = torch.device("cuda" if device is None else device)
    return torch.cuda.current_device() if device.index is None \
        else device.index


def rec_plan(rows_per_set: int, nsets: int, H: int,
             batch_tile: Optional[int] = None, bf16_mm: bool = False,
             device=None) -> ProbePlan:
    """The recurrence kernel's launch on a card (the current one by
    default), as the kernel chooses it; card only."""
    tile = _tile(batch_tile, rows_per_set)
    return _plan(_device_index(device), "gru_rec_plan",
                 (rows_per_set, nsets, H, tile or 0, int(bf16_mm)))


def dual_plan(B: int, D: int, H: int, T: int,
              batch_tile: Optional[int] = None,
              k_steps: Optional[int] = None, bf16_mm: bool = False,
              device=None) -> ProbePlan:
    """The dual kernel's launch on a card for T steps, as the kernel
    chooses it (``k_steps`` None: the plan's chunk); card only."""
    tile = _tile(batch_tile, B)
    return _plan(_device_index(device), "gru_dual_plan",
                 (B, T, D, H, tile or 0, min(k_steps or 0, T),
                  int(bf16_mm)))


def _tile(batch_tile: Optional[int], rows: int) -> Optional[int]:
    """The rows a cluster: None (the plan's), or ``min(batch_tile, rows)``
    rounded up to a tile the kernels have. Raises on a tile they do not
    have."""
    if batch_tile is None:
        return None
    if batch_tile not in TILES:
        raise ValueError(
            f"batch_tile={batch_tile!r}: the kernels run {TILES} rows a "
            "thread-block cluster, or None for the plan's tile (the TPU's "
            "batch tiles do not carry over)")
    return next(t for t in TILES if t >= min(batch_tile, max(rows, 1)))


def _check_fit(g: Optional[Geometry], what: str) -> None:
    if g is None:
        raise ValueError(f"{what}: the tiled body's block for that tile "
                         "needs more threads than it takes: lower "
                         "batch_tile")
    if g.smem > SMEM_LIMIT:
        raise ValueError(f"{what} needs {g.smem} bytes of shared memory, "
                         f"over the block's {SMEM_LIMIT}: lower batch_tile "
                         "or k_steps")


def _check_k_steps(k_steps: Optional[int], none: bool = False) -> None:
    if none and k_steps is None:
        return
    if not isinstance(k_steps, int) or k_steps < 1:
        raise ValueError(f"k_steps={k_steps!r}: timesteps a chunk, "
                         "an int >= 1" + (" or None" if none else ""))


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
                rows_per_set: int, batch_tile: Optional[int], k_steps: int,
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
    tile = _tile(batch_tile, rows_per_set)
    _check_k_steps(k_steps)
    if not 1 <= H <= MAX_HIDDEN:
        raise ValueError(f"hidden size must be in [1, {MAX_HIDDEN}], got {H}")
    _check_fit(rec_geometry(H, tile or 1, bf16_mm),
               f"the recurrence at H={H}, batch_tile={batch_tile} (tile "
               f"{tile or 'the plan'}'s)")
    if not _kernels.use_kernel(impl, xp):
        R = rows_per_set
        return torch.cat([gru_recurrence_plain(
            xp[s * R:(s + 1) * R], lengths[s * R:(s + 1) * R], wh[s], bh[s],
            bf16_mm) for s in range(S)])
    _check_launch((xp, wh, bh), "recurrence")
    if not xp.is_contiguous():
        raise ValueError("xp must be contiguous")
    wh, bh = wh.contiguous(), bh.contiguous()
    lens = lengths.to(device=xp.device, dtype=torch.int32).contiguous()
    y = torch.empty((B, T, H), dtype=torch.float32, device=xp.device)
    if B and T:
        kernel.launch(_kernels.ptr(xp), _kernels.ptr(lens), _kernels.ptr(wh),
                      _kernels.ptr(bh), _kernels.ptr(y), rows_per_set, S, T,
                      H, tile or 0, int(bf16_mm),
                      _kernels.stream_ptr(xp.device))
    return y


def gru_sequence_kstep(xp: torch.Tensor, lengths: torch.Tensor,
                       wh: torch.Tensor, bh: torch.Tensor, *,
                       batch_tile: Optional[int] = None, k_steps: int = 8,
                       bf16_mm: bool = False, impl: str = "auto"
                       ) -> torch.Tensor:
    """One GRU direction's recurrence over a precomputed projection
    (proto_gru2.py::gru_sequence_kstep).

    xp: (B, T, 3H) f32, ``x Wi + bi``; lengths: (B,); wh: (H, 3H); bh:
    (3H,). Returns y (B, T, H) f32, zero at t >= length. ``batch_tile``:
    rows a cluster (one of TILES; None: the plan's); ``k_steps``: checked,
    no chunk here; ``bf16_mm``: h and Wh rounded to bf16 for the
    product."""
    return _recurrence(KSTEP, xp, lengths, wh[None], bh[None], xp.shape[0],
                       batch_tile, k_steps, bf16_mm, impl)


def gru_sequence_kstep_2w(xp: torch.Tensor, lengths: torch.Tensor,
                          wh2: torch.Tensor, bh2: torch.Tensor, *,
                          batch_tile: Optional[int] = None,
                          k_steps: int = 8,
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
                   batch_tile: Optional[int] = None,
                   k_steps: Optional[int] = None, bf16_mm: bool = False,
                   vmem_mb: int = DUAL_VMEM_MB,
                   impl: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """Both directions of one GRU layer in one launch, the projections
    fused (proto_gru4.py::gru_layer_dual).

    x: (B, T, D) f32; x_flip: flip_padded(x, lengths); pf, pb: {'wi' (D, 3H),
    'bi' (3H,), 'wh' (H, 3H), 'bh' (3H,)}. Returns (y_fwd, y_bwd in the
    flipped order), each (B, T, H). ``batch_tile``: rows a cluster (one of
    TILES; None: the plan's); ``k_steps``: steps a chunk, each chunk's
    projection computed before its steps (None: the plan's chunk);
    ``bf16_mm``: x, Wi, h and Wh rounded to bf16 for the products."""
    if vmem_mb != DUAL_VMEM_MB:
        raise ValueError(
            f"vmem_mb={vmem_mb!r}: a Mosaic VMEM limit with no counterpart "
            "on the card (the launch sizes its shared memory itself); the "
            f"port takes only the default {DUAL_VMEM_MB}")
    return _dual(x, x_flip, lengths, pf, pb, batch_tile, k_steps, bf16_mm,
                 impl, None)


def _dual(x: torch.Tensor, x_flip: torch.Tensor, lengths: torch.Tensor,
          pf: dict, pb: dict, batch_tile: Optional[int],
          k_steps: Optional[int],
          bf16_mm: bool, impl: str, stop: Optional[int]
          ) -> tuple[torch.Tensor, torch.Tensor]:
    B, T, D = x.shape
    H = pf["wh"].shape[0]
    want = {"wi": (D, 3 * H), "bi": (3 * H,), "wh": (H, 3 * H),
            "bh": (3 * H,)}
    if x_flip.shape != x.shape or lengths.shape != (B,) or any(
            tuple(p[k].shape) != s for p in (pf, pb) for k, s in want.items()):
        raise ValueError(f"shapes: x {tuple(x.shape)}, x_flip "
                         f"{tuple(x_flip.shape)}, lengths "
                         f"{tuple(lengths.shape)}, weights as {want}")
    tile = _tile(batch_tile, B)
    _check_k_steps(k_steps, none=True)
    if not 1 <= H <= MAX_HIDDEN:
        raise ValueError(f"hidden size must be in [1, {MAX_HIDDEN}], got {H}")
    _check_fit(dual_geometry(D, H, tile or 1, min(k_steps or 1, max(T, 1)),
                             bf16_mm),
               f"the dual kernel at D={D}, H={H}, batch_tile={batch_tile} "
               f"(tile {tile or 'the plan'}'s), k_steps={k_steps}")
    if not _kernels.use_kernel(impl, x):
        return gru_layer_dual_plain(x, x_flip, lengths, pf, pb, bf16_mm)
    ws = [p[k].contiguous() for p in (pf, pb)
          for k in ("wi", "bi", "wh", "bh")]
    _check_launch([x, x_flip] + ws, "dual-chain")
    if not (x.is_contiguous() and x_flip.is_contiguous()):
        raise ValueError("x and x_flip must be contiguous")
    lens = lengths.to(device=x.device, dtype=torch.int32).contiguous()
    y = torch.empty((2, B, T, H), dtype=torch.float32, device=x.device)
    if B and T:
        kernel, extra = (DUAL, ()) if stop is None else (DUAL_STOP, (stop,))
        kernel.launch(_kernels.ptr(x), _kernels.ptr(x_flip),
                      _kernels.ptr(lens), *map(_kernels.ptr, ws),
                      _kernels.ptr(y[0]), _kernels.ptr(y[1]), B, T, D, H,
                      tile or 0, k_steps or 0, int(bf16_mm), *extra,
                      _kernels.stream_ptr(x.device))
    return y[0], y[1]


def gru_layer_dual_stop(x: torch.Tensor, x_flip: torch.Tensor,
                        lengths: torch.Tensor, pf: dict, pb: dict,
                        stop: str, *, batch_tile: Optional[int] = None,
                        k_steps: Optional[int] = None, bf16_mm: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The dual kernel with a part left out, to time the rest (card only;
    its output is not the layer's): ``stop`` one of STOPS, "all" the whole
    kernel, "no_projection" every chunk's projection left at zero,
    "no_product" no recurrent product, "neither" both left out (the steps'
    gates, exchange and barriers)."""
    if stop not in STOPS:
        raise ValueError(f"stop={stop!r}: one of {tuple(STOPS)}")
    if not x.is_cuda:
        raise ValueError("gru_layer_dual_stop times the kernel: a CUDA "
                         "tensor is needed")
    return _dual(x, x_flip, lengths, pf, pb, batch_tile, k_steps, bf16_mm,
                 "kernel", STOPS[stop])
