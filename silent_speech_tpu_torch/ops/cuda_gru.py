"""GRU sequence: two CUDA kernels a layer and their plain PyTorch versions
(port of the JAX ops/pallas_gru.py).

``gru_sequence`` / ``gru_layer`` / ``bigru_kernel`` keep the signatures of
``gru_sequence_pallas`` / ``gru_layer_pallas`` / ``bigru_pallas`` without
the TPU tiling knobs, plus ``impl`` (see ``ops._kernels``). Each layer is
two launches, both directions sharing each:

- ``gru_proj`` (csrc/gru_proj.cu): ``xp = x Wi + bi`` for every (b, t) and
  both directions, one (B T, D) x (D, 6H) product in f32 FMAs; plain
  version :func:`gru_proj_plain` (a matmul);
- ``gru_seq`` (csrc/gru_seq.cu): the masked recurrence over xp, one
  thread-block cluster of C blocks a (direction, tile of BT rows), each
  block holding its slice of Wh in shared memory for all T steps, the
  reverse direction read and written at L-1-t in the kernel; plain version
  :func:`gru_recurrence_plain`.

Their composition's plain version is the masked scan of ``ops/gru.py``.
:func:`pack_layer` lays a layer's weights out for the kernels once, with C
from H (:func:`cluster_size`); the model keeps it in
``BiGRUClassifier.kernel_weights``, and ``gru_sequence`` / ``bigru_kernel``
keep the packs of the weights they were given until those change.
:func:`plan` reports the rest of the launch (BT, where Wh lives), which
the kernel chooses from the shapes and the card.

The kernels have no backward (nor has the JAX package's: ``gru_impl=
'pallas'`` is inference-only). A launch on tensors that autograd would
differentiate raises instead of returning an output without a gradient;
training runs the plain scan.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import threading
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from . import _kernels
from . import gru as gru_ops

_P = ctypes.c_void_p
_I = ctypes.c_int
PROJ = _kernels.Kernel("gru_proj", "gru_proj_forward",
                       [_P, _P, _P, _P,     # x, w, bias, xp
                        _I, _I, _I, _P])    # M, K, N, stream
SEQ = _kernels.Kernel(
    "gru_seq", "gru_seq_forward",
    [_P, _P, _P, _P,                        # xp, lengths, whp, bh
     _I, _I, _I, _P,                        # rev0, rev1, ndir, y
     _I, _I, _I, _I,                        # B, T, H, ldy
     _I, _I, _I, _P])                       # C, BT, smem_w, stream
MAX_HIDDEN = 1024

# The per-block layout of Wh (pack_wh), which csrc/gru_seq.cu reads: a
# block's U units padded to whole warps of UNITS_PER_WARP, H padded to
# H_ALIGN (its KQ); gru_recurrence holds a pack to the layout the kernel's
# gru_seq_plan reports. C, the blocks a cluster, is the smallest of CLUSTERS
# whose Wh slice is at most W_SLICE_TARGET.
UNITS_PER_WARP, H_ALIGN = 8, 16
CLUSTERS = (1, 2, 4, 8)
W_SLICE_TARGET = 128 << 10


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _layout(H: int, C: int) -> tuple[int, int, int]:
    """U units a block, padded to Up; H padded to Hk."""
    U = _ceil(H, C)
    return U, _ceil(U, UNITS_PER_WARP) * UNITS_PER_WARP, _ceil(H, H_ALIGN) \
        * H_ALIGN


def cluster_size(H: int) -> int:
    """C: the smallest cluster whose per-block Wh slice is at most
    W_SLICE_TARGET (4 at H=192: 110.6 KB a block), else the largest."""
    if not 1 <= H <= MAX_HIDDEN:
        raise ValueError(f"hidden size must be in [1, {MAX_HIDDEN}], got {H}")
    for C in CLUSTERS:
        U, Up, Hk = _layout(H, C)
        if Hk * 3 * Up * 4 <= W_SLICE_TARGET:
            return C
    return CLUSTERS[-1]


class Plan(NamedTuple):
    """How ``gru_seq`` runs a layer on the card (csrc/gru_seq.cu's
    gru_seq_plan): ``C`` blocks a cluster, ``U`` hidden units a block
    (``Up`` padded to whole warps), H padded to ``Hk``, ``BT`` batch rows a
    cluster (1 or 2: the split instantiation; 4 n: the tiled one),
    ``smem_w``: the Wh slices in shared memory (else read from device
    memory every step), ``smem`` bytes a block, ``threads`` a block,
    ``blocks`` in the grid, ``clusters`` of this shape the card runs at
    once (cudaOccupancyMaxActiveClusters) and the ``waves`` the grid takes."""

    C: int
    U: int
    Up: int
    Hk: int
    BT: int
    smem_w: bool
    smem: int
    threads: int
    blocks: int
    clusters: int
    waves: int


@functools.lru_cache(maxsize=256)
def _plan(device: int, B: int, H: int, ndir: int, C: int) -> Plan:
    lib = _kernels.library()
    fn = lib.gru_seq_plan
    fn.argtypes = [_I, _I, _I, _I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 10)()
    with torch.cuda.device(device):
        err = fn(B, H, ndir, C, out)
    if err:
        raise RuntimeError(f"gru_seq_plan(B={B}, H={H}, ndir={ndir}, C={C}): "
                           f"CUDA error {err}: "
                           f"{lib.sst_cuda_error_string(err).decode()}")
    U, Up, Hk, BT, smem_w, *rest = out
    return Plan(C, U, Up, Hk, BT, bool(smem_w), *rest)


def plan(B: int, H: int, ndir: int, device=None) -> Plan:
    """The launch of ``gru_seq`` for ``B`` rows, hidden size ``H`` and
    ``ndir`` directions on a card (the current one by default), as the
    kernel chooses it: C from the weights' layout (:func:`cluster_size`),
    the rest from the shapes and the card's occupancy (gru_seq_plan)."""
    device = torch.device("cuda" if device is None else device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return _plan(index, B, H, ndir, cluster_size(H))


def pack_wh(wh: torch.Tensor, C: int) -> torch.Tensor:
    """Wh (H, 3H) in the per-block order csrc/gru_seq.cu reads: (C, Hk/4,
    3, Up, 4), element [c, q, g, u, i] = Wh[4 q + i, g H + c U + u], zero
    where k >= H or the unit c U + u is not block c's or lies past H."""
    H = wh.shape[0]
    U, Up, Hk = _layout(H, C)
    w = wh.reshape(H, 3, H)
    w = F.pad(w, (0, C * U - H, 0, 0, 0, Hk - H))          # (Hk, 3, C U)
    w = F.pad(w.reshape(Hk, 3, C, U), (0, Up - U))          # (Hk, 3, C, Up)
    w = w.reshape(Hk // 4, 4, 3, C, Up).permute(3, 0, 2, 4, 1)
    return w.contiguous()


class LayerPack(NamedTuple):
    """A layer's weights laid out for the kernels (:func:`pack_layer`): Wi
    and bi of the directions side by side for ``gru_proj``, each
    direction's Wh in the per-block order (:func:`pack_wh`) and bh for
    ``gru_seq``, and the JAX-layout Wh for the plain version."""

    wi: torch.Tensor        # (D, ndir 3H)
    bi: torch.Tensor        # (ndir 3H,)
    whp: torch.Tensor       # (ndir, C, Hk/4, 3, Up, 4)
    bh: torch.Tensor        # (ndir, 3H)
    wh: tuple               # ndir x (H, 3H)
    reverse: tuple          # ndir x bool
    C: int


def pack_layer(dirs: Sequence[tuple[dict, bool]]) -> LayerPack:
    """Lay out 1 or 2 directions ``(params, reverse)`` of one layer, params
    {'wi' (D, 3H), 'bi' (3H,), 'wh' (H, 3H), 'bh' (3H,)} f32 on one
    device."""
    if len(dirs) not in (1, 2):
        raise ValueError(f"a layer has 1 or 2 directions, got {len(dirs)}")
    p0 = dirs[0][0]
    D, H = p0["wi"].shape[0], p0["wh"].shape[0]
    if not 1 <= H <= MAX_HIDDEN:
        raise ValueError(f"hidden size must be in [1, {MAX_HIDDEN}], got {H}")
    for p, _ in dirs:
        for key, shape in (("wi", (D, 3 * H)), ("bi", (3 * H,)),
                           ("wh", (H, 3 * H)), ("bh", (3 * H,))):
            w = p[key]
            if tuple(w.shape) != shape or w.dtype != torch.float32 \
                    or w.device != p0["wi"].device:
                raise ValueError(f"{key}: expected f32 {shape} on "
                                 f"{p0['wi'].device}, got {w.dtype} "
                                 f"{tuple(w.shape)} on {w.device}")
    C = cluster_size(H)
    with torch.no_grad():
        return LayerPack(
            torch.cat([p["wi"] for p, _ in dirs], 1).contiguous(),
            torch.cat([p["bi"] for p, _ in dirs]).contiguous(),
            torch.stack([pack_wh(p["wh"], C) for p, _ in dirs]),
            torch.stack([p["bh"] for p, _ in dirs]).contiguous(),
            tuple(p["wh"] for p, _ in dirs),
            tuple(bool(r) for _, r in dirs), C)


_PACKS: collections.OrderedDict = collections.OrderedDict()
_PACKS_KEPT = 8
_PACKS_LOCK = threading.Lock()


def layer_pack(dirs: Sequence[tuple[dict, bool]]) -> LayerPack:
    """:func:`pack_layer` of ``dirs``, kept for the next call with the same
    tensors unchanged (their version counters): the packs of the last
    _PACKS_KEPT weight sets, each holding its tensors. Tensors made under
    inference mode have no version counter and are packed at every call."""
    tensors = [p[k] for p, _ in dirs for k in ("wi", "bi", "wh", "bh")]
    if any(t.is_inference() for t in tensors):
        return pack_layer(dirs)
    key = tuple((id(t), t.data_ptr(), t._version) for t in tensors) + tuple(
        bool(r) for _, r in dirs)
    with _PACKS_LOCK:
        hit = _PACKS.get(key)
        if hit is None:
            # the entry holds the tensors, so no id in a kept key is reused
            hit = _PACKS[key] = (tensors, pack_layer(dirs))
            while len(_PACKS) > _PACKS_KEPT:
                _PACKS.popitem(last=False)
        _PACKS.move_to_end(key)
        return hit[1]


def _refuse_autograd(*tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "the GRU kernels have no backward: run them under "
            "torch.no_grad() / torch.inference_mode(), or use impl='plain' "
            "(the differentiable scan) for training")


def _check_f32(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.dtype != torch.float32 or not t.is_contiguous() \
            or t.device != device:
        raise ValueError(f"{name} must be contiguous f32 on {device}, got "
                         f"{t.dtype}{'' if t.is_contiguous() else ' (strided)'}"
                         f" on {t.device}")


def gru_proj_plain(x: torch.Tensor, wi: torch.Tensor,
                   bi: torch.Tensor) -> torch.Tensor:
    """The plain version of ``gru_proj``: x (..., D) @ wi (D, N) + bi."""
    return x @ wi + bi


def gru_proj(x: torch.Tensor, wi: torch.Tensor, bi: torch.Tensor, *,
             impl: str = "auto") -> torch.Tensor:
    """``xp = x Wi + bi`` over every row of x (..., D): wi (D, N), bi (N,).
    Returns (..., N)."""
    if not _kernels.use_kernel(impl, x):
        return gru_proj_plain(x, wi, bi)
    D, N = wi.shape
    if x.shape[-1] != D or bi.shape != (N,):
        raise ValueError(f"x (..., {D}), bi ({N},) expected for wi "
                         f"{tuple(wi.shape)}, got {tuple(x.shape)}, "
                         f"{tuple(bi.shape)}")
    for name, t in (("x", x), ("wi", wi), ("bi", bi)):
        _check_f32(name, t, x.device)
    _refuse_autograd(x, wi, bi)
    xp = torch.empty(x.shape[:-1] + (N,), dtype=torch.float32,
                     device=x.device)
    M = xp.numel() // N
    if M:
        PROJ.launch(_kernels.ptr(x), _kernels.ptr(wi), _kernels.ptr(bi),
                    _kernels.ptr(xp), M, D, N, _kernels.stream_ptr(x.device))
    return xp


def gru_recurrence_plain(xp: torch.Tensor, lengths: torch.Tensor,
                         wh: torch.Tensor, bh: torch.Tensor, *,
                         reverse: bool = False) -> torch.Tensor:
    """The plain version of one direction of ``gru_seq``: the masked GRU
    recurrence over ``xp = x Wi + bi`` (B, T, 3H); the reverse direction
    over xp read at L-1-t and y written there. Returns y (B, T, H), zero at
    t >= length."""
    if reverse:
        xp = gru_ops.flip_padded(xp, lengths)
    y = gru_ops.gru_recurrence(xp, lengths, wh, bh)[0]
    return gru_ops.flip_padded(y, lengths) if reverse else y


def gru_recurrence(xp: torch.Tensor, lengths: torch.Tensor,
                   pack: LayerPack, *, impl: str = "auto") -> torch.Tensor:
    """The masked recurrence of the pack's directions over xp (B, T,
    ndir 3H), ``gru_proj``'s output. Returns y (B, T, ndir H), direction k
    in columns [k H, k H + H)."""
    ndir, H = len(pack.reverse), pack.wh[0].shape[0]
    B, T, N = xp.shape
    if N != ndir * 3 * H or lengths.shape != (B,):
        raise ValueError(f"xp (B, T, {ndir * 3 * H}) and lengths (B,) "
                         f"expected, got {tuple(xp.shape)}, "
                         f"{tuple(lengths.shape)}")
    if not _kernels.use_kernel(impl, xp):
        return torch.cat([gru_recurrence_plain(
            xp[..., 3 * H * k:3 * H * (k + 1)], lengths, pack.wh[k],
            pack.bh[k], reverse=rev) for k, rev in enumerate(pack.reverse)],
            -1)
    for name, t in (("xp", xp), ("whp", pack.whp), ("bh", pack.bh)):
        _check_f32(name, t, xp.device)
    _refuse_autograd(xp, pack.whp, pack.bh)
    y = torch.empty((B, T, ndir * H), dtype=torch.float32, device=xp.device)
    if B and T:
        pl = plan(B, H, ndir, xp.device)
        want = (ndir, pl.C, pl.Hk // 4, 3, pl.Up, 4)
        if tuple(pack.whp.shape) != want:
            raise ValueError(f"whp {tuple(pack.whp.shape)}: the kernel "
                             f"reads {want}")
        lens = lengths.to(device=xp.device, dtype=torch.int32)
        rev = [int(r) for r in pack.reverse] + [0]
        SEQ.launch(_kernels.ptr(xp), _kernels.ptr(lens),
                   _kernels.ptr(pack.whp), _kernels.ptr(pack.bh),
                   rev[0], rev[1], ndir, _kernels.ptr(y), B, T, H, ndir * H,
                   pl.C, pl.BT, int(pl.smem_w),
                   _kernels.stream_ptr(xp.device))
    return y


def _layer(x: torch.Tensor, lengths: torch.Tensor,
           pack: LayerPack) -> torch.Tensor:
    """One layer through the two kernels: gru_proj, then gru_seq."""
    xp = gru_proj(x.contiguous(), pack.wi, pack.bi, impl="kernel")
    return gru_recurrence(xp, lengths, pack, impl="kernel")


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
    _refuse_autograd(x, wi, bi, wh, bh)
    return _layer(x, lengths, layer_pack([(p, reverse)]))


def gru_layer(x: torch.Tensor, lengths: torch.Tensor, params: dict, *,
              reverse: bool = False, impl: str = "auto") -> torch.Tensor:
    """Drop-in for ops.gru.gru_layer_single_direction (outputs only)."""
    return gru_sequence(x, lengths, params["wi"], params["bi"], params["wh"],
                        params["bh"], reverse=reverse, impl=impl)


def bigru_kernel(x: torch.Tensor, lengths: torch.Tensor, layers: list[dict],
                 *, bidirectional: bool = True, impl: str = "auto"
                 ) -> torch.Tensor:
    """Stacked (bi)GRU (inference). Two launches a layer, gru_proj and
    gru_seq, both directions sharing each and writing the two halves of
    the (B, T, 2H) layer output. A layer dict's ``'packed'`` entry (the
    bidirectional :func:`pack_layer`, as ``BiGRUClassifier.kernel_weights``
    keeps it) is used as it is; otherwise the layer's pack is
    :func:`layer_pack`'s."""
    if not _kernels.use_kernel(impl, x):
        return gru_ops.bigru(x, lengths, layers,
                             bidirectional=bidirectional)[0]
    _refuse_autograd(x, *(w for lp in layers for d in ("fwd", "bwd")
                          if d in lp for w in lp[d].values()))
    lens = lengths.to(device=x.device, dtype=torch.int32)
    out = x
    for lp in layers:
        pack = lp.get("packed") if bidirectional else None
        if pack is None:
            dirs = [(lp["fwd"], False)] + ([(lp["bwd"], True)]
                                           if bidirectional else [])
            pack = layer_pack(dirs)
        out = _layer(out, lens, pack)
    return out
