"""GRU sequence: two CUDA kernels a layer and their plain PyTorch versions
(port of the JAX ops/pallas_gru.py).

``gru_sequence`` / ``gru_layer`` / ``bigru_kernel`` keep the signatures of
``gru_sequence_pallas`` / ``gru_layer_pallas`` / ``bigru_pallas`` without
the TPU tiling knobs, plus ``impl`` (see ``ops._kernels``). Each layer is
two launches, both directions sharing each:

- ``gru_proj`` (csrc/gru_proj.cu): ``xp = x Wi + bi`` for every (b, t) and
  both directions, one (B T, D) x (D, 6H) product in f32's class of error,
  by one of two routes that the kernel chooses from the shapes
  (:func:`proj_geometry` mirrors the choice, :func:`proj_plan` reads it on
  the card): small M (the live path) on the f32 FMAs, 32 x 32 output tiles
  with K split across warps, bound by latency; large M as 3xTF32 on the
  tensor cores' wgmma (x split hi / lo in registers, Wi^T's hi and lo
  planes packed once by :func:`pack_wi_tc`), persistent blocks over 128 x
  192 or 128 x 144 tiles fed by a cp.async ring, bound by the multiply-
  adds at the f32 FMAs and 3xTF32 together (232 TFLOP/s); plain version
  :func:`gru_proj_plain` (a matmul); its CPU tests of the route's
  arithmetic and of the plan's mirror are tests/test_torch_gru_proj_tc.py;
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
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from . import _kernels
from . import gru as gru_ops

_P = ctypes.c_void_p
_I = ctypes.c_int
PROJ = _kernels.Kernel("gru_proj", "gru_proj_forward",
                       [_P, _P, _P, _P, _P,  # x, w, wt, bias, xp
                        _I, _I, _I, _I,      # M, K, N, route
                        _P])                 # stream
# the large route at a chosen tile width and number of TF32 passes, to time
# the parts and the tile choice (gru_proj_stop)
PROJ_STOP = _kernels.Kernel("gru_proj_stop", "gru_proj_stop",
                            [_P, _P, _P, _P,      # x, wt, bias, xp
                             _I, _I, _I, _I, _I,  # M, K, N, bn, passes
                             _P])                 # stream
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


# csrc/gru_proj.cu's routes and tiles, which proj_geometry mirrors: the
# small route for M <= PROJ_SMALL_M and K <= PROJ_KMAX, 32 x 32 tiles of 8
# warps, each warp a share of K rounded up to 4; the large route 128 x BN
# tiles (BN of PROJ_BNS, the one whose waves of PROJ_SMS tiles cost the
# least, waves x (BN + PROJ_TILE_COST), ties to the wider), chunks of
# PROJ_BK rows of K through a ring of at most PROJ_MAX_STAGES cp.async
# stages (Wi^T's hi and lo planes of the tile's columns, x's raw rows of
# stride PROJ_BK + 4) on a 1,024-byte start.
PROJ_ROUTES = ("small", "large")
PROJ_SMALL_M, PROJ_KMAX, PROJ_SMS = 512, 832, 132
PROJ_BNS, PROJ_BK, PROJ_MAX_STAGES, PROJ_THREADS = (192, 144), 32, 4, 256
PROJ_TILE_COST = 64  # a tile's time: about BN + PROJ_TILE_COST columns'
SMEM_BYTES = 232448  # a block's shared memory on the H100


class ProjGeometry(NamedTuple):
    """How ``gru_proj`` runs (M, K, N), from the shapes alone
    (:func:`proj_geometry`): the ``route``, the output tile ``bm`` x
    ``bn``, the ``tiles``, dynamic shared memory bytes a block, cp.async
    ``stages`` (1: the small route stages all of K at once) and threads a
    block. The large route launches min(tiles, the card's resident
    blocks) persistent blocks (:func:`proj_plan`'s ``blocks``)."""

    route: str
    bm: int
    bn: int
    tiles: int
    smem: int
    stages: int
    threads: int


def _proj_route(M: int, K: int, route: Optional[str]) -> str:
    if route is None:
        return "small" if M <= PROJ_SMALL_M and K <= PROJ_KMAX else "large"
    if route not in PROJ_ROUTES:
        raise ValueError(f"unknown route {route!r}; one of {PROJ_ROUTES}")
    if route == "small" and K > PROJ_KMAX:
        raise ValueError(f"the small route takes K <= {PROJ_KMAX}, got {K}")
    return route


def proj_geometry(M: int, K: int, N: int,
                  route: Optional[str] = None) -> ProjGeometry:
    """The route and tile csrc/gru_proj.cu takes for x (M, K) @ Wi (K, N)
    (``route``: None for the shapes' choice, or "small" / "large")."""
    if M < 1 or K < 1 or N < 1:
        raise ValueError(f"M, K, N must be positive, got {M}, {K}, {N}")
    if _proj_route(M, K, route) == "small":
        kw = _ceil(K, 4 * 8) * 4
        stage = 32 * (8 * kw + 4) + 8 * kw * 36
        return ProjGeometry("small", 32, 32, _ceil(M, 32) * _ceil(N, 32),
                            4 * max(stage, 8 * 32 * 32), 1, PROJ_THREADS)
    costs = [(_ceil(_ceil(M, 128) * _ceil(N, bn), PROJ_SMS)
              * (bn + PROJ_TILE_COST), -bn) for bn in PROJ_BNS]
    bn = -min(costs)[1]
    stage = 2 * bn * 4 * PROJ_BK + 128 * (PROJ_BK + 4) * 4
    stages = min(PROJ_MAX_STAGES, (SMEM_BYTES - 1024) // stage)
    return ProjGeometry("large", 128, bn, _ceil(M, 128) * _ceil(N, bn),
                        1024 + stages * stage, stages, PROJ_THREADS)


class ProjPlan(NamedTuple):
    """``gru_proj``'s launch on the card (csrc/gru_proj.cu's
    gru_proj_plan): :class:`ProjGeometry`'s fields and ``blocks``, the
    blocks launched (the large route: persistent, at most the card's
    resident blocks)."""

    route: str
    bm: int
    bn: int
    tiles: int
    blocks: int
    smem: int
    stages: int
    threads: int


@functools.lru_cache(maxsize=256)
def _proj_plan(device: int, M: int, K: int, N: int, code: int) -> ProjPlan:
    lib = _kernels.library()
    fn = lib.gru_proj_plan
    fn.argtypes = [_I, _I, _I, _I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 8)()
    with torch.cuda.device(device):
        err = fn(M, K, N, code, out)
    if err:
        raise RuntimeError(f"gru_proj_plan(M={M}, K={K}, N={N}): CUDA error "
                           f"{err}: {lib.sst_cuda_error_string(err).decode()}")
    return ProjPlan(PROJ_ROUTES[out[0]], *out[1:])


def proj_plan(M: int, K: int, N: int, route: Optional[str] = None,
              device=None) -> ProjPlan:
    """``gru_proj``'s launch for x (M, K) @ Wi (K, N) on a card (the
    current one by default), as the kernel chooses it."""
    proj_geometry(M, K, N, route)  # raises on what the kernel refuses
    device = torch.device("cuda" if device is None else device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    code = -1 if route is None else PROJ_ROUTES.index(route)
    return _proj_plan(index, M, K, N, code)


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
    and bi of the directions side by side for ``gru_proj`` (and Wi split
    for its large route, :func:`pack_wi_tc`), each direction's Wh in the
    per-block order (:func:`pack_wh`) and bh for ``gru_seq``, and the
    JAX-layout Wh for the plain version."""

    wi: torch.Tensor        # (D, ndir 3H)
    bi: torch.Tensor        # (ndir 3H,)
    whp: torch.Tensor       # (ndir, C, Hk/4, 3, Up, 4)
    bh: torch.Tensor        # (ndir, 3H)
    wh: tuple               # ndir x (H, 3H)
    reverse: tuple          # ndir x bool
    C: int
    wt: torch.Tensor        # (2, ndir 3H, D rounded up to PROJ_BK)


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
        wi = torch.cat([p["wi"] for p, _ in dirs], 1).contiguous()
        return LayerPack(
            wi, torch.cat([p["bi"] for p, _ in dirs]).contiguous(),
            torch.stack([pack_wh(p["wh"], C) for p, _ in dirs]),
            torch.stack([p["bh"] for p, _ in dirs]).contiguous(),
            tuple(p["wh"] for p, _ in dirs),
            tuple(bool(r) for _, r in dirs), C, pack_wi_tc(wi))


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


def pack_wi_tc(wi: torch.Tensor) -> torch.Tensor:
    """Wi (K, N) f32 as the large route reads it: (2, N, KP) f32, Wi^T
    split hi = tf32(w), lo = tf32(w - hi) (csrc/mma_tf32.cuh's split: half
    a TF32 ulp added to the magnitude bits, the 13 low bits cleared), K
    padded with zeros to KP, a multiple of PROJ_BK."""
    K, N = wi.shape
    kp = _ceil(K, PROJ_BK) * PROJ_BK
    wt = F.pad(wi.t().to(torch.float32), (0, kp - K)).contiguous()

    def tf32(v: torch.Tensor) -> torch.Tensor:
        return ((v.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)

    hi = tf32(wt)
    return torch.stack([hi, tf32(wt - hi)]).contiguous()


def gru_proj(x: torch.Tensor, wi: torch.Tensor, bi: torch.Tensor, *,
             impl: str = "auto", route: Optional[str] = None,
             wt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``xp = x Wi + bi`` over every row of x (..., D): wi (D, N), bi (N,).
    Returns (..., N). ``route``: the kernel's route, None for the one it
    chooses from the shapes, or "small" / "large" (:func:`proj_geometry`),
    both the same function; ``wt``: :func:`pack_wi_tc` of ``wi``, which
    the large route reads, built once by the caller (without it a large
    launch packs anew)."""
    if route not in (None,) + PROJ_ROUTES:
        raise ValueError(f"unknown route {route!r}; one of {PROJ_ROUTES}")
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
    if not M:
        return xp
    null = ctypes.c_void_p(0)
    if proj_geometry(M, D, N, route).route == "large":
        if wt is None:
            wt = pack_wi_tc(wi)
        _check_f32("wt", wt, x.device)
        if wt.shape != (2, N, _ceil(D, PROJ_BK) * PROJ_BK):
            raise ValueError(f"wt must be pack_wi_tc(wi), (2, {N}, "
                             f"{_ceil(D, PROJ_BK) * PROJ_BK}), got "
                             f"{tuple(wt.shape)}")
    code = -1 if route is None else PROJ_ROUTES.index(route)
    PROJ.launch(_kernels.ptr(x), _kernels.ptr(wi),
                null if wt is None else _kernels.ptr(wt), _kernels.ptr(bi),
                _kernels.ptr(xp), M, D, N, code,
                _kernels.stream_ptr(x.device))
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


def gru_proj_stop(x: torch.Tensor, wt: torch.Tensor, bi: torch.Tensor, *,
                  bn: int = 0, passes: int = 3) -> torch.Tensor:
    """``gru_proj``'s large route at tile width ``bn`` (one of PROJ_BNS; 0
    for the shapes' choice) with ``passes`` TF32 passes, on the card only,
    to time the tile choice and the passes: 3 is the route's function
    (bitwise ``gru_proj`` on the large route at the same tile width), 1
    forms hi*hi alone (one TF32 pass: another function). x (M, K) and
    ``wt`` (:func:`pack_wi_tc`) on the card, K and N multiples of 4."""
    if bn not in (0,) + PROJ_BNS or passes not in (1, 3):
        raise ValueError(f"bn in {(0,) + PROJ_BNS} and passes 1 or 3, got "
                         f"{bn}, {passes}")
    if not x.is_cuda:
        raise ValueError("gru_proj_stop times the card's kernel: it needs "
                         f"CUDA tensors, got one on {x.device}")
    M, K = x.shape
    N = bi.shape[0]
    for name, t in (("x", x), ("wt", wt), ("bi", bi)):
        _check_f32(name, t, x.device)
    if K % 4 or N % 4 or wt.shape != (2, N, _ceil(K, PROJ_BK) * PROJ_BK):
        raise ValueError(f"K and N multiples of 4 and wt pack_wi_tc's, got "
                         f"K={K} N={N} wt {tuple(wt.shape)}")
    xp = torch.empty((M, N), dtype=torch.float32, device=x.device)
    PROJ_STOP.launch(_kernels.ptr(x), _kernels.ptr(wt), _kernels.ptr(bi),
                     _kernels.ptr(xp), M, K, N, bn, passes,
                     _kernels.stream_ptr(x.device))
    return xp


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
    xp = gru_proj(x.contiguous(), pack.wi, pack.bi, impl="kernel",
                  wt=pack.wt)
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
    the (B, T, 2H) layer output (one direction: (B, T, H)). A layer dict's
    ``'packed'`` entry (its :func:`pack_layer` of as many directions, as
    ``BiGRUClassifier.kernel_weights`` keeps it) is used as it is;
    otherwise the layer's pack is :func:`layer_pack`'s."""
    if not _kernels.use_kernel(impl, x):
        return gru_ops.bigru(x, lengths, layers,
                             bidirectional=bidirectional)[0]
    _refuse_autograd(x, *(w for lp in layers for d in ("fwd", "bwd")
                          if d in lp for w in lp[d].values()))
    lens = lengths.to(device=x.device, dtype=torch.int32)
    out = x
    for lp in layers:
        pack = lp.get("packed")
        if pack is None or len(pack.reverse) != 1 + bidirectional:
            dirs = [(lp["fwd"], False)] + ([(lp["bwd"], True)]
                                           if bidirectional else [])
            pack = layer_pack(dirs)
        out = _layer(out, lens, pack)
    return out
