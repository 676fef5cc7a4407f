"""The chained-dot rate probe's kernel (csrc/dot_chain.cu) and its plain
PyTorch version: the port of the Pallas kernel of scripts/probe_int8.py
(``_kernel``, built by ``build``).

Each of ``steps`` grid steps takes the sum of its (8, 128) uint8 block of
``x`` as a seed, runs a serial chain of :data:`DEPTH` products ``y <- y W``
with y (384, K) and W (K, K), and writes one value, the sum of
``y[0, 0:128]``, over its (8, 128) output block. The modes (:data:`MODES`):

- ``f32``: y0 = f32(seed) * 1e-6, f32 products;
- ``bf16``: y0 and each product's f32 sum rounded to bf16;
- ``int8``: y0 = s8(seed & 63); s8 x s8 -> s32 products, then ``>> 7``
  (arithmetic) and a wrap to s8 modulo 256, as XLA's convert does;
- ``int8i``: 14 independent s8 products of ``base + d`` (base = s8(seed &
  63), d < 14) with W, summed in s32.

**Defined weights.** The TPU kernel's W is a VMEM scratch that is never
written (probe_int8.py:105), so its output is undefined. The port takes W
as an input: :func:`make_weights` draws it as the port's scripts use it
(``default_rng(1)``: standard normal / sqrt(K) for ``f32``, the same
rounded to bf16 for ``bf16``, integers in [-128, 128) for the int modes).

**The output sum.** The int modes' sum of the 128 integers is taken
exactly and rounded once to f32 (the TPU's f32 sum of them is exact while
it stays under 2^24; this sum also when it does not).

**Checks.** Every row of y is the same by construction, so the output
alone says little. ``check=True`` launches a check instantiation that also
returns the three moments of each step's final y (:func:`chain_moments`:
the sum, the sum of squares and the sum weighted by ``i % 31``, i the
row-major index in the step's (384, K) y): float64 for the float modes,
int64 sums modulo 2^64 for the int modes, which any summation order gives
bitwise. In ``bf16`` it also returns a trace, one row of each 64-row tile
after each product, which :func:`check_rounding` holds product by product
against the bf16 rounding of the exact product of the row before. The
timed instantiation writes only the TPU kernel's output.

**The f32 kernel** (csrc/dot_chain.cu, namespace chain32). What bounds it
is the multiply-adds at the f32 FMAs and 3xTF32 together (1.750 / 3.110
ms at K=384 / 512 for 256 steps) and, behind them, W's hi and lo planes,
re-read from L2 every product of a 64-row tile. A 64-row y tile in f32
and a whole-width chunk of W do not fit one block, so a cluster of
:data:`F32_CLUSTER` blocks shares a tile, each block holding all of y
and computing half of the columns: W^T's planes (packed once by
:func:`pack_weights`, split as the kernel splits) come by TMA bulk copies
into a ring, y's fragments are split in registers, wgmma m64n(K/4)k8 tf32,
each 32-k chunk's 12 wgmmas summed from zero and added into the product's
f32 total. A block takes a product's chunks from its own half of y on
(:func:`f32_chunk_order`): it runs the first half on the columns it wrote
itself, and the two blocks swap their halves through distributed shared
memory halfway through the product. :func:`f32_geometry` mirrors its shared
memory, :func:`plan` reads its launch on the card,
:func:`dot_chain_f32_stop` times its parts. Its CPU test (the sum order
emulated, the packing, the geometry) is tests/test_torch_mr_dc_tc.py.

**The bf16 kernel** (csrc/dot_chain.cu, namespace chain16). What bounds it
is the bf16 multiply-adds (0.41 / 0.73 ms at K=384 / 512 for 256 steps)
and, behind them, W: a 64-row tile re-reads the whole of W every product.
A block's copy warp streams W in chunks (64 k-columns of W^T for half the
n, packed contiguous by :func:`pack_weights`) into a ring of stages by TMA
bulk copies with mbarriers, shared by the blocks of a cluster (each copies
its share of a chunk into every block's stage, multicast), while two
warpgroups multiply: wgmma m64n(K/2)k16 reading y and the chunk from
shared memory in the 128-byte swizzle. :func:`plan` reads the kernel's
choice of cluster size on the card, :func:`bf16_geometry` mirrors its
shared memory; every cluster size (``cluster`` of :func:`dot_chain`)
computes the same bits. Its CPU tests (the geometry, the packing) are
tests/test_torch_dot_chain_bf16.py.

**The s8 kernel** (int8 and int8i; csrc/dot_chain.cu, namespace chain8).
What bounds it is the s8 multiply-adds (0.205 / 0.365 ms at K=384 / 512
for 256 steps at 1,979 TOP/s). W^T stays in shared memory for the life of a
persistent block, brought from L2 once by TMA: packed by
:func:`pack_weights` in wgmma's 128-byte swizzle (128 k an atom), all of it
at K=384 and half of its rows in each block of a cluster of 2 at K=512
(:func:`s8_geometry`). Each of a block's two warpgroups walks its own
(step, tile) items (slot i, i + slots, ...; :func:`s8_walk`) with its own
64-row y tile: a product is one group of wgmma m64n192k32 / m64n256k32 s8
reading y and W^T from shared memory, the sums in registers, then y
narrowed in place ((acc >> 7) & 0xff, a wrap) or, for int8i, refilled with
the next constant while the sums go on. At K=512 the two blocks of a pair swap their new halves of y
by a bulk copy between their shared memories after every int8 product.
:func:`plan` reads its launch on the card. Its CPU test (a numpy model of
the index maps through exact integer products, the geometry, the item
walk) is tests/test_torch_dc_s8_tc.py.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _kernels
from .tf32_bars import tf32_round

GRID, DEPTH, M = 256, 14, 384  # probe_int8.py:51-53
KS = (384, 512)
MODES = ("f32", "bf16", "int8", "int8i")
_MODE_CODE = {m: i for i, m in enumerate(MODES)}
TM = 64    # csrc/dot_chain.cu: a block's rows
TILES = M // TM
TRACE_STRIDE = 13  # the traced row of tile t: 13 t % TM
POS_PERIOD = 31
_P, _I = ctypes.c_void_p, ctypes.c_int

KERNEL = _kernels.Kernel(
    "dot_chain", "dot_chain",
    [_P, _P, _P, _P, _P, _P,      # x, packed W, out, moments, trace, sink
     _I, _I, _I, _I, _I, _P])     # sink_at, steps, K, mode, variant, stream

# the bf16 chain's geometry (csrc/dot_chain.cu, namespace chain16), which
# bf16_geometry mirrors: clusters of BF16_CLUSTERS blocks along a step's
# TILES (each divides it); a chunk is 64 k-columns of W^T
# for half of the n, BF16_ROW bytes an n; BF16_ALIGN bytes to start the
# planes on the swizzle's period, the y tile (TM x K bf16) and a ring of at
# most BF16_MAX_STAGES chunks with two 8-byte barriers each fill what a
# block's static shared memory (at most 1 KB) leaves of SMEM_BYTES
BF16_CLUSTERS = (1, 2, 3, 6)
BF16_KA, BF16_ROW, BF16_MAX_STAGES, BF16_THREADS = 64, 128, 8, 288
BF16_ALIGN, SMEM_BYTES = 1024, 232448


class Bf16Geometry(NamedTuple):
    """The bf16 chain's shared memory at K (:func:`bf16_geometry`): bytes
    a chunk, of the y tile, ring stages and the block's dynamic bytes."""

    chunk: int
    y_bytes: int
    stages: int
    smem: int


def bf16_geometry(K: int) -> Bf16Geometry:
    """csrc/dot_chain.cu's ``chain16::Geo<K>``."""
    if K % 128:
        raise ValueError(f"K must be a multiple of 128, got {K}")
    chunk, y = K // 2 * BF16_ROW, TM * K * 2
    budget = SMEM_BYTES - 1024 - BF16_ALIGN
    stages = min(BF16_MAX_STAGES, (budget - y - 16 * BF16_MAX_STAGES)
                 // chunk)
    return Bf16Geometry(chunk, y, stages,
                        BF16_ALIGN + y + stages * (chunk + 16))


# the f32 chain's geometry (csrc/dot_chain.cu, namespace chain32), which
# f32_geometry mirrors: clusters of F32_CLUSTER blocks on a tile, a block
# K / F32_CLUSTER columns; a plane is W^T's rows of those columns for F32_BK
# k (F32_ROW bytes a row), hi or lo; a unit of the ring holds both planes
# of a chunk where two such units fit, else one plane; ALIGN bytes, a ring
# of at most F32_MAX_UNITS units with two 8-byte barriers each and the y
# tile (TM x K f32) fill what a block's static shared memory (at most 1 KB)
# leaves of SMEM_BYTES; F32_THREADS a block
F32_CLUSTER, F32_BK, F32_ROW, F32_MAX_UNITS, F32_THREADS = 2, 32, 128, 8, 256
F32_STOPS = {"one_pass": 1, "no_exchange": 2, "no_feed": 3}

KERNEL_F32_STOP = _kernels.Kernel(
    "dot_chain_f32_stop", "dot_chain_f32_stop",
    [_P, _P, _P, _P,              # x, packed W, out, sink
     _I, _I, _I, _P])             # steps, K, stop, stream


class F32Geometry(NamedTuple):
    """The f32 chain's launch shape at K (:func:`f32_geometry`): the
    blocks a ``cluster``, each block's ``cols`` and each warpgroup's
    ``width`` (the wgmma's n), the planes a ring unit holds (``planes``:
    2, a whole chunk, or 1) and its bytes (``unit``), of the ``y`` tile,
    the ring's ``units`` and the block's dynamic ``smem`` bytes."""

    cluster: int
    cols: int
    width: int
    planes: int
    unit: int
    y_bytes: int
    units: int
    smem: int


def f32_chunk_order(K: int, rank: int) -> list[int]:
    """The 32-k chunks of a product in the order block ``rank`` of the f32
    chain's cluster sums them for its columns: from its own half of y on,
    wrapping around."""
    chunks = K // F32_BK
    return [(i + rank * chunks // 2) % chunks for i in range(chunks)]


def f32_geometry(K: int) -> F32Geometry:
    """csrc/dot_chain.cu's ``chain32::Geo<K>``."""
    if K % (64 * F32_CLUSTER):
        raise ValueError(f"K must be a multiple of {64 * F32_CLUSTER}, got "
                         f"{K}")
    cols = K // F32_CLUSTER
    plane, y = cols * F32_ROW, TM * K * 4
    room = SMEM_BYTES - 1024 - BF16_ALIGN - y - 16 * F32_MAX_UNITS
    planes = 2 if room // (2 * plane) >= 2 else 1
    unit = planes * plane
    units = min(F32_MAX_UNITS, room // unit)
    return F32Geometry(F32_CLUSTER, cols, cols // 2, planes, unit, y, units,
                       BF16_ALIGN + units * unit + y + 16 * units)


# the s8 chains' geometry (csrc/dot_chain.cu, namespace chain8), which
# s8_geometry mirrors: S8_WARPGROUPS warpgroups a block, an item each; W^T
# in atoms of S8_KA k (one 128-byte swizzle row an n); clusters of 1 block
# at K=384 and 2 at K=512, each block holding K / cluster of W^T's rows
S8_WARPGROUPS, S8_KA, S8_THREADS = 2, 128, 256


class S8Geometry(NamedTuple):
    """The s8 chains' launch shape at K (:func:`s8_geometry`): blocks a
    ``cluster``, each block's ``cols`` of every product, the wgmmas' n
    (``width``) and their number a k32 step (``parts``), the ``atoms`` of
    128 k, a block's W^T bytes (``w_bytes``), a warpgroup's ``y`` tile
    bytes, the block's dynamic ``smem`` bytes and a thread's s32 sums
    (``sums``)."""

    cluster: int
    cols: int
    width: int
    parts: int
    atoms: int
    w_bytes: int
    y_bytes: int
    smem: int
    sums: int


def s8_geometry(K: int) -> S8Geometry:
    """csrc/dot_chain.cu's ``chain8::Geo<K>``."""
    if K not in KS:
        raise ValueError(f"the s8 kernel takes K in {KS}, got {K}")
    cluster = 1 if K == 384 else 2
    cols, width = K // cluster, K // 2
    atoms = K // S8_KA
    w_bytes, y = atoms * cols * S8_KA, TM * K
    return S8Geometry(cluster, cols, width, cols // width, atoms, w_bytes, y,
                      BF16_ALIGN + w_bytes + S8_WARPGROUPS * y, cols // 2)


def s8_walk(steps: int, active: int) -> list[range]:
    """The items (step * TILES + tile) each warpgroup slot of the s8
    chains' launch runs, in order, on a card that runs ``active`` clusters
    at once (:attr:`Plan.clusters`): min(active, ceil(items / 2)) clusters
    (csrc/dot_chain.cu's ``chain8::launch``), warpgroup h of cluster i the
    slot i S8_WARPGROUPS + h, its items slot, slot + slots, ... (every
    block of the cluster runs them)."""
    items = steps * TILES
    slots = min(active, -(-items // S8_WARPGROUPS)) * S8_WARPGROUPS
    return [range(slot, items, slots) for slot in range(slots)]


class Plan(NamedTuple):
    """A chain's launch on the card (csrc/dot_chain.cu's dot_chain_plan):
    blocks a ``cluster``, ring ``stages``, dynamic ``smem`` bytes a block,
    ``chunk`` bytes, ``threads`` a block, the ``clusters`` of that size the
    card runs at once, the SMs they cover (``sms_used``) and the card's
    ``sms``. The s8 chains hold W^T: one stage, ``chunk`` the block's W^T
    bytes."""

    cluster: int
    stages: int
    smem: int
    chunk: int
    threads: int
    clusters: int
    sms_used: int
    sms: int


@functools.lru_cache(maxsize=64)
def _plan(device: int, K: int, mode: int, variant: int) -> Plan:
    lib = _kernels.library()
    fn = lib.dot_chain_plan
    fn.argtypes = [_I, _I, _I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 8)()
    with torch.cuda.device(device):
        err = fn(K, mode, variant, out)
    if err:
        raise RuntimeError(f"dot_chain_plan(K={K}, mode={mode}, variant="
                           f"{variant}): CUDA error {err}: "
                           f"{lib.sst_cuda_error_string(err).decode()}")
    return Plan(*out)


def _variant(cluster: int, mode: str = "bf16") -> int:
    """csrc/dot_chain.cu's variant code: the bf16 chain's cluster size (0:
    the kernel's choice); the other modes take none."""
    if mode != "bf16":
        if cluster:
            raise ValueError(f"cluster is the bf16 chain's, not {mode!r}'s "
                             "(the f32 chain's clusters are of "
                             f"{F32_CLUSTER})")
        return 0
    if cluster not in (0,) + BF16_CLUSTERS:
        raise ValueError(f"cluster must be 0 (the kernel's choice) or one "
                         f"of {BF16_CLUSTERS}, got {cluster}")
    return cluster


def plan(K: int, cluster: int = 0, device=None, mode: str = "bf16") -> Plan:
    """The ``mode`` chain's launch at K on a card (the current one by
    default); bf16's ``cluster`` 0 for the kernel's choice (the largest
    cluster whose clusters cover at least 15/16 of the SMs at once). For
    f32, ``stages`` and ``chunk`` are the ring's units and a unit's bytes
    (:class:`F32Geometry`); for int8 and int8i one stage of the block's W^T
    (:class:`S8Geometry`)."""
    if K not in KS:
        raise ValueError(f"the kernel takes K in {KS}, got {K}")
    _check_mode(mode, K)
    variant = _variant(cluster, mode)
    device = torch.device("cuda" if device is None else device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return _plan(index, K, _MODE_CODE[mode], variant)


def _check_mode(mode: str, K: int) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; the probe has {MODES}")
    if K < 1:
        raise ValueError(f"K must be positive, got {K}")


def make_weights(mode: str, K: int) -> torch.Tensor:
    """The port's W for ``mode`` (module docstring): f32 (K, K) for f32
    and bf16 (bf16 values held in f32), int8 (K, K) for the int modes."""
    _check_mode(mode, K)
    rng = np.random.default_rng(1)
    if mode.startswith("int8"):
        return torch.from_numpy(rng.integers(-128, 128, (K, K),
                                             dtype=np.int8))
    w = torch.from_numpy((rng.standard_normal((K, K)) / np.sqrt(K))
                         .astype(np.float32))
    return w.to(torch.bfloat16).float() if mode == "bf16" else w


def pack_weights(w: torch.Tensor, mode: str) -> torch.Tensor:
    """W as the kernel reads it: for ``f32``, W transposed and split as
    the kernel splits (hi = TF32(w), lo = TF32(w - hi)), (2 K, K) f32 in
    the f32 chain's chunk layout: chunk c (32 k-columns) after chunk, the
    hi plane then the lo plane, each n's 128 bytes in turn, its 16-byte
    unit u (W^T[n, 32 c + 4 u ... + 3]) stored at unit u ^ (n % 8); for
    the int modes W transposed in int8, (K, K), in the s8 chains' layout:
    for each block r of the cluster (:func:`s8_geometry`: its rows r cols
    ... of W^T) atom a (128 k-columns) after atom, each of its n's 128
    bytes in turn, its 16-byte unit u (W^T[r cols + n, 128 a + 16 u ...
    + 15]) stored at unit u ^ (n % 8), so that a block's planes are one
    contiguous run in wgmma's 128-byte swizzle; for ``bf16`` W transposed
    in bf16, (K, K), in the chain's chunk layout: atom a (64 k-columns)
    after atom, each n's 128 bytes in turn, its 16-byte unit u (W^T[n, 64
    a + 8 u ... + 7]) stored at unit u ^ (n % 8), so that a chunk is one
    contiguous copy in wgmma's 128-byte swizzle."""
    K = w.shape[0]
    n = torch.arange(K, device=w.device)[:, None]
    swizzle = torch.arange(8, device=w.device)[None, :] ^ (n % 8)
    if mode.startswith("int8"):
        geo = s8_geometry(K)
        units = w.t().to(torch.int8).reshape(geo.cluster, geo.cols,
                                             geo.atoms, 8, 16)
        units = units.permute(0, 2, 1, 3, 4)[:, :, n[:geo.cols],
                                             swizzle[:geo.cols]]
        return units.reshape(K, K).contiguous()
    if mode == "f32":
        wt = w.t().to(torch.float32).contiguous()
        hi = tf32_round(wt)
        planes = torch.stack([hi, tf32_round(wt - hi)])  # (2, n, k)
        units = planes.reshape(2, K, K // F32_BK, 8, 4)
        units = units.permute(2, 0, 1, 3, 4)[:, :, n, swizzle]
        return units.reshape(2 * K, K).contiguous()
    units = w.t().to(torch.bfloat16).reshape(K, K // BF16_KA, 8, 8)
    units = units.permute(1, 0, 2, 3)[:, n, swizzle]  # [a][n][u ^ n % 8]
    return units.reshape(K, K).contiguous()


def _steps(x: torch.Tensor) -> int:
    if x.dtype != torch.uint8 or x.ndim != 2 or x.shape[1] != 128 \
            or x.shape[0] % 8:
        raise ValueError(f"x must be (steps * 8, 128) uint8, got "
                         f"{tuple(x.shape)} {x.dtype}")
    return x.shape[0] // 8


def _check_w(w: torch.Tensor, mode: str) -> int:
    K = w.shape[0]
    _check_mode(mode, K)
    want = torch.int8 if mode.startswith("int8") else torch.float32
    if w.ndim != 2 or w.shape[1] != K or w.dtype != want:
        raise ValueError(f"w must be (K, K) {want} for mode {mode!r}, got "
                         f"{tuple(w.shape)} {w.dtype}")
    return K


def seeds(x: torch.Tensor) -> torch.Tensor:
    """(steps,) int64: the sum of each step's 1,024 bytes."""
    steps = _steps(x)
    return x.reshape(steps, 8 * 128).to(torch.int64).sum(dim=1)


def _y0(s: torch.Tensor, mode: str) -> torch.Tensor:
    """The float modes' first y value of each step, f32 (bf16 values in
    bf16 mode)."""
    y0 = s.to(torch.float32) * torch.tensor(1e-6, dtype=torch.float32)
    return _round_bf16(y0) if mode == "bf16" else y0


def chain_plain(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """The plain version of the chain: (steps, 384, K) final y, f32 for the
    float modes (bf16 values held in f32), int64 for the int modes (int8:
    the s8 values; int8i: the s32 sums). f32 products run with the
    caller's TF32 setting (the port's callers turn it off); the bf16 mode
    multiplies bf16 values in f32 (exact products, f32 sums) and rounds
    each product to bf16; the int modes multiply exactly in float64 (every
    sum is an integer under 2^53)."""
    K = _check_w(w, mode)
    s = seeds(x)
    steps = s.shape[0]
    shape = (steps * M, K)
    if mode in ("f32", "bf16"):
        y = _y0(s, mode).to(x.device)[:, None].expand(steps, M * K) \
            .reshape(shape)
        wf = w.to(device=x.device, dtype=torch.float32)
        if mode == "bf16":
            wf = _round_bf16(wf)
        for _ in range(DEPTH):
            y = y @ wf
            if mode == "bf16":
                y = _round_bf16(y)
        return y.reshape(steps, M, K)
    wd = w.to(device=x.device, dtype=torch.float64)
    base = (s & 63).to(x.device)
    if mode == "int8":
        y = base.to(torch.int8)[:, None].expand(steps, M * K).reshape(shape)
        for _ in range(DEPTH):
            acc = (y.to(torch.float64) @ wd).to(torch.int64)
            y = (acc >> 7).to(torch.int8)  # a wrap modulo 256
        return y.to(torch.int64).reshape(steps, M, K)
    acc = torch.zeros(shape, dtype=torch.float64, device=x.device)
    for d in range(DEPTH):
        xd = (base + d).to(torch.int8)[:, None].expand(steps, M * K)
        acc += xd.reshape(shape).to(torch.float64) @ wd
    return acc.to(torch.int64).reshape(steps, M, K)


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def trace_plain(x: torch.Tensor, w: torch.Tensor,
                keep: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The bf16 chain's trace as the check instantiation writes it:
    (steps, TILES, DEPTH, K) bf16, the traced row of each tile after each
    product (every row of y is the same, so one row a step is computed).
    ``keep`` is the type y is held in between products: bf16 for the plain
    version; f32 or f16 give a chain that rounds other than the probe's,
    the controls that :func:`check_rounding` must fail."""
    K = _check_w(w, "bf16")
    s = seeds(x)
    y = _y0(s, "bf16").to(x.device)[:, None].expand(-1, K)
    wf = _round_bf16(w.to(device=x.device, dtype=torch.float32))
    rows = []
    for _ in range(DEPTH):
        y = (y @ wf).to(keep).to(torch.float32)
        rows.append(y.to(torch.bfloat16))
    return torch.stack(rows, dim=1)[:, None].expand(-1, TILES, -1, -1)


def output_of(y: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's output from the final y: (steps, 8, 128) f32, each
    block the sum of y[0, 0:128] (int: exact, then rounded to f32)."""
    row = y[:, 0, :128]
    s = row.sum(dim=1).to(torch.float32)
    return s[:, None, None].expand(-1, 8, 128).contiguous()


def chain_moments(y: torch.Tensor) -> torch.Tensor:
    """(steps, 3) moments of each step's final y (module docstring):
    float64 for float y, int64 modulo 2^64 for integer y."""
    steps = y.shape[0]
    flat = y.reshape(steps, -1)
    idx = torch.arange(flat.shape[1], device=y.device) % POS_PERIOD
    v = flat.to(torch.int64 if not y.is_floating_point() else torch.float64)
    return torch.stack([v.sum(dim=1), (v * v).sum(dim=1),
                        (v * idx).sum(dim=1)], dim=1)


def tile_moments(y: torch.Tensor) -> torch.Tensor:
    """(steps, TILES, 3) moments of each 64-row tile of each step's final
    y, i the row-major index in the step's (384, K) y, as the s8 kernel's
    check instantiation writes them (integer y: int64 modulo 2^64)."""
    steps, _, K = y.shape
    flat = y.reshape(steps, TILES, TM * K)
    idx = (torch.arange(M * K, device=y.device) % POS_PERIOD).reshape(
        TILES, TM * K)
    v = flat.to(torch.int64 if not y.is_floating_point() else torch.float64)
    return torch.stack([v.sum(dim=2), (v * v).sum(dim=2),
                        (v * idx).sum(dim=2)], dim=2)


def dot_chain(x: torch.Tensor, w: torch.Tensor, mode: str, *,
              impl: str = "auto", packed: Optional[torch.Tensor] = None,
              check: bool = False, cluster: int = 0):
    """probe_int8's kernel (``build(mode, K)`` called on x): x (steps * 8,
    128) uint8, w (K, K) f32 (f32, bf16) or int8 (int8, int8i), K 384 or 512
    for the kernel. Returns the (steps, 8, 128) f32 output, or with
    ``check`` the triple (output, :func:`chain_moments` of the final y, the
    trace of :func:`trace_plain` in bf16 and None in the other modes).

    ``packed`` is :func:`pack_weights` of ``w``, built once by the caller;
    without it every launch packs anew. ``impl`` as in ``ops._kernels``.
    ``cluster``: the bf16 chain's blocks a cluster, 0 for the kernel's
    choice (:func:`plan`); every cluster size computes the same bits."""
    K = _check_w(w, mode)
    variant = _variant(cluster, mode)
    steps = _steps(x)
    if not _kernels.use_kernel(impl, x):
        y = chain_plain(x, w, mode)
        out = output_of(y)
        if not check:
            return out
        return out, chain_moments(y), \
            trace_plain(x, w) if mode == "bf16" else None
    out, mom, trace = _launch(x, w, mode, packed, check, variant)
    if not check:
        return out
    return out, mom.sum(dim=1), trace


def _launch(x: torch.Tensor, w: torch.Tensor, mode: str,
            packed: Optional[torch.Tensor], check: bool, variant: int):
    """One launch of the kernel: the output and, for the check
    instantiation, its moments as the kernel writes them ((steps, TILES,
    3), f32: (steps, 2 TILES, 3)) and bf16's trace."""
    K, steps = w.shape[0], _steps(x)
    if K not in KS:
        raise ValueError(f"the kernel takes K in {KS}, got {K}")
    if packed is None:
        packed = pack_weights(w, mode)
    want = {"f32": torch.float32, "bf16": torch.bfloat16}.get(mode,
                                                             torch.int8)
    shape = (2 * K, K) if mode == "f32" else (K, K)
    if packed.shape != shape or packed.dtype != want or \
            packed.device != x.device or not packed.is_contiguous():
        raise ValueError(f"packed must be pack_weights(w, {mode!r}) on "
                         f"{x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16 or packed.data_ptr() % 16:
        raise ValueError("x and packed must be contiguous and 16-byte "
                         "aligned")
    out = torch.empty((steps, 8, 128), dtype=torch.float32, device=x.device)
    mom = None
    if check and mode.startswith("int8"):  # the kernel adds into them
        mom = torch.zeros((steps, TILES, 3), dtype=torch.int64,
                          device=x.device)
    elif check:
        parts = F32_CLUSTER if mode == "f32" else 1
        mom = torch.empty((steps, TILES * parts, 3), device=x.device,
                          dtype=torch.float64)
    trace = None
    if check and mode == "bf16":
        trace = torch.empty((steps, TILES, DEPTH, K), dtype=torch.bfloat16,
                            device=x.device)
    null = ctypes.c_void_p(0)
    sink = torch.zeros(1, dtype=torch.float32, device=x.device)
    if steps:
        KERNEL.launch(_kernels.ptr(x), _kernels.ptr(packed),
                      _kernels.ptr(out), _kernels.ptr(mom) if check else null,
                      null if trace is None else _kernels.ptr(trace),
                      _kernels.ptr(sink), -1, steps, K, _MODE_CODE[mode],
                      variant, _kernels.stream_ptr(x.device))
    return out, mom, trace


def dot_chain_f32_stop(x: torch.Tensor, w: torch.Tensor, stop: str, *,
                       packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The f32 chain's kernel with part of its work left out, to time where
    its time goes (card only; another function): ``one_pass``, hi*hi alone
    (one TF32 pass); ``no_exchange``, each block's y kept its own between
    products; ``no_feed``, W's planes brought into the ring once and re-read
    stale. Returns the (steps, 8, 128) output, which is not the chain's."""
    K = _check_w(w, "f32")
    steps = _steps(x)
    if stop not in F32_STOPS:
        raise ValueError(f"stop must be one of {sorted(F32_STOPS)}, got "
                         f"{stop!r}")
    if not x.is_cuda or K not in KS or not steps:
        raise ValueError("dot_chain_f32_stop times the kernel: x on the "
                         f"card, K in {KS}, steps >= 1")
    if packed is None:
        packed = pack_weights(w, "f32")
    out = torch.empty((steps, 8, 128), dtype=torch.float32, device=x.device)
    sink = torch.zeros(1, dtype=torch.float32, device=x.device)
    KERNEL_F32_STOP.launch(_kernels.ptr(x), _kernels.ptr(packed),
                           _kernels.ptr(out), _kernels.ptr(sink), steps, K,
                           F32_STOPS[stop], _kernels.stream_ptr(x.device))
    return out


def macs(steps: int, K: int) -> int:
    """Multiply-adds of one call: steps * 14 * 384 * K^2."""
    return steps * DEPTH * M * K * K


def bytes_moved(steps: int, K: int, mode: str) -> int:
    """Bytes a call must move: x read (1,024 a step), the (8, 128) f32
    output written a step, and the packed W read once (f32: its hi and lo
    planes)."""
    esize = {"f32": 8, "bf16": 2}.get(mode, 1)
    return steps * 1024 + steps * 4096 + K * K * esize


def library(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """The same chain as 14 library GEMMs of (steps * 384, K) x (K, K), W
    shared by every step: ``torch.matmul`` in f32 (with the caller's TF32
    setting) and in bf16, ``torch._int_mm`` for s8 with the re-narrowing
    between calls as torch ops. Returns the final y as :func:`chain_plain`
    does. A yardstick timed beside the kernel on the card; the port's path
    does not call it."""
    K = _check_w(w, mode)
    s = seeds(x)
    steps = s.shape[0]
    shape = (steps * M, K)
    if mode in ("f32", "bf16"):
        dt = torch.float32 if mode == "f32" else torch.bfloat16
        y0 = (s.to(torch.float32) * torch.tensor(1e-6)).to(dt)
        y = y0[:, None].expand(steps, M * K).reshape(shape)
        wd = w.to(dt)
        for _ in range(DEPTH):
            y = torch.matmul(y, wd)
        return y.float().reshape(steps, M, K)
    base = (s & 63).to(torch.int8)
    if mode == "int8":
        y = base[:, None].expand(steps, M * K).reshape(shape)
        for _ in range(DEPTH):
            y = (torch._int_mm(y, w) >> 7).to(torch.int8)
        return y.to(torch.int64).reshape(steps, M, K)
    acc = torch.zeros(shape, dtype=torch.int32, device=x.device)
    for d in range(DEPTH):
        xd = (base + d)[:, None].expand(steps, M * K).reshape(shape)
        acc += torch._int_mm(xd, w)
    return acc.to(torch.int64).reshape(steps, M, K)


# kernel vs plain, each value (the output, each moment) against its sum of
# |terms|, in float64. f32: each product sums K terms in f32 in another
# order than the plain version's (about sqrt(K) 2^-24 = 1.3e-6 of the row's
# norm at K=512), and W's gain (about 1: W ~ N(0, 1/K)) carries it through
# 14 products: 1e-5. bf16: two sound chains agree bitwise until their f32
# sums, taken in other orders, put one value on the other side of a bf16
# rounding boundary (one flip, one bf16 step apart). From that product on,
# W (gain about 1) spreads the flip over the row and the next roundings
# differ in the two: each product adds at most half a bf16 step (2^-8 of a
# value) of rounding noise of its own, so after the at most 14 products
# left a value differs by about sqrt(14) 2^-8 = 1.5e-2 of its magnitude,
# and a moment by no more of its sum of |terms|: 2e-2. That bar holds the
# placement and the scale of every row; a chain that skips the rounding
# stays under it too, so the bf16 rounding itself is held product by
# product on the traced rows (:func:`check_rounding`). int8, int8i: exact,
# bitwise.
BAR_F32, BAR_BF16 = 1e-5, 2e-2
# check_rounding: a bf16 y value is the bf16 rounding of an f32 sum of its
# K products (bf16 x bf16 is exact in f32). Any order of the K - 1 adds,
# each off by at most 2^-23 of a partial sum even where it truncates, lands
# within K 2^-23 of the terms' sum of |terms| from the exact sum; the
# window is twice that, and rounding is monotone, so a sound chain's every
# value lies between the bf16 roundings of its window's ends.
ROUND_SLACK = 2


def compare(out: torch.Tensor, mom: torch.Tensor, y: torch.Tensor,
            mode: str) -> dict:
    """A kernel's output and moments against those of the plain final y
    (:func:`chain_plain`): the largest difference and the largest share of
    the bar (int modes: bitwise, share 0 or inf). Raises over the bar."""
    want_out, want_mom = output_of(y), chain_moments(y)
    if out.shape != want_out.shape or mom.shape != want_mom.shape:
        raise RuntimeError(f"dot_chain {mode}: shapes {tuple(out.shape)}, "
                           f"{tuple(mom.shape)} off the plain version's")
    err = max((out.double() - want_out.double()).abs().max().item(),
              (mom.double() - want_mom.double()).abs().max().item())
    if mode.startswith("int8"):
        share = 0.0 if torch.equal(out, want_out) and \
            torch.equal(mom, want_mom) else float("inf")
        rel = 0.0
    else:
        rel = BAR_F32 if mode == "f32" else BAR_BF16
        bar_out = rel * y[:, 0, :128].double().abs().sum(dim=1)
        bar_mom = rel * chain_moments(y.abs())
        e_out = (out.double() - want_out.double()).abs().amax(dim=(1, 2))
        e_mom = (mom - want_mom).abs()
        share = max((e_out / bar_out.clamp(min=1e-300)).max().item(),
                    (e_mom / bar_mom.clamp(min=1e-300)).max().item())
    if not (torch.isfinite(out).all() and share <= 1.0):
        raise RuntimeError(f"dot_chain {mode} K={y.shape[2]}: off the plain "
                           f"version (largest difference {err:.3e}; bar: "
                           f"{rel:g} of each value's sum of |terms|, 0 for "
                           f"the int modes)")
    return {"max_abs_err": err, "share_of_bar": share}


def rounding_outside(trace: torch.Tensor, x: torch.Tensor,
                     w: torch.Tensor) -> int:
    """The bf16 chain's trace (:func:`dot_chain` with ``check``, or
    :func:`trace_plain`) product by product: the number of traced values
    (or non-finite ones) outside the bf16 roundings of the ends of their
    window, the exact product of the row before (the step's first y before
    the first product) within ``ROUND_SLACK K 2^-23`` of its sum of
    |terms|. 0 for a sound chain."""
    K = _check_w(w, "bf16")
    s = seeds(x)
    if trace.shape != (s.shape[0], TILES, DEPTH, K) or \
            trace.dtype != torch.bfloat16:
        raise ValueError(f"trace must be ({s.shape[0]}, {TILES}, {DEPTH}, "
                         f"{K}) bf16, got {tuple(trace.shape)} {trace.dtype}")
    y0 = _y0(s, "bf16").to(device=trace.device, dtype=torch.float64)
    prev = torch.cat([y0[:, None, None, None].expand(-1, TILES, 1, K),
                      trace[:, :, :-1].to(torch.float64)], dim=2)
    wd = _round_bf16(w.to(device=trace.device, dtype=torch.float32)).double()
    z = prev @ wd
    e = ROUND_SLACK * K * 2.0 ** -23 * (prev.abs() @ wd.abs())
    lo, hi = _round_bf16((z - e).float()), _round_bf16((z + e).float())
    v = trace.float()
    return int(((v < lo) | (v > hi) | ~torch.isfinite(v)).sum().item())


def check_rounding(trace: torch.Tensor, x: torch.Tensor,
                   w: torch.Tensor) -> None:
    """Raises if a traced value is not a bf16 rounding of its product
    (:func:`rounding_outside`)."""
    outside = rounding_outside(trace, x, w)
    if outside:
        raise RuntimeError(
            f"dot_chain bf16: {outside} of {trace.numel()} traced values are "
            "not a bf16 rounding of their product's f32 sum (off the plain "
            "version)")


def check(x: torch.Tensor, w: torch.Tensor, mode: str, *,
          packed: Optional[torch.Tensor] = None) -> dict:
    """The kernel against the plain version on x's device: the check
    instantiation's output and moments (:func:`compare`; the int modes'
    also tile by tile, :func:`tile_moments`, bitwise) and, in bf16, its
    trace (:func:`check_rounding`); then the timed instantiation's output,
    which must be bitwise the check instantiation's."""
    _check_w(w, mode)
    if not x.is_cuda:
        raise ValueError("check holds the kernel: x on the card")
    out, tiles, trace = _launch(x, w, mode, packed, True, 0)
    y = chain_plain(x, w.to(x.device), mode)
    r = compare(out, tiles.sum(dim=1), y, mode)
    if mode.startswith("int8") and not torch.equal(tiles, tile_moments(y)):
        raise RuntimeError(f"dot_chain {mode}: a tile's moments are off the "
                           "plain version's")
    if trace is not None:
        check_rounding(trace, x, w)
    timed = dot_chain(x, w, mode, impl="kernel", packed=packed)
    if not torch.equal(timed, out):
        raise RuntimeError(f"dot_chain {mode}: the timed instantiation's "
                           "output is not bitwise the check instantiation's")
    return r
