"""The backward-dot probes' kernels (csrc/bwd_dots.cu) and their plain
PyTorch versions: the ports of the Pallas kernels of scripts/
proto_bwd_dots.py (``run_tt``, ``run_nt``), proto_bwd_dots2.py (``_make``
with ``_k_base``, ``_k_tt``, ``_k_xp``) and proto_bwd_dots3.py (``_make``
with ``_k_tt``, ``_k_nn``).

The functions, f32 in and f32 sums, where tile g of an array holds its rows
[g m, g m + m) and G = rows // m (the rows past G m are dropped, as the
TPU grid drops them):

- ``bwd_dot_tt(p, dy, m, steps)``: out (K, N) = the sum over steps s of
  p_g^T dy_g, g = s % G, each step's product added in step order (dots1 and
  dots2: steps = G; dots3: G = 1 and 512 steps of the same product);
- ``bwd_dot_xp(p, dy, m)``: the same function, through an explicit
  transpose of p (``jnp.swapaxes`` in VMEM on the TPU; a pass of its own
  into shared memory on the card);
- ``bwd_dot_nt(dy, w, m)``: out (rows, K), out[g] = dy_g w^T; the rows
  past G m, which the TPU kernel leaves unwritten, are zeros;
- ``bwd_dot_base(p, w, m)``: out (1, N) = the sum over g of the column
  sums of p_g @ w, every product computed (not colsum(p) @ w);
- ``bwd_dot_nn(pk, dy, steps)``: out (K, N) = the sum over steps of
  pk (K, M) @ dy (M, N), every product computed.

``memory_space=VMEM``, ``vmem_limit_bytes`` and ``interpret`` have no
counterpart on the card. The steps kernels (tt, xp, nn) split the steps
into groups of whole tiles, a block an output tile and a group, and add the
groups' partials in group order; base's persistent blocks write each
128-row tile's column sums, added in step order by a second kernel: no
atomics, two launches on the same inputs are bitwise equal. tt, xp, nn and
base form their products on the tensor cores as 3xTF32 (m16n8k8 TF32
mma.sync, x = hi + lo, three MMAs a product, f32 sums; 128 x 128 output
tiles fed by one mainloop, a ring of cp.async stages); xp is tt with each p
chunk written transposed into shared memory by a pass of its own (the next
chunk while the MMAs read this one), so its result is bitwise tt's; nt as
3xTF32 on wgmma (dy split in registers, w split into hi / lo planes by a
small kernel at each call, persistent blocks over 128 x 104 or 128 x 128
tiles of out, each chunk of 32 of N summed from zero and the chunks added
in f32). :func:`plan`
reports a kernel's tile and groups (on the card only). ``impl`` as in
``ops._kernels``. :data:`KINDS` names the five by kind, each with its
wrapper, plain version, counts, route and the rate its bound is taken at,
for :func:`run`, :func:`plain`, :func:`compare` and :func:`check`.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from . import _kernels
from .tf32_bars import BAR_DEPTH, bar64, shares, tf32_round

ROWS = 8192 * 12  # proto_bwd_dots.py:91, proto_bwd_dots2.py:77
STEPS = 512       # proto_bwd_dots3.py:17
_P, _I = ctypes.c_void_p, ctypes.c_int

# the steps kernels (tt, xp, nn) size their groups to one wave of blocks
# from the shapes alone (csrc/bwd_dots.cu, groups()); bwd_dot_scratch says
# how many floats of partial sums a launch needs (base: a row of N a
# 128-row tile of a step), by its layout number
_LAYOUT = {"tt": 0, "nn": 1, "xp": 2, "base": 3, "nt": 4}
_STEPS_ARGS = [_P, _P, _P, _P,            # p, dy, out, partial
               _I, _I, _I, _I, _I,        # K, N, m, G, steps
               _P]                        # stream
KERNEL_TT = _kernels.Kernel("bwd_dot_tt", "bwd_dot_tt", _STEPS_ARGS)
# bwd_dot_tt's kernel stopped after a part of its mainloop, to time the
# parts (csrc/bwd_dots.cu tc::Stop), in this order
STOPS = ("all", "one_pass", "feed", "ring")
KERNEL_TT_STOP = _kernels.Kernel(
    "bwd_dot_tt_stop", "bwd_dot_tt_stop",
    _STEPS_ARGS[:-1] + [_I, _P])          # ..., steps, stop, stream
KERNEL_XP = _kernels.Kernel("bwd_dot_xp", "bwd_dot_xp", _STEPS_ARGS)
_NT_ARGS = [_P, _P, _P, _P,               # dy, w, out, wt
            _I, _I, _I, _I,               # rows, Gm, N, K
            _P]                           # stream
KERNEL_NT = _kernels.Kernel("bwd_dot_nt", "bwd_dot_nt", _NT_ARGS)
# bwd_dot_nt's kernel in three TF32 passes or one, to time what the two
# extra passes cost
KERNEL_NT_STOP = _kernels.Kernel(
    "bwd_dot_nt_stop", "bwd_dot_nt_stop",
    _NT_ARGS[:-1] + [_I, _P])             # ..., K, passes, stream
KERNEL_NN = _kernels.Kernel(
    "bwd_dot_nn", "bwd_dot_nn",
    [_P, _P, _P, _P, _I, _I, _I, _I, _P])  # pk, dy, out, partial, K, M, N,
                                           # steps, stream
KERNEL_BASE = _kernels.Kernel(
    "bwd_dot_base", "bwd_dot_base",
    [_P, _P, _P, _P, _I, _I, _I, _I, _P])  # p, w, out, partial, K, N, m, G,
                                           # stream


def _f32_2d(name: str, t: torch.Tensor) -> None:
    if t.ndim != 2 or t.dtype != torch.float32:
        raise ValueError(f"{name} must be a 2-d f32 tensor, got "
                         f"{tuple(t.shape)} {t.dtype}")


def _tiles(rows: int, m: int) -> int:
    if m < 1 or rows < m:
        raise ValueError(f"m must be in [1, rows={rows}], got {m}")
    return rows // m


def _same_rows(a: torch.Tensor, b: torch.Tensor, m: int) -> int:
    _f32_2d("p", a)
    _f32_2d("dy", b)
    if a.shape[0] != b.shape[0]:
        raise ValueError(f"p and dy need the same rows, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    return _tiles(a.shape[0], m)


def _launchable(*ts: torch.Tensor) -> None:
    if any(t.device != ts[0].device or not t.is_contiguous() for t in ts):
        raise ValueError("the operands must be contiguous and on one device")


def _scratch(kind: str, Mo: int, No: int, steps: int,
             device: torch.device) -> torch.Tensor:
    """The partial sums a steps kernel of ``kind`` needs at these shapes."""
    fn = _kernels.library().bwd_dot_scratch
    fn.argtypes = [_I, _I, _I, _I]
    fn.restype = ctypes.c_longlong
    n = fn(_LAYOUT[kind], Mo, No, steps)
    if n < 0:
        raise RuntimeError(f"bwd_dot_scratch: no layout for {kind!r}")
    return torch.empty(n, dtype=torch.float32, device=device)


class Plan(NamedTuple):
    """A kernel's launch at some shapes (csrc/bwd_dots.cu,
    ``bwd_dot_plan``): the output tile (``tile_m`` x ``tile_n``), the
    contraction rows a chunk, threads a block, ring stages (xp: 3 beside
    its two planes, else 4), dynamic shared memory bytes, output tiles,
    groups, steps a group, and the blocks an SM holds by the card's
    occupancy query (the groups assume 1). For base, ``tiles`` counts its
    items (row tiles of the steps x column tiles), ``groups`` its
    persistent blocks and ``steps_per_group`` the items a block walks, at
    most; for nt the same of its tiles of out."""

    tile_m: int
    tile_n: int
    chunk: int
    threads: int
    stages: int
    smem_bytes: int
    tiles: int
    groups: int
    steps_per_group: int
    resident_per_sm: int


def plan(kind: str, Mo: int, No: int, steps: int) -> Plan:
    """The launch of ``kind``'s kernel: tt, nn or xp for Mo x No outputs
    over ``steps`` steps; base for Mo = m rows a step, No = N columns and
    steps = G steps; nt for Mo = G m rows of out, No = K columns and steps
    = N. Builds the kernels, so on the card only."""
    if kind not in _LAYOUT:
        raise ValueError(f"no plan for {kind!r}; one of {tuple(_LAYOUT)}")
    fn = _kernels.library().bwd_dot_plan
    fn.argtypes = [_I, _I, _I, _I, ctypes.POINTER(_I)]
    fn.restype = _I
    out = (_I * len(Plan._fields))()
    err = fn(_LAYOUT[kind], Mo, No, steps, out)
    if err:
        raise RuntimeError(f"bwd_dot_plan: CUDA error {err}")
    return Plan(*out)


# ------------------------------------------------------ plain versions


def _steps_plain(product, G: int, m: int, steps: int) -> torch.Tensor:
    out = None
    for s in range(steps):
        g = s % G
        v = product(slice(g * m, g * m + m))
        out = v if out is None else out + v
    return out


def bwd_dot_tt_plain(p: torch.Tensor, dy: torch.Tensor, m: int,
                     steps: Optional[int] = None) -> torch.Tensor:
    """run_tt / ``_k_tt``: the sum of p_g^T dy_g, step by step, in step
    order; matmuls with the caller's TF32 setting."""
    G = _same_rows(p, dy, m)
    return _steps_plain(lambda r: p[r].T @ dy[r], G, m,
                        G if steps is None else steps)


def bwd_dot_xp_plain(p: torch.Tensor, dy: torch.Tensor,
                     m: int) -> torch.Tensor:
    """``_k_xp``: each tile of p transposed into a copy of its own, then
    the product, added in tile order."""
    G = _same_rows(p, dy, m)
    return _steps_plain(lambda r: p[r].t().contiguous() @ dy[r], G, m, G)


def bwd_dot_nt_plain(dy: torch.Tensor, w: torch.Tensor,
                     m: int) -> torch.Tensor:
    """run_nt: out[g] = dy_g w^T, tile by tile; the tail rows zeros."""
    _f32_2d("dy", dy)
    _f32_2d("w", w)
    G = _tiles(dy.shape[0], m)
    out = torch.zeros((dy.shape[0], w.shape[0]), dtype=torch.float32,
                      device=dy.device)
    for g in range(G):
        out[g * m:g * m + m] = dy[g * m:g * m + m] @ w.T
    return out


def bwd_dot_base_plain(p: torch.Tensor, w: torch.Tensor,
                       m: int) -> torch.Tensor:
    """``_k_base``: the column sums of p_g @ w, added in tile order; every
    product computed."""
    _f32_2d("p", p)
    _f32_2d("w", w)
    G = _tiles(p.shape[0], m)
    return _steps_plain(lambda r: (p[r] @ w).sum(dim=0, keepdim=True), G, m,
                        G)


def _nn_operands(pk: torch.Tensor, dy: torch.Tensor, steps: int) -> None:
    _f32_2d("pk", pk)
    _f32_2d("dy", dy)
    if pk.shape[1] != dy.shape[0] or steps < 1:
        raise ValueError(f"pk (K, M), dy (M, N) and steps >= 1, got "
                         f"{tuple(pk.shape)}, {tuple(dy.shape)}, {steps}")


def bwd_dot_nn_plain(pk: torch.Tensor, dy: torch.Tensor,
                     steps: int = STEPS) -> torch.Tensor:
    """dots3's ``_k_nn``: pk @ dy computed anew in each step and added in
    step order."""
    _nn_operands(pk, dy, steps)
    return _steps_plain(lambda r: pk @ dy, 1, dy.shape[0], steps)


# ------------------------------------------------------------ wrappers


def _steps(kind: str, p: torch.Tensor, dy: torch.Tensor, m: int, G: int,
           steps: int) -> torch.Tensor:
    _launchable(p, dy)
    K, N = p.shape[1], dy.shape[1]
    kernel = KERNEL_XP if kind == "xp" else KERNEL_TT
    out = torch.empty((K, N), dtype=torch.float32, device=p.device)
    partial = _scratch(kind, K, N, steps, p.device)
    kernel.launch(_kernels.ptr(p), _kernels.ptr(dy), _kernels.ptr(out),
                  _kernels.ptr(partial), K, N, m, G, steps,
                  _kernels.stream_ptr(p.device))
    return out


def bwd_dot_tt(p: torch.Tensor, dy: torch.Tensor, m: int,
               steps: Optional[int] = None, *,
               impl: str = "auto") -> torch.Tensor:
    """p (rows, K), dy (rows, N) f32 -> (K, N): the sum over ``steps``
    (default G) steps of p_g^T dy_g, g = step % G."""
    G = _same_rows(p, dy, m)
    steps = G if steps is None else steps
    if steps < 1:
        raise ValueError(f"steps >= 1, got {steps}")
    if not _kernels.use_kernel(impl, p):
        return bwd_dot_tt_plain(p, dy, m, steps)
    return _steps("tt", p, dy, m, G, steps)


def bwd_dot_tt_stop(p: torch.Tensor, dy: torch.Tensor, m: int, stop: str,
                    steps: Optional[int] = None) -> torch.Tensor:
    """bwd_dot_tt's kernel with its mainloop stopped after a part, on the
    card only, to time the parts (:data:`STOPS`): ``all`` of it (bwd_dot_tt
    itself, bitwise); ``one_pass``, hi*hi alone (one TF32 pass: another
    function); ``feed``, the fragment loads and hi/lo splits without MMAs
    (each split value folded into the sums by one XOR); ``ring``, the
    cp.async ring and its barriers alone (the sums zero). K and N
    multiples of 4 (16-byte rows)."""
    G = _same_rows(p, dy, m)
    steps = G if steps is None else steps
    if stop not in STOPS:
        raise ValueError(f"unknown stop {stop!r}; one of {STOPS}")
    if not p.is_cuda:
        raise ValueError("bwd_dot_tt_stop times the card's kernel: it needs "
                         f"CUDA tensors, got one on {p.device}")
    _launchable(p, dy)
    K, N = p.shape[1], dy.shape[1]
    if K % 4 or N % 4 or steps < 1:
        raise ValueError(f"K and N multiples of 4 and steps >= 1, got K={K}"
                         f" N={N} steps={steps}")
    out = torch.empty((K, N), dtype=torch.float32, device=p.device)
    partial = _scratch("tt", K, N, steps, p.device)
    KERNEL_TT_STOP.launch(_kernels.ptr(p), _kernels.ptr(dy),
                          _kernels.ptr(out), _kernels.ptr(partial), K, N, m,
                          G, steps, STOPS.index(stop),
                          _kernels.stream_ptr(p.device))
    return out


def bwd_dot_xp(p: torch.Tensor, dy: torch.Tensor, m: int, *,
               impl: str = "auto") -> torch.Tensor:
    """bwd_dot_tt's function (steps = G) through an explicit transpose:
    on the card tt's mainloop with each p chunk written transposed into one
    of two shared-memory planes by a pass of its own while the MMAs read
    the chunk before it from the other, as nn reads its A stage; the same
    values in the same MMAs, so bitwise ``bwd_dot_tt(p, dy, m)``."""
    G = _same_rows(p, dy, m)
    if not _kernels.use_kernel(impl, p):
        return bwd_dot_xp_plain(p, dy, m)
    return _steps("xp", p, dy, m, G, G)


def _nt_operands(dy: torch.Tensor, w: torch.Tensor, m: int) -> int:
    _f32_2d("dy", dy)
    _f32_2d("w", w)
    if dy.shape[1] != w.shape[1]:
        raise ValueError(f"dy (rows, N) and w (K, N), got {tuple(dy.shape)},"
                         f" {tuple(w.shape)}")
    return _tiles(dy.shape[0], m)


def _nt(kernel: _kernels.Kernel, dy: torch.Tensor, w: torch.Tensor, G: int,
        m: int, *extra: int) -> torch.Tensor:
    _launchable(dy, w)
    rows, N = dy.shape
    K = w.shape[0]
    out = torch.empty((rows, K), dtype=torch.float32, device=dy.device)
    wt = _scratch("nt", K, N, 1, dy.device)  # w's planes, made every call
    kernel.launch(_kernels.ptr(dy), _kernels.ptr(w), _kernels.ptr(out),
                  _kernels.ptr(wt), rows, G * m, N, K, *extra,
                  _kernels.stream_ptr(dy.device))
    return out


def bwd_dot_nt(dy: torch.Tensor, w: torch.Tensor, m: int, *,
               impl: str = "auto") -> torch.Tensor:
    """dy (rows, N), w (K, N) f32 -> (rows, K): dy_g w^T, zeros past G m.
    On the card 3xTF32 on wgmma: w split into hi / lo planes by a first
    kernel (which also writes the zero tail), then 128-row tiles of dy
    split in registers, each chunk of 32 of N summed from zero and the
    chunks added in f32."""
    G = _nt_operands(dy, w, m)
    if not _kernels.use_kernel(impl, dy):
        return bwd_dot_nt_plain(dy, w, m)
    return _nt(KERNEL_NT, dy, w, G, m)


def bwd_dot_nt_stop(dy: torch.Tensor, w: torch.Tensor, m: int,
                    passes: int = 3) -> torch.Tensor:
    """bwd_dot_nt's kernel with ``passes`` 3 (3xTF32, bitwise bwd_dot_nt)
    or 1 (hi*hi alone: one TF32 pass, another function), on the card only,
    to time what the two extra passes cost. N and K multiples of 4 (16-byte
    rows)."""
    G = _nt_operands(dy, w, m)
    if passes not in (1, 3):
        raise ValueError(f"passes 1 or 3, got {passes}")
    if not dy.is_cuda:
        raise ValueError("bwd_dot_nt_stop times the card's kernel: it needs "
                         f"CUDA tensors, got one on {dy.device}")
    if dy.shape[1] % 4 or w.shape[0] % 4:
        raise ValueError(f"N and K multiples of 4, got N={dy.shape[1]} "
                         f"K={w.shape[0]}")
    return _nt(KERNEL_NT_STOP, dy, w, G, m, passes)


def bwd_dot_base(p: torch.Tensor, w: torch.Tensor, m: int, *,
                 impl: str = "auto") -> torch.Tensor:
    """p (rows, K), w (K, N) f32 -> (1, N): the column sums of p_g @ w
    over the tiles, every product computed (never colsum(p) @ w). On the
    card each 128-row tile of a step times 128 columns of w as 3xTF32 on
    the tensor cores (K in chunks of 32, each from zero, added in f32),
    then the tile's column sums in a fixed order; a second kernel adds them
    in step order."""
    _f32_2d("p", p)
    _f32_2d("w", w)
    if p.shape[1] != w.shape[0]:
        raise ValueError(f"p (rows, K) and w (K, N), got {tuple(p.shape)}, "
                         f"{tuple(w.shape)}")
    G = _tiles(p.shape[0], m)
    if not _kernels.use_kernel(impl, p):
        return bwd_dot_base_plain(p, w, m)
    _launchable(p, w)
    K, N = w.shape
    out = torch.empty((1, N), dtype=torch.float32, device=p.device)
    partial = _scratch("base", m, N, G, p.device)
    KERNEL_BASE.launch(_kernels.ptr(p), _kernels.ptr(w), _kernels.ptr(out),
                       _kernels.ptr(partial), K, N, m, G,
                       _kernels.stream_ptr(p.device))
    return out


def bwd_dot_nn(pk: torch.Tensor, dy: torch.Tensor, steps: int = STEPS, *,
               impl: str = "auto") -> torch.Tensor:
    """pk (K, M), dy (M, N) f32 -> (K, N): pk @ dy, computed in each of
    ``steps`` steps and summed."""
    _nn_operands(pk, dy, steps)
    if not _kernels.use_kernel(impl, pk):
        return bwd_dot_nn_plain(pk, dy, steps)
    _launchable(pk, dy)
    (K, M), N = pk.shape, dy.shape[1]
    out = torch.empty((K, N), dtype=torch.float32, device=pk.device)
    partial = _scratch("nn", K, N, steps, pk.device)
    KERNEL_NN.launch(_kernels.ptr(pk), _kernels.ptr(dy), _kernels.ptr(out),
                     _kernels.ptr(partial), K, M, N, steps,
                     _kernels.stream_ptr(pk.device))
    return out


# ------------------------------------------------ the kinds, by one table


def _gm(shape: tuple) -> int:
    rows, m = shape[:2]
    return rows // m * m


def _or(steps: Optional[int], default: int) -> int:
    return default if steps is None else steps


class Kind(NamedTuple):
    """One function of the probes. ``wrapper`` and ``plain`` take (a, b)
    and the keywords of their signatures (``m``: the tile's rows; tt and nn
    ``steps``); ``terms(a, b, m, steps)`` is n, the products summed into
    one output element; ``macs(shape, steps)`` and ``bytes(shape)`` count
    one call on ``shape``: (rows, m, K, N), for nn (M, K, N). ``bytes``
    reads each input once (the G m rows a call reads) and writes each
    output once, f32. ``route``: where the kernel forms its products;
    ``rate``: the peak its bound is taken at (a key of
    ``scripts.proto_parity_cnn.PEAK_OPS``)."""

    wrapper: Callable[..., torch.Tensor]
    plain: Callable[..., torch.Tensor]
    terms: Callable[..., int]
    macs: Callable[..., int]
    bytes: Callable[..., int]
    route: str = "f32 FMAs"
    rate: str = "f32"


TENSOR_CORES = "3xTF32 on mma.sync"
TENSOR_CORES_WGMMA = "3xTF32 on wgmma"


def _tt_terms(a, b, m, steps):
    return _or(steps, a.shape[0] // m) * m


def _tt_macs(shape, steps):
    rows, m, K, N = shape
    return _or(steps, rows // m) * m * K * N


def _tt_bytes(shape):
    return 4 * (_gm(shape) * (shape[2] + shape[3]) + shape[2] * shape[3])


KINDS = {
    "tt": Kind(bwd_dot_tt, bwd_dot_tt_plain, _tt_terms, _tt_macs, _tt_bytes,
               TENSOR_CORES, "f32_3xtf32"),
    "xp": Kind(bwd_dot_xp, bwd_dot_xp_plain, _tt_terms, _tt_macs, _tt_bytes,
               TENSOR_CORES, "f32_3xtf32"),
    "nt": Kind(bwd_dot_nt, bwd_dot_nt_plain,
               lambda a, b, m, steps: a.shape[1], _tt_macs,
               lambda s: 4 * (_gm(s) * s[3] + s[2] * s[3] + s[0] * s[2]),
               TENSOR_CORES_WGMMA, "f32_3xtf32"),
    "base": Kind(bwd_dot_base, bwd_dot_base_plain,
                 lambda a, b, m, steps: a.shape[0] // m * m * a.shape[1],
                 _tt_macs,
                 lambda s: 4 * (_gm(s) * s[2] + s[2] * s[3] + s[3]),
                 TENSOR_CORES, "f32_3xtf32"),
    "nn": Kind(bwd_dot_nn, bwd_dot_nn_plain,
               lambda a, b, m, steps: _or(steps, STEPS) * a.shape[1],
               lambda s, steps: _or(steps, STEPS) * s[0] * s[1] * s[2],
               lambda s: 4 * (s[1] * s[0] + s[0] * s[2] + s[1] * s[2]),
               TENSOR_CORES, "f32_3xtf32"),
}


def kind_of(kind: str) -> Kind:
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; one of {tuple(KINDS)}")
    return KINDS[kind]


def _keywords(m: Optional[int], steps: Optional[int]) -> dict:
    """The keywords given; a kind's functions raise TypeError on one they do
    not take (steps for xp, nt, base; m for nn) or on a missing m."""
    return {n: v for n, v in (("m", m), ("steps", steps)) if v is not None}


def plain(kind: str, a: torch.Tensor, b: torch.Tensor, *,
          m: Optional[int] = None, steps: Optional[int] = None
          ) -> torch.Tensor:
    """The plain version of ``kind`` on (a, b)."""
    return kind_of(kind).plain(a, b, **_keywords(m, steps))


def run(kind: str, a: torch.Tensor, b: torch.Tensor, *,
        m: Optional[int] = None, steps: Optional[int] = None,
        impl: str = "auto") -> torch.Tensor:
    """The wrapper of ``kind`` on (a, b)."""
    return kind_of(kind).wrapper(a, b, **_keywords(m, steps), impl=impl)


def macs(kind: str, shape: tuple, steps: Optional[int] = None) -> int:
    """Multiply-adds of one call of ``kind`` on ``shape`` (see Kind)."""
    return kind_of(kind).macs(shape, steps)


def bytes_moved(kind: str, shape: tuple) -> int:
    """Bytes of one call of ``kind`` on ``shape`` (see Kind)."""
    return kind_of(kind).bytes(shape)


# ------------------------------------------------------------- checks

# kernel vs plain: BAR_DEPTH sqrt(n) 2^-24 of each element's sum of |terms|
# (ops/tf32_bars), n: tt and xp steps m, nt N, base G m K, nn steps M; the
# tensor-core kinds (tt, xp, base, nn, nt: 3xTF32) against the float64
# version: tf32_bars.bar64, derived in compare()
TC_KINDS = tuple(k for k, v in KINDS.items() if v.rate == "f32_3xtf32")


def reference64(kind: str, a: torch.Tensor, b: torch.Tensor, *,
                m: Optional[int] = None, steps: Optional[int] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The function of a tensor-core kind on (a, b) in float64, step by
    step, and each element's sum of |terms| (the same on |a|, |b|): tt's
    and xp's sum of p_g^T dy_g, base's column sums of p_g @ w in tile
    order, nn's sum of pk @ dy, nt's dy_g w^T (zeros past G m)."""
    if kind == "nt":
        G = _nt_operands(a, b, m)

        def nt64(x, y):
            out = torch.zeros((x.shape[0], y.shape[0]), dtype=torch.float64,
                              device=x.device)
            out[:G * m] = x[:G * m] @ y.T
            return out

        a64, b64 = a.double(), b.double()
        return nt64(a64, b64), nt64(a64.abs(), b64.abs())
    if kind in ("tt", "xp"):
        G = _same_rows(a, b, m)
        steps, product = _or(steps, G), lambda x, y, r: x[r].T @ y[r]
    elif kind == "base":
        _f32_2d("p", a)
        _f32_2d("w", b)
        G = _tiles(a.shape[0], m)
        steps, product = G, lambda x, y, r: (x[r] @ y).sum(0, keepdim=True)
    elif kind == "nn":
        steps = _or(steps, STEPS)
        _nn_operands(a, b, steps)
        G, m, product = 1, b.shape[0], lambda x, y, r: x @ y
    else:
        raise ValueError(f"no float64 version for {kind!r}; one of "
                         f"{TC_KINDS}")
    a64, b64 = a.double(), b.double()
    return tuple(_steps_plain(lambda r: product(x, y, r), G, m, steps)
                 for x, y in ((a64, b64), (a64.abs(), b64.abs())))


def one_pass(kind: str, a: torch.Tensor, b: torch.Tensor, *,
             m: Optional[int] = None, steps: Optional[int] = None
             ) -> torch.Tensor:
    """A tensor-core kind's function as one TF32 pass forms it, in f32:
    the operands rounded to TF32, their products exact and summed in
    float64. The control that :func:`compare`'s float64 bar must refuse
    where its derivation says it can."""
    return reference64(kind, tf32_round(a), tf32_round(b), m=m,
                       steps=steps)[0].float()


def measure(kind: str, got: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            *, m: Optional[int] = None, steps: Optional[int] = None
            ) -> dict:
    """:func:`compare`'s figures without its verdict: the largest
    difference from the plain version and its share of the bar; for the
    tensor-core kinds also from the float64 version (``max_abs_err64``,
    ``share_of_bar64``). Raises on a wrong shape only."""
    want = plain(kind, a, b, m=m, steps=steps)
    if got.shape != want.shape:
        raise RuntimeError(f"bwd_dot {kind}: shape {tuple(got.shape)}, want "
                           f"{tuple(want.shape)}")
    absolute = plain(kind, a.abs(), b.abs(), m=m, steps=steps)
    bar = (BAR_DEPTH * KINDS[kind].terms(a, b, m, steps) ** 0.5
           * 2.0 ** -24 * absolute)
    out = shares(got, want, bar)
    if kind in TC_KINDS:
        ref, absolute = reference64(kind, a, b, m=m, steps=steps)
        n_steps = 1 if kind == "nt" else _or(
            steps, STEPS if kind == "nn" else a.shape[0] // m)
        out.update(shares(got.double(), ref, bar64(ref, absolute, n_steps),
                          "64"))
    return out


def compare(kind: str, got: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            *, m: Optional[int] = None, steps: Optional[int] = None) -> dict:
    """A result of ``kind`` against the plain version on (a, b), and the
    tensor-core kinds' also against the float64 version: the figures of
    :func:`measure`; raises over either bar (nt's tail rows, whose sums of
    |terms| are 0, must be exact zeros).

    The float64 bar, for the kernels that form their products as 3xTF32
    (tt, xp, base, nn, nt): with ref the float64 value and A the element's sum
    of |terms|
    (:func:`reference64`), |got - ref| <= 2^-24 (32 A + steps / 2 |ref|).
    3xTF32 forms a b as ah bh + ah bl + al bh from x = hi + lo, each part
    rounded to TF32: the dropped al bl and the lo parts' roundings leave at
    most 3 2^-22 = 12 2^-24 of |a b|, and the f32 sums within a step (32
    rows at a time on the MMAs, whose accumulation truncates, then the
    chunks' sums added in f32) a few 2^-24 of A: 32 A, with room. The step sums are then added in step order in f32, each add
    within 2^-24 of its partial sum; where the steps are alike (dots3: one
    product every step) the roundings repeat rather than cancel, and the
    partial after j steps is j / steps of the value: steps / 2 2^-24 |ref|
    at most. One TF32 pass rounds each operand to TF32, about 2^-12.3 of it
    (rms) off, each product 2.9e-4 |a b| (rms; standard normal operands,
    the scripts' draws), a random walk of n such errors: 2.9e-4 sqrt(n)
    against A = 0.64 n, 24.7 2^-24 A a standard deviation at the scripts'
    n = 98,304 independent terms (dots1, dots2), so their largest element
    (of 26,624-131,072) lies about 3x over 32 A; where the steps repeat, so
    does the step's error (dots3, 512 steps of 384 rows: 395 2^-24 A a
    standard deviation); at the tests' n <= 64, over 960. The bar against
    the f32 plain version, 4 sqrt(n) 2^-24 A (1,254-1,774 2^-24 A at the
    full shapes), lets one pass through at every full shape.

    xp forms tt's function in tt's arithmetic (bitwise tt's result): tt's
    bar and control. base: each row product y = p_r w (one element: K
    terms) is formed as a K-row step of tt (32-row chunks from zero on the
    MMAs, added in f32), within tt's 32 A_y of it (A_y its sum of |terms|;
    the A_y add up to A). The y are then added over the G m rows: a
    thread's 8 rows of a tile, 3 shuffles, the two warps along M, then the
    reduction's tps = ceil(m / 128) tiles of a step, a run of ceil(G / 256)
    steps and a tree of 8 levels: D = 20 + tps + ceil(G / 256) adds at most
    a value (24 / 33 at dots2's m 384 / 1536, 22 at the tests' shapes),
    each within 2^-24 of a partial sum of the y, at most Y = the sum of
    |y| (a first-order bound: D 2^-24 Y in all). The y cancel: with the
    scripts' standard normal operands |y| is about 0.8 sqrt(K) and a
    term's |.| 0.64, so Y is about 1.25 A / sqrt(K): D Y is 1.3-1.8 A at
    K = 512, 5.6-6.9 A at the tests' K of 16-24, inside 32 A with room
    (operands of one sign, Y = A, could reach D 2^-24 A if every rounding
    went one way; random roundings give about sqrt(D) 2^-24 A). So base
    keeps the bar, steps = G. The control at base's shapes: TF32 rounds p
    and w, each about 2^-12.3 off (rms); p's roundings give 2.0e-4 sqrt(n)
    of error (rms, n = G m K), and w's as much (w[k, n] multiplies the
    column sum of p, about sqrt(G m)): 2.9e-4 sqrt(n), against 32 A = 20.4
    n 2^-24, a share of 237 / sqrt(n) a standard deviation. At dots2's
    n = 50.3 M that is 0.033: no bar scaled by A can refuse one pass there
    (|ref| is about sqrt(n), A about 0.64 n), and none is run there. At
    chip_smoke's BWD_SMALL (n = 9,984) it is 2.4, the largest of 130
    elements about 3 standard deviations; at the tests' n <= 1,536, 6 or
    more: the control is run at those shapes.

    nt: each output is one N-deep dot of a row of dy and a row of w, formed
    as one step of tt (chunks of 32 from zero on wgmma, whose accumulation
    truncates as mma.sync's does, added in f32) and written once: tt's
    32 A with steps = 1 (its final rounding, |ref| / 2). The control: n = N
    independent terms, a share of 238 / sqrt(n) standard deviations (as
    base's above), 14.9 at dots1's N = 256 and 10.5 at N = 512, 20.9 at
    BWD_SMALL's N = 130: refused at every shape. Its tail rows, whose sums
    of |terms| are 0, must be exact zeros."""
    r = measure(kind, got, a, b, m=m, steps=steps)
    for tag, what in (("", "plain"), ("64", "float64")):
        share = r.get("share_of_bar" + tag, 0.0)
        if not share <= 1.0:
            raise RuntimeError(
                f"bwd_dot {kind} {tuple(a.shape)} x {tuple(b.shape)} m={m} "
                f"steps={steps}: off the {what} version ({share:.3f} of the "
                "bar)")
    return r


def check(kind: str, a: torch.Tensor, b: torch.Tensor, *,
          m: Optional[int] = None, steps: Optional[int] = None) -> dict:
    """The kernel against the plain version on a's device (TF32 off is the
    caller's), and the tensor-core kinds against the float64 version,
    through :func:`compare`."""
    return compare(kind, run(kind, a, b, m=m, steps=steps, impl="kernel"),
                   a, b, m=m, steps=steps)


def draw(rng: np.random.Generator, shape: tuple, device) -> torch.Tensor:
    """One of the JAX scripts' draws: ``standard_normal`` cast to f32."""
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device)
