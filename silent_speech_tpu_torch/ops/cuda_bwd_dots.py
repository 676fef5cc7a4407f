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
counterpart on the card. The kernels split the steps into groups of whole
tiles, a block a 64 x 64 output tile and a group, and add the groups'
partials in group order: no atomics, two launches on the same inputs are
bitwise equal. ``impl`` as in ``ops._kernels``. :data:`KINDS` names the
five by kind, each with its wrapper, plain version and counts, for
:func:`run`, :func:`plain`, :func:`compare` and :func:`check`.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from . import _kernels

ROWS = 8192 * 12  # proto_bwd_dots.py:91, proto_bwd_dots2.py:77
STEPS = 512       # proto_bwd_dots3.py:17
_P, _I = ctypes.c_void_p, ctypes.c_int

# the steps kernels (tt, xp, nn) size their groups to one wave of blocks
# from the shapes alone (csrc/bwd_dots.cu, groups()); bwd_dot_scratch says
# how many floats of partial sums a launch needs, by its layout number
_LAYOUT = {"tt": 0, "nn": 1, "xp": 2}
_STEPS_ARGS = [_P, _P, _P, _P,            # p, dy, out, partial
               _I, _I, _I, _I, _I,        # K, N, m, G, steps
               _P]                        # stream
KERNEL_TT = _kernels.Kernel("bwd_dot_tt", "bwd_dot_tt", _STEPS_ARGS)
KERNEL_XP = _kernels.Kernel("bwd_dot_xp", "bwd_dot_xp", _STEPS_ARGS)
KERNEL_NT = _kernels.Kernel(
    "bwd_dot_nt", "bwd_dot_nt",
    [_P, _P, _P, _I, _I, _I, _I, _P])     # dy, w, out, rows, Gm, N, K, stream
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


def bwd_dot_xp(p: torch.Tensor, dy: torch.Tensor, m: int, *,
               impl: str = "auto") -> torch.Tensor:
    """bwd_dot_tt's function (steps = G) through an explicit transpose."""
    G = _same_rows(p, dy, m)
    if not _kernels.use_kernel(impl, p):
        return bwd_dot_xp_plain(p, dy, m)
    return _steps("xp", p, dy, m, G, G)


def bwd_dot_nt(dy: torch.Tensor, w: torch.Tensor, m: int, *,
               impl: str = "auto") -> torch.Tensor:
    """dy (rows, N), w (K, N) f32 -> (rows, K): dy_g w^T, zeros past G m."""
    _f32_2d("dy", dy)
    _f32_2d("w", w)
    if dy.shape[1] != w.shape[1]:
        raise ValueError(f"dy (rows, N) and w (K, N), got {tuple(dy.shape)},"
                         f" {tuple(w.shape)}")
    G = _tiles(dy.shape[0], m)
    if not _kernels.use_kernel(impl, dy):
        return bwd_dot_nt_plain(dy, w, m)
    _launchable(dy, w)
    rows, N = dy.shape
    K = w.shape[0]
    out = torch.empty((rows, K), dtype=torch.float32, device=dy.device)
    KERNEL_NT.launch(_kernels.ptr(dy), _kernels.ptr(w), _kernels.ptr(out),
                     rows, G * m, N, K, _kernels.stream_ptr(dy.device))
    return out


def bwd_dot_base(p: torch.Tensor, w: torch.Tensor, m: int, *,
                 impl: str = "auto") -> torch.Tensor:
    """p (rows, K), w (K, N) f32 -> (1, N): the column sums of p_g @ w
    over the tiles, every product computed."""
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
    partial = torch.empty((G * -(-m // 64), N), dtype=torch.float32,
                          device=p.device)  # a row a 64-row tile of p_g
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
    one output element; ``macs(shape, steps)`` and ``bytes(shape)`` count one call on
    ``shape``: (rows, m, K, N), for nn (M, K, N). ``bytes`` reads each
    input once (the G m rows a call reads) and writes each output once,
    f32."""

    wrapper: Callable[..., torch.Tensor]
    plain: Callable[..., torch.Tensor]
    terms: Callable[..., int]
    macs: Callable[..., int]
    bytes: Callable[..., int]


def _tt_terms(a, b, m, steps):
    return _or(steps, a.shape[0] // m) * m


def _tt_macs(shape, steps):
    rows, m, K, N = shape
    return _or(steps, rows // m) * m * K * N


def _tt_bytes(shape):
    return 4 * (_gm(shape) * (shape[2] + shape[3]) + shape[2] * shape[3])


KINDS = {
    "tt": Kind(bwd_dot_tt, bwd_dot_tt_plain, _tt_terms, _tt_macs, _tt_bytes),
    "xp": Kind(bwd_dot_xp, bwd_dot_xp_plain, _tt_terms, _tt_macs, _tt_bytes),
    "nt": Kind(bwd_dot_nt, bwd_dot_nt_plain,
               lambda a, b, m, steps: a.shape[1], _tt_macs,
               lambda s: 4 * (_gm(s) * s[3] + s[2] * s[3] + s[0] * s[2])),
    "base": Kind(bwd_dot_base, bwd_dot_base_plain,
                 lambda a, b, m, steps: a.shape[0] // m * m * a.shape[1],
                 _tt_macs,
                 lambda s: 4 * (_gm(s) * s[2] + s[2] * s[3] + s[3])),
    "nn": Kind(bwd_dot_nn, bwd_dot_nn_plain,
               lambda a, b, m, steps: _or(steps, STEPS) * a.shape[1],
               lambda s, steps: _or(steps, STEPS) * s[0] * s[1] * s[2],
               lambda s: 4 * (s[1] * s[0] + s[0] * s[2] + s[1] * s[2])),
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

# kernel vs plain: each output element sums n products in f32, in another
# order in the two; a random walk of n roundings, each at most 2^-24 of a
# partial sum under the element's sum of |terms|, stays within sqrt(n)
# 2^-24 of it; the bar is 4 times that (ops/cuda_mm_rate.BAR_DEPTH). n: tt
# and xp steps m, nt N, base G m K, nn steps M.
BAR_DEPTH = 4


def compare(kind: str, got: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            *, m: Optional[int] = None, steps: Optional[int] = None) -> dict:
    """A result of ``kind`` against the plain version on (a, b): the
    largest difference and share of the bar; raises over it (nt's tail
    rows, whose sums of |terms| are 0, must be exact zeros)."""
    want = plain(kind, a, b, m=m, steps=steps)
    absolute = plain(kind, a.abs(), b.abs(), m=m, steps=steps)
    bar = (BAR_DEPTH * KINDS[kind].terms(a, b, m, steps) ** 0.5
           * 2.0 ** -24 * absolute)
    if got.shape != want.shape:
        raise RuntimeError(f"bwd_dot {kind}: shape {tuple(got.shape)}, want "
                           f"{tuple(want.shape)}")
    err = (got - want).abs()
    share = (err / bar.clamp(min=1e-30)).max().item() if err.numel() else 0.0
    if not bool(torch.isfinite(got).all()) or not share <= 1.0:
        raise RuntimeError(f"bwd_dot {kind} {tuple(a.shape)} x "
                           f"{tuple(b.shape)} m={m} steps={steps}: off the "
                           f"plain version ({share:.3f} of the bar)")
    return {"max_abs_err": err.max().item() if err.numel() else 0.0,
            "share_of_bar": share}


def check(kind: str, a: torch.Tensor, b: torch.Tensor, *,
          m: Optional[int] = None, steps: Optional[int] = None) -> dict:
    """The kernel against the plain version on a's device (TF32 off is the
    caller's), through :func:`compare`."""
    return compare(kind, run(kind, a, b, m=m, steps=steps, impl="kernel"),
                   a, b, m=m, steps=steps)


def draw(rng: np.random.Generator, shape: tuple, device) -> torch.Tensor:
    """One of the JAX scripts' draws: ``standard_normal`` cast to f32."""
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device)
