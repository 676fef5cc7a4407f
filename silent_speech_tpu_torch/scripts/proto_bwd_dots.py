"""Probe: the backward kernel's two dot forms at its shapes (port of
scripts/proto_bwd_dots.py); also the rows' harness of proto_bwd_dots2 and
proto_bwd_dots3.

    python -m silent_speech_tpu_torch.scripts.proto_bwd_dots [ROWS] \\
        [device=cuda] [iters=3]

For each of the JAX script's (m, K, N) shapes, over ROWS (98,304) rows of
p (ROWS, K) and dy (ROWS, N) and then w (K, N), drawn from one
``default_rng(0)`` in the JAX loop's order:

- ``tt``: dW = the sum over the row tiles g < G = ROWS // m of p_g^T dy_g
  (``run_tt``; ops/cuda_bwd_dots.bwd_dot_tt, csrc/bwd_dots.cu);
- ``nt``: dp[g] = dy_g w^T (``run_nt``; ``bwd_dot_nt``).

On the card each row's result is held against its plain version
(``cuda_bwd_dots.compare``, TF32 off), then timed: the device time of a
call with the host's launches held out (``proto_parity_cnn.device_ms``), T
MAC/s, the share of the f32 bound, the plain version's time and one
PyTorch call computing the same function (:func:`library_call`;
``p[:G m].T @ dy[:G m]``, ``dy[:G m] @ w.T``) as the library row. The JAX script printed a rate
only; the last line here is one JSON object with the rows. On the CPU
(``device=cpu``) a run is a check of the code through the plain versions,
timed by the host clock, not a measurement; without a CUDA device it
raises unless ``device=cpu`` is given.
"""

from __future__ import annotations

import sys
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..infer.predictor import full_f32
from ..ops import cuda_bwd_dots as bd
from . import proto_parity_cnn as harness

ITERS = 3  # the JAX script's warm calls
SHAPES = ((192, 104, 256), (384, 512, 256), (384, 256, 512))  # (m, K, N)


def parse(argv: Sequence[str], what: str, least: int, default: int,
          iters: int) -> harness.Args:
    """``[N] [device=cuda] [iters=...]``: N rows (or steps) at least
    ``least``."""
    args = harness.parse_args(argv, what, n_default=default, n_step=1,
                              iters_default=iters)
    if args.N < least:
        raise SystemExit(f"{what}: N={args.N} is under {least}")
    return args


def library_call(kind: str, a: torch.Tensor, b: torch.Tensor, *,
                 m: Optional[int] = None,
                 steps: Optional[int] = None) -> Callable[[], torch.Tensor]:
    """One PyTorch call computing ``kind``'s function on (a, b), for the
    library column (timed beside the kernel; nothing in the port calls
    it): tt and xp ``a[:G m].T @ b[:G m]``, and tt over ``steps`` steps of
    one tile (dots3) ``addmm`` with ``alpha=steps``; nt ``a[:G m] @ b.T``
    (without nt's zero tail rows); base ``einsum('rk,kn->n')`` over the G m
    rows (the library sums the rows first, 1/N of base's multiply-adds); nn
    ``addmm`` with ``alpha=steps``. tt and nn compute the product once."""
    if kind == "nn":
        c = torch.empty((a.shape[0], b.shape[1]), device=a.device)
        return lambda: torch.addmm(c, a, b, beta=0, alpha=steps)
    Gm = a.shape[0] // m * m
    if kind == "tt" and steps is not None:
        if Gm != a.shape[0] or Gm != m:
            raise ValueError("tt over steps has one call only for one tile")
        c = torch.empty((a.shape[1], b.shape[1]), device=a.device)
        return lambda: torch.addmm(c, a.T, b, beta=0, alpha=steps)
    if kind in ("tt", "xp"):
        return lambda: torch.matmul(a[:Gm].T, b[:Gm])
    if kind == "nt":
        return lambda: torch.matmul(a[:Gm], b.T)
    if kind == "base":
        return lambda: torch.einsum("rk,kn->n", a[:Gm], b)
    raise ValueError(f"unknown kind {kind!r}")


def dot_row(name: str, kind: str, a: torch.Tensor, b: torch.Tensor,
            args: harness.Args, shape: tuple, *, m: Optional[int] = None,
            steps: Optional[int] = None,
            one_matmul: Optional[tuple[Callable, int]] = None) -> dict:
    """One row: ``kind`` on (a, b) (keywords as ``cuda_bwd_dots.run``),
    checked against its plain version on the card, then timed beside its
    bound, its plain version and :func:`library_call`; ``one_matmul`` (a
    call and its multiply-adds), where given, is one product's rate beside
    it."""
    kw = {"m": m, "steps": steps}
    fn = lambda: bd.run(kind, a, b, **kw)  # noqa: E731
    err = share = None
    if args.device.type == "cuda":
        c = bd.compare(kind, fn(), a, b, **kw)
        err, share = c["max_abs_err"], c["share_of_bar"]
    ms = harness.timed_ms(fn, args)
    plain_ms = harness.timed_ms(lambda: bd.plain(kind, a, b, **kw), args)
    macs = bd.macs(kind, shape, steps)
    b_ms, b_by = harness.bound_ms(macs, bd.bytes_moved(kind, shape))
    r = {"name": name, "kind": kind, "ms": ms,
         "t_macs": macs / (ms * 1e-3) / 1e12, "bound_ms": b_ms,
         "bound_by": b_by, "plain_ms": plain_ms,
         "library_ms": harness.timed_ms(library_call(kind, a, b, **kw), args),
         "max_abs_err": err, "share_of_bar": share}
    lib = f"{r['library_ms']:.4f} ms"
    if one_matmul is not None:
        one_ms = harness.timed_ms(one_matmul[0], args)
        r["library_ms_one_matmul"] = one_ms
        r["library_t_macs"] = one_matmul[1] / (one_ms * 1e-3) / 1e12
        lib += f" (one torch.matmul: {r['library_t_macs']:.2f} T MAC/s)"
    print(f"  {name:>18s}: {ms:9.4f} ms {r['t_macs']:7.2f} T MAC/s "
          f"{b_ms / ms:6.1%} of its f32 bound {b_ms:.4f} ms ({b_by}); plain "
          f"{plain_ms:.4f} ms; library {lib}"
          + ("" if err is None else f"; err {err:.3e} ({share:.3f} of the "
                                    "bar)"), flush=True)
    return r


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse(sys.argv[1:] if argv is None else argv, "proto_bwd_dots",
                 max(m for m, _, _ in SHAPES), bd.ROWS, ITERS)
    rows, dev = args.N, args.device
    print(f"proto_bwd_dots: {rows} rows, f32 in, f32 sums, on "
          f"{harness.device_name(dev)}", flush=True)
    rng = np.random.default_rng(0)
    out = []
    with torch.no_grad(), full_f32():
        for m, K, N in SHAPES:
            p, dy = bd.draw(rng, (rows, K), dev), bd.draw(rng, (rows, N), dev)
            out.append(dot_row(f"tt_{m}x{K}x{N}", "tt", p, dy, args,
                               (rows, m, K, N), m=m))
            w = bd.draw(rng, (K, N), dev)
            out.append(dot_row(f"nt_{m}x{K}x{N}", "nt", dy, w, args,
                               (rows, m, K, N), m=m))
            del p, dy, w
    return harness.report("proto_bwd_dots", args, out)


if __name__ == "__main__":
    main()
