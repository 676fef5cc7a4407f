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
(``cuda_bwd_dots.compare``, TF32 off; both kinds also against the float64
version), then timed: the device time of a call with the host's launches
held out (``proto_parity_cnn.device_ms``), T MAC/s, the share of the bound
(at the f32 FMAs and 3xTF32 together, the rate of both kinds' tensor-core
routes), the plain version's time and one PyTorch call
computing the same function (:func:`library_call`; ``p[:G m].T @ dy[:G
m]``, ``dy[:G m] @ w.T``) as the library row. The JAX script printed a
rate only; the last line here is one JSON object with the rows. On the CPU
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
                 m: Optional[int] = None, steps: Optional[int] = None,
                 same_work: bool = False) -> Callable[[], torch.Tensor]:
    """One PyTorch call computing ``kind``'s function on (a, b), for the
    library columns (timed beside the kernel; nothing in the port calls
    it): tt and xp ``a[:G m].T @ b[:G m]``; nt ``a[:G m] @ b.T`` (without
    nt's zero tail rows); base ``einsum('rk,kn->n')`` over the G m rows
    (the library sums the rows first, 1/N of base's multiply-adds), with
    ``same_work`` ``torch.matmul(a[:G m], b)``, every product without the
    column sums. tt over ``steps`` steps of one tile and nn (dots3):
    ``addmm`` with ``alpha=steps``, which computes the product once and
    scales it, 1/steps of the multiply-adds; with ``same_work``,
    ``torch.matmul`` of the operands stacked ``steps`` times along the
    contraction (tt: a and b (steps M, K) and (steps M, N); nn: a (K, steps
    M), b (steps M, N)), stacked here, before the call: every step's
    product, as the kernel. The other kinds' call already does their
    work."""
    if kind == "nn":
        if same_work:
            A, B = a.repeat(1, steps), b.repeat(steps, 1)
            return lambda: torch.matmul(A, B)
        c = torch.empty((a.shape[0], b.shape[1]), device=a.device)
        return lambda: torch.addmm(c, a, b, beta=0, alpha=steps)
    Gm = a.shape[0] // m * m
    if kind == "tt" and steps is not None:
        if Gm != a.shape[0] or Gm != m:
            raise ValueError("tt over steps has one call only for one tile")
        if same_work:
            A, B = a.repeat(steps, 1), b.repeat(steps, 1)
            return lambda: torch.matmul(A.T, B)
        c = torch.empty((a.shape[1], b.shape[1]), device=a.device)
        return lambda: torch.addmm(c, a.T, b, beta=0, alpha=steps)
    if kind in ("tt", "xp"):
        return lambda: torch.matmul(a[:Gm].T, b[:Gm])
    if kind == "nt":
        return lambda: torch.matmul(a[:Gm], b.T)
    if kind == "base":
        if same_work:
            return lambda: torch.matmul(a[:Gm], b)
        return lambda: torch.einsum("rk,kn->n", a[:Gm], b)
    raise ValueError(f"unknown kind {kind!r}")


def dot_row(name: str, kind: str, a: torch.Tensor, b: torch.Tensor,
            args: harness.Args, shape: tuple, *, m: Optional[int] = None,
            steps: Optional[int] = None,
            one_matmul: Optional[tuple[Callable, int]] = None) -> dict:
    """One row: ``kind`` on (a, b) (keywords as ``cuda_bwd_dots.run``),
    checked against its plain version on the card (the tensor-core kinds
    also against the float64 version, ``cuda_bwd_dots.compare``), then
    timed beside its bound (at the rate of the kind's route,
    ``Kind.rate``), its plain version and :func:`library_call`; the
    tensor-core kinds also beside the library call that does the same work
    (``library_ms_same_work``: dots3's stacked product, base's
    ``torch.matmul(p, w)``; tt's and xp's library call itself);
    ``one_matmul`` (a call and its multiply-adds), where given, is one
    product's rate beside it."""
    kw = {"m": m, "steps": steps}
    k = bd.kind_of(kind)
    fn = lambda: bd.run(kind, a, b, **kw)  # noqa: E731
    checked = {}
    if args.device.type == "cuda":
        checked = bd.compare(kind, fn(), a, b, **kw)
    ms = harness.timed_ms(fn, args)
    plain_ms = harness.timed_ms(lambda: bd.plain(kind, a, b, **kw), args)
    macs = bd.macs(kind, shape, steps)
    b_ms, b_by = harness.bound_ms(macs, bd.bytes_moved(kind, shape), k.rate)
    r = {"name": name, "kind": kind, "route": k.route, "rate": k.rate,
         "ms": ms, "t_macs": macs / (ms * 1e-3) / 1e12, "bound_ms": b_ms,
         "bound_by": b_by, "plain_ms": plain_ms,
         "library_ms": harness.timed_ms(library_call(kind, a, b, **kw), args),
         "max_abs_err": checked.get("max_abs_err"),
         "share_of_bar": checked.get("share_of_bar")}
    lib = f"{r['library_ms']:.4f} ms"
    if kind in bd.TC_KINDS:
        r.update({k64: checked.get(k64) for k64 in ("max_abs_err64",
                                                     "share_of_bar64")})
        if kind in ("nn", "base") or steps is not None:
            r["library_ms_same_work"] = harness.timed_ms(
                library_call(kind, a, b, **kw, same_work=True), args)
            lib += f" (the same work: {r['library_ms_same_work']:.4f} ms)"
        else:
            r["library_ms_same_work"] = r["library_ms"]
    if one_matmul is not None:
        one_ms = harness.timed_ms(one_matmul[0], args)
        r["library_ms_one_matmul"] = one_ms
        r["library_t_macs"] = one_matmul[1] / (one_ms * 1e-3) / 1e12
        lib += f" (one torch.matmul: {r['library_t_macs']:.2f} T MAC/s)"
    err = "" if not checked else (
        f"; err {r['max_abs_err']:.3e} ({r['share_of_bar']:.3f} of the bar"
        + (f", {r['share_of_bar64']:.3f} of the float64 bar"
           if "share_of_bar64" in checked else "") + ")")
    print(f"  {name:>18s}: {ms:9.4f} ms {r['t_macs']:7.2f} T MAC/s "
          f"{b_ms / ms:6.1%} of its {k.rate} bound {b_ms:.4f} ms ({b_by}); "
          f"plain {plain_ms:.4f} ms; library {lib}{err}", flush=True)
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
