"""Probe: why the lhs-transposed dot is slow, by variants of one
accumulation over row tiles (port of scripts/proto_bwd_dots2.py).

    python -m silent_speech_tpu_torch.scripts.proto_bwd_dots2 [ROWS] \\
        [device=cuda] [iters=5]

p (ROWS, 512), dy (ROWS, 256) and w (512, 256) from ``default_rng(0)``
(ROWS = 98,304), then, each an m-row tile a step (ops/cuda_bwd_dots.py,
csrc/bwd_dots.cu):

- ``base`` (m 384, 1536): the column sums of p_g @ w, added over the
  tiles (``bwd_dot_base``): the same multiply-adds as tt in the normal
  form. Its library row is ``torch.einsum('rk,kn->n', p[:G m], w)``, which
  sums the rows before the product (1/N of the multiply-adds); the same
  work is one ``torch.matmul(p, w)`` (``library_ms_same_work``, also
  given as a product's rate);
- ``tt`` (m 384, 1536, 3072): the sum of p_g^T dy_g (``bwd_dot_tt``);
- ``xp`` (m 384, 1536): tt's function through an explicit transpose of
  each p chunk into shared memory (``bwd_dot_xp``), the card's
  ``jnp.swapaxes``; bitwise tt's result. tt and xp have
  ``torch.matmul(p[:G m].T, dy[:G m])`` as their library row.

All three form their products as 3xTF32 on the tensor cores, on one
mainloop (ops/cuda_bwd_dots.py), so their rows compare layouts on one
route: xp - tt is the transposing stage's cost, base's the normal form's
with a column-sum epilogue; each row is bound at the f32 FMAs and 3xTF32
together.

``vmem_limit_bytes`` has no counterpart on the card. Each row is checked
and timed as proto_bwd_dots's (``proto_bwd_dots.dot_row``); the last line
is one JSON object with the rows. On the CPU (``device=cpu``) a run is a
check of the code through the plain versions, timed by the host clock,
not a measurement; without a CUDA device it raises unless ``device=cpu``
is given.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import numpy as np
import torch

from ..infer.predictor import full_f32
from ..ops import cuda_bwd_dots as bd
from . import proto_bwd_dots
from . import proto_parity_cnn as harness

ITERS = 5  # proto_bwd_dots2.py:66
K, N = 512, 256
BASE_MS, TT_MS, XP_MS = (384, 1536), (384, 1536, 3072), (384, 1536)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = proto_bwd_dots.parse(sys.argv[1:] if argv is None else argv,
                                "proto_bwd_dots2",
                                max(BASE_MS + TT_MS + XP_MS), bd.ROWS, ITERS)
    rows, dev = args.N, args.device
    print(f"proto_bwd_dots2: {rows} rows, K={K}, N={N}, f32 in, f32 sums, "
          f"on {harness.device_name(dev)}", flush=True)
    rng = np.random.default_rng(0)
    out = []
    with torch.no_grad(), full_f32():
        p, dy = bd.draw(rng, (rows, K), dev), bd.draw(rng, (rows, N), dev)
        w = bd.draw(rng, (K, N), dev)
        for m in BASE_MS:
            out.append(proto_bwd_dots.dot_row(
                f"base_m{m}", "base", p, w, args, (rows, m, K, N), m=m,
                one_matmul=(lambda: torch.matmul(p, w), rows * K * N)))
        for kind, ms in (("tt", TT_MS), ("xp", XP_MS)):
            for m in ms:
                out.append(proto_bwd_dots.dot_row(
                    f"{kind}_m{m}", kind, p, dy, args, (rows, m, K, N),
                    m=m))
    return harness.report("proto_bwd_dots2", args, out, K=K, N_cols=N)


if __name__ == "__main__":
    main()
