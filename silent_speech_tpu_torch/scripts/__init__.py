"""Measurement scripts of the port: the counterparts of the JAX package's
``scripts/`` that probe a kernel's design on the card.

bench_gru    the plain GRU scan against the GRU sequence kernel (K2), for
             the stack and for one direction; the harness the probes share
proto_gru2   a recurrence kernel over a hoisted projection, one weight set
             and the two directions stacked along the batch (bf16 products
             optional)
proto_gru3   the projection fused in the kernel, one launch a direction:
             K2's function, run through K2's one-direction launch
proto_gru4   both directions of a layer as two chains in one kernel

Each runs as ``python -m silent_speech_tpu_torch.scripts.<name> [B] [T]
[device=cuda] [iters=100]`` (B=512, T=32 by default), on the card unless
``device=cpu`` is given, and prints one row a variant (ms, speedup over the
table's first row, max abs error against the plain scan) and then one JSON
line.
"""
