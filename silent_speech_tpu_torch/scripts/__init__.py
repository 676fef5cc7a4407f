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
proto_parity_cnn  the parity-packed conv1 + pool1 kernel against the plain
             conv1 + pool1; the harness of the CNN-front probes
proto_parity_e2e  the whole ROI CNN with the parity kernel in front and a
             plain back half, against K1 and the plain CNN, f32 and bf16
proto_ablate the parity kernel's stages timed one by one
probe_front  K1's input front as a ladder of micro-kernels, frames a block,
             the front beside K1-sized arithmetic, and K1's debug stops
probe_int8   a serial chain of 14 (384, K) x (K, K) products a step in f32,
             bf16 and int8 (tensor cores for the last two), K 384 and 512
bench_fused_cnn  the matmul rate at K1's packed shapes (``mxu``), K1
             against the plain CNN with K1's debug stops and the live
             forward (``main``), and the f_tile sweep (``ftile``, which
             has no counterpart on the card and says so)
mosaic_micro nine layout primitives on (768, 768) f32 blocks: copies,
             rolls and maxes, strided rows, the transpose, lane slices, a
             product beside a copy
proto_bwd_dots  the backward kernel's two dot forms over 98,304 rows,
             p^T dy summed over row tiles (tt) and dy w^T (nt), beside
             torch.matmul; the rows' harness of the next two
proto_bwd_dots2  variants of one accumulation over row tiles: the column
             sums of p @ w (base), tt, and tt through an explicit
             transpose (xp), m 384 to 3072
proto_bwd_dots3  tt and the normal-form product (nn) on operands that stay
             put, recomputed and summed over 512 steps

The GRU probes run as ``python -m silent_speech_tpu_torch.scripts.<name>
[B] [T] [device=cuda] [iters=100]`` (B=512, T=32 by default) and print one
row a variant (ms, speedup over the table's first row, max abs error
against the plain scan); the CNN-front probes as ``... [N] [device=cuda]
[iters=30]`` (N=8192 frames by default, a multiple of 16) and print one row
a variant (ms, the kernel's device time, max abs error); the rate probes
as ``... [STEPS] [device=cuda] [iters=N]`` (probe_int8: 256 steps at
K=384 and 512; mosaic_micro: 512 steps; bench_fused_cnn: ``[mxu|ftile]
[N] ...``, N=8192 frames; proto_bwd_dots and proto_bwd_dots2 ``[ROWS]``,
98,304 rows; proto_bwd_dots3 ``[STEPS]``, 512) and print one row a mode, shape or body (ms,
rate, share of the card's bound, the plain version's time). All run on the card
unless ``device=cpu`` is given, and end with one JSON line.
"""
