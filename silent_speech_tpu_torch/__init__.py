"""silent_speech_tpu_torch — the PyTorch + CUDA port of silent_speech_tpu.

The JAX package beside it stays the reference: every module here has a
counterpart of the same path there, and the tests hold each one against it.
This package imports ``torch`` and numpy and never ``jax``, nor anything of
the JAX package: the jax-free modules it needs are copied under ``core/``.

Ported (the official model's serving, training and offline evaluation,
and the CTC family's):

ops/_kernels     routing (auto / kernel / plain), nvcc build, launch counts
ops/nn           dense, layer_norm, conv2d_nhwc, max_pool_2x2, inits
ops/pooling      length_mask, attn_pool
ops/gru          masked GRU scan (the plain version of the GRU kernel)
ops/cuda_cnn     fused TinyROICNN forward, f32 and bf16 (csrc/roi_cnn.cu),
                 its weight gradients (csrc/roi_cnn_bwd.cu), plain versions
ops/cuda_cnn_q8  the int8 TinyROICNN (csrc/roi_cnn_q8.cu) + plain version
ops/cuda_cnn_im2col  the TinyROICNN as im2col GEMMs (csrc/roi_cnn_im2col.cu)
ops/cuda_gru     GRU sequence: the input projection (csrc/gru_proj.cu) and
                 the cluster recurrence (csrc/gru_seq.cu) + plain versions
ops/cuda_gru_proto  the GRU design probes' kernels (csrc/gru_proto.cu) +
                 plain versions
ops/ctc          the CTC lattice: ctc_loss, dictionary word scores, the
                 length prior
models/bigru     BiGRUConfig, TinyROICNN, SequenceModel (the ROI embedding
                 and BiGRU, every route), BiGRUClassifier (dual forward,
                 serving modes, the bf16 training route)
models/ctc_model the BiGRU-CTC model (BiGRUCTC), vocabulary
data             synthetic corpus, corpus preflight, dataset, loader,
                 augmentation
train            step, loop (host_data, bf16, profile_dir), ctc_loop,
                 checkpoint (npz), metrics (torch.profiler trace)
infer/predictor  Predictor, load_predictor (official family)
infer/evaluator  evaluate_dataset, evaluate_ctc_dataset (the corpus sweeps)
infer/ctc_decode trim_silence, Dictionary, CTCDecoder
apps/cli         ``python -m silent_speech_tpu_torch train | eval-dataset |
                 predict | train-ctc | eval-ctc``
scripts          the GRU design probes as measurement scripts (bench_gru,
                 proto_gru2, proto_gru3, proto_gru4)

Not ported yet (ROADMAP.md lists the order): the benchmark, the model
variants and legacy trainers, features and ROI crop, streaming and the
camera apps (``infer-ctc`` among them), and the parallel (multi-GPU) layer.
"""

__version__ = "0.1.0"
