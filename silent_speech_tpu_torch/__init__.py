"""silent_speech_tpu_torch — the PyTorch + CUDA port of silent_speech_tpu.

The JAX package beside it stays the reference: every module here has a
counterpart of the same path there, and the tests hold each one against it.
This package imports ``torch`` and numpy and never ``jax``; of the JAX
package it reuses only the jax-free ``core.schema`` (the ``.npz`` clip
format) and ``core.torch_export`` (the reference ``state_dict`` layout).

Ported (the live serving path of the official model):

ops/_kernels     routing (auto / kernel / plain), nvcc build, launch counts
ops/nn           dense, layer_norm, conv2d_nhwc, max_pool_2x2, inits
ops/pooling      length_mask, attn_pool
ops/gru          masked GRU scan (the plain version of the GRU kernel)
ops/cuda_cnn     fused TinyROICNN kernel (csrc/roi_cnn.cu) + plain version
ops/cuda_gru     GRU sequence kernel (csrc/gru_seq.cu) + plain version
models/bigru     BiGRUConfig, TinyROICNN, BiGRUClassifier (dual forward)
train/checkpoint npz checkpoints and the reference metadata
infer/predictor  Predictor, load_predictor (official family)
apps/cli         ``python -m silent_speech_tpu_torch predict``

Not ported yet (ROADMAP.md lists the order): features and ROI crop, the
dataset evaluator, training (and its fused CNN backward kernel), CTC, the
model variants and legacy trainers, streaming and the camera apps, the
parallel (multi-GPU) layer, the int8 and bf16 CNN modes, and the im2col
CNN kernel.
"""

__version__ = "0.1.0"
