"""The GRU kernel module (silent_speech_tpu_torch.ops.cuda_gru) against the
JAX package's Pallas GRU (ops/pallas_gru.py) in interpret mode.

On the CPU the module's wrappers run their plain version (the masked scan);
the two CUDA kernels (gru_proj, gru_seq) are held against their plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py). atol 1e-4:
the bar of the JAX package's own GRU parity tests."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from silent_speech_tpu.ops.pallas_gru import (bigru_pallas, gru_layer_pallas,
                                              gru_sequence_pallas)
from silent_speech_tpu_torch.ops import cuda_gru
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-4


def _dir(rng, d, h):
    s = 1 / np.sqrt(h)
    return {k: rng.uniform(-s, s, shape).astype(np.float32)
            for k, shape in (("wi", (d, 3 * h)), ("bi", (3 * h,)),
                             ("wh", (h, 3 * h)), ("bh", (3 * h,)))}


def _t(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("B,T,D", [(12, 11, 16), (3, 4, 5)])
def test_gru_sequence_matches_pallas(rng, B, T, D):
    H = 8
    p = _dir(rng, D, H)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    lengths = rng.integers(1, T + 1, B).astype(np.int32)
    lengths[0] = T
    got = cuda_gru.gru_sequence(torch.from_numpy(x), torch.from_numpy(lengths),
                                **_t(p))
    want = gru_sequence_pallas(jnp.asarray(x), jnp.asarray(lengths), **_j(p),
                               batch_tile=8, k_steps=4, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_gru_layer_reverse_matches_pallas(rng):
    B, T, D, H = 9, 10, 6, 8
    p = _dir(rng, D, H)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    lengths = np.array([10, 3, 7, 1, 10, 5, 9, 2, 6], np.int32)
    got = cuda_gru.gru_layer(torch.from_numpy(x), torch.from_numpy(lengths),
                             _t(p), reverse=True, impl="plain")
    want = gru_layer_pallas(jnp.asarray(x), jnp.asarray(lengths), _j(p),
                            reverse=True, batch_tile=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    assert (got[3, 1:] == 0).all()  # zero past the length


def test_bigru_kernel_matches_bigru_pallas(rng):
    B, T, D, H = 6, 7, 10, 8
    layers = [{"fwd": _dir(rng, d, H), "bwd": _dir(rng, d, H)}
              for d in (D, 2 * H)]
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    lengths = np.array([7, 2, 5, 7, 1, 4], np.int32)
    got = cuda_gru.bigru_kernel(
        torch.from_numpy(x), torch.from_numpy(lengths),
        [{k: _t(v) for k, v in lp.items()} for lp in layers])
    want = bigru_pallas(jnp.asarray(x), jnp.asarray(lengths),
                        [{k: _j(v) for k, v in lp.items()} for lp in layers],
                        batch_tile=8, interpret=True)
    assert got.shape == (B, T, 2 * H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
