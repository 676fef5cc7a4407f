"""The ROI CNN kernel module (silent_speech_tpu_torch.ops.cuda_cnn) against
the JAX package's fused Pallas CNN (ops/pallas_cnn2.py, variant 'tiled3')
in interpret mode.

On the CPU the wrapper runs its plain version; the CUDA kernel itself is
held against that plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py). Bars as tests/test_pallas_cnn2.py: atol 2e-4 live, 2e-3
with the per-frame standardization. No constant frame here: the Pallas
kernel scales by a rounded 1/255 and takes E[x^2]-E[x]^2, so a constant
frame standardizes its rounding noise (x / 1e-6); the card test holds the
kernel's constant frames against the plain version instead."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from silent_speech_tpu.models.bigru import init_roi_cnn
from silent_speech_tpu.ops.pallas_cnn2 import pack_roi_cnn_fused, roi_cnn_fused
from silent_speech_tpu_torch.models.bigru import TinyROICNN
from silent_speech_tpu_torch.ops import cuda_cnn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _params(seed):
    return jax.tree.map(np.asarray, init_roi_cnn(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("N,standardize,atol", [(32, False, 2e-4),
                                                (21, True, 2e-3)])
def test_roi_cnn_fused_matches_pallas_tiled3(rng, N, standardize, atol):
    params = _params(N)
    roi = rng.integers(0, 256, (N, 48, 96), dtype=np.uint8)
    want = roi_cnn_fused(jnp.asarray(roi), pack_roi_cnn_fused(params),
                         standardize=standardize, variant="tiled3",
                         interpret=True)
    got = cuda_cnn.roi_cnn_fused(
        torch.from_numpy(roi),
        jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params),
        standardize=standardize)
    assert got.shape == (N, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


def test_standardize_frames_matches_jax(rng):
    from silent_speech_tpu.models.bigru import standardize_frames

    r = rng.random((3, 48, 96)).astype(np.float32)
    r[1] = 0.25  # constant frame
    np.testing.assert_allclose(
        cuda_cnn.standardize_frames(torch.from_numpy(r)).numpy(),
        np.asarray(standardize_frames(jnp.asarray(r))), atol=1e-5, rtol=0)


def test_flat_weights_is_the_kernels_oihw_layout():
    """The kernel's weight buffer, built from the module's JAX-layout views,
    is the module's torch-layout parameters concatenated in order."""
    m = TinyROICNN(32)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    flat = cuda_cnn.flat_weights(m.params_tree())
    want = torch.cat([m.net[k].weight.reshape(-1) if w else
                      m.net[k].bias.reshape(-1)
                      for k in ("0", "3", "6") for w in (True, False)]
                     + [m.fc.weight.reshape(-1), m.fc.bias.reshape(-1)])
    assert torch.equal(flat, want)
    assert flat.device == m.fc.weight.device and flat.is_contiguous()
    assert flat.numel() == 8 * 9 + 8 + 16 * 8 * 9 + 16 + 24 * 16 * 9 + 24 \
        + 32 * 24 + 32
