"""The f32 ROI CNN kernel's tensor-core arithmetic (csrc/roi_cnn.cu),
emulated on the CPU.

The kernel runs conv2 and conv3 as 3xTF32 on m16n8k8 TF32 MMAs: each
operand x is split as hi = tf32(x), lo = tf32(x - hi), both rounded to
nearest with ties away from zero (``cvt.rna.tf32.f32``), and a product is
hi*hi + hi*lo + lo*hi with f32 accumulation. Here the products are formed
from those values and summed in float64 (a product of two TF32 values is
exact there); conv1, the pools, biases, ReLUs, mean and fc are f32 as in
the plain version. The network so computed must lie within 1e-6 of
``cuda_cnn.roi_cnn_plain`` and within the JAX bars (2e-4 live, 2e-3
standardized) of the Pallas kernel (variant 'tiled3', interpret mode), and
one TF32 pass (hi*hi alone) must lie at least 100x further from the plain
version: the split, not luck, keeps f32 accuracy. The kernel itself is
held against the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py) to bars that sit between the two: the last test here holds
the emulated split at least 10x inside them and one TF32 pass outside
them, at the port's initialisation of those card checks."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from silent_speech_tpu.models.bigru import init_roi_cnn
from silent_speech_tpu.ops.pallas_cnn2 import pack_roi_cnn_fused, roi_cnn_fused
from silent_speech_tpu_torch.models.bigru import init_roi_cnn as torch_init
from silent_speech_tpu_torch.ops import cuda_cnn
from silent_speech_tpu_torch.ops.nn import conv2d_nhwc, dense, max_pool_2x2
from tc_emulation import conv_tc, split_tf32, tf32_rna
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N_FRAMES = 6
# the f32 kernel's bars on the card, live and standardized (chip_smoke.py
# BAR_K1_LIVE / BAR_K1_STD, tests/test_torch_cuda.py _K1_BARS["f32"])
CARD_BARS = (2e-6, 1e-5)


def roi_cnn_tc(roi_u8: torch.Tensor, p: dict, standardize: bool,
               passes: int) -> torch.Tensor:
    """The f32 kernel's network with conv2 and conv3 as :func:`conv_tc`."""
    x = cuda_cnn.preprocess_roi(roi_u8, standardize).unsqueeze(-1)
    x = max_pool_2x2(torch.relu(conv2d_nhwc(x, p["conv0"])))
    x = torch.relu(max_pool_2x2(conv_tc(x, p["conv1"]["w"], passes))
                   + p["conv1"]["b"])
    x = torch.relu(conv_tc(x, p["conv2"]["w"], passes) + p["conv2"]["b"])
    return dense(x.mean(dim=(1, 2)), p["fc"])


def test_tf32_rounding_is_nearest_ties_away():
    one = 1.0 + 2.0 ** -10  # the TF32 neighbour of 1
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 - 2.0 ** -23,
                      -(1.0 + 2.0 ** -11), 1.0 + 3 * 2.0 ** -11, 0.0, -3.5],
                     dtype=torch.float32)
    want = torch.tensor([one, 1.0, -one, 1.0 + 2 * 2.0 ** -10, 0.0, -3.5])
    assert torch.equal(tf32_rna(x), want)
    hi, lo = split_tf32(torch.tensor([1.0 / 3.0]))
    assert abs((hi.double() + lo.double()).item() - 1.0 / 3.0) < 2.0 ** -22


@pytest.mark.parametrize("standardize", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_3xtf32_network_keeps_f32_accuracy(seed, standardize):
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, init_roi_cnn(jax.random.PRNGKey(seed)))
    roi = rng.integers(0, 256, (N_FRAMES, 48, 96), dtype=np.uint8)
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    r = torch.from_numpy(roi)
    plain = cuda_cnn.roi_cnn_plain(r, p, standardize).double()
    three = roi_cnn_tc(r, p, standardize, passes=3).double()
    one = roi_cnn_tc(r, p, standardize, passes=1).double()
    err3 = (three - plain).abs().max().item()
    err1 = (one - plain).abs().max().item()
    assert err3 <= 1e-6, err3
    assert err1 >= 100 * err3, (err1, err3)
    want = roi_cnn_fused(jnp.asarray(roi), pack_roi_cnn_fused(params),
                         standardize=standardize, variant="tiled3",
                         interpret=True)
    np.testing.assert_allclose(three.numpy(), np.asarray(want),
                               atol=2e-3 if standardize else 2e-4, rtol=0)


@pytest.mark.parametrize("standardize", [False, True])
@pytest.mark.parametrize("seed,emb", [(11, 32), (21, 32), (64, 64), (1, 1)])
def test_card_bars_tell_3xtf32_from_one_pass(seed, emb, standardize):
    p = torch_init(emb, torch.Generator().manual_seed(seed))
    r = torch.randint(0, 256, (N_FRAMES, 48, 96), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(seed))
    plain = cuda_cnn.roi_cnn_plain(r, p, standardize).double()
    err3, err1 = ((roi_cnn_tc(r, p, standardize, passes).double() - plain)
                  .abs().max().item() for passes in (3, 1))
    bar = CARD_BARS[standardize]
    assert 10 * err3 <= bar < err1, (err3, bar, err1)
