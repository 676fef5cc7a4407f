"""The im2col ROI CNN kernel's tensor-core arithmetic
(csrc/roi_cnn_im2col.cu), emulated on the CPU.

The kernel computes conv2 and conv3 as GEMMs of patch rows against
``pack_im2col``'s packed matrices, issuing 3xTF32 MMAs only for the
fragments that ``cuda_cnn_im2col.nonzero_fragments`` lists. Here each conv
is that GEMM, its B built from the listed fragments of the packed buffer
alone (a fragment left out would drop its weights), its products formed as
the tensor cores form them (tests/tc_emulation.py: hi*hi + hi*lo + lo*hi
in float64, then f32); conv1, the pools, biases, ReLUs, mean and fc are
f32 as in the plain version. The network so computed must lie within 1e-6
of ``cuda_cnn.roi_cnn_plain`` and within
test_im2col_plain_matches_pallas_im2col's tolerances of the Pallas kernel
(``roi_cnn_pallas``, interpret mode), and one TF32 pass (hi*hi alone) at
least 100x further from the plain version. The kernel itself is held on the
card at K1's f32 bars (tests/test_torch_cuda.py, chip_smoke.py): the last
test holds the emulated split at least 10x inside them and one TF32 pass
outside them."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from silent_speech_tpu.models.bigru import init_roi_cnn
from silent_speech_tpu.ops import pallas_cnn
from silent_speech_tpu_torch.models.bigru import init_roi_cnn as torch_init
from silent_speech_tpu_torch.ops import cuda_cnn, cuda_cnn_im2col
from silent_speech_tpu_torch.ops.nn import conv2d_nhwc, dense, max_pool_2x2
from tc_emulation import tc_product
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N_FRAMES = 6
# K1's f32 bars on the card, live and standardized (chip_smoke.py
# BAR_K1_LIVE / BAR_K1_STD), which hold K5 too
CARD_BARS = (2e-6, 1e-5)


def fragment_matrices(packed: torch.Tensor, emb: int) -> list:
    """Each conv's packed matrix rebuilt from the kernel's nonzero
    fragments of ``packed`` alone, as (3, wx_len, Ci, w_tile, Co)."""
    out, o, c_in = [], 0, 1
    for conv, (c_out, (w_tile, wx_len)) in enumerate(
            zip(cuda_cnn.CHANNELS, cuda_cnn_im2col.TILES)):
        rows, cols = 3 * wx_len * c_in, w_tile * c_out
        full = packed[o:o + rows * cols].reshape(rows, cols)
        b = torch.zeros_like(full)
        fk, fn = cuda_cnn_im2col.FRAG_K[conv], cuda_cnn_im2col.FRAG_N[conv]
        for r, c, _, _ in cuda_cnn_im2col.nonzero_fragments(conv):
            b[r:r + fk, c:c + fn] = full[r:r + fk, c:c + fn]
        out.append(b.reshape(3, wx_len, c_in, w_tile, c_out))
        o += rows * cols + cols
        c_in = c_out
    assert o + 25 * emb == packed.numel()
    return out


def packed_conv_tc(x: torch.Tensor, b: torch.Tensor, passes: int
                   ) -> torch.Tensor:
    """SAME conv of x (N, H, W, Ci) as the kernel's GEMM: patch rows (h, w
    tile j) of (dy, wx, ci) against b (3, wx_len, Ci, w_tile, Co), as the
    tensor cores form it, then f32 (N, H, W, Co)."""
    n, h, w, _ = x.shape
    _, wx_len, _, w_tile, co = b.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    tiles = w // w_tile
    a = torch.stack([torch.stack([xp[:, dy:dy + h, w_tile * j:w_tile * j
                                     + wx_len] for dy in range(3)], 2)
                     for j in range(tiles)], 2)  # (N, H, J, 3, wx, Ci)
    y = tc_product(a, b, lambda p, q: torch.einsum("nhjdxc,dxcwo->nhjwo",
                                                   p, q), passes).float()
    return y.reshape(n, h, w, co)


def roi_cnn_im2col_tc(roi_u8: torch.Tensor, p: dict, standardize: bool,
                      passes: int) -> torch.Tensor:
    """The kernel's network: conv1 on the f32 FMAs, conv2 and conv3 as
    :func:`packed_conv_tc` over the nonzero fragments of pack_im2col."""
    emb = p["fc"]["b"].shape[0]
    _, b2, b3 = fragment_matrices(cuda_cnn_im2col.pack_im2col(p), emb)
    x = cuda_cnn.preprocess_roi(roi_u8, standardize).unsqueeze(-1)
    x = max_pool_2x2(torch.relu(conv2d_nhwc(x, p["conv0"])))
    x = torch.relu(max_pool_2x2(packed_conv_tc(x, b2, passes))
                   + p["conv1"]["b"])
    x = torch.relu(packed_conv_tc(x, b3, passes) + p["conv2"]["b"])
    return dense(x.mean(dim=(1, 2)), p["fc"])


def _torch(params):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)


@pytest.mark.parametrize("standardize,atol,rtol",
                         [(False, 2e-4, 1e-4), (True, 2e-3, 1e-3)])
@pytest.mark.parametrize("seed", [0, 3])
def test_fragment_3xtf32_network_keeps_f32_accuracy(seed, standardize, atol,
                                                    rtol):
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, init_roi_cnn(jax.random.PRNGKey(seed)))
    roi = rng.integers(0, 256, (N_FRAMES, 48, 96), dtype=np.uint8)
    p, r = _torch(params), torch.from_numpy(roi)
    plain = cuda_cnn.roi_cnn_plain(r, p, standardize).double()
    three = roi_cnn_im2col_tc(r, p, standardize, passes=3).double()
    one = roi_cnn_im2col_tc(r, p, standardize, passes=1).double()
    err3 = (three - plain).abs().max().item()
    err1 = (one - plain).abs().max().item()
    assert err3 <= 1e-6, err3
    assert err1 >= 100 * err3, (err1, err3)
    want = pallas_cnn.roi_cnn_pallas(
        jnp.asarray(roi), pallas_cnn.pack_roi_cnn_params(params),
        standardize=standardize, interpret=True)
    np.testing.assert_allclose(three.numpy(), np.asarray(want), atol=atol,
                               rtol=rtol)


def test_fragments_rebuild_the_packed_matrices():
    """The listed fragments hold every weight: the matrices rebuilt from
    them alone are pack_im2col's."""
    p = torch_init(32, torch.Generator().manual_seed(4))
    packed = cuda_cnn_im2col.pack_im2col(p)
    for conv, b in enumerate(fragment_matrices(packed, 32)):
        _, wx_len, ci, w_tile, co = b.shape
        want = cuda_cnn_im2col.pack_conv(p[f"conv{conv}"]["w"], w_tile,
                                         wx_len)
        assert torch.equal(b.reshape(want.shape), want), conv


@pytest.mark.parametrize("standardize", [False, True])
@pytest.mark.parametrize("seed,emb", [(11, 32), (64, 64), (1, 1)])
def test_card_bars_tell_3xtf32_from_one_pass(seed, emb, standardize):
    p = torch_init(emb, torch.Generator().manual_seed(seed))
    r = torch.randint(0, 256, (N_FRAMES, 48, 96), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(seed))
    plain = cuda_cnn.roi_cnn_plain(r, p, standardize).double()
    err3, err1 = ((roi_cnn_im2col_tc(r, p, standardize, passes).double()
                   - plain).abs().max().item() for passes in (3, 1))
    bar = CARD_BARS[standardize]
    assert 10 * err3 <= bar < err1, (err3, bar, err1)
