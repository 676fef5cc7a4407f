"""The port's CUDA kernels against their plain versions, on the card.

Edge shapes the smoke run (chip_smoke.py) does not reach: single frames and
rows, ragged batch tiles, zero lengths, constant frames under
standardization, odd widths. Every test needs a CUDA device and skips
without one. On the GPU machine (which has no jax, and tests/conftest.py
imports jax) run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from silent_speech_tpu_torch.infer.predictor import full_f32
from silent_speech_tpu_torch.models.bigru import init_roi_cnn
from silent_speech_tpu_torch.ops import _kernels, cuda_cnn, cuda_gru
from silent_speech_tpu_torch.ops import gru as gru_ops
from silent_speech_tpu_torch.ops.nn import gru_dir_init

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """The CUDA device, with TF32 off for the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with full_f32():
        yield torch.device("cuda")


def _cnn_params(dev, seed, emb=32):
    g = torch.Generator().manual_seed(seed)
    return {k: {n: t.to(dev) for n, t in v.items()}
            for k, v in init_roi_cnn(emb, g).items()}


@pytest.mark.parametrize("standardize,bar", [(False, 2e-4), (True, 2e-3)])
@pytest.mark.parametrize("N", [1, 7, 300])
def test_roi_cnn_kernel_matches_plain(dev, N, standardize, bar):
    g = torch.Generator().manual_seed(N)
    roi = torch.randint(0, 256, (N, 48, 96), generator=g, dtype=torch.uint8)
    roi[0] = 255  # a constant frame: std clamps at 1e-6 under standardize
    roi = roi.to(dev)
    p = _cnn_params(dev, N)
    before = cuda_cnn.KERNEL.launches
    got = cuda_cnn.roi_cnn_fused(roi, p, standardize=standardize,
                                 impl="kernel")
    torch.cuda.synchronize()
    assert cuda_cnn.KERNEL.launches == before + 1
    ref = cuda_cnn.roi_cnn_plain(roi, p, standardize)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=bar, rtol=0)


def test_roi_cnn_kernel_narrow_embedding(dev):
    roi = torch.randint(0, 256, (5, 48, 96), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(1)).to(dev)
    p = _cnn_params(dev, 2, emb=8)
    got = cuda_cnn.roi_cnn_fused(roi, p)
    torch.testing.assert_close(got, cuda_cnn.roi_cnn_plain(roi, p),
                               atol=2e-4, rtol=0)


def test_roi_cnn_kernel_weights_per_launch_on_two_streams(dev):
    """Launches with two weight sets, in turns on two streams, each give
    their own plain result: no launch reads the other's weights."""
    roi = torch.randint(0, 256, (64, 48, 96), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(4)).to(dev)
    ps = [_cnn_params(dev, s) for s in (5, 6)]
    flats = [cuda_cnn.flat_weights(p) for p in ps]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = [[], []]
    torch.cuda.synchronize()
    for _ in range(4):
        for i in (0, 1):
            with torch.cuda.stream(streams[i]):
                outs[i].append(cuda_cnn.roi_cnn_fused(roi, ps[i],
                                                      flat=flats[i]))
    torch.cuda.synchronize()
    for i in (0, 1):
        ref = cuda_cnn.roi_cnn_plain(roi, ps[i])
        for got in outs[i]:
            torch.testing.assert_close(got, ref, atol=2e-4, rtol=0)


def test_roi_cnn_kernel_rejects_what_it_does_not_take(dev):
    p = _cnn_params(dev, 3)
    roi = torch.zeros((4, 48, 96), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_cnn.roi_cnn_fused(roi[::2], p)
    with pytest.raises(ValueError, match="48x96"):
        cuda_cnn.roi_cnn_fused(torch.zeros((2, 40, 96), dtype=torch.uint8,
                                           device=dev), p)
    with pytest.raises(ValueError, match="f32"):
        cuda_cnn.roi_cnn_fused(roi, _cnn_params("cpu", 3))
    flat = cuda_cnn.flat_weights(p)
    for bad in (flat[:-1], flat.cpu(), flat.double()):
        with pytest.raises(ValueError, match="flat_weights"):
            cuda_cnn.roi_cnn_fused(roi, p, flat=bad)


@pytest.mark.parametrize("B,T,D,H", [(1, 1, 4, 8), (9, 5, 13, 40),
                                     (17, 33, 212, 192)])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_kernel_matches_plain(dev, B, T, D, H, reverse):
    g = torch.Generator().manual_seed(B * 100 + T)
    x = torch.randn(B, T, D, generator=g).to(dev)
    lengths = torch.randint(0, T + 1, (B,), generator=g)
    lengths[0] = T
    if B > 2:
        lengths[1] = 0
    p = {k: v.to(dev) for k, v in gru_dir_init(D, H, g).items()}
    got = cuda_gru.gru_layer(x, lengths, p, reverse=reverse, impl="kernel")
    torch.cuda.synchronize()
    ref = gru_ops.gru_layer_single_direction(x, lengths.to(dev), p,
                                             reverse=reverse)[0]
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)


def test_bigru_kernel_one_launch_per_layer(dev):
    g = torch.Generator().manual_seed(5)
    B, T, D, H = 11, 9, 20, 16
    layers = [{"fwd": gru_dir_init(d, H, g), "bwd": gru_dir_init(d, H, g)}
              for d in (D, 2 * H)]
    layers = [{k: {n: t.to(dev) for n, t in v.items()} for k, v in lp.items()}
              for lp in layers]
    x = torch.randn(B, T, D, generator=g).to(dev)
    lengths = torch.randint(1, T + 1, (B,), generator=g).to(dev)
    _kernels.reset_launch_counts()
    got = cuda_gru.bigru_kernel(x, lengths, layers)
    assert _kernels.launch_counts()["gru_seq"] == 2
    ref = gru_ops.bigru(x, lengths, layers)[0]
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)
