"""The port's CUDA kernels against their plain versions, on the card.

Edge shapes the smoke run (chip_smoke.py) does not reach: single frames and
rows, ragged batch tiles, zero lengths, constant frames under
standardization, odd widths; the ROI CNN backward (K3) on tie frames, its
determinism and the inputs it refuses; the GRU kernel refusing autograd;
a train step through the kernels against the plain path. Every test needs
a CUDA device and skips without one. On the GPU machine (which has no jax, and tests/conftest.py
imports jax) run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

import numpy as np

from silent_speech_tpu_torch.infer.predictor import full_f32
from silent_speech_tpu_torch.models.bigru import (BiGRUClassifier,
                                                  BiGRUConfig, init_params,
                                                  init_roi_cnn)
from silent_speech_tpu_torch.train.step import (make_optimizer,
                                                smoothed_cross_entropy)
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


# --------------------------------------------------------------------- K3


def _plain_weight_grads(roi, dE, p, standardize):
    leaves = {k: {n: t.detach().clone().requires_grad_(True)
                  for n, t in v.items()} for k, v in p.items()}
    out = cuda_cnn.roi_cnn_train_plain(roi, leaves, standardize)
    flat = [t for v in leaves.values() for t in v.values()]
    grads = iter(torch.autograd.grad(out, flat, dE))
    return cuda_cnn.flat_weights({k: {n: next(grads) for n in v}
                                  for k, v in leaves.items()})


def _assert_rel(got, ref, emb, bar=5e-5):
    """max |d| / max |ref| < bar for each parameter tensor of the flat
    layout (tests/test_fused_train.py's bar)."""
    o = 0
    for n in (72, 8, 1152, 16, 3456, 24, 24 * emb, emb):
        a, b = got[o:o + n].double(), ref[o:o + n].double()
        rel = ((a - b).abs().max() / b.abs().max()).item()
        assert rel < bar, f"entries {o}:{o + n}: rel err {rel:.2e}"
        o += n


def _const_frames(levels):
    return torch.tensor(levels, dtype=torch.uint8)[:, None, None].expand(
        len(levels), 48, 96).contiguous()


@pytest.mark.parametrize("N,standardize,levels,emb", [
    (1, False, (), 32), (10, False, (0, 37, 128, 255), 32),
    (10, True, (0, 255), 32), (133, True, (), 8), (300, False, (), 32)])
def test_roi_cnn_bwd_matches_plain(dev, N, standardize, levels, emb):
    """Random frames plus constant tie frames (every 2x2 window a tie);
    under the standardization only 0 and 255 standardize exactly. N=133
    gives some blocks two frames."""
    g = torch.Generator().manual_seed(N)
    roi = torch.cat([torch.randint(0, 256, (N, 48, 96), generator=g,
                                   dtype=torch.uint8), _const_frames(levels)])
    roi, p = roi.to(dev), _cnn_params(dev, N, emb)
    dE = torch.randn(roi.shape[0], emb, generator=g).to(dev)
    flat = cuda_cnn.flat_weights(p)
    before = cuda_cnn.BWD_KERNEL.launches
    got = cuda_cnn.roi_cnn_weight_grads(roi, dE, flat,
                                        standardize=standardize)
    again = cuda_cnn.roi_cnn_weight_grads(roi, dE, flat,
                                          standardize=standardize)
    torch.cuda.synchronize()
    assert cuda_cnn.BWD_KERNEL.launches == before + 2
    assert torch.equal(got, again)  # a fixed summation order
    _assert_rel(got, _plain_weight_grads(roi, dE, p, standardize), emb)


def test_roi_cnn_fused_train_autograd_reaches_the_parameters(dev):
    """Through the kernels (forward K1, backward K3) autograd gives the
    module's OIHW and (out, in) parameters the plain version's gradients."""
    cfg = BiGRUConfig(x_dim=4, hidden=8, head_hidden=4, roi_emb=16)
    model = BiGRUClassifier.from_jax_params(
        init_params(cfg, torch.Generator().manual_seed(3)), cfg).to(dev)
    roi = torch.randint(0, 256, (40, 48, 96), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(4)).to(dev)
    grads = []
    for impl in ("kernel", "plain"):
        model.zero_grad()
        out = cuda_cnn.roi_cnn_fused_train(
            roi, model.roi_cnn.params_tree(), impl=impl)
        torch.tanh(out).sum().backward()
        grads.append([p.grad.clone() for p in model.roi_cnn.parameters()])
    for a, b in zip(*grads):
        assert ((a - b).abs().max() / b.abs().max()).item() < 5e-5


def test_roi_cnn_bwd_rejects_what_it_does_not_take(dev):
    p = _cnn_params(dev, 3)
    flat = cuda_cnn.flat_weights(p)
    roi = torch.zeros((4, 48, 96), dtype=torch.uint8, device=dev)
    dE = torch.zeros((4, 32), device=dev)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_cnn.roi_cnn_weight_grads(roi.cpu(), dE, flat, standardize=True)
    with pytest.raises(ValueError, match="dE"):
        cuda_cnn.roi_cnn_weight_grads(roi, dE[:3], flat, standardize=True)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_cnn.roi_cnn_weight_grads(roi[::2], dE[:2], flat,
                                      standardize=True)
    with pytest.raises(ValueError, match="flat_weights"):
        cuda_cnn.roi_cnn_weight_grads(roi, dE, flat[:-1], standardize=True)
    zero = cuda_cnn.roi_cnn_weight_grads(roi[:0], dE[:0], flat,
                                         standardize=True)
    torch.cuda.synchronize()
    assert zero.shape == flat.shape and not zero.any()


def test_gru_kernel_refuses_autograd(dev):
    g = torch.Generator().manual_seed(6)
    p = {k: v.to(dev) for k, v in gru_dir_init(8, 16, g).items()}
    x = torch.randn(3, 5, 8, generator=g).to(dev)
    lengths = torch.tensor([5, 3, 1])
    cuda_gru.gru_layer(x, lengths, p, impl="kernel")  # nothing requires grad
    for grad_x, grad_w in ((True, False), (False, True)):
        xx = x.clone().requires_grad_(grad_x)
        pp = {k: v.clone().requires_grad_(grad_w) for k, v in p.items()}
        with pytest.raises(RuntimeError, match="no backward"):
            cuda_gru.gru_layer(xx, lengths, pp, impl="kernel")
        with torch.no_grad():
            cuda_gru.gru_layer(xx, lengths, pp, impl="kernel")


def test_train_step_kernels_match_plain(dev):
    """One step (forward, loss, backward, clip, Adam) through K1 and K3
    against the plain path; the bars of tests/test_fused_train.py:180-189
    and tests/test_train.py:101,113."""
    cfg = BiGRUConfig(x_dim=12, num_classes=4, hidden=16, roi_emb=8,
                      head_hidden=8, gru_dropout=0.0, head_dropout=0.0)
    params = init_params(cfg, torch.Generator().manual_seed(7))
    rng = np.random.default_rng(7)
    B, T = 4, 16
    X = torch.from_numpy(rng.standard_normal((B, T, 12)).astype(np.float32))
    L = torch.tensor([16, 9, 5, 12])
    R = torch.from_numpy(rng.integers(0, 256, (B, T, 48, 96),
                                      dtype=np.uint8))
    y = torch.tensor([0, 3, 1, 2])
    batch = [t.to(dev) for t in (X, L, R, y)]
    res = []
    for impl in ("kernel", "plain"):
        model = BiGRUClassifier.from_jax_params(params, cfg).to(dev)
        opt = make_optimizer(model, 3e-4)
        _kernels.reset_launch_counts()
        logits = model.train_forward(*batch[:3], roi_impl=impl,
                                     generator=torch.Generator(device=dev))
        loss = smoothed_cross_entropy(logits, batch[3], 4, 0.05)
        loss.backward()
        grads = [p.grad.clone() for p in model.parameters()]
        opt.step()
        counts = _kernels.launch_counts()
        want = 1 if impl == "kernel" else 0
        assert counts["roi_cnn"] == counts["roi_cnn_bwd"] == want
        assert counts["gru_seq"] == 0  # the training GRU is the plain scan
        assert all(g.abs().max() > 0 for g in grads)
        res.append((loss.item(), grads,
                    [p.detach().clone() for p in model.parameters()]))
    (lk, gk, pk), (lp, gp, pp) = res
    assert abs(lk - lp) < 1e-5
    assert max((a - b).abs().max().item() for a, b in zip(gk, gp)) <= 1e-4
    assert max((a - b).abs().max().item() for a, b in zip(pk, pp)) <= 3e-4
