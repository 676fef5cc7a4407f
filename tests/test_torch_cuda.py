"""The port's CUDA kernels against their plain versions, on the card.

Edge shapes the smoke run (chip_smoke.py) does not reach: single frames and
rows, ragged batch tiles, zero lengths, constant frames under
standardization, odd widths; the ROI CNN backward (K3) on tie frames, its
determinism and the inputs it refuses; the GRU kernel refusing autograd;
a train step through the kernels against the plain path; the serving
modes' CNN kernels (K1-bf16, K4 int8, K5 im2col) on ragged and single
frames, narrow embeddings, the inputs they refuse, and the Predictor in
each mode against its plain path; the GRU probes' kernels (the recurrence
kernel with one and two weight sets, the dual-chain kernel) in f32 and
bf16, their launch counts, their independence of the knobs and the inputs
they refuse; the CNN-front prototypes' kernels (the parity conv1 + pool1
kernel in both layouts and its ablation stops, the front probe's stages,
K1's debug stops) against their plain versions, and the four scripts' main
at N=64; the forward rate probes' kernels (the matmul-rate kernel at small
ragged shapes, the chained-dot kernel in every mode at K=384 and 512, the
layout kernel in every body) against their plain versions, their launch
counts, the inputs they refuse, and the three scripts' main at small
sizes; the backward-dot probes' kernels (tt, xp, nt, and nn with its two
epilogues) at ragged shapes, bitwise repeatable, nt's zero tail, the
inputs they refuse, and the three scripts' main at small sizes. Every test
needs
a CUDA device and skips without one. On the GPU machine (which has no jax, and tests/conftest.py
imports jax) run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

import numpy as np

from silent_speech_tpu_torch.infer.predictor import Predictor, full_f32
from silent_speech_tpu_torch.models.bigru import (BiGRUClassifier,
                                                  BiGRUConfig, init_params,
                                                  init_roi_cnn)
from silent_speech_tpu_torch.train.step import (make_optimizer,
                                                smoothed_cross_entropy)
from silent_speech_tpu_torch.ops import (_kernels, cuda_bwd_dots, cuda_cnn,
                                         cuda_cnn_im2col, cuda_cnn_q8,
                                         cuda_dot_chain,
                                         cuda_front_probe, cuda_gru,
                                         cuda_gru_proto, cuda_layout_micro,
                                         cuda_mm_rate, cuda_parity_cnn)
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


# ----------------------------------------------------- K1-bf16, K4 and K5

# chip_smoke.py's bars (live, standardized): bf16 crossings of rounding
# boundaries after f32 reassociation; int8 bitwise up to the last ReLU;
# im2col as K1. On a constant frame one bf16 crossing moves a whole map:
# chip_smoke.py's BAR_BF16_CONST there.
_MODE_BARS = {"bf16": (1e-4, 1e-4), "q8": (1e-6, None),
              "im2col": (2e-4, 2e-3)}
_BF16_CONST_BAR = 2e-3


def _mode_call(mode, roi, p, standardize, impl="kernel", packed=None):
    if mode == "bf16":
        return cuda_cnn.roi_cnn_bf16(roi, p, standardize=standardize,
                                     impl=impl, flat=packed)
    if mode == "q8":
        return cuda_cnn_q8.roi_cnn_q8(roi, p, standardize=standardize,
                                      impl=impl, packed=packed)
    return cuda_cnn_im2col.roi_cnn_im2col(roi, p, standardize=standardize,
                                          impl=impl, packed=packed)


@pytest.mark.parametrize("mode", ["bf16", "q8", "im2col"])
@pytest.mark.parametrize("N,emb", [(1, 32), (33, 32), (300, 8), (7, 64)])
def test_serving_mode_kernel_matches_plain(dev, mode, N, emb):
    g = torch.Generator().manual_seed(N)
    roi = torch.randint(0, 256, (N, 48, 96), generator=g, dtype=torch.uint8)
    roi[-1] = 255
    if N > 2:
        roi[0] = 0
    roi, p = roi.to(dev), _cnn_params(dev, N, emb)
    for std, bar in zip((False, True), _MODE_BARS[mode]):
        if bar is None:
            continue
        before = _kernels.launch_counts()
        got = _mode_call(mode, roi, p, std)
        torch.cuda.synchronize()
        after = _kernels.launch_counts()
        assert [k for k in after if after[k] != before[k]] == \
            [{"bf16": "roi_cnn_bf16", "q8": "roi_cnn_q8",
              "im2col": "roi_cnn_im2col"}[mode]]
        ref = _mode_call(mode, roi, p, std, impl="plain")
        assert got.shape == (N, emb) and torch.isfinite(got).all()
        const = roi.reshape(N, -1).amin(1) == roi.reshape(N, -1).amax(1)
        if mode == "bf16":
            torch.testing.assert_close(got[const], ref[const],
                                       atol=_BF16_CONST_BAR, rtol=0)
            got, ref = got[~const], ref[~const]
        torch.testing.assert_close(got, ref, atol=bar, rtol=0)


def test_q8_kernel_rows_do_not_depend_on_the_batch(dev):
    roi = torch.randint(0, 256, (65, 48, 96), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(8)).to(dev)
    p = _cnn_params(dev, 8)
    q = cuda_cnn_q8.quantize_roi_cnn(p)
    whole = cuda_cnn_q8.roi_cnn_q8(roi, p, packed=q)
    for lo, hi in ((0, 1), (64, 65), (10, 43)):
        part = cuda_cnn_q8.roi_cnn_q8(roi[lo:hi].contiguous(), p, packed=q)
        assert torch.equal(part, whole[lo:hi])


@pytest.mark.parametrize("mode", ["bf16", "q8", "im2col"])
def test_serving_mode_kernel_rejects_what_it_does_not_take(dev, mode):
    p = _cnn_params(dev, 3)
    roi = torch.zeros((4, 48, 96), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="uint8"):
        _mode_call(mode, roi.float(), p, False)
    with pytest.raises(ValueError, match="contiguous"):
        _mode_call(mode, roi[::2], p, False)
    if mode != "im2col":  # one 16-byte load per thread
        off = torch.zeros(4 * 48 * 96 + 1, dtype=torch.uint8, device=dev)
        with pytest.raises(ValueError, match="aligned"):
            _mode_call(mode, off[1:].view(4, 48, 96), p, False)
    with pytest.raises(ValueError, match="48x96"):
        _mode_call(mode, torch.zeros((2, 40, 96), dtype=torch.uint8,
                                     device=dev), p, False)
    with pytest.raises(ValueError, match="f32"):
        _mode_call(mode, roi, _cnn_params("cpu", 3), False)
    bad = {"bf16": cuda_cnn.flat_weights_bf16(p)[:-1],
           "q8": {"qi": cuda_cnn_q8.quantize_roi_cnn(p)["qi"][:-1],
                  "qf": cuda_cnn_q8.quantize_roi_cnn(p)["qf"]},
           "im2col": cuda_cnn_im2col.pack_im2col(p).double()}[mode]
    with pytest.raises(ValueError):
        _mode_call(mode, roi, p, False, packed=bad)
    if mode == "q8":
        with pytest.raises(ValueError, match="serving-only"):
            _mode_call(mode, roi, p, True)
    assert _mode_call(mode, roi[:0], p, False).shape == (0, 32)


@pytest.mark.parametrize("knobs,kernel", [
    ({"compute_dtype": "bfloat16"}, "roi_cnn_bf16"),
    ({"roi_variant": "tiled3_q8"}, "roi_cnn_q8"),
    ({"roi_variant": "im2col"}, "roi_cnn_im2col"),
    ({"roi_variant": "tiled3_q8", "compute_dtype": "bfloat16"}, "roi_cnn_q8"),
])
def test_predictor_serving_mode_kernels_match_plain(dev, knobs, kernel):
    """Each mode's Predictor through its kernels against the same mode's
    plain path on the card (the GRU kernel's 1e-4 and the CNN's bars carry
    through a narrow model to well under 1e-3 on the logits)."""
    cfg = BiGRUConfig(x_dim=12, num_classes=5, hidden=16, roi_emb=8,
                      head_hidden=8)
    model = BiGRUClassifier.from_jax_params(
        init_params(cfg, torch.Generator().manual_seed(9)), cfg)
    rng = np.random.default_rng(9)
    X = rng.standard_normal((6, 20, 12)).astype(np.float32)
    L = np.array([20, 5, 11, 20, 1, 17], np.int32)
    R = rng.integers(0, 256, (6, 20, 48, 96), dtype=np.uint8)
    labels = dict(enumerate("abcde"))
    _kernels.reset_launch_counts()
    got = Predictor(model=model, id_to_label=labels, device="cuda",
                    **knobs).predict_batch(X, L, R)
    counts = _kernels.launch_counts()
    assert counts[kernel] == 1 and counts["gru_seq"] == 2
    assert sum(counts.values()) == 3
    ref = Predictor(model=model, id_to_label=labels, device="cuda",
                    roi_impl="plain", gru_impl="plain",
                    **knobs).predict_batch(X, L, R)
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)
    assert (got.argmax(-1) == ref.argmax(-1)).all()


# ----------------------------------------------- the GRU probes' kernels

# chip_smoke.py's bars: f32 as K2; with bf16_mm an h within one f32 sum
# order of a bf16 rounding boundary rounds one bf16 step apart in the kernel
# and its plain version, which moves the next step's product by up to
# max|Wh| * 2^-8 * |h| (about 1e-3 here)
_PROBE_BARS = {False: 1e-4, True: 2e-3}


def _probe_problem(dev, B, T, D, H, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, T, D, generator=g)
    lengths = torch.randint(1, T + 1, (B,), generator=g)
    lengths[0] = T
    lengths[-1] = 1
    if B > 2:
        lengths[1] = 0
    ps = [{k: v.to(dev) for k, v in gru_dir_init(D, H, g).items()}
          for _ in range(2)]
    return x.to(dev), lengths.to(dev), ps


# (batch_tile, k_steps) for each bf16_mm at H=192: the bf16 recurrence keeps
# Wh in shared memory beside a small stage
_REC_KNOBS = {False: (8, 8), True: (2, 1)}


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("B", [1, 33])
@pytest.mark.parametrize("sets", [1, 2])
def test_recurrence_kernel_matches_plain(dev, sets, B, bf16):
    T, D, H = 32, 180, 192
    x, lengths, ps = _probe_problem(dev, B, T, D, H, B + 10 * sets)
    xps = [x @ p["wi"] + p["bi"] for p in ps[:sets]]
    xp, L = torch.cat(xps), lengths.repeat(sets)
    wh = torch.stack([p["wh"] for p in ps[:sets]])
    bh = torch.stack([p["bh"] for p in ps[:sets]])
    bt, k = _REC_KNOBS[bf16]
    kernel = cuda_gru_proto.KSTEP if sets == 1 else cuda_gru_proto.KSTEP_2W
    before = _kernels.launch_counts()
    if sets == 1:
        got = cuda_gru_proto.gru_sequence_kstep(
            xp, L, wh[0], bh[0], batch_tile=bt, k_steps=k, bf16_mm=bf16)
    else:
        got = cuda_gru_proto.gru_sequence_kstep_2w(
            xp, L, wh, bh, batch_tile=bt, k_steps=k, bf16_mm=bf16)
    torch.cuda.synchronize()
    after = _kernels.launch_counts()
    assert {n for n in after if after[n] != before[n]} == {kernel.name}
    assert after[kernel.name] == before[kernel.name] + 1
    ref = torch.cat([cuda_gru_proto.gru_recurrence_plain(
        xps[s], lengths, wh[s], bh[s], bf16) for s in range(sets)])
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=_PROBE_BARS[bf16], rtol=0)
    assert not got[L.cpu() == 0].any()


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("B,D", [(1, 180), (33, 384)])
def test_dual_kernel_matches_plain(dev, B, D, bf16):
    T, H = 32, 192
    x, lengths, (pf, pb) = _probe_problem(dev, B, T, D, H, B + D)
    x_flip = gru_ops.flip_padded(x, lengths)
    before = cuda_gru_proto.DUAL.launches
    got = cuda_gru_proto.gru_layer_dual(x, x_flip, lengths, pf, pb,
                                        bf16_mm=bf16)
    torch.cuda.synchronize()
    assert cuda_gru_proto.DUAL.launches == before + 1
    ref = cuda_gru_proto.gru_layer_dual_plain(x, x_flip, lengths, pf, pb,
                                              bf16)
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, r, atol=_PROBE_BARS[bf16], rtol=0)


def test_probe_kernels_f32_do_not_depend_on_the_knobs(dev):
    """Every row's sums run in the same order whatever the tile and the
    stage: the f32 outputs are bitwise equal across the knobs."""
    x, lengths, (pf, pb) = _probe_problem(dev, 37, 20, 24, 64, 3)
    xp = x @ pf["wi"] + pf["bi"]
    x_flip = gru_ops.flip_padded(x, lengths)
    rec = [cuda_gru_proto.gru_sequence_kstep(
        xp, lengths, pf["wh"], pf["bh"], batch_tile=bt, k_steps=k)
        for bt, k in ((8, 8), (1, 1), (16, 3), (2, 20), (4, 32))]
    dual = [cuda_gru_proto.gru_layer_dual(x, x_flip, lengths, pf, pb,
                                          batch_tile=bt, k_steps=k)
            for bt, k in ((8, 8), (1, 1), (4, 3), (2, 32))]
    ref = cuda_gru_proto.gru_recurrence_plain(xp, lengths, pf["wh"],
                                              pf["bh"])
    for y in rec:
        torch.testing.assert_close(y, ref, atol=1e-4, rtol=0)
    ref = cuda_gru_proto.gru_layer_dual_plain(x, x_flip, lengths, pf, pb)
    for y in dual:
        for g, r in zip(y, ref):
            torch.testing.assert_close(g, r, atol=1e-4, rtol=0)
    for y in rec[1:]:
        assert torch.equal(y, rec[0]), (y - rec[0]).abs().max().item()
    for y in dual[1:]:
        for g, r in zip(y, dual[0]):
            assert torch.equal(g, r), (g - r).abs().max().item()


def test_probe_kernels_refuse_what_they_do_not_take(dev):
    x, lengths, (pf, pb) = _probe_problem(dev, 4, 6, 8, 16, 4)
    xp = x @ pf["wi"] + pf["bi"]
    with pytest.raises(RuntimeError, match="no backward"):
        cuda_gru_proto.gru_sequence_kstep(
            xp, lengths, pf["wh"].clone().requires_grad_(), pf["bh"])
    with pytest.raises(RuntimeError, match="no backward"):
        cuda_gru_proto.gru_layer_dual(x.clone().requires_grad_(), x, lengths,
                                      pf, pb)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_gru_proto.gru_sequence_kstep(xp.transpose(0, 1).contiguous()
                                          .transpose(0, 1), lengths,
                                          pf["wh"], pf["bh"])
    with pytest.raises(ValueError, match="f32"):
        cuda_gru_proto.gru_layer_dual(x.double(), x.double(), lengths, pf,
                                      pb)
    y = cuda_gru_proto.gru_sequence_kstep(xp[:0], lengths[:0], pf["wh"],
                                          pf["bh"])
    assert y.shape == (0, 6, 16)


# ---------------------------------------------- the CNN-front prototypes


def _parity_inputs(dev, N, kind, seed, const=None):
    """Class arrays of N frames (the last two all-0 and all-255 when
    ``const``) and packed or random (unpacked) WE, WO, bias."""
    rng = np.random.default_rng(seed)
    roi = rng.integers(0, 256, (N, 48, 96), dtype=np.uint8)
    if const:
        roi[-2], roi[-1] = 0, 255
    if kind == "packed":
        w = cuda_parity_cnn.pack_parity_conv1(
            rng.standard_normal((3, 3, 1, 8)).astype(np.float32) * 0.3,
            rng.standard_normal(8).astype(np.float32) * 0.1)
    else:
        w = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for s in ((104, 128), (104, 128), (1, 384))]
    roi = torch.from_numpy(roi).to(dev)
    return roi, cuda_parity_cnn.split_classes(roi), [t.to(dev) for t in w]


def _parity_close(got, ref, kind):
    """Packed: the scripts' f32 bar 1e-4; random weights (outputs in the
    thousands): max|err| / max|ref| <= 1e-6."""
    assert torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    if kind == "packed":
        assert err <= 1e-4, err
    else:
        assert err <= 1e-6 * ref.abs().max().item(), err


@pytest.mark.parametrize("kind", ["packed", "random"])
@pytest.mark.parametrize("N", [16, 48])
def test_parity_kernel_matches_plain(dev, N, kind):
    roi, xs, w = _parity_inputs(dev, N, kind, N, const=True)
    before = _kernels.launch_counts()
    halves = cuda_parity_cnn.conv1pool1_parity(*xs, *w)
    one = cuda_parity_cnn.conv1pool1(*[x.reshape(-1, 96) for x in xs], *w)
    torch.cuda.synchronize()
    after = _kernels.launch_counts()
    assert {n: after[n] - before[n] for n in after
            if after[n] != before[n]} == {"conv1pool1_parity": 1,
                                          "conv1pool1": 1}
    ref = cuda_parity_cnn.parity_halves_plain(xs, *w)
    for g, r in zip(halves, ref):
        _parity_close(g, r, kind)
    _parity_close(one, cuda_parity_cnn.pooled1_from_quadrants(ref, N), kind)
    assert torch.equal(one, cuda_parity_cnn.pooled1_from_quadrants(
        halves, N))
    if kind == "packed":
        _parity_close(one, cuda_parity_cnn.ref_conv1pool1(
            roi, *_conv0_of(w, dev)), kind)


def _conv0_of(w, dev):
    """Recover (k, b) from packed WE and bias: WE[dy*34 + dx, co] holds
    k[dy, dx, 0, co] / 255 (t = 0)."""
    WE, _, bias = (t.cpu() for t in w)
    k = torch.stack([torch.stack([WE[dy * 34 + dx, :8] for dx in range(3)])
                     for dy in range(3)])[:, :, None, :] * 255.0
    return k.to(dev), bias[0, :8].to(dev)


def test_parity_ablation_full_is_the_kernel_bitwise(dev):
    roi, xs, w = _parity_inputs(dev, 32, "random", 5)
    flat = [x.reshape(-1, 96) for x in xs]
    pp = cuda_parity_cnn.conv1pool1_parity(*xs, *w)
    before = cuda_parity_cnn.ABLATE.launches
    full = cuda_parity_cnn.run(*flat, *w, mode="full")
    for mode in ("io_only", "widen_only", "halo_only", "no_dot"):
        out = cuda_parity_cnn.run(*flat, *w, mode=mode)
        assert [o.shape for o in out] == [(32 * 12, 384)] * 2
    torch.cuda.synchronize()
    assert cuda_parity_cnn.ABLATE.launches == before + 5
    for a, b in zip(full, pp):
        assert torch.equal(a, b)


def test_parity_kernel_refuses_what_it_does_not_take(dev):
    _, xs, w = _parity_inputs(dev, 16, "packed", 1)
    with pytest.raises(ValueError, match="multiple of 16"):
        cuda_parity_cnn.conv1pool1_parity(*[x[:8] for x in xs], *w)
    with pytest.raises(ValueError, match="WE"):
        cuda_parity_cnn.conv1pool1_parity(*xs, w[0].double(), *w[1:])
    with pytest.raises(ValueError, match="must be on"):
        cuda_parity_cnn.conv1pool1_parity(*xs, w[0].cpu(), *w[1:])
    with pytest.raises(ValueError, match="counterpart"):
        cuda_parity_cnn.run(*[x.reshape(-1, 96) for x in xs], *w,
                            mode="no_patch")


@pytest.mark.parametrize("stage,F", [("dma", 1), ("dma", 2), ("dma", 4),
                                     ("widen", 1), ("front", 1),
                                     ("front_std", 1), ("overlap_a", 1),
                                     ("overlap_b", 1)])
def test_front_probe_stage_matches_plain(dev, stage, F):
    rng = np.random.default_rng(F)
    roi = rng.integers(0, 256, (36, 48, 96), dtype=np.uint8)
    roi[0], roi[1] = 0, 255
    x = torch.from_numpy(roi.reshape(-1, 384))
    if stage == "overlap_b":
        x = torch.from_numpy(roi[:, 5, :4].copy())
    before = cuda_front_probe.PROBE.launches
    got = cuda_front_probe.probe(stage, x.to(dev), F)
    torch.cuda.synchronize()
    assert cuda_front_probe.PROBE.launches == before + 1
    want = cuda_front_probe.probe_plain(stage, x, F)
    err = (got.cpu().double() - want.double()).abs()
    assert (err <= cuda_front_probe.bar(stage, x, F).double()).all(), \
        err.max().item()


@pytest.mark.parametrize("standardize", [False, True])
@pytest.mark.parametrize("stop", ["load", "norm", "conv1", "conv2", "conv3"])
def test_roi_cnn_debug_stop_matches_plain(dev, stop, standardize):
    """Each row holds three moments of the stage (sum, sum of squares,
    index-weighted sum): f32 sums of 4,608 to 10,400 terms against float64,
    within 1e-5 of each moment's sum of absolute terms."""
    g = torch.Generator().manual_seed(7)
    roi = torch.randint(0, 256, (9, 48, 96), generator=g, dtype=torch.uint8)
    roi = roi.to(dev)
    p = _cnn_params(dev, 7)
    before = _kernels.launch_counts()
    got = cuda_cnn.roi_cnn_fused(roi, p, standardize=standardize,
                                 debug_stop=stop)
    torch.cuda.synchronize()
    after = _kernels.launch_counts()
    assert {n for n in after if after[n] != before[n]} == {"roi_cnn_debug"}
    ref = cuda_cnn.roi_cnn_debug_plain(roi, p, standardize, stop)
    bar = 1e-5 * cuda_cnn.roi_cnn_debug_plain(roi, p, standardize, stop,
                                              absolute=True)
    assert torch.isfinite(got).all()
    assert ((got - ref).abs() <= bar).all(), (got - ref).abs().max().item()


@pytest.mark.parametrize("script", ["proto_parity_cnn", "proto_parity_e2e",
                                    "proto_ablate", "probe_front"])
def test_cnn_front_script_main_on_the_card(dev, script, capsys):
    import importlib
    mod = importlib.import_module(f"silent_speech_tpu_torch.scripts.{script}")
    _kernels.reset_launch_counts()
    out = mod.main(["64", "iters=2"])
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    assert out["timer"] == "cuda events" and out["N"] == 64
    want = {"proto_parity_cnn": ["conv1pool1_parity"],
            "proto_parity_e2e": ["conv1pool1", "roi_cnn"],
            "proto_ablate": ["parity_ablate"],
            "probe_front": ["roi_front_probe", "roi_cnn", "roi_cnn_debug"]}
    assert all(counts[k] > 0 for k in want[script]), counts
    assert all(r["ms"] is not None for r in out["rows"]
               if "no counterpart" not in r.get("note", ""))


# ------------------------------------------------ the forward rate probes


@pytest.mark.parametrize("M,K,N,reps,grid", [
    (16, 24, 16, 9, 2), (70, 104, 130, 9, 2), (1, 8, 1, 1, 1),
    (192, 104, 128, 64, 3)])
def test_mm_rate_kernel_matches_plain(dev, M, K, N, reps, grid):
    a, b = cuda_mm_rate.make_problem(M, K, N, dev)
    before = cuda_mm_rate.KERNEL.launches
    r = cuda_mm_rate.check(a, b, reps, grid)
    torch.cuda.synchronize()
    assert cuda_mm_rate.KERNEL.launches == before + 1
    assert r["share_of_bar"] <= 1.0


@pytest.mark.parametrize("mode", cuda_dot_chain.MODES)
@pytest.mark.parametrize("K", cuda_dot_chain.KS)
def test_dot_chain_kernel_matches_plain(dev, mode, K):
    rng = np.random.default_rng(K)
    x = torch.from_numpy(rng.integers(0, 256, (3 * 8, 128),
                                      dtype=np.uint8)).to(dev)
    x[:8] = 255  # the largest seed
    w = cuda_dot_chain.make_weights(mode, K).to(dev)
    before = cuda_dot_chain.KERNEL.launches
    cuda_dot_chain.check(x, w, mode)  # the check and timed instantiations
    torch.cuda.synchronize()
    assert cuda_dot_chain.KERNEL.launches == before + 2
    timed = cuda_dot_chain.dot_chain(x, w, mode)
    want = cuda_dot_chain.output_of(cuda_dot_chain.chain_plain(x, w, mode))
    if mode.startswith("int8"):
        assert torch.equal(timed, want)
    if mode == "bf16":  # chains held in f32 or f16 fail the rounding check
        for keep in (torch.float32, torch.float16):
            assert cuda_dot_chain.rounding_outside(
                cuda_dot_chain.trace_plain(x, w, keep), x, w) > 0


def test_rate_probe_kernels_refuse_what_they_do_not_take(dev):
    x = torch.zeros((16, 128), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="K in"):
        cuda_dot_chain.dot_chain(x, cuda_dot_chain.make_weights(
            "f32", 256).to(dev), "f32")
    w = cuda_dot_chain.make_weights("int8", 384).to(dev)
    with pytest.raises(ValueError, match="packed"):
        cuda_dot_chain.dot_chain(x, w, "int8", packed=w.float())
    with pytest.raises(ValueError, match="uint8"):
        cuda_dot_chain.dot_chain(x[:, :64], w, "int8")
    a, b = cuda_mm_rate.make_problem(8, 16, 8, dev)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_mm_rate.mm_rate(a.t(), b[:8].t().contiguous())
    xs = torch.zeros((768, 768), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_layout_micro.layout("copy", xs.t())
    with pytest.raises(ValueError, match="unknown body"):
        cuda_layout_micro.layout("gather", xs)


@pytest.mark.parametrize("body", cuda_layout_micro.BODIES)
def test_layout_kernel_matches_plain(dev, body):
    from silent_speech_tpu_torch.scripts import mosaic_micro
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2 * 768, 768)).astype(np.float32)).to(dev)
    before = cuda_layout_micro.KERNEL.launches
    mosaic_micro.check_body(body, x)
    torch.cuda.synchronize()
    assert cuda_layout_micro.KERNEL.launches == before + 1


@pytest.mark.parametrize("script,argv,want", [
    ("probe_int8", ["2", "iters=2"], ["dot_chain"]),
    ("mosaic_micro", ["2", "iters=2"], ["layout_micro"]),
    ("bench_fused_cnn", ["64", "iters=2"],
     ["mm_rate", "roi_cnn", "roi_cnn_bf16", "roi_cnn_debug", "gru_seq"])])
def test_rate_probe_script_main_on_the_card(dev, script, argv, want,
                                            monkeypatch):
    import importlib
    mod = importlib.import_module(f"silent_speech_tpu_torch.scripts.{script}")
    monkeypatch.setattr(cuda_mm_rate, "REPS", 2)  # the mxu probe, cut
    monkeypatch.setattr(cuda_mm_rate, "GRID", 2)
    _kernels.reset_launch_counts()
    parts = [mod.probe_mxu, mod.main] if script == "bench_fused_cnn" \
        else [mod.main]
    outs = [part(argv) for part in parts]
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    assert all(counts[k] > 0 for k in want), counts
    assert all(o["timer"] == "cuda events" for o in outs)
    assert all(r["ms"] > 0 for o in outs for r in o["rows"]
               if r["ms"] is not None)


# ---------------------------------------------- the backward-dot probes

BWD_KERNELS = {"tt": cuda_bwd_dots.KERNEL_TT, "xp": cuda_bwd_dots.KERNEL_XP,
               "nt": cuda_bwd_dots.KERNEL_NT,
               "base": cuda_bwd_dots.KERNEL_BASE,
               "nn": cuda_bwd_dots.KERNEL_NN}


def _bwd_operands(kind, dev, rows, m, K, N, seed=5):
    rng = np.random.default_rng(seed)
    p = cuda_bwd_dots.draw(rng, (rows, K), dev)
    dy = cuda_bwd_dots.draw(rng, (rows, N), dev)
    w = cuda_bwd_dots.draw(rng, (K, N), dev)
    return {"tt": (p, dy, {"m": m}), "xp": (p, dy, {"m": m}),
            "nt": (dy, w, {"m": m}), "base": (p, w, {"m": m}),
            "nn": (p[:m].T.contiguous(), dy[:m].contiguous(),
                   {"steps": 3})}[kind]


@pytest.mark.parametrize("kind", cuda_bwd_dots.KINDS)
@pytest.mark.parametrize("rows,m,K,N", [(100, 24, 104, 130), (64, 64, 16, 8),
                                        (1, 1, 1, 1), (300, 37, 65, 63)])
def test_bwd_dot_kernel_matches_plain(dev, kind, rows, m, K, N):
    a, b, kw = _bwd_operands(kind, dev, rows, m, K, N)
    before = BWD_KERNELS[kind].launches
    r = cuda_bwd_dots.check(kind, a, b, **kw)
    torch.cuda.synchronize()
    assert BWD_KERNELS[kind].launches == before + 1
    assert r["share_of_bar"] <= 1.0


@pytest.mark.parametrize("M,K,N,steps", [(384, 104, 256, 7), (24, 130, 70, 3),
                                         (384, 512, 256, 600)])
def test_bwd_dot_tt_steps_match_plain(dev, M, K, N, steps):
    """dots3's form: one tile of M rows, its product added in each step."""
    p, dy, _ = _bwd_operands("tt", dev, M, M, K, N)
    cuda_bwd_dots.check("tt", p, dy, m=M, steps=steps)
    pk = p.T.contiguous()
    cuda_bwd_dots.check("nn", pk, dy, steps=steps)


@pytest.mark.parametrize("kind", cuda_bwd_dots.KINDS)
def test_bwd_dot_kernels_are_bitwise_repeatable(dev, kind):
    a, b, kw = _bwd_operands(kind, dev, 3000, 384 if kind != "nn" else 96,
                             104, 256)
    one = cuda_bwd_dots.run(kind, a, b, **kw)
    two = cuda_bwd_dots.run(kind, a, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(one, two)


@pytest.mark.parametrize("kind,K,N,steps,groups", [
    ("tt", 512, 256, 256, 12),   # 32 tiles: 384 blocks of 396 slots
    ("nn", 104, 256, 512, 47),   # 8 tiles: 376 blocks, 11 steps a group
    ("xp", 512, 256, 256, 8),    # 2 blocks an SM: 256 of 264 slots
    ("tt", 128, 192, 4, 4),      # fewer steps than slots: a step a group
    ("tt", 1600, 1600, 5, 1)])   # more tiles than slots: one group
def test_bwd_dot_groups_fill_one_wave(dev, kind, K, N, steps, groups):
    """csrc/bwd_dots.cu sizes the groups from the shapes alone: at most one
    wave of the blocks its launch bounds guarantee on 132 SMs."""
    n = cuda_bwd_dots._scratch(kind, K, N, steps, dev).numel()
    assert n == (0 if groups == 1 else groups * K * N)


def test_bwd_dot_nt_writes_zeros_past_the_tiles(dev):
    dy, w, kw = _bwd_operands("nt", dev, 100, 24, 104, 130)
    m = kw["m"]
    junk = torch.full((100, 104), float("nan"), device=dev)
    del junk  # the allocator hands the block to the output next
    out = cuda_bwd_dots.bwd_dot_nt(dy, w, m)
    torch.cuda.synchronize()
    assert torch.equal(out[96:], torch.zeros_like(out[96:]))
    assert torch.isfinite(out).all()


def test_bwd_dot_kernels_refuse_what_they_do_not_take(dev):
    p, dy, w = (_bwd_operands(k, dev, 64, 16, 16, 16)[i]
                for k, i in (("tt", 0), ("tt", 1), ("nt", 1)))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_bwd_dots.bwd_dot_tt(p, dy.T.contiguous().T, 16)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_bwd_dots.bwd_dot_nt(dy, w.T.contiguous().T, 16)
    with pytest.raises(ValueError, match="one device"):
        cuda_bwd_dots.bwd_dot_base(p, w.cpu(), 16)
    with pytest.raises(ValueError, match="f32"):
        cuda_bwd_dots.bwd_dot_nn(p.T.contiguous().half(), dy, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_bwd_dots.bwd_dot_xp(p.cpu(), dy.cpu(), 16, impl="kernel")


@pytest.mark.parametrize("script,argv,want", [
    ("proto_bwd_dots", ["3072", "iters=2"], ["bwd_dot_tt", "bwd_dot_nt"]),
    ("proto_bwd_dots2", ["3072", "iters=2"],
     ["bwd_dot_base", "bwd_dot_tt", "bwd_dot_xp"]),
    ("proto_bwd_dots3", ["4", "iters=2"], ["bwd_dot_tt", "bwd_dot_nn"])])
def test_bwd_dots_script_main_on_the_card(dev, script, argv, want):
    import importlib
    mod = importlib.import_module(f"silent_speech_tpu_torch.scripts.{script}")
    _kernels.reset_launch_counts()
    out = mod.main(argv)
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    assert all(counts[k] > 0 for k in want), counts
    assert out["timer"] == "cuda events"
    assert all(r["ms"] > 0 and r["share_of_bar"] <= 1.0 for r in out["rows"])
