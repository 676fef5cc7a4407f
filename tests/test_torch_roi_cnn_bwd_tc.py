"""The ROI CNN weight-gradient kernel's tensor-core arithmetic
(csrc/roi_cnn_bwd.cu), emulated on the CPU (tests/tc_emulation.py).

The kernel recomputes the forward with conv2 and conv3 as 3xTF32 (K1's own
stage code) and forms every GEMM-shaped backward product as 3xTF32 too:
dW3 and the transposed conv3 with conv3's ReLU mask, exact in TF32, as an
operand (dfeat / 288 applied per frame), and dW2 and the transposed conv2
over the routed d conv2 written dense. Emulated so, the flat weight
gradient must lie
within the card bar (chip_smoke.py BAR_K3, max |d| / max |ref| a tensor)
of autograd through ``cuda_cnn.roi_cnn_train_plain`` (at least 10x inside
it on random frames; inside it on constant tie frames, where a window
routed elsewhere would miss it by far), and within the JAX test's bar of
``roi_cnn_fused_train``'s gradient (the Pallas backward in interpret
mode); one TF32 pass (hi*hi alone) must lie outside the card bar, so the
bar tells the split from one pass."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from silent_speech_tpu.models import bigru as jm
from silent_speech_tpu.ops.pallas_cnn2_grad import roi_cnn_fused_train
from silent_speech_tpu_torch.models.bigru import init_roi_cnn as torch_init
from silent_speech_tpu_torch.ops import cuda_cnn, cuda_cnn_check
from tc_emulation import BAR_K3, weight_grads_tc

N_FRAMES = 4
SIZES = {"conv0.w": 72, "conv0.b": 8, "conv1.w": 1152, "conv1.b": 16,
         "conv2.w": 3456, "conv2.b": 24, "fc.w": None, "fc.b": None}


def rel_errs(got: torch.Tensor, ref: torch.Tensor, emb: int) -> dict:
    """max |got - ref| / max |ref| for each parameter tensor of the flat
    layout."""
    out, o = {}, 0
    for name, n in SIZES.items():
        n = n or (24 * emb if name == "fc.w" else emb)
        a, b = got[o:o + n].double(), ref[o:o + n].double()
        out[name] = ((a - b).abs().max() / b.abs().max()).item()
        o += n
    assert o == got.numel() == ref.numel()
    return out


def plain_grads(roi: torch.Tensor, p: dict, dE: torch.Tensor,
                standardize: bool) -> torch.Tensor:
    leaves = {k: {n: t.detach().clone().requires_grad_(True)
                  for n, t in v.items()} for k, v in p.items()}
    out = cuda_cnn.roi_cnn_train_plain(roi, leaves, standardize)
    flat = [t for v in leaves.values() for t in v.values()]
    grads = iter(torch.autograd.grad(out, flat, dE))
    return cuda_cnn.flat_weights({k: {n: next(grads) for n in v}
                                  for k, v in leaves.items()})


def const_frames(levels) -> torch.Tensor:
    return torch.tensor(levels, dtype=torch.uint8)[:, None, None].expand(
        len(levels), 48, 96).contiguous()


@pytest.mark.parametrize("standardize", [False, True])
@pytest.mark.parametrize("seed,emb", [(0, 32), (11, 32), (64, 64), (1, 1)])
def test_3xtf32_weight_grads_within_card_bar_one_pass_outside(seed, emb,
                                                              standardize):
    g = torch.Generator().manual_seed(seed)
    p = torch_init(emb, g)
    roi = torch.randint(0, 256, (N_FRAMES, 48, 96), dtype=torch.uint8,
                        generator=g)
    dE = torch.randn(N_FRAMES, emb, generator=g)
    ref = plain_grads(roi, p, dE, standardize)
    err3, err1 = (max(rel_errs(weight_grads_tc(roi, p, dE, standardize,
                                               passes), ref, emb).values())
                  for passes in (3, 1))
    assert 10 * err3 <= BAR_K3 < err1, (err3, BAR_K3, err1)


@pytest.mark.parametrize("standardize,levels", [
    (False, (0, 37, 128, 255)), (True, (0, 255))])
def test_3xtf32_weight_grads_on_tie_frames(standardize, levels):
    """Constant frames make every 2x2 window an exact tie (under the
    standardization only 0 and 255 standardize exactly): the emulated
    routing to the first max is the plain version's (a frame routed
    elsewhere would miss the bar by orders of magnitude)."""
    g = torch.Generator().manual_seed(5)
    p = torch_init(32, g)
    roi = torch.cat([torch.randint(0, 256, (2, 48, 96), dtype=torch.uint8,
                                   generator=g), const_frames(levels)])
    dE = torch.randn(roi.shape[0], 32, generator=g)
    errs = rel_errs(weight_grads_tc(roi, p, dE, standardize, 3),
                    plain_grads(roi, p, dE, standardize), 32)
    assert max(errs.values()) < BAR_K3, errs


def test_3xtf32_weight_grads_match_pallas_backward():
    """Against the JAX package's fused custom VJP, the Pallas backward in
    interpret mode, at the bar of tests/test_fused_train.py, with the
    training path's standardization."""
    standardize = True
    rng = np.random.default_rng(3)
    params = jax.tree.map(np.asarray,
                          jm.init_roi_cnn(jax.random.PRNGKey(2), 32))
    roi = rng.integers(0, 256, (N_FRAMES, 48, 96), dtype=np.uint8)
    dE = rng.standard_normal((N_FRAMES, 32)).astype(np.float32)

    def loss(q):
        out = roi_cnn_fused_train(jnp.asarray(roi), q, standardize=standardize,
                                  f_tile=N_FRAMES, interpret=True)
        return jnp.sum(out * jnp.asarray(dE))

    want = jax.grad(loss)(jax.tree.map(jnp.asarray, params))
    want = cuda_cnn.flat_weights(jax.tree.map(
        lambda a: torch.from_numpy(np.array(a)), want))
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    got = weight_grads_tc(torch.from_numpy(roi), p, torch.from_numpy(dE),
                          standardize, 3)
    errs = rel_errs(got, want, 32)
    assert max(errs.values()) < BAR_K3, errs


# The route: the forward's decisions the gradient follows (the kernel's
# check entry writes K1's; chip_smoke.py and the card tests hold K3 against
# the plain version along that route, and the route's differences from the
# plain forward's own to near-ties).


def encode_route(r: cuda_cnn_check.Route) -> torch.Tensor:
    """A route in csrc/roi_cnn_bwd.cu write_route's byte layout."""
    def words(field, width, dtype):
        v = (field.to(torch.int64) << (width * torch.arange(
            field.shape[-1]))).sum(-1)
        return v.to(dtype).flatten(1).view(torch.uint8)
    n = r.arg1.shape[0]
    raw = torch.cat([words(r.arg1, 2, torch.int16).reshape(n, -1),
                     words(r.live1, 1, torch.int16).to(torch.uint8)
                     .reshape(n, -1, 2)[..., 0],
                     words(r.arg2, 2, torch.int64).reshape(n, -1, 8)[..., :4]
                     .reshape(n, -1),
                     words(r.live2, 1, torch.int16).reshape(n, -1),
                     words(r.live3, 1, torch.int64).reshape(n, -1, 8)[..., :4]
                     .reshape(n, -1)], dim=1)
    assert raw.shape[1] == cuda_cnn_check.ROUTE_BYTES
    return raw


def test_route_layout_decodes():
    g = torch.Generator().manual_seed(8)
    roi = torch.randint(0, 256, (3, 48, 96), dtype=torch.uint8, generator=g)
    r = cuda_cnn_check.plain_route(roi, torch_init(32, g), True)
    back = cuda_cnn_check.decode_route(encode_route(r))
    for name, a, b in zip(r._fields, r, back):
        assert torch.equal(a.to(torch.int64), b.to(torch.int64)), name


@pytest.mark.parametrize("standardize", [False, True])
def test_plain_along_its_own_route_is_the_plain_version(standardize):
    """Value and gradient: each pool takes the window's first max and each
    ReLU passes where its input is > 0, as roi_cnn_plain's own forward."""
    g = torch.Generator().manual_seed(9)
    p = torch_init(16, g)
    roi = torch.cat([torch.randint(0, 256, (3, 48, 96), dtype=torch.uint8,
                                   generator=g), const_frames((0, 255))])
    dE = torch.randn(roi.shape[0], 16, generator=g)
    route = cuda_cnn_check.plain_route(roi, p, standardize)
    outs = []
    for fn in (lambda q: cuda_cnn.roi_cnn_plain(roi, q, standardize),
               lambda q: cuda_cnn_check.roi_cnn_plain_routed(
                   roi, q, standardize, route)):
        leaves = {k: {n: t.clone().requires_grad_(True)
                      for n, t in v.items()} for k, v in p.items()}
        out = fn(leaves)
        flat = [t for v in leaves.values() for t in v.values()]
        outs.append([out] + list(torch.autograd.grad(out, flat, dE)))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    gaps = cuda_cnn_check.route_gaps(roi, p, standardize, route)
    assert all(g.diffs == 0 for g in gaps.values()), gaps


def test_route_gaps_catch_a_wrong_route():
    """A route that sends a pool window to another element than its max (a
    routing fault) shows a gap of the layer's own scale; one decision
    flipped at a near-tie would show a gap of its rounding."""
    g = torch.Generator().manual_seed(10)
    p = torch_init(8, g)
    roi = torch.randint(0, 256, (2, 48, 96), dtype=torch.uint8, generator=g)
    r = cuda_cnn_check.plain_route(roi, p, False)
    bad = r._replace(arg2=(r.arg2 + 1) % 4)
    gaps = cuda_cnn_check.route_gaps(roi, p, False, bad)
    assert gaps["pool2"].diffs == bad.arg2.numel()
    assert gaps["pool2"].gap > 1e-2
    assert gaps["pool1"] == (0, 0.0, 0)
    assert not cuda_cnn_check.near_ties_only(gaps, 1e-5)


@pytest.mark.parametrize("standardize,levels", [
    (False, (0, 37, 255)), (True, (0, 255))])
def test_route_gaps_catch_a_tie_taken_another_way(standardize, levels):
    """On constant frames most pool windows are exact ties (in float64 as
    in f32): a route that passes them on to their last element instead of
    the first shows gaps of 0, and only the count at exact ties tells it
    from the plain forward's own route."""
    p = {k: {n: t.double() for n, t in v.items()}
         for k, v in torch_init(8, torch.Generator().manual_seed(12)).items()}
    roi = const_frames(levels)
    own = cuda_cnn_check.plain_route(roi, p, standardize)
    c1, c2, _ = cuda_cnn_check._plain_stages(roi, p, standardize)
    tied = [(w == w[:, :, :, :1]).all(dim=3)
            for w in map(cuda_cnn_check._windows, (c1, c2))]
    assert all(t.float().mean() > 0.5 for t in tied)
    bad = own._replace(arg1=torch.where(tied[0], 3, own.arg1),
                       arg2=torch.where(tied[1], 3, own.arg2))
    gaps = cuda_cnn_check.route_gaps(roi, p, standardize, bad)
    for name, t in zip(("pool1", "pool2"), tied):
        assert gaps[name] == (int(t.sum()), 0.0, int(t.sum())), gaps
    assert not cuda_cnn_check.near_ties_only(gaps, 1e-5)
    assert cuda_cnn_check.near_ties_only(
        cuda_cnn_check.route_gaps(roi, p, standardize, own), 0.0)
