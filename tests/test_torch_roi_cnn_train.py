"""The port's training ROI CNN (``cuda_cnn.roi_cnn_fused_train``) against
the JAX package's fused custom VJP (ops/pallas_cnn2_grad.py, the Pallas
backward in interpret mode) and its 'xla' autodiff.

On the CPU the wrapper runs its plain version, autograd through the plain
CNN; the CUDA backward kernel is held against that plain version on the
card (tests/test_torch_cuda.py, chip_smoke.py). The bar is
tests/test_fused_train.py's: max |d| / max |ref| < 5e-5 for each gradient
tensor, with the readout sum(tanh(out) @ proj). Constant frames make every
2x2 pool window an exact tie; under the standardization only frames of 0
and 255 are held (another level's mean rounds in an order-dependent way
and the 1e-6 std floor magnifies it), and against 'xla' only: the Pallas
kernel scales by a rounded 1/255.

The autograd wiring of the kernel path (a flat weight buffer built from the
parameters, a Function whose backward returns the buffer's gradient) is
tested here too, with the two kernels replaced by plain stand-ins."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from silent_speech_tpu.models import bigru as jm
from silent_speech_tpu.ops.pallas_cnn2_grad import roi_cnn_fused_train
from silent_speech_tpu_torch.ops import _kernels, cuda_cnn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BAR = 5e-5


def _jax_grads(p, roi, proj, standardize, impl):
    def loss(p):
        if impl == "fused":
            out = roi_cnn_fused_train(roi, p, standardize=standardize,
                                      f_tile=4, interpret=True)
        else:
            r = jm.preprocess_roi(roi.reshape(1, *roi.shape), standardize)
            out = jm.roi_cnn_forward(p, r)[0]
        return jnp.sum(jnp.tanh(out) @ proj)
    return jax.grad(loss)(p)


def _torch_grads(params, roi, proj, standardize):
    leaves = {k: {n: torch.from_numpy(np.array(v)).requires_grad_(True)
                  for n, v in d.items()} for k, d in params.items()}
    out = cuda_cnn.roi_cnn_fused_train(torch.from_numpy(roi), leaves,
                                       standardize=standardize)
    (torch.tanh(out) @ torch.from_numpy(proj)).sum().backward()
    return {k: {n: t.grad.numpy() for n, t in d.items()}
            for k, d in leaves.items()}


def _assert_close(got, want, bar=BAR):
    for k in want:
        for n in want[k]:
            a, b = got[k][n], np.asarray(want[k][n])
            rel = np.abs(a - b).max() / max(1e-6, float(np.abs(b).max()))
            assert rel < bar, f"{k}/{n}: rel err {rel:.2e}"


def _frames(kind, rng):
    if kind == "random":
        return rng.integers(0, 256, (10, 48, 96), dtype=np.uint8)
    levels = [0, 37, 128, 255] if kind == "ties" else [0, 255]
    return np.broadcast_to(np.asarray(levels, np.uint8)[:, None, None],
                           (len(levels), 48, 96)).copy()


@pytest.mark.parametrize("kind,standardize,impls", [
    ("random", False, ("fused", "xla")),
    ("random", True, ("fused", "xla")),
    ("ties", False, ("fused", "xla")),
    ("exact-ties", True, ("xla",)),
])
def test_weight_grads_match_jax(rng, kind, standardize, impls):
    p = jax.tree.map(np.asarray, jm.init_roi_cnn(jax.random.PRNGKey(1), 32))
    roi = _frames(kind, rng)
    proj = rng.standard_normal((32,)).astype(np.float32)
    got = _torch_grads(p, roi, proj, standardize)
    for impl in impls:
        _assert_close(got, _jax_grads(p, jnp.asarray(roi), jnp.asarray(proj),
                                      standardize, impl))


def test_frames_get_no_gradient_and_geometry_is_checked():
    p = {k: {n: torch.from_numpy(np.array(v)) for n, v in d.items()}
         for k, d in jax.tree.map(np.asarray, jm.init_roi_cnn(
             jax.random.PRNGKey(2), 8)).items()}
    roi = torch.zeros((2, 48, 96), dtype=torch.uint8)
    out = cuda_cnn.roi_cnn_fused_train(roi, p)
    assert not out.requires_grad and not roi.requires_grad
    with pytest.raises(ValueError, match="48x96"):
        cuda_cnn.roi_cnn_fused_train(torch.zeros((2, 96, 48),
                                                 dtype=torch.uint8), p)
    with pytest.raises(ValueError, match="uint8"):
        cuda_cnn.roi_cnn_fused_train(roi.float(), p)


def _unflat(flat, emb):
    """The kernels' flat weight vector -> the JAX-layout parameter dict."""
    out, o = {}, 0
    for key, (ci, co) in zip(("conv0", "conv1", "conv2"),
                             ((1, 8), (8, 16), (16, 24))):
        w = flat[o:o + 9 * ci * co].reshape(co, ci, 3, 3)
        o += 9 * ci * co
        out[key] = {"w": w.permute(2, 3, 1, 0), "b": flat[o:o + co]}
        o += co
    out["fc"] = {"w": flat[o:o + 24 * emb].reshape(emb, 24).t(),
                 "b": flat[o + 24 * emb:o + 25 * emb]}
    return out


def test_kernel_path_autograd_wiring(monkeypatch, rng):
    """With the kernel path's two launches replaced by plain stand-ins that
    take the flat buffer, the Function gives every parameter (HWIO convs,
    (in, out) fc) the gradient that autograd through the plain CNN gives,
    and the backward reads the buffer the forward was given."""
    emb = 8
    seen = {}

    def fwd(roi, flat, emb_, standardize):
        seen["fwd"] = flat
        return cuda_cnn.roi_cnn_plain(roi, _unflat(flat, emb_), standardize)

    def bwd(roi, dE, flat, *, standardize):
        seen["bwd"] = flat
        with torch.enable_grad():
            f = flat.detach().requires_grad_(True)
            out = cuda_cnn.roi_cnn_plain(roi, _unflat(f, emb), standardize)
            return torch.autograd.grad(out, f, dE)[0]

    monkeypatch.setattr(_kernels, "use_kernel", lambda impl, t: True)
    monkeypatch.setattr(cuda_cnn, "_forward_kernel", fwd)
    monkeypatch.setattr(cuda_cnn, "roi_cnn_weight_grads", bwd)
    g = torch.Generator().manual_seed(0)
    base = {k: {n: torch.randn(t.shape, generator=g) * 0.3
                for n, t in d.items()}
            for k, d in jax.tree.map(np.asarray, jm.init_roi_cnn(
                jax.random.PRNGKey(3), emb)).items()}
    roi = torch.from_numpy(rng.integers(0, 256, (5, 48, 96), dtype=np.uint8))
    dE = torch.randn(5, emb, generator=g)
    grads = []
    for route in ("kernel", "plain"):
        leaves = {k: {n: t.clone().requires_grad_(True) for n, t in d.items()}
                  for k, d in base.items()}
        out = (cuda_cnn.roi_cnn_fused_train(roi, leaves, impl="auto")
               if route == "kernel" else
               cuda_cnn.roi_cnn_train_plain(roi, leaves))
        (out * dE).sum().backward()
        grads.append({k: {n: t.grad for n, t in d.items()}
                      for k, d in leaves.items()})
    assert seen["bwd"].data_ptr() == seen["fwd"].data_ptr()
    for k in grads[1]:
        for n in grads[1][k]:
            torch.testing.assert_close(grads[0][k][n], grads[1][k][n],
                                       rtol=1e-5, atol=1e-6)
