"""The port's official model (silent_speech_tpu_torch.models.bigru) against
the JAX package's (silent_speech_tpu.models.bigru): the weight carry-over
``from_jax_params`` and both sides of the dual forward, at narrow widths
and once at full width. Bar: logits atol 1e-3 and the same argmax, as
tests/test_model_parity.py holds the JAX model against the reference."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from silent_speech_tpu.core.torch_export import (export_bigru_classifier,
                                                 export_reference_checkpoint)
from silent_speech_tpu.models import bigru as jm
from silent_speech_tpu_torch.models import bigru as tm
from silent_speech_tpu_torch.ops import cuda_cnn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NARROW = dict(x_dim=20, hidden=16, head_hidden=8, roi_emb=8)


def _pair(seed, **cfg_kw):
    jcfg = jm.BiGRUConfig(**cfg_kw)
    params = jax.tree.map(np.asarray,
                          jm.init_params(jax.random.PRNGKey(seed), jcfg))
    model = tm.BiGRUClassifier.from_jax_params(params, tm.BiGRUConfig(**cfg_kw))
    return jcfg, params, model


def _inputs(rng, B, T, D, use_roi):
    X = rng.standard_normal((B, T, D)).astype(np.float32)
    lengths = rng.integers(2, T + 1, B).astype(np.int32)
    lengths[0] = T
    roi = (rng.integers(0, 256, (B, T, 48, 96), dtype=np.uint8)
           if use_roi else None)
    return X, lengths, roi


def _logits(model, X, lengths, roi, live):
    args = (torch.from_numpy(X), torch.from_numpy(lengths),
            None if roi is None else torch.from_numpy(roi))
    with torch.no_grad():
        out = (model.live_forward(*args) if live
               else model.train_forward(*args, train=False))
    return out.numpy()


def _jax_logits(params, cfg, X, lengths, roi, live):
    args = (params, cfg, jnp.asarray(X), jnp.asarray(lengths),
            None if roi is None else jnp.asarray(roi))
    return np.asarray(jm.live_forward(*args) if live
                      else jm.train_forward(*args, train=False))


def _check(got, want):
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    assert (got.argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize("use_roi", [True, False])
@pytest.mark.parametrize("live", [True, False])
def test_dual_forward_matches_jax_narrow(rng, use_roi, live):
    cfg, params, model = _pair(1, use_roi=use_roi, **NARROW)
    X, lengths, roi = _inputs(rng, 4, 9, NARROW["x_dim"], use_roi)
    _check(_logits(model, X, lengths, roi, live),
           _jax_logits(params, cfg, X, lengths, roi, live))


def test_live_forward_matches_jax_full_width(rng):
    cfg, params, model = _pair(2)
    X, lengths, roi = _inputs(rng, 2, 16, 180, True)
    got = _logits(model, X, lengths, roi, live=True)
    assert got.shape == (2, 10)
    _check(got, _jax_logits(params, cfg, X, lengths, roi, live=True))


def test_state_dict_names_and_reference_pt(tmp_path, rng):
    """The parameters carry the reference names, and a reference .pt
    written by core.torch_export loads with load_state_dict."""
    cfg, params, model = _pair(3, **NARROW)
    assert set(model.state_dict()) == set(export_bigru_classifier(params))
    meta = dict(x_dim=NARROW["x_dim"], max_t=9, use_roi=True, roi_w=96,
                roi_h=48, labels=[f"w{i}" for i in range(10)],
                label_to_id={f"w{i}": i for i in range(10)},
                id_to_label={i: f"w{i}" for i in range(10)})
    path = str(tmp_path / "ref.pt")
    export_reference_checkpoint(params, meta, path)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    loaded = tm.BiGRUClassifier(tm.BiGRUConfig(**NARROW))
    loaded.load_state_dict(ckpt["model"], strict=True)
    X, lengths, roi = _inputs(rng, 3, 7, NARROW["x_dim"], True)
    np.testing.assert_array_equal(
        _logits(loaded.eval(), X, lengths, roi, True),
        _logits(model, X, lengths, roi, True))


def test_params_tree_round_trips_and_dual_forward_differs(rng):
    cfg, params, model = _pair(4, **NARROW)
    tree = jax.tree.map(lambda t: t.detach().numpy(), model.params_tree())
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    X, lengths, roi = _inputs(rng, 2, 6, NARROW["x_dim"], True)
    live = _logits(model, X, lengths, roi, True)
    train = _logits(model, X, lengths, roi, False)
    assert np.abs(live - train).max() > 1e-4  # the reference's skew


def test_training_forward_is_not_ported(rng):
    """What the training forward does not take: dropout without a
    generator, the GRU kernel (it has no backward), float frames."""
    _, _, model = _pair(5, **NARROW)
    X, lengths, roi = _inputs(rng, 1, 5, NARROW["x_dim"], True)
    with pytest.raises(ValueError, match="generator"):
        model.train_forward(torch.from_numpy(X), torch.from_numpy(lengths),
                            torch.from_numpy(roi))
    with pytest.raises(ValueError, match="no backward"):
        model.train_forward(torch.from_numpy(X), torch.from_numpy(lengths),
                            torch.from_numpy(roi),
                            generator=torch.Generator(), gru_impl="kernel")
    with pytest.raises(ValueError, match="uint8"):
        model.live_forward(torch.from_numpy(X), torch.from_numpy(lengths),
                           torch.from_numpy(roi).float())


def test_kernel_weights_built_once_and_rebuilt_on_change():
    """The kernels' weight layouts hold the model's values, are kept across
    calls, and are built anew after an in-place change of a parameter."""
    _, params, model = _pair(6, **NARROW)
    kw = model.kernel_weights()
    assert model.kernel_weights() is kw
    tree = model.params_tree()
    for lk, lp in zip(kw["gru"], tree["gru"]):
        for d in ("fwd", "bwd"):
            for k, v in lp[d].items():
                assert lk[d][k].is_contiguous()
                assert torch.equal(lk[d][k], v)
    assert torch.equal(kw["roi_cnn"], cuda_cnn.flat_weights(tree["roi_cnn"]))
    with torch.no_grad():
        model.roi_cnn.fc.bias.add_(1.0)
    kw2 = model.kernel_weights()
    assert kw2 is not kw
    assert torch.equal(kw2["roi_cnn"][-NARROW["roi_emb"]:],
                       kw["roi_cnn"][-NARROW["roi_emb"]:] + 1.0)
