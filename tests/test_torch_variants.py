"""The port's variant families (silent_speech_tpu_torch/models/variants.py)
against the JAX package's, on the CPU at small widths.

- Each family's forward against the JAX forward on the same weights
  (carried over with ``from_jax_params``) and inputs: logits within
  BAR_LOGITS, the same argmax.
- The TemporalCNN's ``lengths`` mask: a clip padded to 32 frames gives the
  logits of the clip run unpadded, bitwise.
- ``params_tree`` round-trips through ``from_jax_params``, an npz
  checkpoint and a reference ``state_dict``.
- The GRU families' training forward: the plain scan, differentiable, its
  dropout drawn from the generator; the kernel refuses it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from silent_speech_tpu.models import variants as JV
from silent_speech_tpu_torch.models import variants as V
from silent_speech_tpu_torch.train.checkpoint import (load_checkpoint,
                                                      save_checkpoint)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# the same f32 function; the sums differ in order only
BAR_LOGITS = 1e-4
B, T, D, H, C = 3, 12, 13, 8, 5

# family: (the JAX init, its forward, the port's class, init arguments)
FAMILIES = {
    "temporal_cnn": (JV.init_temporal_cnn, JV.temporal_cnn_forward,
                     V.TemporalCNN, dict(width=16)),
    "gru_word": (JV.init_gru_word_classifier,
                 JV.gru_word_classifier_forward, V.GRUWordClassifier,
                 dict(hidden=H)),
    "unigru": (JV.init_unigru_classifier, JV.unigru_classifier_forward,
               V.UniGRUClassifier, dict(hidden=H)),
    "reduced": (JV.init_reduced_bigru, JV.reduced_bigru_forward,
                V.ReducedBiGRU, dict(hidden=H)),
    "mlp": (JV.init_mlp, JV.mlp_forward, V.SummaryMLP, {}),
}


def _jax_params(family: str, seed: int = 0):
    init, _, _, kw = FAMILIES[family]
    d_in = 2 * D if family == "mlp" else D
    return jax.tree.map(np.asarray,
                        init(jax.random.PRNGKey(seed), d_in, C, **kw))


def _inputs(family: str, seed: int = 1) -> np.ndarray:
    X = np.random.default_rng(seed).standard_normal((B, T, D)).astype(
        np.float32)
    if family == "mlp":
        return np.concatenate([X.mean(1), X.std(1)], -1).astype(np.float32)
    return X


def _np64(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().numpy()
    return np.asarray(t, np.float64)


def _max_diff(a, b) -> float:
    pa, pb = dict(V.named_leaves(a)), dict(V.named_leaves(b))
    assert sorted(pa) == sorted(pb)
    return max(float(np.abs(_np64(pa[k]) - _np64(pb[k])).max()) for k in pa)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_forward_matches_jax(family):
    params = _jax_params(family)
    X = _inputs(family)
    want = np.asarray(FAMILIES[family][1](params, jnp.asarray(X)))
    model = FAMILIES[family][2].from_jax_params(params)
    with torch.no_grad():
        got = model(torch.from_numpy(X)).numpy()
    assert got.shape == (B, C)
    np.testing.assert_allclose(got, want, atol=BAR_LOGITS, rtol=0)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    if family == "mlp":  # the summary: np.std's population std
        Xc = _inputs("temporal_cnn")
        np.testing.assert_allclose(
            V.clip_to_summary(torch.from_numpy(Xc)).numpy(),
            np.asarray(JV.clip_to_summary(jnp.asarray(Xc))), atol=1e-6)


def test_temporal_cnn_lengths_mask_is_the_unpadded_run():
    """A clip zero-padded to 32 frames with its length given is the clip
    run alone, bitwise (the masked forward the JAX package buckets with);
    the masked summary likewise matches the JAX one."""
    model = V.TemporalCNN.from_jax_params(_jax_params("temporal_cnn"))
    rng = np.random.default_rng(2)
    with torch.no_grad():
        for n in (5, 17, 31):
            X = rng.standard_normal((1, n, D)).astype(np.float32)
            Xp = np.zeros((1, 32, D), np.float32)
            Xp[:, :n] = X
            alone = model(torch.from_numpy(X))
            padded = model(torch.from_numpy(Xp), torch.tensor([n]))
            assert torch.equal(alone, padded), n
    X = rng.standard_normal((2, 9, D)).astype(np.float32)
    L = np.array([9, 4], np.int32)
    np.testing.assert_allclose(
        V.clip_to_summary(torch.from_numpy(X), torch.from_numpy(L)).numpy(),
        np.asarray(JV.clip_to_summary(jnp.asarray(X), jnp.asarray(L))),
        atol=1e-6)


def test_params_tree_round_trips(tmp_path):
    """params_tree -> from_jax_params, -> an npz checkpoint and back, and
    -> a reference state_dict (from_state_dict) give the same parameters,
    under the JAX tree's names."""
    for family, (_, _, cls, _) in FAMILIES.items():
        params = _jax_params(family, seed=3)
        model = cls.from_jax_params(params)
        tree = jax.tree.map(lambda t: t.detach().numpy(),
                            model.params_tree())
        assert jax.tree.structure(tree) == jax.tree.structure(params)
        assert _max_diff(tree, params) == 0.0
        path = str(tmp_path / f"{family}.ckpt")
        save_checkpoint(path, model.params_tree(), {"model": family})
        again = cls.from_jax_params(load_checkpoint(path)[0])
        assert _max_diff(again.params_tree(), params) == 0.0
        ref = cls.from_state_dict(model.state_dict())
        assert _max_diff(ref.params_tree(), params) == 0.0


def test_reduced_head_names_and_mlp_widths():
    """The reduced model loads its head as ``head.0.*`` or a bare
    ``head.*``; the MLP takes its hidden widths from the state dict."""
    model = V.ReducedBiGRU.from_jax_params(_jax_params("reduced"))
    sd = model.state_dict()
    bare = {("head" + k[len("head.0"):] if k.startswith("head.0") else k): v
            for k, v in sd.items()}
    assert "head.weight" in bare
    got = V.ReducedBiGRU.from_state_dict(bare)
    assert _max_diff(got.params_tree(), model.params_tree()) == 0.0
    wide = torch.nn.Sequential(
        torch.nn.Linear(2 * D, 256), torch.nn.ReLU(), torch.nn.Dropout(0.2),
        torch.nn.Linear(256, 128), torch.nn.ReLU(), torch.nn.Dropout(0.2),
        torch.nn.Linear(128, C)).eval()
    mlp = V.SummaryMLP.from_state_dict(
        {f"net.{k}": v for k, v in wide.state_dict().items()})
    feat = torch.from_numpy(_inputs("mlp"))
    with torch.no_grad():
        torch.testing.assert_close(mlp(feat), wide(feat), atol=1e-6, rtol=0)


def test_gru_training_forward_is_the_differentiable_scan():
    """With autograd the GRU families run the plain scan, their gradient
    reaches every parameter, their dropout draws from the generator (the
    same seed, the same logits; no generator raises); gru_impl='kernel'
    refuses the differentiable forward."""
    X = torch.from_numpy(_inputs("gru_word"))
    for family in ("gru_word", "unigru", "reduced"):
        model = FAMILIES[family][2].from_jax_params(_jax_params(family))
        model(X).sum().backward()
        assert all(p.grad is not None and p.grad.abs().sum() > 0
                   for p in model.parameters()), family
        with pytest.raises(ValueError, match="no backward"):
            model(X, gru_impl="kernel")
    for family in ("gru_word", "unigru", "mlp"):
        model = FAMILIES[family][2].from_jax_params(_jax_params(family))
        x = torch.from_numpy(_inputs(family))
        a, b = (model(x, train=True,
                      generator=torch.Generator().manual_seed(4))
                for _ in range(2))
        assert torch.equal(a, b)
        with torch.no_grad():
            assert not torch.equal(a, model(x))
        with pytest.raises(ValueError, match="generator"):
            model(x, train=True)
