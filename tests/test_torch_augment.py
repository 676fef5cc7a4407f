"""The port's augmentation (silent_speech_tpu_torch.data.augment) against
the JAX package's.

The two packages draw different numbers from the same seed, so each
``apply_*`` function is fed the draws that the JAX function's own key
splits make (recomputed here with jax.random) and must give the JAX
function's output. The arithmetic is the same f32 ops in the same order:
the bar is equality, or 1e-6 relative where a product is involved. The
``draw_*`` side is held to invariants under a ``torch.Generator``."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from silent_speech_tpu.data import augment as ja
from silent_speech_tpu_torch.data import augment as ta
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

EXTREME = dataclasses.replace(ja.OFFICIAL_AUGMENT, drop_max=12, drop_min_t=4)


def _batch(seed, B=6, T=20, D=5):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, T, D)).astype(np.float32)
    L = rng.integers(3, T + 1, B).astype(np.int32)
    L[0] = T
    return X, L


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _port_cfg(cfg):
    return ta.AugmentConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_noise_matches_jax(seed):
    X, L = _batch(seed)
    key = jax.random.PRNGKey(seed)
    want = ja.add_noise(key, jnp.asarray(X), jnp.asarray(L), 0.7, 0.01)
    k1, k2 = jax.random.split(key)
    apply = jax.random.bernoulli(k1, 0.7, (X.shape[0], 1, 1))
    noise = jax.random.normal(k2, X.shape, jnp.float32) * 0.01
    got = ta.apply_noise(*_t(X, L, apply, noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cfg", [ja.OFFICIAL_AUGMENT, ja.REDUCED_AUGMENT,
                                 EXTREME],
                         ids=["official", "reduced", "clamped"])
@pytest.mark.parametrize("seed", [0, 3])
def test_apply_drop_matches_jax(cfg, seed):
    X, L = _batch(seed)
    L[1] = 2  # too short to drop from
    key = jax.random.PRNGKey(seed)
    wX, wL = ja.drop_frames(key, jnp.asarray(X), jnp.asarray(L), cfg)
    k_gate, k_count, k_scores = jax.random.split(key, 3)
    gate = jax.random.bernoulli(k_gate, cfg.drop_prob, (X.shape[0],))
    k = jax.random.randint(k_count, (X.shape[0],), 1, cfg.drop_max + 1)
    scores = jax.random.uniform(k_scores, X.shape[:2])
    gX, gL = ta.apply_drop(*_t(X, L, gate, k, scores), _port_cfg(cfg))
    np.testing.assert_array_equal(gX.numpy(), np.asarray(wX))
    np.testing.assert_array_equal(gL.numpy(), np.asarray(wL))


@pytest.mark.parametrize("seed", [0, 5])
def test_apply_time_warp_matches_jax(seed):
    cfg = dataclasses.replace(ja.REDUCED_AUGMENT, time_warp_prob=0.8)
    X, L = _batch(seed, B=8, T=24)
    key = jax.random.PRNGKey(seed)
    wX, wL = ja.time_warp(key, jnp.asarray(X), jnp.asarray(L), cfg)
    k_gate, k_scale = jax.random.split(key)
    gate = jax.random.bernoulli(k_gate, cfg.time_warp_prob, (8,))
    scale = jax.random.uniform(k_scale, (8,), minval=cfg.time_warp_lo,
                               maxval=cfg.time_warp_hi)
    gX, gL = ta.apply_time_warp(*_t(X, L, gate, scale))
    np.testing.assert_array_equal(gX.numpy(), np.asarray(wX))
    np.testing.assert_array_equal(gL.numpy(), np.asarray(wL))


def test_apply_scale_jitter_matches_jax():
    cfg = dataclasses.replace(ja.REDUCED_AUGMENT, scale_jitter_prob=0.6)
    X, L = _batch(2)
    key = jax.random.PRNGKey(2)
    want = ja.scale_jitter(key, jnp.asarray(X), jnp.asarray(L), cfg)
    k_gate, k_s = jax.random.split(key)
    gate = jax.random.bernoulli(k_gate, 0.6, (X.shape[0], 1, 1))
    s = jax.random.uniform(k_s, (X.shape[0], 1, 1), minval=0.95,
                           maxval=1.05)
    got = ta.apply_scale_jitter(*_t(X, L, gate, s))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_apply_mixup_matches_jax():
    X, _ = _batch(4)
    y = np.eye(3, dtype=np.float32)[np.random.default_rng(4).integers(0, 3, 6)]
    key = jax.random.PRNGKey(4)
    wX, wy = ja.mixup(key, jnp.asarray(X), jnp.asarray(y), 0.2)
    k_lam, k_perm = jax.random.split(key)
    lam = jax.random.beta(k_lam, 0.2, 0.2)
    perm = jax.random.permutation(k_perm, 6)
    gX, gy = ta.apply_mixup(*_t(X, y, lam, perm))
    np.testing.assert_allclose(gX.numpy(), np.asarray(wX), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=1e-6,
                               atol=1e-7)
    same = ta.mixup(torch.Generator(), torch.from_numpy(X),
                    torch.from_numpy(y), alpha=0.0)
    assert same[0] is not None and torch.equal(same[0], torch.from_numpy(X))


@pytest.mark.parametrize("cfg", [ta.OFFICIAL_AUGMENT, ta.REDUCED_AUGMENT],
                         ids=["official", "reduced"])
def test_augment_batch_invariants(cfg):
    """Under a generator: lengths stay in [1, T], kept frames keep their
    order, everything past a clip's length is zero, and the same seed gives
    the same batch."""
    X, L = _batch(7, B=32, T=30, D=3)
    X[:, :, 0] = np.arange(30)[None, :]  # frame index in feature 0
    noise_free = dataclasses.replace(cfg, noise_prob=0.0,
                                     scale_jitter_prob=0.0)
    gX, gL = ta.augment_batch(torch.Generator().manual_seed(1),
                              torch.from_numpy(X), torch.from_numpy(L),
                              noise_free)
    assert ((gL >= 1) & (gL <= 30)).all()
    for b in range(32):
        n = int(gL[b])
        assert (gX[b, n:] == 0).all()
        if cfg.time_warp_prob == 0:
            idx = gX[b, :n, 0]
            assert n <= L[b] and (idx[1:] > idx[:-1]).all()
    again = ta.augment_batch(torch.Generator().manual_seed(1),
                             torch.from_numpy(X), torch.from_numpy(L),
                             noise_free)
    assert torch.equal(again[0], gX) and torch.equal(again[1], gL)
    noisy, _ = ta.augment_batch(torch.Generator().manual_seed(2),
                                torch.from_numpy(X), torch.from_numpy(L), cfg)
    assert noisy.shape == gX.shape and torch.isfinite(noisy).all()


def test_draws_follow_the_config():
    """The gates fire at about their probability, counts and scales stay in
    range, and noise has the configured spread."""
    g = torch.Generator().manual_seed(0)
    X = torch.zeros(4000, 8, 2)
    apply, noise = ta.draw_noise(g, X, 0.7, 0.01)
    assert abs(apply.float().mean().item() - 0.7) < 0.03
    assert abs(noise.std().item() - 0.01) < 5e-4
    gate, k, scores = ta.draw_drop(g, X, ta.OFFICIAL_AUGMENT)
    assert abs(gate.float().mean().item() - 0.35) < 0.03
    assert set(k.unique().tolist()) == {1, 2}
    assert ((scores >= 0) & (scores < 1)).all()
    _, scale = ta.draw_time_warp(g, X, ta.REDUCED_AUGMENT)
    assert ((scale >= 0.8) & (scale < 1.2)).all()
