"""The port's training path (silent_speech_tpu_torch.train) against the JAX
package's, on the CPU at a small width (x_dim 12, hidden 16, emb 8; the ROI
stays 48x96).

Bars, as the JAX package's own training tests set them
(tests/test_train.py, tests/test_fused_train.py): one step's gradients
within 1e-4 and its post-Adam parameters within 3e-4 (Adam scales every
gradient by its own magnitude, which amplifies f32 reassociation noise
toward the lr); four steps, and a step after a checkpoint resume, within
5e-4. Dropout is off and augmentation absent wherever the two packages are
compared: they draw different random numbers."""

import json
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from silent_speech_tpu.models import bigru as jm
from silent_speech_tpu.train import checkpoint as jckpt
from silent_speech_tpu.train import step as jstep
from silent_speech_tpu_torch.apps import cli
from silent_speech_tpu_torch.core.config import TrainConfig
from silent_speech_tpu_torch.data.synthetic import generate_corpus
from silent_speech_tpu_torch.models.bigru import (BiGRUClassifier,
                                                  BiGRUConfig, jax_tree,
                                                  tree_leaves)
from silent_speech_tpu_torch.ops.nn import dropout
from silent_speech_tpu_torch.train import checkpoint as tckpt
from silent_speech_tpu_torch.train import loop
from silent_speech_tpu_torch.train.loop import train
from silent_speech_tpu_torch.train.step import (StepConfig,
                                                make_optimizer,
                                                smoothed_cross_entropy,
                                                train_step)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SMALL = dict(x_dim=12, num_classes=4, hidden=16, roi_emb=8, head_hidden=8,
             gru_dropout=0.0, head_dropout=0.0)
LR = 3e-4


def _batches(n, seed=5, B=3, T=8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        L = rng.integers(3, T + 1, B).astype(np.int32)
        L[0] = T
        out.append((rng.standard_normal((B, T, 12)).astype(np.float32), L,
                    rng.integers(0, 256, (B, T, 48, 96), dtype=np.uint8),
                    rng.integers(0, 4, B).astype(np.int32)))
    return out


def _params0(seed=0):
    return jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(seed),
                                                   jm.BiGRUConfig(**SMALL)))


def _jax_step():
    opt = jstep.make_optimizer(LR)
    return opt, jstep.make_batch_train_step(
        jstep.StepConfig(model=jm.BiGRUConfig(**SMALL), augment=None), opt)


def _jax_run(params, opt_state, batches):
    opt, step = _jax_step()
    params = jax.tree.map(jnp.asarray, params)
    if opt_state is None:
        opt_state = opt.init(params)
    key = jax.random.PRNGKey(0)
    for b in batches:
        params, opt_state, key, _ = step(params, opt_state, key,
                                         *map(jnp.asarray, b))
    return params, opt_state


def _port_model(params):
    return BiGRUClassifier.from_jax_params(params, BiGRUConfig(**SMALL))


def _port_run(model, opt, batches):
    scfg = StepConfig(model=model.cfg)
    for X, L, R, y in batches:
        train_step(model, opt, scfg, *map(torch.from_numpy, (X, L, R)),
                   torch.from_numpy(y).long(), torch.Generator())


def _max_diff(port_tree, jax_tree_):
    return max(float(np.abs(np.asarray(a.detach()) - np.asarray(b)).max())
               for a, b in zip(tree_leaves(port_tree),
                               jax.tree.leaves(jax_tree_)))


@pytest.mark.parametrize("smoothing", [0.0, 0.05, 0.2])
def test_smoothed_cross_entropy_matches_jax(smoothing):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((7, 5)).astype(np.float32) * 3
    y = rng.integers(0, 5, 7)
    got = smoothed_cross_entropy(torch.from_numpy(logits),
                                 torch.from_numpy(y), 5, smoothing)
    want = jstep.smoothed_cross_entropy(jnp.asarray(logits), jnp.asarray(y),
                                        5, smoothing)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    ref = torch.nn.CrossEntropyLoss(label_smoothing=smoothing)(
        torch.from_numpy(logits), torch.from_numpy(y))
    np.testing.assert_allclose(got.item(), ref.item(), rtol=1e-6)


def test_one_step_matches_jax():
    params = _params0()
    X, L, R, y = _batches(1)[0]
    jcfg = jm.BiGRUConfig(**SMALL)

    def loss_fn(p):
        lg = jm.train_forward(p, jcfg, *map(jnp.asarray, (X, L, R)),
                              train=True, rng=jax.random.PRNGKey(0))
        return jstep.smoothed_cross_entropy(lg, jnp.asarray(y), 4, 0.05)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree.map(jnp.asarray, params))
    model = _port_model(params)
    opt = make_optimizer(model, LR)
    logits = model.train_forward(*map(torch.from_numpy, (X, L, R)),
                                 generator=torch.Generator())
    loss = smoothed_cross_entropy(logits, torch.from_numpy(y), 4, 0.05)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5)
    grads = jax_tree({n: p.grad for n, p in model.named_parameters()},
                     model.cfg)
    assert _max_diff(grads, jgrads) <= 1e-4
    opt.step()
    want, _ = _jax_run(params, None, [(X, L, R, y)])
    assert _max_diff(model.params_tree(), want) <= 3e-4


def test_four_steps_match_jax():
    params, batches = _params0(1), _batches(4, seed=9)
    model = _port_model(params)
    _port_run(model, make_optimizer(model, LR), batches)
    assert _max_diff(model.params_tree(), _jax_run(params, None,
                                                   batches)[0]) <= 5e-4


def test_clip_follows_optax():
    """Gradients under the max norm pass unchanged; over it they scale to
    exactly the max norm (optax.clip_by_global_norm)."""
    import optax

    model = _port_model(_params0())
    opt = make_optimizer(model, LR, grad_clip_norm=1.0)
    for scale in (1e-3, 10.0):
        g = torch.Generator().manual_seed(0)
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=g) * scale
        tree = jax_tree({n: p.grad.clone() for n, p in
                         model.named_parameters()}, model.cfg)
        want, _ = optax.clip_by_global_norm(1.0).update(
            jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree), None)
        opt.clip()
        got = jax_tree({n: p.grad for n, p in model.named_parameters()},
                       model.cfg)
        assert _max_diff(got, want) <= 1e-6 * max(1.0, scale)


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_opt_state_checkpoint_interop(tmp_path, direction):
    """A run saved after two steps by one package resumes in the other, and
    the third step lands where the saving package's own third step does."""
    params, batches = _params0(2), _batches(3, seed=11)
    path = str(tmp_path / "two_steps.ckpt")
    if direction == "jax-to-port":
        p2, s2 = _jax_run(params, None, batches[:2])
        jckpt.save_checkpoint(path, jax.tree.map(np.asarray, p2), {"x": 1},
                              opt_state_arrays=[np.asarray(a) for a in
                                                jax.tree.leaves(s2)])
        want, _ = _jax_run(p2, s2, batches[2:])
        p, _, leaves = tckpt.load_checkpoint(path)
        model = _port_model(p)
        opt = make_optimizer(model, LR)
        opt.load_state_arrays(leaves)
        _port_run(model, opt, batches[2:])
        assert _max_diff(model.params_tree(), want) <= 5e-4
        assert int(opt.state_arrays()[0]) == 3
    else:
        model = _port_model(params)
        opt = make_optimizer(model, LR)
        _port_run(model, opt, batches[:2])
        tckpt.save_checkpoint(path, model.params_tree(), {"x": 1},
                              opt_state_arrays=opt.state_arrays())
        _port_run(model, opt, batches[2:])
        p, _, leaves = jckpt.load_checkpoint(path)
        jopt, _ = _jax_step()
        p = jax.tree.map(jnp.asarray, p)
        state = jax.tree.unflatten(jax.tree.structure(jopt.init(p)),
                                   [jnp.asarray(a) for a in leaves])
        want, _ = _jax_run(p, state, batches[2:])
        assert _max_diff(model.params_tree(), want) <= 5e-4


def test_dropout_scales_and_eval_is_deterministic():
    x = torch.ones(400, 50)
    y = dropout(x, 0.25, torch.Generator().manual_seed(0), True)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert dropout(x, 0.25, None, False) is x
    with pytest.raises(ValueError, match="generator"):
        dropout(x, 0.25, None, True)

    cfg = BiGRUConfig(**dict(SMALL, gru_dropout=0.3, head_dropout=0.3))
    model = BiGRUClassifier.from_jax_params(_params0(), cfg)
    X, L, R, _ = map(torch.from_numpy, _batches(1)[0])
    with torch.no_grad():
        e1 = model.train_forward(X, L, R, train=False)
        e2 = model.train_forward(X, L, R, train=False)
        t1 = model.train_forward(X, L, R, generator=torch.Generator()
                                 .manual_seed(1))
        t2 = model.train_forward(X, L, R, generator=torch.Generator()
                                 .manual_seed(1))
        t3 = model.train_forward(X, L, R, generator=torch.Generator()
                                 .manual_seed(2))
    assert torch.equal(e1, e2) and torch.equal(t1, t2)
    assert not torch.equal(t1, t3) and not torch.equal(t1, e1)


def test_every_parameter_gets_a_gradient():
    cfg = BiGRUConfig(**dict(SMALL, gru_dropout=0.1, head_dropout=0.2))
    model = BiGRUClassifier.from_jax_params(_params0(3), cfg)
    X, L, R, y = map(torch.from_numpy, _batches(1, seed=2, B=4)[0])
    logits = model.train_forward(X, L, R, generator=torch.Generator())
    smoothed_cross_entropy(logits, y, 4, 0.05).backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and p.grad.abs().max() > 0, name


# ---------------------------------------------------------------- train()

TINY = dict(epochs=2, batch_size=4, max_t=20, hidden=8, roi_emb=4,
            patience=5, lr=1e-3)
LINE = re.compile(r"^ep \d\d \| train loss \d+\.\d{4} acc \d\.\d{3} \| "
                  r"val loss \d+\.\d{4} acc \d\.\d{3}"
                  r"( \| top confusions: .+)? \[\d+\.\ds\]$")


@pytest.fixture(scope="module")
def tiny_corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny")
    generate_corpus(str(d), clips_per_word=3, words=["yes", "no"], seed=4)
    return str(d)


def test_train_console_checkpoint_and_history(tiny_corpus, tmp_path, capsys):
    out_path = str(tmp_path / "m.ckpt")
    r = train(TrainConfig(clip_dir=tiny_corpus, out_path=out_path, **TINY),
              device="cpu", metrics_path=str(tmp_path / "m.jsonl"))
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("ep ")]
    assert len(lines) == 2 and all(LINE.match(ln) for ln in lines), lines
    assert [h["epoch"] for h in r["history"]] == [1, 2]
    params, meta, opt = tckpt.load_checkpoint(out_path)
    assert meta["best_val_acc"] == r["best_acc"] > 0
    assert meta["x_dim"] == 180 and meta["labels"] == ["no", "yes"]
    n = len(tree_leaves(params))
    assert len(opt) == 1 + 2 * n
    for a, b in zip(tree_leaves(params), tree_leaves(r["params"])):
        np.testing.assert_array_equal(a, b)
    assert len(open(tmp_path / "m.jsonl").read().splitlines()) == 2


def test_train_learns_the_synthetic_corpus(tmp_path):
    """The bar of the JAX package's test_train_overfits_synthetic_corpus:
    separable synthetic classes beat 5-way chance decisively. Two threads:
    the test workers share the cores."""
    corpus = tmp_path / "clips"
    generate_corpus(str(corpus), clips_per_word=6,
                    words=["yes", "no", "hello", "thanks", "please"], seed=7)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        r = train(TrainConfig(clip_dir=str(corpus),
                              out_path=str(tmp_path / "m"), epochs=12,
                              patience=12, batch_size=10, max_t=30, lr=1e-3,
                              hidden=32, roi_emb=8),
                  verbose=False, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert r["best_acc"] >= 0.4
    assert r["history"][-1]["train_acc"] >= 0.5


def test_train_patience_stops_early(tiny_corpus, tmp_path, capsys):
    """lr=0 leaves the model as it starts, so the validation accuracy never
    improves after the first epoch: patience 1 stops at epoch 2."""
    r = train(TrainConfig(clip_dir=tiny_corpus, out_path=str(tmp_path / "p"),
                          **dict(TINY, epochs=5, patience=1, lr=0.0)),
              device="cpu")
    assert len(r["history"]) == 2
    assert "Early stopping." in capsys.readouterr().out


def test_train_resume_restores_best_acc_and_patience(tiny_corpus, tmp_path,
                                                     capsys):
    path = str(tmp_path / "r.ckpt")
    train(TrainConfig(clip_dir=tiny_corpus, out_path=path,
                      **dict(TINY, epochs=1)), device="cpu")
    params, meta, opt = tckpt.load_checkpoint(path)
    tckpt.save_checkpoint(path, params, dict(meta, epoch=1, best_val_acc=1.0,
                                             bad_epochs=1),
                          opt_state_arrays=opt)
    capsys.readouterr()
    r = train(TrainConfig(clip_dir=tiny_corpus, out_path=path,
                          **dict(TINY, epochs=4, patience=2)),
              device="cpu", resume_from=path)
    out = capsys.readouterr().out
    assert "at epoch 2 (best val acc so far 1.000)" in out
    assert "Early stopping. Best val acc: 1.000" in out
    assert [h["epoch"] for h in r["history"]] == [2]
    assert tckpt.load_checkpoint(path)[1]["epoch"] == 1  # not overwritten


def test_steps_per_dispatch_changes_nothing(tiny_corpus, tmp_path):
    runs = [train(TrainConfig(clip_dir=tiny_corpus, steps_per_dispatch=k,
                              out_path=str(tmp_path / f"{k}.ckpt"), **TINY),
                  verbose=False, device="cpu")["history"] for k in (0, 2)]
    assert [h["train_loss"] for h in runs[0]] == \
        [h["train_loss"] for h in runs[1]]


def test_train_cli(tiny_corpus, tmp_path, capsys):
    out_path = str(tmp_path / "cli.ckpt")
    assert cli.main(["train", f"clip_dir={tiny_corpus}",
                     f"out_path={out_path}", "epochs=1", "batch_size=4",
                     "max_t=20", "hidden=8", "roi_emb=4", "device=cpu",
                     f"metrics_path={tmp_path / 'cli.jsonl'}"]) == 0
    out = capsys.readouterr().out
    assert any(LINE.match(ln) for ln in out.splitlines()), out
    # the narrow checkpoint serves: the Predictor takes the widths the
    # metadata does not carry from the parameters
    assert cli.main(["predict", f"ckpt_path={out_path}",
                     f"clip={tiny_corpus}/*_0000.npz", "device=cpu"]) == 0
    assert "[('" in capsys.readouterr().out
    assert cli.main(["train", "clip_dir=x", "no_such_key=1"]) == 2
    assert "unknown arguments" in capsys.readouterr().out


@pytest.mark.parametrize("key,value", [
    ("mesh_shape", "data:2"),
    ("checkpoint_format", "orbax"), ("async_checkpoint", "true"),
    ("compute_dtype", "float16"), ("roi_remat", "true"),
    ("roi_impl", "xla"), ("roi_impl", "grouped"), ("roi_impl", "pallas"),
    ("roi_impl", "fused"), ("steps_per_dispatch", "-1"),
])
def test_unported_options_raise(key, value):
    with pytest.raises((NotImplementedError, ValueError), match=key):
        cli.main(["train", "clip_dir=/nonexistent", f"{key}={value}",
                  "device=cpu"])


def test_profile_dir_and_default_device(tiny_corpus, tmp_path,
                                        monkeypatch):
    """profile_dir: a torch.profiler trace of the first epoch, whose
    events name its train step (4 training clips, batch 4), stopped also
    when a step fails, so that the next run traces again; the default
    device is the card."""
    cfg = TrainConfig(clip_dir=tiny_corpus, out_path=str(tmp_path / "d"),
                      **TINY)
    prof = tmp_path / "prof"

    def failing(*args, **kwargs):
        raise RuntimeError("step failed")

    with monkeypatch.context() as m:
        m.setattr(loop, "train_step", failing)
        with pytest.raises(RuntimeError, match="step failed"):
            train(cfg, profile_dir=str(prof), device="cpu", verbose=False)
    for trace in prof.glob("trace_*.json"):
        trace.unlink()
    train(cfg, profile_dir=str(prof), device="cpu", verbose=False)
    traces = list(prof.glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert sum(ev.get("name") == "train_step" for ev in events) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train(cfg)
