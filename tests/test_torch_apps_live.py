"""The port's camera commands (silent_speech_tpu_torch/apps/live.py through
apps/cli.py) against the JAX package's, headless: both CLIs run in process
with ``sim=48`` (the fake camera, landmarker and cv2 of runtime/fakes.py,
the same scenario) on one checkpoint written by the JAX package, the port
with ``device=cpu``.

- ``infer-live`` (also with ``predict_async=true``: the clip predicted on
  a worker thread), ``infer-gated`` (official model, hidden 16) and
  ``infer-ctc`` (hidden 16, 2 layers): the same printed predictions, the
  same labels in the same order, probabilities (CTC: scores) within 1e-3.
- ``infer-gated pipeline=threaded`` prints bitwise what its sequential run
  prints, and its frames went through the native ring.
- ``infer-stream``, the window engine (GRU-word, hidden 16) and the carry
  engine (uni-GRU, hidden 16, d_target 180; also threaded): the same
  predictions at the same frames (the softmax each engine hands on),
  within 1e-3.
- The commands ask for a card by default: without one they raise; bad keys
  print the usage and exit 2.
"""

import ast
import re

import numpy as np
import pytest
import torch

import jax

from silent_speech_tpu.apps import cli as jcli
from silent_speech_tpu.core.landmarks import WORDS
from silent_speech_tpu.infer import streaming as jstreaming
from silent_speech_tpu.train.checkpoint import reference_meta, save_checkpoint
from silent_speech_tpu_torch.apps import cli
from silent_speech_tpu_torch.infer import streaming
from silent_speech_tpu_torch.models import variants as V
from silent_speech_tpu_torch.models.bigru import BiGRUConfig, init_params
from silent_speech_tpu_torch.models.ctc_model import init_params as ctc_init
from silent_speech_tpu_torch.runtime import pipeline
from torch_threads import one_blas_thread  # noqa: F401 (autouse)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SIM = ["sim=48"]
BAR = 1e-3
LABELS = sorted(WORDS)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """The four checkpoints, saved by the JAX package. Their trees come
    from the port's inits in the JAX layout (the JAX inits take 15 s on
    the CPU, most of it compiling), from a torch generator."""
    d = tmp_path_factory.mktemp("live")
    gen = torch.Generator().manual_seed(0)
    tree = lambda p: jax.tree.map(lambda t: t.detach().numpy(), p)
    out = {k: str(d / f"{k}.ckpt") for k in ("official", "window", "carry",
                                             "ctc")}
    cfg = BiGRUConfig(x_dim=180, num_classes=10, use_roi=True, hidden=16)
    l2i = {w: i for i, w in enumerate(LABELS)}
    save_checkpoint(out["official"], tree(init_params(cfg, gen)),
                    reference_meta(x_dim=180, max_t=90, use_roi=True,
                                   roi_w=96, roi_h=48, labels=LABELS,
                                   label_to_id=l2i,
                                   id_to_label={i: w for w, i in l2i.items()},
                                   seed=42))
    save_checkpoint(out["window"], tree(V.GRUWordClassifier.init(
        gen, 83, 5, hidden=16).params_tree()), dict(
        input_dim=83, max_t=40,
        id_to_label={i: w for i, w in enumerate(LABELS[:5])}))
    save_checkpoint(out["carry"], tree(V.UniGRUClassifier.init(
        gen, 360, 5, hidden=16).params_tree()), dict(
        model="unigru", d_in=360, t_target=32, d_target=180,
        use_deltas=True, trim=dict(margin=2, q=0.6, min_keep=6),
        id_to_word={str(i): w for i, w in enumerate(LABELS[:5])}))
    save_checkpoint(out["ctc"], tree(ctc_init(180, gen, hidden=16,
                                              gru_layers=2, roi_emb=4)),
                    dict(max_t=40, uniq_labels=["yes", "no", "hello", "six"],
                         len_lambda=0.02, exp_len=5))
    return out


def _run(main, args, capsys):
    capsys.readouterr()
    rc = main(args)
    out = capsys.readouterr().out
    assert rc == 0, out
    return out


def _tops(out: str) -> list:
    """Every printed top-k list: 'Top3: [...]' lines (the CTC line too)."""
    return [ast.literal_eval(m) for m in re.findall(r"Top3: (\[.*\])", out)]


def _same_tops(got: list, want: list):
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert [lab for lab, _ in g] == [lab for lab, _ in w]
        np.testing.assert_allclose([p for _, p in g], [p for _, p in w],
                                   atol=BAR)


@pytest.mark.parametrize("cmd", ["infer-live", "infer-gated", "infer-ctc",
                                 "infer-live predict_async=true"])
def test_clip_commands_print_jax_predictions(ckpts, capsys, cmd):
    ckpt = ckpts["ctc" if cmd == "infer-ctc" else "official"]
    args = cmd.split()[:1] + [f"ckpt_path={ckpt}"] + cmd.split()[1:] + SIM
    want = _run(jcli.main, args, capsys)
    got = _run(cli.main, args + ["device=cpu"], capsys)
    _same_tops(_tops(got), _tops(want))
    if cmd == "infer-ctc":
        assert re.findall(r"Prediction: (\S+)", got) == \
            re.findall(r"Prediction: (\S+)", want)
        for line in ("Loaded ROI+CTC model. max_t = 40 len_lambda = 0.02",
                     "exp_len: 5", "raw T"):
            assert line in got and line in want


def test_gated_threaded_bitwise_sequential(ckpts, capsys, monkeypatch):
    rings = []
    orig = pipeline.FrameRing

    def ring(*a, **k):
        rings.append(orig(*a, **k))
        return rings[-1]

    monkeypatch.setattr(pipeline, "FrameRing", ring)
    args = ["infer-gated", f"ckpt_path={ckpts['official']}", "device=cpu",
            "sim=60"]
    seq = _run(cli.main, args, capsys)
    thr = _run(cli.main, args + ["pipeline=threaded"], capsys)
    assert "pipeline: produced=60 consumed=60 dropped=0" in thr
    tops = [ln for ln in seq.splitlines() if ln.startswith("Top3:")]
    assert len(tops) >= 2
    assert [ln for ln in thr.splitlines() if ln.startswith("Top3:")] == tops
    assert len(rings) == 1 and rings[0].native


@pytest.mark.parametrize("engine,pipe", [("window", "sequential"),
                                         ("carry", "sequential"),
                                         ("carry", "threaded")])
def test_stream_engines_predict_as_jax(ckpts, capsys, monkeypatch, engine,
                                      pipe):
    """The port's run (also threaded: every frame through the native ring,
    in order) against the JAX package's sequential run."""
    seen = {"jax": [], "port": []}
    for name, mod in (("jax", jstreaming), ("port", streaming)):
        orig = mod.stream_probs
        monkeypatch.setattr(mod, "stream_probs", lambda x, _o=orig,
                            _s=seen[name]: _s.append(_o(x)) or _s[-1])
    args = ["infer-stream", f"ckpt_path={ckpts[engine]}", f"engine={engine}",
            "max_t=20", "warmup_min=4"] + SIM
    _run(jcli.main, args, capsys)
    out = _run(cli.main, args + ["device=cpu", f"pipeline={pipe}"], capsys)
    if pipe == "threaded":
        assert "pipeline: produced=48 consumed=48 dropped=0" in out
    got, want = np.stack(seen["port"]), np.stack(seen["jax"])
    assert len(got) >= 20
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, atol=BAR)


def test_commands_need_a_card_unless_asked(ckpts, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cmd, ckpt in (("infer-live", "official"), ("infer-gated", "official"),
                      ("infer-stream", "window"), ("infer-ctc", "ctc"),
                      ("record", None)):
        args = [cmd] + ([f"ckpt_path={ckpts[ckpt]}"] if ckpt else []) + SIM
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(args)
    assert cli.main(["infer-stream"] + SIM) == 2
    assert "usage" in capsys.readouterr().out
    assert cli.main(["infer-live", "bogus=1"]) == 2
    assert "unknown arguments" in capsys.readouterr().out
