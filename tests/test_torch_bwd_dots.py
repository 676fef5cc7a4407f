"""The backward-dot probes of the port (silent_speech_tpu_torch.scripts.
proto_bwd_dots, proto_bwd_dots2, proto_bwd_dots3; ops/cuda_bwd_dots.py)
against the JAX scripts' kernels, loaded from their files and run in
interpret mode; the scripts themselves are not edited.

proto_bwd_dots's ``run_tt`` and ``run_nt`` take ``interpret=True``;
proto_bwd_dots2's and proto_bwd_dots3's ``_make`` have no such flag, so
the loaded module's ``pl`` is replaced by a namespace whose
``pallas_call`` runs in interpret mode (and dots3's STEPS is cut to 3):
their own ``_make``, BlockSpecs and compiler params run unchanged.

On the CPU the port's wrappers run their plain versions; the CUDA kernels
are held against those on the card (tests/test_torch_cuda.py,
chip_smoke.py). Sizes: rows <= 64 (one ragged count, 40), m in {8, 16},
K in {16, 24}, N in {8, 24}; inputs from numpy seeds; the bar 1e-5 of the
largest value (relative).
"""

import functools
import importlib.util
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from silent_speech_tpu_torch.ops import cuda_bwd_dots as bd
from silent_speech_tpu_torch.scripts import (proto_bwd_dots,
                                             proto_bwd_dots2,
                                             proto_bwd_dots3)
from silent_speech_tpu_torch.scripts import proto_parity_cnn as harness

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-5
STEPS3 = 3


def _load_jax_script(name, interpret_pl=False):
    spec = importlib.util.spec_from_file_location(
        f"_jax_bwd_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if interpret_pl:
        mod.pl = types.SimpleNamespace(**{
            **{k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")},
            "pallas_call": functools.partial(pl.pallas_call,
                                             interpret=True)})
    return mod


@pytest.fixture(scope="module")
def dots1():
    return _load_jax_script("proto_bwd_dots")


@pytest.fixture(scope="module")
def dots2():
    return _load_jax_script("proto_bwd_dots2", interpret_pl=True)


@pytest.fixture(scope="module")
def dots3():
    mod = _load_jax_script("proto_bwd_dots3", interpret_pl=True)
    mod.STEPS = STEPS3
    return mod


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL * np.abs(want).max()


SIZES = [(rows, m, K, N) for rows in (64, 40) for m in (8, 16)
         for K, N in ((16, 8), (24, 24))]


# ------------------------------------------------------ proto_bwd_dots


@pytest.mark.parametrize("rows,m,K,N", SIZES)
def test_tt_plain_matches_run_tt(dots1, rows, m, K, N):
    p, dy = _draw(rows + m + K, (rows, K), (rows, N))
    want = np.asarray(dots1.run_tt(jnp.asarray(p), jnp.asarray(dy), m, True))
    got = bd.bwd_dot_tt(torch.from_numpy(p), torch.from_numpy(dy), m)
    _close(got.numpy(), want)


@pytest.mark.parametrize("rows,m,K,N", SIZES)
def test_nt_plain_matches_run_nt(dots1, rows, m, K, N):
    dy, w = _draw(rows + m + N, (rows, N), (K, N))
    want = np.asarray(dots1.run_nt(jnp.asarray(dy), jnp.asarray(w), m, True))
    got = bd.bwd_dot_nt(torch.from_numpy(dy), torch.from_numpy(w), m).numpy()
    Gm = rows // m * m
    assert got.shape == want.shape == (rows, K)
    _close(got[:Gm], want[:Gm])
    assert not got[Gm:].any()  # the rows the TPU kernel leaves unwritten


def test_ragged_rows_drop_the_tail(dots1):
    """run_tt's G = rows // m sums the first G m rows only."""
    p, dy = _draw(7, (20, 16), (20, 8))
    want = np.asarray(dots1.run_tt(jnp.asarray(p), jnp.asarray(dy), 8, True))
    _close(want, p[:16].T @ dy[:16])
    assert np.abs(want - p.T @ dy).max() > 0.1
    got = bd.bwd_dot_tt(torch.from_numpy(p), torch.from_numpy(dy), 8)
    _close(got.numpy(), p[:16].T @ dy[:16])


# ----------------------------------------------------- proto_bwd_dots2


@pytest.mark.parametrize("kind", ["base", "tt", "xp"])
@pytest.mark.parametrize("rows,m", [(64, 8), (64, 16), (40, 16)])
def test_dots2_plain_matches_the_jax_kernel(dots2, kind, rows, m):
    K, N = 24, 8
    p, dy, w = _draw(rows + m, (rows, K), (rows, N), (K, N))
    body = {"base": dots2._k_base, "tt": dots2._k_tt, "xp": dots2._k_xp}
    b = w if kind == "base" else dy
    out_shape = (1, N) if kind == "base" else (K, N)
    f = dots2._make(body[kind], p.shape, b.shape, m, out_shape,
                    a_follows_grid=kind != "base")
    want = np.asarray(f(jnp.asarray(p), jnp.asarray(b)))
    got = bd.run(kind, torch.from_numpy(p), torch.from_numpy(b), m=m)
    _close(got.numpy(), want)


# ----------------------------------------------------- proto_bwd_dots3


@pytest.mark.parametrize("kind", ["tt", "nn"])
@pytest.mark.parametrize("M,K,N", [(16, 24, 8), (8, 16, 24)])
def test_dots3_plain_matches_the_jax_kernel(dots3, kind, M, K, N):
    p, dy, pk = _draw(M + K + N, (M, K), (M, N), (K, M))
    if kind == "tt":
        f = dots3._make(dots3._k_tt, (M, K), (M, N), (K, N))
        want = np.asarray(f(jnp.asarray(p), jnp.asarray(dy)))
        got = bd.bwd_dot_tt(torch.from_numpy(p), torch.from_numpy(dy), M,
                            STEPS3)
    else:
        f = dots3._make(dots3._k_nn, (K, M), (M, N), (K, N))
        want = np.asarray(f(jnp.asarray(pk), jnp.asarray(dy)))
        got = bd.bwd_dot_nn(torch.from_numpy(pk), torch.from_numpy(dy),
                            STEPS3)
    _close(got.numpy(), want)
    one = (p.T @ dy) if kind == "tt" else (pk @ dy)
    _close(want, STEPS3 * one)  # every step added: not one step, not 512


# ------------------------------------------------------------ compare


def _problem():
    p, dy, w = _draw(3, (40, 16), (40, 16), (16, 16))
    return torch.from_numpy(p), torch.from_numpy(dy), torch.from_numpy(w)


def test_compare_passes_the_plain_versions():
    p, dy, w = _problem()
    for kind, a, b, kw in (("tt", p, dy, {"m": 8}), ("xp", p, dy, {"m": 16}),
                           ("nt", dy, w, {"m": 16}), ("base", p, w, {"m": 8}),
                           ("nn", p[:8].T.contiguous(), dy[:8], {"steps": 3}),
                           ("tt", p[:8], dy[:8], {"m": 8, "steps": 3})):
        r = bd.compare(kind, bd.run(kind, a, b, **kw), a, b, **kw)
        assert r["share_of_bar"] == 0.0


@pytest.mark.parametrize("fault", ["transposed", "dropped_tile", "tail_tile",
                                   "step_short", "nt_tail", "base_tile_short"])
def test_compare_sees_faults(fault):
    p, dy, w = _problem()
    m = 16  # G = 2 tiles of 16 rows, 8 tail rows
    kw = {"m": m}
    if fault == "transposed":  # K = N: an output stored transposed
        kind, a, b = "tt", p, dy
        bad = bd.bwd_dot_tt_plain(p, dy, m).T.contiguous()
    elif fault == "dropped_tile":
        kind, a, b = "tt", p, dy
        bad = p[:16].T @ dy[:16]
    elif fault == "tail_tile":  # the tail rows summed in too
        kind, a, b = "xp", p, dy
        bad = p.T @ dy
    elif fault == "step_short":
        kind, a, b, kw = "nn", p[:8].T.contiguous(), dy[:8], {"steps": 3}
        bad = bd.bwd_dot_nn_plain(a, b, 2)
    elif fault == "nt_tail":  # a row of the tail written
        kind, a, b = "nt", dy, w
        bad = bd.bwd_dot_nt_plain(dy, w, m)
        bad[35] = 1e-3
    else:  # the column sums of one tile of two
        kind, a, b = "base", p, w
        bad = (p[:16] @ w).sum(dim=0, keepdim=True)
    with pytest.raises(RuntimeError, match="off the plain"):
        bd.compare(kind, bad, a, b, **kw)


def test_compare_rejects_a_wrong_shape():
    p, dy, _ = _problem()
    with pytest.raises(RuntimeError, match="shape"):
        bd.compare("tt", torch.zeros((16, 8)), p, dy, m=8)


# ------------------------------------------------------ counts, bounds


@pytest.mark.parametrize("kind,shape,steps,gmacs,ms", [
    ("tt", (98304, 384, 512, 256), None, 12.885, 0.3846),
    ("nt", (98304, 384, 256, 512), None, 12.885, 0.3846),
    ("xp", (98304, 1536, 512, 256), None, 12.885, 0.3846),
    ("base", (98304, 384, 512, 256), None, 12.885, 0.3846),
    ("tt", (98304, 192, 104, 256), None, 2.617, 0.0781),
    ("nt", (98304, 192, 104, 256), None, 2.617, 0.0781),
    ("tt", (384, 384, 512, 256), 512, 25.770, 0.7692),
    ("nn", (384, 256, 512), 512, 25.770, 0.7692),
    ("nn", (384, 104, 256), 512, 5.234, 0.1563)])
def test_bounds_are_the_worked_out_bounds(kind, shape, steps, gmacs, ms):
    n = bd.macs(kind, shape, steps)
    assert abs(n / 1e9 - gmacs) / gmacs < 2e-4
    b_ms, by = harness.bound_ms(n, bd.bytes_moved(kind, shape))
    assert by == "operations" and abs(b_ms - ms) / ms < 5e-4  # 4 digits


def test_bytes_count_each_input_once():
    assert bd.bytes_moved("tt", (98304, 384, 512, 256)) == 4 * (
        98304 * 768 + 512 * 256)
    assert bd.bytes_moved("nt", (100, 24, 104, 130)) == 4 * (
        96 * 130 + 104 * 130 + 100 * 104)


@pytest.mark.parametrize("kind,kw", [
    ("tt", {"m": 16}), ("xp", {"m": 16}), ("nt", {"m": 16}),
    ("base", {"m": 16}), ("nn", {"steps": 3}), ("tt", {"m": 8, "steps": 3})])
def test_library_call_computes_the_same_function(kind, kw):
    """The scripts' library column: one PyTorch call, the kind's function
    (nt's first G m rows; base's (1, N) as (N,))."""
    p, dy, w = _problem()
    a, b = {"nt": (dy, w), "base": (p, w)}.get(kind, (p, dy))
    if kind == "nn":
        a, b = p[:8].T.contiguous(), dy[:8]
    elif "steps" in kw:
        a, b = p[:8], dy[:8]
    want = bd.plain(kind, a, b, **kw)
    got = proto_bwd_dots.library_call(kind, a, b, **kw)()
    if kind == "nt":
        want = want[:32]
    _close(got.numpy(), want.reshape(got.shape).numpy())


def test_library_call_has_no_single_call_for_steps_over_tiles():
    p, dy, _ = _problem()
    with pytest.raises(ValueError, match="one tile"):
        proto_bwd_dots.library_call("tt", p, dy, m=8, steps=3)


# -------------------------------------------------------- what raises


def test_unknown_kinds_and_options_raise():
    p, dy, w = _problem()
    with pytest.raises(ValueError, match="unknown kind"):
        bd.run("tn", p, dy, m=8)
    with pytest.raises(TypeError, match="steps"):
        bd.run("xp", p, dy, m=8, steps=2)
    with pytest.raises(TypeError, match="m"):
        bd.plain("tt", p, dy)
    with pytest.raises(ValueError, match="m must be"):
        bd.bwd_dot_tt(p, dy, 41)
    with pytest.raises(ValueError, match="same rows"):
        bd.bwd_dot_tt(p, dy[:32], 8)
    with pytest.raises(ValueError, match="f32"):
        bd.bwd_dot_xp(p.double(), dy, 8)
    with pytest.raises(ValueError, match="steps >= 1"):
        bd.bwd_dot_nn(p[:8].T.contiguous(), dy[:8], 0)
    with pytest.raises(ValueError, match="w"):
        bd.bwd_dot_nt(dy, w[:, :8], 8)
    with pytest.raises(ValueError, match="unknown impl"):
        bd.bwd_dot_base(p, w, 8, impl="pallas")
    with pytest.raises(SystemExit):
        proto_bwd_dots.parse(["100", "device=cpu", "k=3"], "proto_bwd_dots",
                             1, 100, 1)
    with pytest.raises(SystemExit):  # fewer rows than the largest tile
        proto_bwd_dots2.main(["1000", "device=cpu"])


# -------------------------------------------------------- the scripts

SCRIPT_RUNS = {
    "proto_bwd_dots": (proto_bwd_dots, ["50", "device=cpu", "iters=1"],
                       {"SHAPES": ((16, 24, 8), (24, 16, 24))}),
    "proto_bwd_dots2": (proto_bwd_dots2, ["64", "device=cpu", "iters=1"],
                        {"K": 24, "N": 8, "BASE_MS": (8, 16),
                         "TT_MS": (8, 16, 32), "XP_MS": (8, 16)}),
    "proto_bwd_dots3": (proto_bwd_dots3, ["3", "device=cpu", "iters=1"],
                        {"SHAPES": ((16, 24, 8), (8, 16, 24))}),
}


@pytest.mark.parametrize("script", list(SCRIPT_RUNS))
def test_script_main_on_the_cpu(script, capsys, monkeypatch):
    mod, argv, cut = SCRIPT_RUNS[script]
    for name, value in cut.items():
        monkeypatch.setattr(mod, name, value)
    out = mod.main(argv)
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == out
    assert out["device"] == "cpu" and out["script"] == script
    assert "not a device measurement" in out["timer"]
    names = [r["name"] for r in out["rows"]]
    want = {"proto_bwd_dots": ["tt_16x24x8", "nt_16x24x8", "tt_24x16x24",
                               "nt_24x16x24"],
            "proto_bwd_dots2": ["base_m8", "base_m16", "tt_m8", "tt_m16",
                                "tt_m32", "xp_m8", "xp_m16"],
            "proto_bwd_dots3": ["tt_16x24x8", "nn_16x24x8", "tt_8x16x24",
                                "nn_8x16x24"]}[script]
    assert names == want
    for r in out["rows"]:
        assert r["ms"] > 0 and r["plain_ms"] > 0 and r["bound_ms"] > 0
        assert r["bound_by"] in ("bytes", "operations")
        assert r["library_ms"] > 0
        one_matmul = script == "proto_bwd_dots3" or r["kind"] == "base"
        assert ("library_t_macs" in r) == one_matmul
        assert not one_matmul or r["library_t_macs"] > 0


@pytest.mark.parametrize("script", ["proto_bwd_dots", "proto_bwd_dots2",
                                    "proto_bwd_dots3"])
def test_script_without_a_gpu_raises_unless_the_cpu_is_asked_for(script):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", f"silent_speech_tpu_torch.scripts.{script}",
         "3072"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "device=cpu" in proc.stderr
    assert proc.stdout.strip() == ""
