"""The GRU design probes of the port (silent_speech_tpu_torch.scripts.
proto_gru2/3/4 and ops/cuda_gru_proto.py) against the JAX scripts'
functions (scripts/proto_gru2.py, proto_gru3.py, proto_gru4.py), loaded
from their files and run in Pallas interpret mode.

On the CPU the port's wrappers run their plain versions; the CUDA kernels
are held against those on the card (tests/test_torch_cuda.py,
chip_smoke.py). Bars: f32 atol 1e-4, the bar of tests/test_torch_gru.py;
with ``bf16_mm`` atol 1e-4 against the JAX function with ``bf16_mm`` (the
rounding sits at the same points in both, so only f32 sums in another
order differ).
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from silent_speech_tpu_torch.ops import cuda_gru_proto
from silent_speech_tpu_torch.scripts import (bench_gru, proto_gru2,
                                             proto_gru3, proto_gru4)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
B, T, D, H = 3, 7, 20, 16
LENGTHS = (7, 4, 1)
PORT = {"proto_gru2": proto_gru2, "proto_gru3": proto_gru3,
        "proto_gru4": proto_gru4}


def _load_jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_scripts():
    return {name: _load_jax_script(name) for name in PORT}


def _flip_np(x, lengths):
    out = x.copy()
    for b, n in enumerate(lengths):
        out[b, :n] = x[b, :n][::-1]
    return out


def _problem():
    """numpy inputs from a seed: 2 bidirectional layers, nonzero biases."""
    rng = np.random.default_rng(0)
    s = 1 / np.sqrt(H)

    def dir_params(d):
        return {k: rng.uniform(-s, s, shape).astype(np.float32)
                for k, shape in (("wi", (d, 3 * H)), ("bi", (3 * H,)),
                                 ("wh", (H, 3 * H)), ("bh", (3 * H,)))}

    layers = [{"fwd": dir_params(d), "bwd": dir_params(d)}
              for d in (D, 2 * H)]
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    lengths = np.array(LENGTHS, np.int32)
    x_flip = _flip_np(x, lengths)
    pf, pb = layers[0]["fwd"], layers[0]["bwd"]
    xp_f = x @ pf["wi"] + pf["bi"]
    xp_b = x_flip @ pb["wi"] + pb["bi"]
    return {"x": x, "x_flip": x_flip, "lengths": lengths, "layers": layers,
            "xp": xp_f, "wh": pf["wh"], "bh": pf["bh"],
            "xp2": np.concatenate([xp_f, xp_b]),
            "len2": np.concatenate([lengths, lengths]),
            "wh2": np.stack([pf["wh"], pb["wh"]]),
            "bh2": np.stack([pf["bh"], pb["bh"]])}


def _to(tree, conv):
    if isinstance(tree, dict):
        return {k: _to(v, conv) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, conv) for v in tree]
    return conv(tree)


PROBLEM = _problem()
TORCH_IN = _to(PROBLEM, lambda a: torch.from_numpy(a.copy()))
JAX_IN = _to(PROBLEM, jnp.asarray)

# name: (script, call of the function with the inputs)
CALLS = {
    "gru_sequence_kstep": ("proto_gru2", lambda f, a, **kw: f(
        a["xp"], a["lengths"], a["wh"], a["bh"], **kw)),
    "gru_sequence_kstep_2w": ("proto_gru2", lambda f, a, **kw: f(
        a["xp2"], a["len2"], a["wh2"], a["bh2"], **kw)),
    "bigru_fused": ("proto_gru2", lambda f, a, **kw: f(
        a["x"], a["lengths"], a["layers"], **kw)),
    "gru_layer_fusedproj": ("proto_gru3", lambda f, a, **kw: f(
        a["x"], a["lengths"], a["layers"][0]["fwd"], **kw)),
    "bigru_fusedproj": ("proto_gru3", lambda f, a, **kw: f(
        a["x"], a["lengths"], a["layers"], **kw)),
    "gru_layer_dual": ("proto_gru4", lambda f, a, **kw: f(
        a["x"], a["x_flip"], a["lengths"], a["layers"][0]["fwd"],
        a["layers"][0]["bwd"], **kw)),
    "bigru_dual": ("proto_gru4", lambda f, a, **kw: f(
        a["x"], a["lengths"], a["layers"], **kw)),
}
P3 = ("gru_layer_fusedproj", "bigru_fusedproj")


def _port(name, **kw):
    script, call = CALLS[name]
    with torch.no_grad():
        out = call(getattr(PORT[script], name), TORCH_IN, **kw)
    return [o.numpy() for o in (out if isinstance(out, tuple) else (out,))]


def _jax(jax_scripts, name, **kw):
    script, call = CALLS[name]
    out = call(getattr(jax_scripts[script], name), JAX_IN, interpret=True,
               **kw)
    return [np.asarray(o) for o in (out if isinstance(out, tuple)
                                    else (out,))]


@pytest.mark.parametrize("name,kw", [
    (name, kw) for name in CALLS
    for kw in ([{"reverse": False}, {"reverse": True}]
               if name == "gru_layer_fusedproj" else
               [{}] if name in P3 else [{}, {"bf16_mm": True}])],
    ids=lambda v: v if isinstance(v, str) else
    ",".join(f"{k}={w}" for k, w in v.items()) or "f32")
def test_probe_matches_jax_script(jax_scripts, name, kw):
    got, want = _port(name, **kw), _jax(jax_scripts, name, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
    for g in got:  # zero past each length
        for b, n in enumerate(LENGTHS):
            assert not g[b, n:].any()


@pytest.mark.parametrize("name", ["gru_sequence_kstep", "bigru_fused",
                                  "bigru_dual"])
def test_bf16_mm_moves_the_result(name):
    """The bf16 rounding is really applied: the result differs from f32
    (by the JAX scripts' own 1.65e-4 / 9.0e-4 at their size), within a
    bf16 step."""
    d = np.abs(_port(name, bf16_mm=True)[0] - _port(name)[0]).max()
    assert 1e-6 < d < 1e-2


@pytest.mark.parametrize("name,knobs", [
    ("gru_sequence_kstep", [{"batch_tile": 1, "k_steps": 1},
                            {"batch_tile": 16, "k_steps": 3}]),
    ("gru_sequence_kstep_2w", [{"batch_tile": 2, "k_steps": 7},
                               {"batch_tile": 4, "k_steps": 2}]),
    ("bigru_fused", [{"batch_tile": 1, "k_steps": 32},
                     {"batch_tile": 16, "k_steps": 1}]),
    ("gru_layer_dual", [{"batch_tile": 1, "k_steps": 1},
                        {"batch_tile": 4, "k_steps": 5}]),
    ("bigru_dual", [{"batch_tile": 2, "k_steps": 16},
                    {"batch_tile": 8, "k_steps": 1}]),
])
def test_f32_result_does_not_depend_on_the_knobs(name, knobs):
    ref = _port(name)
    for kw in knobs:
        for g, r in zip(_port(name, **kw), ref):
            assert np.array_equal(g, r), kw


def _zeros_problem(h, d=8, rows=2, t=3):
    z = torch.zeros
    p = {"wi": z(d, 3 * h), "bi": z(3 * h), "wh": z(h, 3 * h),
         "bh": z(3 * h)}
    return z(rows, t, d), z(rows, t, 3 * h), torch.full((rows,), t), p


_X, _L, _LAYERS = TORCH_IN["x"], TORCH_IN["lengths"], TORCH_IN["layers"]
TPU_KNOBS = {  # id: (call, what the error names)
    "kstep-tb256": (lambda: proto_gru2.gru_sequence_kstep(
        TORCH_IN["xp"], _L, TORCH_IN["wh"], TORCH_IN["bh"], batch_tile=256),
        "batch_tile"),
    "fused-tb128": (lambda: proto_gru2.bigru_fused(
        _X, _L, _LAYERS, batch_tile=128), "batch_tile"),
    "fused-k0": (lambda: proto_gru2.bigru_fused(
        _X, _L, _LAYERS, k_steps=0), "k_steps"),
    "2w-odd-rows": (lambda: proto_gru2.gru_sequence_kstep_2w(
        TORCH_IN["xp"], _L, TORCH_IN["wh2"], TORCH_IN["bh2"]), "two halves"),
    "dual-tb128": (lambda: proto_gru4.bigru_dual(
        _X, _L, _LAYERS, batch_tile=128), "batch_tile"),
    "dual-vmem96": (lambda: proto_gru4.bigru_dual(
        _X, _L, _LAYERS, vmem_mb=96), "vmem_mb"),
    "fusedproj-tb128": (lambda: proto_gru3.bigru_fusedproj(
        _X, _L, _LAYERS, batch_tile=128), "batch_tile"),
    "fusedproj-k8": (lambda: proto_gru3.bigru_fusedproj(
        _X, _L, _LAYERS, k_steps=8), "k_steps"),
    "fusedproj-vmem64": (lambda: proto_gru3.bigru_fusedproj(
        _X, _L, _LAYERS, vmem_mb=64), "vmem_mb"),
    "fusedproj-bf16": (lambda: proto_gru3.bigru_fusedproj(
        _X, _L, _LAYERS, bf16_mm=True), "bf16_mm"),
}


@pytest.mark.parametrize("case", TPU_KNOBS)
def test_tpu_only_knob_values_raise(case):
    call, match = TPU_KNOBS[case]
    with pytest.raises(ValueError, match=match):
        call()


def test_knobs_over_shared_memory_raise_at_full_width():
    """At H=192 the recurrence keeps its cluster's Wh slice beside h. In
    f32 (C=4: 110,592 bytes a block) every tile fits, the largest (64 rows)
    in 209,152 bytes; under bf16_mm the block holds Wh as bf16, so C=2 (the
    same bytes, 96 units a block), whose tiled body takes up to 32 rows: a
    64-row tile raises. The dual kernel (C=8) adds Wi's slice and the
    chunk's projection: at D=384 a 64-row tile does not fit, nor 20 rows
    with 8-step chunks; 16 x 8 and 24 x 4 do, and so does the plan's
    choice."""
    _, xp, lengths, p = _zeros_problem(192, rows=4, t=2)
    for bf16 in (False, True):
        y = cuda_gru_proto.gru_sequence_kstep(xp, lengths, p["wh"], p["bh"],
                                              bf16_mm=bf16, batch_tile=64)
        assert y.shape == (4, 2, 192)
    assert cuda_gru_proto.rec_smem_bytes(192, 64) == 209_152 <= \
        cuda_gru_proto.SMEM_LIMIT
    assert cuda_gru_proto.rec_smem_bytes(192, 32, bf16_mm=True) == 159_872
    _, xp, lengths, p = _zeros_problem(192, rows=64, t=2)
    with pytest.raises(ValueError, match="batch_tile"):
        cuda_gru_proto.gru_sequence_kstep(xp, lengths, p["wh"], p["bh"],
                                          bf16_mm=True, batch_tile=64)
    x, _, lengths, p = _zeros_problem(192, d=384, rows=64, t=8)
    for kw in ({"batch_tile": 64}, {"batch_tile": 20, "k_steps": 8}):
        with pytest.raises(ValueError, match="shared memory"):
            cuda_gru_proto.gru_layer_dual(x, x, lengths, p, p, **kw)
    for kw in ({"batch_tile": 16, "k_steps": 8},
               {"batch_tile": 24, "k_steps": 4}, {}):
        cuda_gru_proto.gru_layer_dual(x, x, lengths, p, p, **kw)
    assert cuda_gru_proto.dual_smem_bytes(384, 192, 20, 8) > \
        cuda_gru_proto.SMEM_LIMIT >= \
        cuda_gru_proto.dual_smem_bytes(384, 192, 16, 8)


@pytest.mark.parametrize("script", ["bench_gru", "proto_gru2", "proto_gru3",
                                    "proto_gru4"])
def test_script_main_on_the_cpu(script, capsys):
    """The script's main at a tiny size on the CPU (device=cpu): one row a
    variant, f32 rows within the bar of the scan, and the JSON line."""
    mod = {"bench_gru": bench_gru, **PORT}[script]
    out = mod.main(["5", "4", "device=cpu", "iters=1"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == out
    assert out["device"] == "cpu" and out["B"] == 5 and out["T"] == 4
    names = [r["name"] for r in out["rows"]]
    assert names[:2] == ["scan", "K2 bigru_kernel"]
    assert len(names) == len(printed) - 2 - len({r["table"] for r in
                                                 out["rows"]})
    for r in out["rows"]:
        bar = 1e-2 if "bf16" in r["name"] else ATOL
        assert r["max_abs_err"] <= bar and r["ms"] > 0, r


def test_script_without_a_gpu_raises_unless_the_cpu_is_asked_for():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "silent_speech_tpu_torch.scripts.proto_gru4",
         "8", "4"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "device=cpu" in proc.stderr
    assert proc.stdout.strip() == ""
