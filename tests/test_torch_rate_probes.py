"""The forward rate probes of the port (silent_speech_tpu_torch.scripts.
probe_int8, bench_fused_cnn, mosaic_micro; ops/cuda_mm_rate.py,
ops/cuda_dot_chain.py, ops/cuda_layout_micro.py) against the JAX scripts'
kernel bodies (scripts/bench_fused_cnn.py ``_mm_kernel``,
scripts/probe_int8.py ``_kernel``, scripts/mosaic_micro.py's nine bodies),
loaded from their files and run through test-built ``pallas_call``s in
interpret mode; the scripts themselves are not edited.

On the CPU the port's wrappers run their plain versions; the CUDA kernels
are held against those on the card (tests/test_torch_cuda.py,
chip_smoke.py). Sizes: MR at (16, 24, 16) and (8, 16, 24), reps 9 (every
r % 8), grid 2; DC with the chain's 384 rows cut to 16, K in {16, 24}, 2
steps (the JAX kernel's never-written W scratch passed as an input); LP at
2 steps of (768, 768). Bars: MR and f32 1e-5 relative; the int modes and
the layout bodies bitwise (the unaligned body on the lanes it writes); the
product body 1e-5 relative; bf16 against the JAX body bitwise (both round
each product's f32 sum to bf16, and at these sizes the two f32 sums agree
on the CPU), its traced rows product by product
(ops/cuda_dot_chain.check_rounding, which chains held in f32 or f16
between products fail), and its moments within the card's bar (2e-2 of
each value's sum of |terms|, ops/cuda_dot_chain.BAR_BF16).
"""

import functools
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from silent_speech_tpu_torch.ops import cuda_dot_chain as dc
from silent_speech_tpu_torch.ops import cuda_layout_micro as lm
from silent_speech_tpu_torch.ops import cuda_mm_rate as mr
from silent_speech_tpu_torch.scripts import (bench_fused_cnn, mosaic_micro,
                                             probe_int8)
from silent_speech_tpu_torch.scripts import proto_parity_cnn as harness
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-5
DC_M, DC_STEPS = 16, 2


def _load_jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_rate_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_bfc():
    return _load_jax_script("bench_fused_cnn")


@pytest.fixture(scope="module")
def jax_int8():
    mod = _load_jax_script("probe_int8")
    mod.M = DC_M  # the chain's rows, cut to size
    return mod


@pytest.fixture
def small_chain(monkeypatch):
    """The port's chain cut to the test's rows."""
    monkeypatch.setattr(dc, "M", DC_M)


@pytest.fixture(scope="module")
def jax_layout_outputs():
    """mosaic_micro.main() at 2 steps with ``_mk`` in interpret mode and a
    ``timed`` that evaluates once: {body: output}, and x."""
    mod = _load_jax_script("mosaic_micro")
    mod.STEPS = 2

    def _mk(body, out_rows=mod.R):
        def kernel(x_ref, o_ref):
            body(x_ref, o_ref)

        @jax.jit
        def run(x):
            return pl.pallas_call(
                kernel, grid=(mod.STEPS,),
                in_specs=[pl.BlockSpec((mod.R, mod.L), lambda i: (i, 0))],
                out_specs=pl.BlockSpec((out_rows, mod.L), lambda i: (i, 0)),
                out_shape=jax.ShapeDtypeStruct((mod.STEPS * out_rows, mod.L),
                                               jnp.float32),
                interpret=True)(x)
        return run

    outs = []

    def timed(run, x, iters=0):
        outs.append(np.asarray(run(x)))
        return 0.0

    mod._mk, mod.timed = _mk, timed
    mod.main()
    x = np.random.default_rng(0).standard_normal(
        (mod.STEPS * mod.R, mod.L)).astype(np.float32)
    assert len(outs) == len(lm.BODIES)
    return dict(zip(lm.BODIES, outs)), x


# ------------------------------------------------------------- MR


@pytest.mark.parametrize("M,K,N", [(16, 24, 16), (8, 16, 24)])
def test_mm_rate_plain_matches_the_jax_kernel(jax_bfc, M, K, N):
    reps, grid = 9, 2
    a, b = mr.make_problem(M, K, N, "cpu")
    f = pl.pallas_call(
        functools.partial(jax_bfc._mm_kernel, reps), grid=(grid,),
        in_specs=[pl.BlockSpec((M, K), lambda i: (0, 0)),
                  pl.BlockSpec((K, N), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((M, N), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((M, N), jnp.float32), interpret=True)
    want = np.asarray(f(jnp.asarray(a.numpy()), jnp.asarray(b.numpy())))
    got = mr.mm_rate(a, b, reps, grid).numpy()
    assert np.abs(got - want).max() <= REL * np.abs(want).max()


def test_mm_rate_rolls_the_lanes_as_jnp_roll():
    a = torch.arange(12, dtype=torch.float32).reshape(2, 6)
    eye = torch.eye(6)
    got = mr.mm_rate_plain(a, eye, reps=10, grid=1).numpy()
    want = sum(np.roll(a.numpy(), r % 8, axis=1) for r in range(10))
    assert np.array_equal(got, want)


def test_mm_rate_compare_sees_faults():
    reps = 9
    a, b = mr.make_problem(70, 104, 130, "cpu")
    good = mr.mm_rate_plain(a, b, reps, 1)
    assert mr.compare(good, a, b, reps)["share_of_bar"] == 0.0
    wrong_roll = sum(torch.roll(a, -(r % 8), dims=1) @ b for r in range(reps))
    one_rep = a @ b * reps
    shifted = torch.roll(good, 1, dims=1)  # a store one column off
    for bad in (wrong_roll, one_rep, good * (1 + 1e-3), shifted):
        with pytest.raises(RuntimeError, match="off the plain"):
            mr.compare(bad.contiguous(), a, b, reps)


def test_mm_rate_bounds_are_the_worked_out_bounds():
    """At the f32 FMAs and 3xTF32 together (232 TFLOP/s): the kernel runs
    its products as 3xTF32 on wgmma."""
    want = {(192, 104, 128): 0.0903, (192, 1152, 384): 3.000,
            (192, 512, 128): 0.4443, (192, 1152, 576): 4.499,
            (512, 512, 512): 4.739, (1024, 1024, 1024): 37.91}
    for (M, K, N), ms in want.items():
        b_ms, by = harness.bound_ms(mr.macs(M, K, N), 0, "f32_3xtf32")
        assert by == "operations" and abs(b_ms - ms) / ms < 2e-3


# ------------------------------------------------------------- DC


def _dc_problem(mode, K):
    x = np.random.default_rng(K).integers(0, 256, (DC_STEPS * 8, 128),
                                          dtype=np.uint8)
    return x, dc.make_weights(mode, K)


def _jax_dc(jax_int8, mode, K, x, w):
    wdtype = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8,
              "int8i": jnp.int8}[mode]
    f = pl.pallas_call(
        lambda x_ref, w_ref, o_ref: jax_int8._kernel(mode, K, x_ref, o_ref,
                                                     w_ref),
        grid=(DC_STEPS,),
        in_specs=[pl.BlockSpec((8, 128), lambda i: (i, 0)),
                  pl.BlockSpec((K, K), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((1, 8, 128), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((DC_STEPS, 8, 128), jnp.float32),
        interpret=True)
    return np.asarray(f(jnp.asarray(x), jnp.asarray(w.numpy()).astype(wdtype)))


@pytest.mark.parametrize("mode", dc.MODES)
@pytest.mark.parametrize("K", [16, 24])
def test_dot_chain_plain_matches_the_jax_kernel(jax_int8, small_chain, mode,
                                                K):
    x, w = _dc_problem(mode, K)
    want = _jax_dc(jax_int8, mode, K, x, w)
    y = dc.chain_plain(torch.from_numpy(x), w, mode)
    got = dc.dot_chain(torch.from_numpy(x), w, mode).numpy()
    assert got.shape == want.shape == (DC_STEPS, 8, 128)
    if mode == "f32":
        scale = y[:, 0, :128].abs().sum(dim=1).numpy()[:, None, None]
        assert (np.abs(got - want) <= REL * scale).all()
    else:
        assert np.array_equal(got, want)
    if mode == "bf16":  # a chain held in f32 between products ends elsewhere
        unrounded = dc.trace_plain(torch.from_numpy(x), w, torch.float32)
        out = unrounded[:, 0, -1, :128].float().sum(dim=1)
        assert not np.array_equal(out.numpy(), want[:, 0, 0])


def _bf16_np(a):
    """f32 rounded to the nearest bf16 (ties to even), held in f32."""
    u = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _chain_np(x, w, mode):
    """A numpy transcription of probe_int8._kernel's body for each step:
    the final (M, K) y (int8i: the s32 sum)."""
    ys = []
    for s in range(x.shape[0] // 8):
        seed = int(x[8 * s:8 * s + 8].astype(np.int32).sum())
        K = w.shape[0]
        if mode in ("f32", "bf16"):
            y = np.full((DC_M, K), np.float32(seed) * np.float32(1e-6),
                        np.float32)
            wf = w.astype(np.float32)
            for _ in range(dc.DEPTH):
                y = y @ wf if mode == "f32" else _bf16_np(_bf16_np(y) @ wf)
            y = _bf16_np(y) if mode == "bf16" else y
        elif mode == "int8":
            y = np.full((DC_M, K), seed & 63, np.int8)
            for _ in range(dc.DEPTH):
                acc = y.astype(np.int32) @ w.astype(np.int32)
                y = (acc >> 7).astype(np.int8)
        else:
            base = np.full((DC_M, K), seed & 63, np.int8)
            y = np.zeros((DC_M, K), np.int32)
            for d in range(dc.DEPTH):
                y += (base + np.int8(d)).astype(np.int32) @ w.astype(np.int32)
        ys.append(y)
    return np.stack(ys)


@pytest.mark.parametrize("mode", dc.MODES)
@pytest.mark.parametrize("K", [16, 24, 128])
def test_dot_chain_plain_y_matches_numpy(small_chain, mode, K):
    x, w = _dc_problem(mode, K)
    y = dc.chain_plain(torch.from_numpy(x), w, mode)
    want = _chain_np(x, w.numpy(), mode)
    if mode.startswith("int8"):
        assert y.dtype == torch.int64 and np.array_equal(y.numpy(), want)
        return
    yt = torch.from_numpy(want)
    dc.compare(dc.output_of(yt), dc.chain_moments(yt), y, mode)
    if mode == "f32":
        np.testing.assert_allclose(y.numpy(), want, rtol=0,
                                   atol=REL * np.abs(want).max())


@pytest.mark.parametrize("mode,fault", [
    ("f32", "scale"), ("f32", "shift"), ("bf16", "scale"), ("int8", "one"),
    ("int8i", "one"), ("int8", "shift")])
def test_dot_chain_compare_sees_faults(small_chain, mode, fault):
    x, w = _dc_problem(mode, 128)
    y = dc.chain_plain(torch.from_numpy(x), w, mode)
    assert dc.compare(dc.output_of(y), dc.chain_moments(y), y,
                      mode)["share_of_bar"] == 0.0
    bad = y.clone()
    if fault == "scale":
        bad = bad * (1.05 if mode == "bf16" else 1 + 1e-4)
    elif fault == "shift":  # a store one column off
        bad = torch.roll(bad, 1, dims=2)
    else:
        bad[0, 3, 5] += 1
    with pytest.raises(RuntimeError, match="off the plain"):
        dc.compare(dc.output_of(bad), dc.chain_moments(bad), y, mode)


@pytest.mark.parametrize("keep", ["bfloat16", "float32", "float16"])
@pytest.mark.parametrize("K", [16, 128, 512])
def test_dot_chain_rounding_check_fails_other_precisions(keep, K):
    """The plain bf16 chain's trace passes the product-by-product check;
    the controls, the chain held in f32 or f16 between products, fail it."""
    x, w = _dc_problem("bf16", K)
    x = torch.from_numpy(x)
    trace = dc.trace_plain(x, w, getattr(torch, keep))
    outside = dc.rounding_outside(trace, x, w)
    if keep == "bfloat16":
        assert outside == 0
        dc.check_rounding(trace, x, w)
    else:
        assert outside > trace.numel() // 100
        with pytest.raises(RuntimeError, match="off the plain"):
            dc.check_rounding(trace, x, w)


@pytest.mark.parametrize("fault", ["shift", "nan", "step"])
def test_dot_chain_rounding_check_sees_faults(small_chain, fault):
    x, w = _dc_problem("bf16", 128)
    x = torch.from_numpy(x)
    out, mom, trace = dc.dot_chain(x, w, "bf16", check=True)
    assert trace.shape == (DC_STEPS, dc.TILES, dc.DEPTH, 128)
    assert torch.equal(trace, dc.trace_plain(x, w))
    y = dc.chain_plain(x, w, "bf16")
    assert torch.equal(trace[:, 0, -1].float(), y[:, 0])
    bad = trace.clone()
    if fault == "shift":  # a store one column off
        bad = torch.roll(bad, 1, dims=3)
    elif fault == "nan":
        bad[1, 4, 7, 9] = float("nan")
    else:  # one product of one row four bf16 steps off
        bad[0, 2, 5] = (bad[0, 2, 5].float() * (1 + 2.0 ** -5)).bfloat16()
    assert dc.rounding_outside(bad, x, w) > 0


def test_dot_chain_defined_weights():
    for K in (16, 384):
        w = dc.make_weights("f32", K)
        assert w.dtype == torch.float32 and abs(w.std().item()
                                                * K ** 0.5 - 1) < 0.1
        b = dc.make_weights("bf16", K)
        assert torch.equal(b, b.bfloat16().float())
        q = dc.make_weights("int8", K)
        assert q.dtype == torch.int8 and torch.equal(
            q, dc.make_weights("int8i", K))
    units = dc.pack_weights(q, "int8").reshape(K // 128, K, 8, 16)
    n = torch.arange(K)[:, None]  # one cluster block at K=384: its atoms
    units = units[:, n, torch.arange(8)[None, :] ^ (n % 8)]
    assert units.permute(1, 0, 2, 3).reshape(K, K).equal(q.t())


def test_dot_chain_int_moments_wrap_modulo_2_64():
    y = torch.full((1, 2, 2), 3_000_000_000, dtype=torch.int64)
    m = dc.chain_moments(y)
    want = (4 * 3_000_000_000 ** 2) % 2 ** 64
    assert m[0, 1].item() % 2 ** 64 == want


def test_dot_chain_bounds_are_the_worked_out_bounds():
    want = {("f32_3xtf32", 384): 1.750, ("f32_3xtf32", 512): 3.110,
            ("bf16", 384): 0.410, ("bf16", 512): 0.730, ("int8", 384): 0.205,
            ("int8", 512): 0.365}
    for (kind, K), ms in want.items():
        b_ms, by = harness.bound_ms(dc.macs(dc.GRID, K), 0, kind)
        assert by == "operations" and abs(b_ms - ms) / ms < 3e-3


# ------------------------------------------------------------- LP


@pytest.mark.parametrize("body", lm.BODIES)
def test_layout_plain_matches_the_jax_body(jax_layout_outputs, body):
    outs, x = jax_layout_outputs
    want = outs[body]
    got = lm.layout(body, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    if body == "matmul_768x512x128":
        assert np.abs(got - want).max() <= REL * np.abs(want).max()
    elif body == "unaligned_18lane_x6":  # the JAX body leaves the rest unset
        assert np.array_equal(got[:, lm.WRITTEN], want[:, lm.WRITTEN])
        assert not np.delete(got, lm.WRITTEN, axis=1).any()
    else:
        assert np.array_equal(got, want)


def test_layout_library_rows_compute_the_bodies():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2 * 768, 768)).astype(np.float32))
    for body in lm.BODIES:
        lib = lm.library(body, x)
        plain = lm.layout_plain(body, x)
        if lib is None:
            continue
        if body == "matmul_768x512x128":
            plain = plain.reshape(2, 768, 768)[:, :, :128]
        assert torch.allclose(lib.reshape(plain.shape), plain, atol=1e-4)


def test_layout_bounds_are_the_worked_out_bounds():
    want = {"copy": (0.721, "bytes"), "rows_reshape_max": (0.541, "bytes"),
            "rows_strided_slice": (0.361, "bytes"),
            "unaligned_18lane_x6": (0.407, "bytes"),
            "matmul_768x512x128": (0.7212, "bytes")}
    for body, (ms, by) in want.items():
        b_ms, b_by = harness.bound_ms(lm.macs(body), lm.bytes_moved(body),
                                      lm.rate(body))
        assert b_by == by and abs(b_ms - ms) / ms < 2e-3, body


# --------------------------------------------------- what raises


def test_unknown_modes_bodies_and_options_raise():
    x = torch.zeros((16, 128), dtype=torch.uint8)
    with pytest.raises(ValueError, match="unknown mode"):
        dc.dot_chain(x, torch.zeros((16, 16)), "int4")
    with pytest.raises(ValueError, match="w must be"):
        dc.dot_chain(x, torch.zeros((16, 16)), "int8")
    with pytest.raises(ValueError, match="x must be"):
        dc.dot_chain(x[:12], torch.zeros((16, 16)), "f32")
    with pytest.raises(ValueError, match="unknown body"):
        lm.layout("gather", torch.zeros((768, 768)))
    with pytest.raises(ValueError, match="x must be"):
        lm.layout("copy", torch.zeros((700, 768)))
    with pytest.raises(ValueError, match="f32"):
        mr.mm_rate(torch.zeros((4, 8)), torch.zeros((4, 8)))
    with pytest.raises(SystemExit):
        harness.parse_args(["2", "device=cpu", "k=3"], "probe_int8",
                           n_step=1)
    with pytest.raises(SystemExit):  # the live forward's T=32 frames a clip
        bench_fused_cnn.parse(["48", "device=cpu"], "bench_fused_cnn")


# ------------------------------------------------------- the scripts

# each run's argv and the module constants it cuts to size
SCRIPT_RUNS = {
    "probe_int8": (probe_int8.main, ["2", "device=cpu", "iters=1"],
                   {"KS": (32,)}),
    "mosaic_micro": (mosaic_micro.main, ["2", "device=cpu", "iters=1"], {}),
    "bench_fused_cnn mxu": (bench_fused_cnn.probe_mxu,
                            ["32", "device=cpu", "iters=1"],
                            {"REPS": 1, "GRID": 1}),
    "bench_fused_cnn": (bench_fused_cnn.main, ["64", "device=cpu",
                                               "iters=1"], {}),
    "bench_fused_cnn ftile": (bench_fused_cnn.sweep_f_tile,
                              ["32", "device=cpu", "iters=1"], {}),
}


@pytest.mark.parametrize("run", list(SCRIPT_RUNS))
def test_script_main_on_the_cpu(run, capsys, monkeypatch):
    fn, argv, cut = SCRIPT_RUNS[run]
    for name, value in cut.items():
        monkeypatch.setattr(dc if name == "KS" else mr, name, value)
    out = fn(argv)
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == out
    assert out["device"] == "cpu" and out["script"] == run
    assert "not a device measurement" in out["timer"]
    ran = [r for r in out["rows"] if r["ms"] is not None]
    assert ran and all(r["ms"] > 0 for r in ran)
    assert all(r["note"] for r in out["rows"] if r["ms"] is None)
    if run in ("probe_int8", "mosaic_micro", "bench_fused_cnn mxu"):
        assert all(r["plain_ms"] > 0 and r["bound_ms"] > 0 and r["bound_by"]
                   in ("bytes", "operations") for r in out["rows"])
    if run == "probe_int8":  # the JAX script's keys
        assert {f"{m}_k32" for m in dc.MODES} <= set(out)
    if run == "mosaic_micro":
        assert [r["name"] for r in out["rows"]] == list(lm.BODIES)
    if run == "bench_fused_cnn":
        assert all(r["max_abs_err"] <= 1e-4 for r in ran
                   if r.get("max_abs_err") is not None
                   and "bf16" not in r["name"])


@pytest.mark.parametrize("script", ["probe_int8", "bench_fused_cnn",
                                    "mosaic_micro"])
def test_script_without_a_gpu_raises_unless_the_cpu_is_asked_for(script):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", f"silent_speech_tpu_torch.scripts.{script}",
         "64"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "device=cpu" in proc.stderr
    assert proc.stdout.strip() == ""
