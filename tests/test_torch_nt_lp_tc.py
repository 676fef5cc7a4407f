"""NT (csrc/bwd_dots.cu on csrc/wgmma_mainloop.cuh;
ops/cuda_bwd_dots.bwd_dot_nt) and LP's product body (csrc/layout_micro.cu
``matmul_kernel``; ops/cuda_layout_micro.layout('matmul_768x512x128')) on
the CPU: their tensor-core arithmetic emulated, and the yardsticks beside
them.

Both form their products as 3xTF32: each operand x split hi = tf32(x), lo =
tf32(x - hi), an 8-deep slice adding lo*hi, hi*lo and hi*hi (nt on wgmma
m64nBNk8, LP on m16n8k8 mma.sync), each chunk of 32 contraction rows summed
from zero and the chunks added in f32; tests/tc_emulation.step_product
forms each MMA's products exactly in float64 and rounds once an MMA (the
card's MMA may truncate instead). nt's w planes are split as the kernel
splits its dy fragments (the same rounding), and its rows past G m are
zeros. The emulated kernels are held against the JAX scripts' Pallas
kernels in interpret mode (proto_bwd_dots ``run_nt`` at
tests/test_torch_bwd_dots.py's small shapes; mosaic_micro's
``matmul_512x128`` body through ``_mk`` at 2 steps, as
tests/test_torch_rate_probes.py runs it) and against both of their bars
(``cuda_bwd_dots.compare``, ``cuda_layout_micro.compare_product``); one
TF32 pass misses the float64 bar. The kernels run on the card only
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from silent_speech_tpu_torch.ops import cuda_bwd_dots as bd
from silent_speech_tpu_torch.ops import cuda_layout_micro as lm
from silent_speech_tpu_torch.ops import cuda_mm_rate as mr
from silent_speech_tpu_torch.scripts import bench_fused_cnn
from tc_emulation import step_product
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-5  # of the largest value, as tests/test_torch_bwd_dots.py
# tests/test_torch_bwd_dots.py's SIZES: (rows, m, K, N)
NT_SIZES = [(rows, m, K, N) for rows in (64, 40) for m in (8, 16)
            for K, N in ((16, 8), (24, 24))]
LP_STEPS = 2


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_nt_lp_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in shapes]


def _close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL * np.abs(want).max()


def nt_tc(dy, w, m, passes=3):
    """nt as the kernel forms it: out[:G m] = dy[:G m] w^T, one 32-row
    chunk of N at a time from zero, the chunks added in f32; zeros past."""
    Gm = dy.shape[0] // m * m
    out = torch.zeros((dy.shape[0], w.shape[0]), dtype=torch.float32)
    out[:Gm] = step_product(dy[:Gm], w.T, passes)
    return out


def lp_tc(x, passes=3):
    """LP's product body as the kernel forms it: each step's (768, 512) x
    (512, 128) product in 32-row chunks, the other lanes copied."""
    v = x.reshape(-1, lm.R, lm.L)
    o = v.clone()
    for s in range(v.shape[0]):
        o[s, :, :lm.MM_N] = step_product(v[s, :, :lm.MM_K],
                                         v[s, :lm.MM_K, :lm.MM_N], passes)
    return o.reshape(x.shape)


@pytest.fixture(scope="module")
def dots1():
    return _load("proto_bwd_dots")


@pytest.fixture(scope="module")
def jax_matmul_body():
    """mosaic_micro.main() at 2 steps with ``_mk`` in interpret mode and a
    ``timed`` that evaluates the product body alone, once: its output and
    x."""
    mod = _load("mosaic_micro")
    mod.STEPS = LP_STEPS
    outs = {}

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
        return body.__name__, run

    def timed(named, x, iters=0):
        name, run = named
        if name == "matmul_512x128":
            outs[name] = np.asarray(run(x))
        return 0.0

    mod._mk, mod.timed = _mk, timed
    mod.main()
    x = np.random.default_rng(0).standard_normal(
        (mod.STEPS * mod.R, mod.L)).astype(np.float32)
    return outs["matmul_512x128"], torch.from_numpy(x)


# ------------------------------------------------------------------ nt


def test_nt_emulated_matches_run_nt_within_both_bars(dots1):
    """At each small shape: the emulated kernel against the JAX ``run_nt``
    (interpret mode) on its G m rows, zeros past them, and within
    ``compare``'s plain and float64 bars."""
    for rows, m, K, N in NT_SIZES:
        dy, w = _draw(rows + m + N, (rows, N), (K, N))
        want = np.asarray(dots1.run_nt(jnp.asarray(dy.numpy()),
                                       jnp.asarray(w.numpy()), m, True))
        got = nt_tc(dy, w, m)
        Gm = rows // m * m
        _close(got[:Gm].numpy(), want[:Gm])
        assert not got[Gm:].any()
        r = bd.compare("nt", got, dy, w, m=m)
        assert r["share_of_bar"] <= 1.0 and r["share_of_bar64"] <= 1.0


def test_nt_one_pass_misses_the_float64_bar():
    """One TF32 pass, emulated as the kernel's stop forms it and as
    ``cuda_bwd_dots.one_pass`` forms it, lies outside the float64 bar at
    every small shape (238 / sqrt(N) standard deviations an element: 48 or
    more at N <= 24)."""
    for rows, m, K, N in NT_SIZES:
        dy, w = _draw(rows + m + N, (rows, N), (K, N))
        for control in (nt_tc(dy, w, m, passes=1),
                        bd.one_pass("nt", dy, w, m=m)):
            assert bd.measure("nt", control, dy, w, m=m)[
                "share_of_bar64"] > 1.0


def test_nt_tail_and_options_are_checked():
    """A written tail row fails the float64 bar too (its bar is 0); the
    stopped kernel is the card's alone (no plain version)."""
    dy, w = _draw(3, (40, 16), (16, 16))
    bad = nt_tc(dy, w, 16)
    bad[35, 0] = 1e-3
    assert bd.measure("nt", bad, dy, w, m=16)["share_of_bar64"] > 1.0
    with pytest.raises(ValueError, match="CUDA tensors"):
        bd.bwd_dot_nt_stop(dy, w, 16)
    with pytest.raises(ValueError, match="passes 1 or 3"):
        bd.bwd_dot_nt_stop(dy, w, 16, passes=2)


# ------------------------------------------------------------------ LP


def test_lp_emulated_matches_the_jax_body_within_both_bars(jax_matmul_body):
    """The emulated body against mosaic_micro's ``matmul_512x128`` (its
    ``_mk`` in interpret mode) at 2 steps: the copied lanes bitwise, the
    product within 1e-5 of the largest value, and within
    ``compare_product``'s plain and float64 bars."""
    want, x = jax_matmul_body
    got = lp_tc(x)
    assert np.array_equal(got[:, lm.MM_N:].numpy(), want[:, lm.MM_N:])
    _close(got[:, :lm.MM_N].numpy(), want[:, :lm.MM_N])
    r = lm.compare_product(got, x)
    assert r["share_of_bar"] <= 1.0 and r["share_of_bar64"] <= 1.0


def test_lp_one_pass_misses_the_float64_bar(jax_matmul_body):
    _, x = jax_matmul_body
    for control in (lp_tc(x, passes=1), lm.one_pass(x)):
        assert lm.measure_product(control, x)["share_of_bar64"] > 1.0


def test_lp_compare_wants_the_copied_lanes_bitwise():
    x = _draw(5, (lm.R, lm.L))[0]
    got = lm.layout_plain(lm.MATMUL, x)
    assert lm.compare_product(got, x)["share_of_bar64"] <= 1.0
    bits = got.view(torch.int32)
    bits[7, lm.MM_N + 3] ^= 1  # one ulp in a copied lane
    with pytest.raises(RuntimeError, match="bitwise"):
        lm.compare_product(got, x)


# --------------------------------------------------------- the yardsticks


def test_library_same_work_calls_do_the_work(monkeypatch):
    """LP's same-work column: its product part and the copy of the other
    lanes; MR's: one matmul of a's rolled copies side by side and b
    stacked, each grid step's sum (all steps stacked: grid times it)."""
    x = _draw(6, (LP_STEPS * lm.R, lm.L))[0]
    prod, rest = lm.library_same_work(x)
    want = lm.layout_plain(lm.MATMUL, x).reshape(LP_STEPS, lm.R, lm.L)
    assert torch.allclose(prod, want[:, :, :lm.MM_N], rtol=0, atol=1e-3)
    assert torch.equal(rest, want[:, :, lm.MM_N:])
    a, b = mr.make_problem(16, 24, 8, torch.device("cpu"))
    one_step = mr.mm_rate_plain(a, b, 9, 1)
    for budget, calls in ((0, 3), (bench_fused_cnn.SAME_WORK_BYTES, 1)):
        monkeypatch.setattr(bench_fused_cnn, "SAME_WORK_BYTES", budget)
        call, n = bench_fused_cnn.same_work_call(a, b, 9, 3)
        assert n == calls
        _close(call().numpy(), (one_step * (3 // calls)).numpy())
