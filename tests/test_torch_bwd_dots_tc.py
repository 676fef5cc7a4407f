"""The tensor-core arithmetic of the backward-dot kernels tt, xp, nn and
base (csrc/bwd_dots.cu, ``tc::steps_kernel`` and ``tc::base_kernel``),
emulated on the CPU.

The kernels form each step's product on m16n8k8 TF32 MMAs as 3xTF32: each
operand x is split as hi = tf32(x), lo = tf32(x - hi), both rounded to
nearest with ties away from zero, and each 8-deep slice of a 32-row chunk
of the contraction adds lo*hi, then hi*lo, then hi*hi into the chunk's f32
sum, one MMA each; the chunks' sums are added into the step's. The steps'
sums are added in step order within a group of steps, and the groups'
partials in group order (the groups sized from the shapes as ``groups()``
sizes them). Here each MMA's 8 products are formed exactly in float64 and
added to the f32 sum with one rounding (the card's MMA may truncate
instead); ``passes=1`` adds hi*hi alone, one TF32 pass. xp is tt's
arithmetic (its transpose only moves values): the same emulation. base
forms each 128-row tile of a step times w as one K-deep step of the same
arithmetic, then takes the tile's column sums in the kernel's order and
adds them in step order as its second kernel does.

The emulated kernels are held against the JAX scripts' Pallas kernels
(``run_tt``, dots2's ``_k_tt``, ``_k_xp`` and ``_k_base``, dots3's
``_k_tt`` and ``_k_nn``, loaded from their files and run in interpret mode
as tests/test_torch_bwd_dots.py runs them) at that file's small shapes,
and against both of ``cuda_bwd_dots.compare``'s bars; one TF32 pass misses
the float64 bar there and at dots3's full (384, 104, 256) x 512 steps,
where it passes the bar against the f32 plain version; at base's large n
no bar scaled by the sum of |terms| can refuse it (compare's docstring).
The kernels themselves are held to both bars on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import functools
import importlib.util
import os
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from silent_speech_tpu_torch.ops import cuda_bwd_dots as bd
from silent_speech_tpu_torch.scripts import proto_bwd_dots
from silent_speech_tpu_torch.scripts import proto_parity_cnn as harness
from tc_emulation import step_product, tf32_rna
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-5  # of the largest value, as tests/test_torch_bwd_dots.py
STEPS3 = 3
TILE, SLOTS = 128, 132  # the kernels' output tile; one block an SM, 132 SMs


def _load(name, interpret_pl=False):
    spec = importlib.util.spec_from_file_location(
        f"_jax_bwd_tc_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
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
    return _load("proto_bwd_dots")


@pytest.fixture(scope="module")
def dots2():
    return _load("proto_bwd_dots2", interpret_pl=True)


@pytest.fixture(scope="module")
def dots3():
    mod = _load("proto_bwd_dots3", interpret_pl=True)
    mod.STEPS = STEPS3
    return mod


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in shapes]


# -------------------------------------------------- the kernel, emulated


def steps_per_group(Mo, No, steps):
    """csrc/bwd_dots.cu groups(): one wave of one block an SM."""
    tiles = -(-Mo // TILE) * -(-No // TILE)
    g = max(1, min(steps, SLOTS // tiles, 65535))
    return -(-steps // g)


def column_sums_tc(y):
    """The column sums of a 128-row tile y (128, N) in base's order
    (csrc/bwd_dots.cu ``column_sums``): a thread's 8 rows of a column (m16
    tile mt, then its two 8-row halves), the warp's 8 row groups by a
    butterfly of shuffles (each pair adds the same two values), then the
    two warps along M."""
    Y = y.view(2, 4, 2, 8, -1)  # [warp along M, mt, half, row group, col]
    s = Y[:, 0, 0]
    for mt in range(4):
        for h in range(2):
            if mt or h:
                s = s + Y[:, mt, h]
    for d in (1, 2, 4):  # lane ^ 4, ^ 8, ^ 16: row group g ^ 1, ^ 2, ^ 4
        s = s + s[:, torch.arange(8) ^ d]
    return s[0, 0] + s[1, 0]


def kernel_base_tc(p, w, m, passes=3):
    """base as the kernel computes it: each 128-row tile of a step (rows
    past the step's end zeros) times w as one K-deep step, its column sums
    in the kernel's order; then the reduction's order: a step's tiles,
    thread j's run of ceil(G / 256) steps, a tree of 8 levels."""
    G, tps, N = p.shape[0] // m, -(-m // TILE), w.shape[1]
    partial = []
    for g in range(G):
        for t in range(tps):
            r0 = g * m + t * TILE
            r1 = min(r0 + TILE, g * m + m)
            tile = torch.zeros((TILE, p.shape[1]))
            tile[:r1 - r0] = p[r0:r1]
            partial.append(column_sums_tc(step_product(tile, w, passes)))
    per = -(-G // 256)
    run = torch.zeros((256, N))
    for j in range(256):
        v = torch.zeros(N)
        for g in range(j * per, min(G, j * per + per)):
            step = torch.zeros(N)
            for t in range(tps):
                step = step + partial[g * tps + t]
            v = v + step
        run[j] = v
    half = 128
    while half:
        run[:half] = run[:half] + run[half:2 * half]
        half //= 2
    return run[:1]


def kernel_tc(kind, a, b, *, m=None, steps=None, passes=3):
    """tt, xp (tt's arithmetic) or nn as the kernel computes it: the step
    products, added in step order within each group, the groups' partials
    in group order; base by :func:`kernel_base_tc`."""
    if kind == "base":
        return kernel_base_tc(a, b, m, passes)
    if kind in ("tt", "xp"):
        G = a.shape[0] // m
        steps = G if steps is None else steps
        products = [step_product(a[g * m:g * m + m].T, b[g * m:g * m + m],
                                 passes) for g in range(min(G, steps))]
        step = lambda s: products[s % G]  # noqa: E731
    else:
        one = step_product(a, b, passes)
        step = lambda s: one  # noqa: E731
    per = steps_per_group(a.shape[0] if kind == "nn" else a.shape[1],
                          b.shape[1], steps)
    partials = []
    for s0 in range(0, steps, per):
        acc = torch.zeros_like(step(0))
        for s in range(s0, min(steps, s0 + per)):
            acc = acc + step(s)
        partials.append(acc)
    out = partials[0]
    for p in partials[1:]:
        out = out + p
    return out


def _close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL * np.abs(want).max()


def _held_to_both_bars(kind, got, a, b, **kw):
    """Within both of compare's bars, the float64 one at most a tenth
    used."""
    r = bd.compare(kind, got, a, b, **kw)
    assert r["share_of_bar64"] <= 0.1, r
    return r


SIZES = [(rows, m, K, N) for rows in (64, 40) for m in (8, 16)
         for K, N in ((16, 8), (24, 24))]


# ----------------------------------------- against the Pallas kernels


@pytest.mark.parametrize("rows,m,K,N", SIZES)
def test_tt_tc_matches_run_tt(dots1, rows, m, K, N):
    p, dy = _draw(rows + m + K, (rows, K), (rows, N))
    want = np.asarray(dots1.run_tt(jnp.asarray(p.numpy()),
                                   jnp.asarray(dy.numpy()), m, True))
    got = kernel_tc("tt", p, dy, m=m)
    _close(got.numpy(), want)
    _held_to_both_bars("tt", got, p, dy, m=m)


@pytest.mark.parametrize("rows,m", [(64, 8), (64, 16), (40, 16)])
def test_tt_tc_matches_dots2_k_tt(dots2, rows, m):
    K, N = 24, 8
    p, dy = _draw(rows + m, (rows, K), (rows, N))
    f = dots2._make(dots2._k_tt, p.shape, dy.shape, m, (K, N),
                    a_follows_grid=True)
    want = np.asarray(f(jnp.asarray(p.numpy()), jnp.asarray(dy.numpy())))
    got = kernel_tc("tt", p, dy, m=m)
    _close(got.numpy(), want)
    _held_to_both_bars("tt", got, p, dy, m=m)


@pytest.mark.parametrize("rows,m", [(64, 8), (64, 16), (40, 16)])
def test_xp_tc_matches_dots2_k_xp(dots2, rows, m):
    K, N = 24, 8
    p, dy = _draw(rows + m, (rows, K), (rows, N))
    f = dots2._make(dots2._k_xp, p.shape, dy.shape, m, (K, N),
                    a_follows_grid=True)
    want = np.asarray(f(jnp.asarray(p.numpy()), jnp.asarray(dy.numpy())))
    got = kernel_tc("xp", p, dy, m=m)
    _close(got.numpy(), want)
    _held_to_both_bars("xp", got, p, dy, m=m)


@pytest.mark.parametrize("rows,m,K,N", [(64, 8, 24, 8), (64, 16, 24, 8),
                                        (40, 16, 24, 8), (400, 200, 16, 8),
                                        (300, 130, 16, 136)])
def test_base_tc_matches_dots2_k_base(dots2, rows, m, K, N):
    """base's emulation, 128-row tiles of the steps (m 130 and 200: two
    tiles a step, the second ragged; N 136: two column tiles) against
    dots2's ``_k_base``."""
    p, w = _draw(rows + m + K, (rows, K), (K, N))
    f = dots2._make(dots2._k_base, p.shape, w.shape, m, (1, N),
                    a_follows_grid=False)
    want = np.asarray(f(jnp.asarray(p.numpy()), jnp.asarray(w.numpy())))
    got = kernel_tc("base", p, w, m=m)
    _close(got.numpy(), want)
    _held_to_both_bars("base", got, p, w, m=m)


@pytest.mark.parametrize("kind", ["tt", "nn"])
@pytest.mark.parametrize("M,K,N", [(16, 24, 8), (8, 16, 24)])
def test_dots3_tc_matches_the_jax_kernel(dots3, kind, M, K, N):
    p, dy, pk = _draw(M + K + N, (M, K), (M, N), (K, M))
    if kind == "tt":
        f = dots3._make(dots3._k_tt, (M, K), (M, N), (K, N))
        want = np.asarray(f(jnp.asarray(p.numpy()), jnp.asarray(dy.numpy())))
        a, kw = p, {"m": M, "steps": STEPS3}
    else:
        f = dots3._make(dots3._k_nn, (K, M), (M, N), (K, N))
        want = np.asarray(f(jnp.asarray(pk.numpy()),
                            jnp.asarray(dy.numpy())))
        a, kw = pk, {"steps": STEPS3}
    got = kernel_tc(kind, a, dy, **kw)
    _close(got.numpy(), want)
    _held_to_both_bars(kind, got, a, dy, **kw)


# ------------------------------------------ the float64 bar, one pass


@pytest.mark.parametrize("kind,rows,m,K,N,steps", [
    ("tt", 64, 8, 16, 8, None), ("tt", 40, 16, 24, 24, None),
    ("tt", 16, 16, 24, 8, STEPS3), ("nn", 8, 8, 16, 24, STEPS3),
    ("nn", 24, 24, 104, 130, 7), ("xp", 64, 8, 16, 8, None),
    ("xp", 40, 16, 24, 24, None), ("base", 64, 8, 16, 8, None),
    ("base", 40, 16, 24, 24, None), ("base", 100, 24, 104, 130, None)])
def test_float64_bar_refuses_one_tf32_pass(kind, rows, m, K, N, steps):
    """At the small shapes one TF32 pass (emulated in the kernel's order,
    and cuda_bwd_dots.one_pass) lies over the float64 bar, 3xTF32 within a
    tenth of it (base also at chip_smoke's BWD_SMALL, n = 9,984 terms an
    element, where by compare's derivation a standard deviation of one
    pass's error is 2.4 times the bar)."""
    p, dy = _draw(rows * K + N, (rows, K), (rows, N))
    if kind in ("tt", "xp"):
        a, b, kw = p, dy, {"m": m, "steps": steps}
    elif kind == "nn":
        a, b, kw = p[:m].T.contiguous(), dy[:m], {"steps": steps}
    else:
        a, b, kw = p, _draw(K * N, (K, N))[0], {"m": m}
    three = bd.measure(kind, kernel_tc(kind, a, b, **kw), a, b, **kw)
    assert three["share_of_bar64"] <= 0.1, three
    for one in (kernel_tc(kind, a, b, **kw, passes=1),
                bd.one_pass(kind, a, b, **kw)):
        r = bd.measure(kind, one, a, b, **kw)
        assert r["share_of_bar64"] > 3.0, r
        with pytest.raises(RuntimeError, match="off the"):
            bd.compare(kind, one, a, b, **kw)


def test_float64_bar_cannot_refuse_base_one_pass_at_large_n():
    """compare's derivation: at n terms an element one TF32 pass of base
    lies 237 / sqrt(n) of the float64 bar off a standard deviation, so at
    n = 1,048,576 (4,096 rows of K = 256, m 512: four 128-row tiles a step)
    it passes the bar, as it would at dots2's n = 50.3 M; the emulated
    3xTF32 kernel stays within a tenth of it there too."""
    rows, m, K, N = 4096, 512, 256, 8
    p, w = _draw(21, (rows, K), (K, N))
    three = bd.measure("base", kernel_tc("base", p, w, m=m), p, w, m=m)
    one = bd.measure("base", bd.one_pass("base", p, w, m=m), p, w, m=m)
    assert three["share_of_bar"] <= 0.1 and three["share_of_bar64"] <= 0.1
    assert one["share_of_bar64"] < 1.0, one


@pytest.fixture
def steps_once(monkeypatch):
    """cuda_bwd_dots' step sums (``_steps_plain``, under its plain, float64
    and one-pass versions) with each distinct step product computed once
    and then added in step order as there: the same adds of the same
    products. dots3 repeats one product 512 times, and 512 small matmuls a
    version, with every xdist worker's threads on the same cores, took
    most of this file's time."""
    def steps_plain(product, G, m, steps):
        products, out = {}, None
        for s in range(steps):
            g = s % G
            if g not in products:
                products[g] = product(slice(g * m, g * m + m))
            out = products[g] if out is None else out + products[g]
        return out
    monkeypatch.setattr(bd, "_steps_plain", steps_plain)


@pytest.mark.parametrize("kind", ["tt", "nn"])
def test_float64_bar_refuses_one_pass_at_dots3_full_size(kind, steps_once):
    """dots3 at (M, K, N) = (384, 104, 256), 512 steps of one product: the
    bar against the f32 plain version (4 sqrt(n) 2^-24 of the sum of
    |terms|, n = 196,608) lets one TF32 pass through; the float64 bar
    refuses it by more than 10x and holds the emulated 3xTF32 kernel
    within half of it."""
    M, K, N = 384, 104, 256
    p, dy, pk = _draw(0, (M, K), (M, N), (K, M))
    a, kw = (p, {"m": M, "steps": bd.STEPS}) if kind == "tt" else \
        (pk, {"steps": bd.STEPS})
    three = bd.measure(kind, kernel_tc(kind, a, dy, **kw), a, dy, **kw)
    one = bd.measure(kind, bd.one_pass(kind, a, dy, **kw), a, dy, **kw)
    assert three["share_of_bar"] <= 0.1 and three["share_of_bar64"] <= 0.5
    assert one["share_of_bar"] <= 1.0, one  # the f32 bar cannot tell
    assert one["share_of_bar64"] > 10.0, one


def test_tf32_round_is_the_kernels_rounding():
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 3 * 2.0 ** -11, 0.0, -3.5, 1e-30, 3e38])
    x = torch.cat([x, _draw(5, (1000,))[0] * 1e3])
    assert torch.equal(bd.tf32_round(x), tf32_rna(x))


# -------------------------------------------- the yardsticks of the rows


@pytest.mark.parametrize("kind,shape,steps,ms,by", [
    ("tt", (98304, 384, 512, 256), None, 0.1111, "operations"),
    ("tt", (98304, 384, 256, 512), None, 0.1111, "operations"),
    ("tt", (98304, 1536, 512, 256), None, 0.1111, "operations"),
    ("tt", (98304, 3072, 512, 256), None, 0.1111, "operations"),
    ("tt", (98304, 192, 104, 256), None, 0.04229, "bytes"),
    ("tt", (384, 384, 512, 256), 512, 0.2222, "operations"),
    ("nn", (384, 104, 256), 512, 0.04512, "operations"),
    ("nn", (384, 256, 512), 512, 0.2222, "operations"),
    ("xp", (98304, 384, 512, 256), None, 0.1111, "operations"),
    ("xp", (98304, 1536, 512, 256), None, 0.1111, "operations"),
    ("base", (98304, 384, 512, 256), None, 0.1111, "operations"),
    ("base", (98304, 1536, 512, 256), None, 0.1111, "operations")])
def test_tc_rows_are_bound_at_the_combined_rate(kind, shape, steps, ms, by):
    """tt, xp, base and nn at the f32 FMAs and 3xTF32 together, 67 + 495 /
    3 = 232 TFLOP/s (nt's rows: tests/test_torch_bwd_dots.py)."""
    k = bd.kind_of(kind)
    assert k.rate == "f32_3xtf32" and k.route == bd.TENSOR_CORES
    b_ms, b_by = harness.bound_ms(bd.macs(kind, shape, steps),
                                  bd.bytes_moved(kind, shape), k.rate)
    assert b_by == by and abs(b_ms - ms) / ms < 5e-4


def test_the_fma_kinds_keep_the_f32_rate():
    """No kind is left on the f32 FMAs: nt too forms its products as
    3xTF32, on wgmma, and is bound at the combined rate."""
    assert bd.TC_KINDS == ("tt", "xp", "nt", "base", "nn")
    assert bd.kind_of("nt").rate == "f32_3xtf32"
    assert bd.kind_of("nt").route == bd.TENSOR_CORES_WGMMA


@pytest.mark.parametrize("kind", ["tt", "nn"])
def test_library_same_work_stacks_every_step(kind):
    """dots3's same-work column: one matmul of the operands stacked steps
    times, every step's product (the addmm column scales one)."""
    p, dy = _draw(3, (8, 16), (8, 24))
    a = p if kind == "tt" else p.T.contiguous()
    kw = {"m": 8, "steps": 5} if kind == "tt" else {"steps": 5}
    got = proto_bwd_dots.library_call(kind, a, dy, **kw, same_work=True)()
    _close(got.numpy(), bd.plain(kind, a, dy, **kw).numpy())


def test_library_same_work_of_base_is_every_product():
    """base's same-work column: ``torch.matmul(p[:G m], w)``, every
    product without the column sums, whose sums are base's function; the
    library column's einsum sums the rows first."""
    p, w = _draw(6, (40, 16), (16, 24))
    y = proto_bwd_dots.library_call("base", p, w, m=16, same_work=True)()
    assert y.shape == (32, 24)
    _close(y.sum(0, keepdim=True).numpy(),
           bd.plain("base", p, w, m=16).numpy())


def test_the_stopped_kernel_is_the_cards_alone():
    """bwd_dot_tt_stop times the kernel's parts: no plain version, so a CPU
    tensor, an unknown stop or rows not of 16 bytes raise."""
    p, dy = _draw(4, (32, 16), (32, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        bd.bwd_dot_tt_stop(p, dy, 8, "all")
    with pytest.raises(ValueError, match="unknown stop"):
        bd.bwd_dot_tt_stop(p, dy, 8, "mma")
    assert bd.STOPS == ("all", "one_pass", "feed", "ring")
