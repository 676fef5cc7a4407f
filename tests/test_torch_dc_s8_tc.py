"""DC's s8 chains (csrc/dot_chain.cu, namespace chain8; ops/cuda_dot_chain
in modes ``int8`` and ``int8i``) on the CPU: a numpy model of the kernel's
index maps, fed through exact integer products.

The model reads W^T's planes from ``pack_weights``'s bytes as wgmma reads
its B operand (K-major, the 128-byte swizzle: byte k of row n of an atom
at n 128 + (k ^ 16 (n % 8))), y from a warpgroup's tile in the same
swizzle (A), forms each product's sums exactly, hands them to the threads
as wgmma's m64nN accumulator fragments lay them out (acc[e] of lane (g,
t4) of warp w: row 16 w + g + 8 ((e & 3) >> 1), column 8 (e >> 2) + 2 t4 +
(e & 1)), and runs the kernel's epilogue on them: (acc >> 7) & 0xff into
the swizzled byte of (row, column), the two blocks of a K=512 pair
copying their own atoms into each other's y after every int8 product;
int8i refills y with the next constant and adds on. It must give the
plain version (``chain_plain``) bitwise, and the moments the kernel sums.
The kernel itself runs on the card only (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from silent_speech_tpu_torch.ops import cuda_dot_chain as dc

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

KA, Y_ATOM = 128, dc.TM * 128  # an atom's k; a y tile's bytes of one atom


def _swizzled(rows: int) -> tuple[np.ndarray, np.ndarray]:
    """(row, k) -> byte offset of an atom plane of ``rows`` 128-byte rows."""
    r, k = np.arange(rows)[:, None], np.arange(KA)[None, :]
    return r, r * KA + (k ^ ((r % 8) << 4))


def read_b(plane: np.ndarray, cols: int) -> np.ndarray:
    """A block's W^T planes as its wgmmas read them: (K, cols) int64."""
    atoms = plane.size // (cols * KA)
    _, off = _swizzled(cols)
    return np.concatenate([plane[a * cols * KA + off].view(np.int8).T
                           for a in range(atoms)]).astype(np.int64)


def read_a(y: np.ndarray) -> np.ndarray:
    """A warpgroup's y tile (its bytes) as A: (64, K) int64 of the s8s."""
    _, off = _swizzled(dc.TM)
    return np.concatenate([y[a * Y_ATOM + off].view(np.int8)
                           for a in range(y.size // Y_ATOM)],
                          axis=1).astype(np.int64)


def fragments(cols: int) -> tuple[np.ndarray, np.ndarray]:
    """(row, column of the block) of acc[e] of each of the warpgroup's 128
    threads: (128, cols / 2) each."""
    t = np.arange(128)[:, None]
    e = np.arange(cols // 2)[None, :]
    g, t4 = (t % 32) // 4, t % 4
    return (16 * (t // 32) + g + 8 * ((e & 3) >> 1),
            8 * (e >> 2) + 2 * t4 + (e & 1))


def epilogue(y: np.ndarray, acc: np.ndarray, rows, cols_g) -> None:
    """The int8 epilogue: each thread's (acc >> 7) & 0xff into its bytes."""
    c = cols_g
    off = (c // KA) * Y_ATOM + rows * KA + ((((c % KA) >> 4) ^ (rows % 8))
                                            << 4) + (c & 15)
    y[off] = ((acc >> 7) & 0xFF).astype(np.uint8)


def emulate(x: torch.Tensor, w: torch.Tensor, mode: str, tiles):
    """The kernel's final values of the given (step, tile) items, (items,
    64, K) int64, and their moments, (items, 3) int64 modulo 2^64."""
    K = w.shape[0]
    geo = dc.s8_geometry(K)
    C, cols = geo.cluster, geo.cols
    packed = dc.pack_weights(w, mode).numpy().view(np.uint8).reshape(-1)
    bs = [read_b(packed[r * geo.w_bytes:(r + 1) * geo.w_bytes], cols)
          for r in range(C)]
    rows, cl = fragments(cols)
    own = geo.atoms // C * Y_ATOM
    seeds = dc.seeds(x).numpy()
    finals, moments = [], []
    for step, tile in tiles:
        base = int(seeds[step]) & 63
        ys = [np.full(geo.y_bytes, base, np.uint8) for _ in range(C)]
        accs = [np.zeros((128, cols // 2), np.int64) for _ in range(C)]
        for d in range(dc.DEPTH):
            for r in range(C):
                prod = (read_a(ys[r]).astype(np.float64)
                        @ bs[r].astype(np.float64)).astype(np.int64)
                accs[r] = (accs[r] if mode == "int8i" and d else 0) \
                    + prod[rows, cl]
            if d + 1 == dc.DEPTH:
                break
            if mode == "int8i":
                ys = [np.full(geo.y_bytes, base + d + 1, np.uint8)
                      for _ in range(C)]
                continue
            for r in range(C):
                epilogue(ys[r], accs[r], rows, r * cols + cl)
            for r in range(C):  # the bulk copy of its own atoms
                ys[r ^ 1 if C > 1 else r][r * own:(r + 1) * own] = \
                    ys[r][r * own:(r + 1) * own]
        tile_y = np.zeros((dc.TM, K), np.int64)
        mom = np.zeros(3, np.uint64)
        for r in range(C):
            v = accs[r] if mode == "int8i" else \
                ((accs[r] >> 7) & 0xFF).astype(np.uint8).view(
                    np.int8).astype(np.int64)
            tile_y[rows, r * cols + cl] = v
            idx = (tile * dc.TM + rows) * K + r * cols + cl
            u = v.astype(np.uint64)
            mom += np.array([u.sum(), (u * u).sum(),
                             ((idx % dc.POS_PERIOD).astype(np.uint64)
                              * u).sum()], np.uint64)
        finals.append(tile_y)
        moments.append(mom.view(np.int64))
    return np.stack(finals), np.stack(moments)


def _x(steps: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (steps * 8, 128), dtype=np.uint8))


@pytest.mark.parametrize("K", dc.KS)
def test_s8_layouts_carry_w_and_a_random_product(K):
    """The pack read as B is W^T's rows of each block; a random y stored
    by the epilogue's map and read as A is that y; one product through the
    layouts is the direct product, exactly."""
    geo = dc.s8_geometry(K)
    rng = np.random.default_rng(K)
    w = torch.from_numpy(rng.integers(-128, 128, (K, K), dtype=np.int8))
    packed = dc.pack_weights(w, "int8").numpy().view(np.uint8).reshape(-1)
    wt = w.t().numpy().astype(np.int64)
    rows, cl = fragments(geo.cols)
    for r in range(geo.cluster):
        b = read_b(packed[r * geo.w_bytes:(r + 1) * geo.w_bytes], geo.cols)
        np.testing.assert_array_equal(b, wt[r * geo.cols:
                                            (r + 1) * geo.cols].T)
        # every (row, column) of the block once among the fragments
        assert np.unique(rows * K + cl).size == dc.TM * geo.cols
        want = rng.integers(-2 ** 14, 2 ** 14, (dc.TM, K))
        y = np.zeros(geo.y_bytes, np.uint8)
        for q in range(geo.cluster):
            epilogue(y, want[rows, q * geo.cols + cl] << 7, rows,
                     q * geo.cols + cl)
        a = read_a(y)
        np.testing.assert_array_equal(a, (want & 0xFF).astype(np.uint8)
                                      .view(np.int8))
        np.testing.assert_array_equal(
            (a.astype(np.float64) @ b.astype(np.float64)).astype(np.int64),
            a @ wt[r * geo.cols:(r + 1) * geo.cols].T)


@pytest.mark.parametrize("mode", ["int8", "int8i"])
@pytest.mark.parametrize("K", dc.KS)
def test_s8_chain_through_the_layouts_is_bitwise_plain(mode, K):
    """Two steps, the first and last tile of each: the modelled kernel's
    final values and moments are the plain chain's, bitwise."""
    x = _x(2, K)
    w = dc.make_weights(mode, K)
    items = [(s, t) for s in range(2) for t in (0, dc.TILES - 1)]
    got, mom = emulate(x, w, mode, items)
    plain = dc.chain_plain(x, w, mode)
    tiles = dc.tile_moments(plain).numpy()
    for i, (s, t) in enumerate(items):
        np.testing.assert_array_equal(
            got[i], plain[s, t * dc.TM:(t + 1) * dc.TM].numpy())
        np.testing.assert_array_equal(mom[i], tiles[s, t])
    np.testing.assert_array_equal(tiles.sum(axis=1),
                                  dc.chain_moments(plain).numpy())


@pytest.mark.parametrize("K", dc.KS)
def test_s8_geometry_fits_a_block(K):
    """W^T's planes and two y tiles in a block's 232,448 bytes with the
    static arrays (under 1 KB), every plane and tile on the swizzle's
    1,024-byte period; the wgmma widths the card has; the sums a thread
    holds (192 at K=384, 128 at K=512)."""
    geo = dc.s8_geometry(K)
    assert geo.smem + 1024 <= dc.SMEM_BYTES
    assert geo.w_bytes * geo.cluster == K * K
    assert geo.w_bytes == geo.atoms * geo.cols * KA
    assert geo.y_bytes == dc.TM * K and geo.y_bytes % 1024 == 0
    assert (geo.cols * KA) % 1024 == 0 and geo.width in (192, 256)
    assert geo.parts * geo.width == geo.cols and geo.sums == geo.cols // 2
    assert geo.cluster == (1 if K == 384 else 2)
    assert geo.sums == {384: 192, 512: 128}[K]


def test_s8_item_walk_covers_every_item_once():
    """The persistent launch (ops/cuda_dot_chain.s8_walk) at ragged step
    counts on 1 to 132 clusters at once: every (step, tile) item once, in
    order within a slot, the slots at most one item apart, and no cluster
    launched without an item."""
    for steps in (1, 3, 23, 45, 256):
        for active in (1, 5, 66, 132):
            walk = dc.s8_walk(steps, active)
            clusters = len(walk) // dc.S8_WARPGROUPS
            assert 1 <= clusters <= active
            flat = sorted(i for slot in walk for i in slot)
            assert flat == list(range(steps * dc.TILES))
            sizes = [len(s) for s in walk]
            assert max(sizes) - min(sizes) <= 1
            assert all(len(walk[c * dc.S8_WARPGROUPS]) >= 1
                       for c in range(clusters))
