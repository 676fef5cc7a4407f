"""The port's live runtime (silent_speech_tpu_torch/runtime/) against the
JAX package's, on the CPU.

- The native ring (the port's own csrc/ringbuf.cpp) against the JAX
  ``FrameRing`` on the same pushes and pops: the bytes, the stamps, the
  wrap past the capacity, ``pop_batch`` and the drop counter; every
  payload once and in order across a producer and a consumer thread. The
  JAX ring runs its pure-Python path here (its loader patched to find no
  library): an implementation independent of the C++, and no build of
  the JAX package's library, whose loader races between test workers.
- The build: two processes building the library into an empty directory
  at once both load it, and no temporary file is left; a source that
  does not compile raises with g++'s stderr, and the next build of a good
  source succeeds (nothing is remembered as tried).
- ``FramePacker`` round trips; ``LivePipeline`` delivers a source's frames
  to the sink in order, through the native ring.
- The fakes: ``face_track`` and ``FakeCamera`` frames bitwise JAX's; the
  missing landmarker bundle's error names the path and the variable.
- Every module of the port, and chip_smoke.py, imports with cv2 and
  mediapipe absent (the card's machine has neither); only
  runtime/capture.py imports them at its top level, optionally.
"""

import ast
import glob
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

from silent_speech_tpu.runtime import fakes as JFK
from silent_speech_tpu.runtime import native as jnative
from silent_speech_tpu.runtime.ringbuf import FrameRing as JFrameRing
from silent_speech_tpu_torch.runtime import capture, native
from silent_speech_tpu_torch.runtime import fakes as PFK
from silent_speech_tpu_torch.runtime.pipeline import FramePacker, LivePipeline
from silent_speech_tpu_torch.runtime.ringbuf import FrameRing
from torch_threads import one_blas_thread  # noqa: F401 (autouse)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_ring_against_jax_ring(rng, monkeypatch):
    """The same pushes and pops on both rings: the same accepted pushes,
    sizes, drops, stamps and payload bytes (a slot's bytes past a short
    payload are not compared: the native slot keeps its earlier
    contents)."""
    monkeypatch.setattr(jnative, "load", lambda: None)
    rp, rj = FrameRing(capacity=5, slot_bytes=24), \
        JFrameRing(capacity=5, slot_bytes=24)
    assert rp.native and not rj.native
    assert rp.capacity == rj.capacity == 8
    queued, stamp = [], 0
    for rnd in range(4):  # each round wraps past the capacity
        for _ in range(int(rng.integers(3, 12))):
            payload = rng.integers(0, 256, int(rng.integers(1, 30)),
                                   np.uint8)
            stamp += 1
            ok = rp.push(payload, stamp)
            assert ok == rj.push(payload, stamp)
            if ok:
                queued.append((payload[:24], stamp))
            assert rp.dropped == rj.dropped and len(rp) == len(rj)
        for _ in range(int(rng.integers(0, 6))):
            a, b = rp.pop(), rj.pop()
            assert (a is None) == (b is None)
            if a is not None:
                want, st = queued.pop(0)
                assert a[1] == b[1] == st
                np.testing.assert_array_equal(a[0][:len(want)], want)
                np.testing.assert_array_equal(b[0][:len(want)], want)
        pa, sa = rp.pop_batch(3)
        pb, sb = rj.pop_batch(3)
        np.testing.assert_array_equal(sa, sb)
        for row_a, row_b in zip(pa, pb):
            want, st = queued.pop(0)
            np.testing.assert_array_equal(row_a[:len(want)], want)
            np.testing.assert_array_equal(row_b[:len(want)], want)
    fill = np.zeros(4, np.uint8)
    while rp.push(fill):  # to full: the next push drops in both
        assert rj.push(fill)
    assert not rj.push(fill)
    assert len(rp) == len(rj) == 8 and rp.dropped == rj.dropped > 0


def test_ring_spsc_threads():
    r = FrameRing(capacity=64, slot_bytes=8)
    N, got = 20000, []

    def producer():
        i = 0
        while i < N:
            if r.push(np.asarray([i, i], np.int32), stamp=i):
                i += 1

    def consumer():
        while len(got) < N:
            item = r.pop()
            if item is not None:
                got.append(int(item[0].view(np.int32)[0]))

    threads = [threading.Thread(target=producer),
               threading.Thread(target=consumer)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert got == list(range(N))


_BUILD_AND_USE = textwrap.dedent("""
    import sys
    from pathlib import Path
    import numpy as np
    from silent_speech_tpu_torch.runtime import native, ringbuf
    native.BUILD_ROOT = Path(sys.argv[1])
    r = ringbuf.FrameRing(4, 8)
    assert r.push(np.arange(2, dtype=np.int32), 7)
    out, stamp = r.pop()
    assert stamp == 7 and out.view(np.int32).tolist() == [0, 1]
    print("ring ok", native.library_path())
""")


def test_two_processes_build_at_once(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_USE,
                               str(tmp_path)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert "ring ok" in out
    libs = list(tmp_path.rglob("*"))
    assert [p.name for p in libs if p.is_file()] == ["libsst_ring.so"], libs


def test_failed_build_raises_and_is_not_remembered(tmp_path, monkeypatch):
    bad = tmp_path / "ringbuf.cpp"
    bad.write_text("extern \"C\" int rb_create( { this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        native.build()
    assert "error" in str(e.value)
    assert not [p for p in (tmp_path / "build").rglob("*") if p.is_file()]
    bad.write_text((native.Path(REPO) / "silent_speech_tpu_torch" / "csrc"
                    / "ringbuf.cpp").read_text())
    lib = native.build()
    assert lib.exists() and lib.parent.parent == tmp_path / "build"


def test_packer_round_trip(rng):
    for roi_hw in ((48, 96), None):
        pk = FramePacker(feat_dim=181, roi_hw=roi_hw)
        feat = rng.standard_normal(181).astype(np.float32)
        roi = (rng.integers(0, 256, roi_hw, np.uint8) if roi_hw else None)
        payload = pk.pack(feat, roi)
        assert payload.nbytes == pk.slot_bytes
        f2, r2 = pk.unpack(payload)
        np.testing.assert_array_equal(f2, feat)
        if roi_hw:
            np.testing.assert_array_equal(r2, roi)
            # a missing ROI travels as zeros
            assert not pk.unpack(pk.pack(feat, None))[1].any()
        else:
            assert r2 is None


def test_pipeline_delivers_in_order(rng):
    feats = rng.standard_normal((300, 6)).astype(np.float32)
    rois = rng.integers(0, 256, (300, 4, 8), np.uint8)
    seen = []
    pipe = LivePipeline(((feats[i], rois[i], i) for i in range(300)),
                        lambda f, r, ts: seen.append((f, r, ts)),
                        FramePacker(feat_dim=6, roi_hw=(4, 8)), capacity=512)
    stats = pipe.run(timeout=60)
    assert pipe.ring.native
    assert stats["produced"] == stats["consumed"] == 300
    assert stats["dropped"] == 0 and not stats["hung"]
    assert [ts for _, _, ts in seen] == list(range(300))
    np.testing.assert_array_equal(np.stack([f for f, _, _ in seen]), feats)
    np.testing.assert_array_equal(np.stack([r for _, r, _ in seen]), rois)


def test_fakes_bitwise_jax(rng):
    opens = list(rng.uniform(4.0, 24.0, 30))
    for a, b in zip(PFK.face_track(30, open_seq=opens),
                    JFK.face_track(30, open_seq=opens)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(PFK.make_face(75.0, 9.0, seed=3),
                                  JFK.make_face(75.0, 9.0, seed=3))
    cp, cj = PFK.FakeCamera(5, seed=2), JFK.FakeCamera(5, seed=2)
    for (fa, ta), (fb, tb) in zip(cp.frames(), cj.frames()):
        assert ta == tb and fa.shape == (480, 640, 3)
        np.testing.assert_array_equal(fa, fb)
    kp, kj = PFK.FakeCV2(), JFK.FakeCV2()
    img = rng.integers(0, 256, (6, 7, 3), np.uint8)
    for code in (kp.COLOR_BGR2RGB, kp.COLOR_BGR2GRAY):
        np.testing.assert_array_equal(kp.cvtColor(img, code),
                                      kj.cvtColor(img, code))


def test_missing_landmarker_bundle_names_path_and_variable(monkeypatch,
                                                           tmp_path):
    monkeypatch.delenv(capture.LANDMARKER_ENV, raising=False)
    missing = str(tmp_path / "nope.task")
    with pytest.raises(FileNotFoundError) as e:
        capture.resolve_landmarker_asset(missing)
    msg = str(e.value)
    assert missing in msg and capture.LANDMARKER_ENV in msg
    assert "http" not in msg and "curl" not in msg
    found = tmp_path / "lm.task"
    found.write_bytes(b"x")
    monkeypatch.setenv(capture.LANDMARKER_ENV, str(found))
    assert capture.resolve_landmarker_asset(missing) == str(found)


_CHECK_NO_CV2 = r"""
import importlib, pkgutil, sys
sys.modules["cv2"] = None  # an import of either now raises ImportError
sys.modules["mediapipe"] = None
import silent_speech_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, prefix=pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
from silent_speech_tpu_torch.runtime import capture
assert capture.cv2 is None and capture.mp is None
print("no-cv2 ok")
"""


def test_port_imports_without_cv2_or_mediapipe():
    """The GPU machine has neither cv2 nor mediapipe: every module of the
    port and chip_smoke.py import without them (runtime/capture.py's
    optional imports come back None), and no other module imports cv2 at
    its top level."""
    proc = subprocess.run([sys.executable, "-c", _CHECK_NO_CV2], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "no-cv2 ok" in proc.stdout
    for path in sorted(glob.glob(os.path.join(
            REPO, "silent_speech_tpu_torch", "**", "*.py"),
            recursive=True)) + [os.path.join(REPO, "chip_smoke.py")]:
        tree = ast.parse(open(path).read(), path)
        top = [n for n in tree.body if isinstance(n, (ast.Import, ast.Try))]
        names = {a.name.split(".")[0] for n in top for node in ast.walk(n)
                 if isinstance(node, ast.Import) for a in node.names}
        if path.endswith(os.path.join("runtime", "capture.py")):
            assert {"cv2", "mediapipe"} <= names
        else:
            assert not names & {"cv2", "mediapipe"}, path
