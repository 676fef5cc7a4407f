"""Threaded live-inference pipeline: producer -> ring buffer -> device
(port of the JAX runtime/pipeline.py).

The reference runs capture, MediaPipe, feature math and model inference on
one thread, so every stage's latency adds to the frame period. Here a
producer thread (camera and landmarker, or any frame-feature source)
pushes fixed-size payloads into the lock-free SPSC ring
(runtime/ringbuf.py -> csrc/ringbuf.cpp) while the dispatch thread drains
it and drives a streaming engine: the landmarker's latency overlaps the
device's work, and the ring's drop counter shows backpressure instead of
hidden lag. A device dispatch made on the dispatch thread runs on that
thread's current CUDA stream; its results come back to the host
(``.cpu()``) before the UI reads them.

Payload layout per frame: [feat (D) f32 | roi (H*W) raw u8 bytes], packed
by FramePacker so the C++ ring stays type-agnostic.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

import numpy as np

from ..train.metrics import StageTimer
from .ringbuf import FrameRing


@dataclasses.dataclass
class FramePacker:
    """Packs (feat f32 (D,), roi u8 (H, W) or None) into one byte payload."""

    feat_dim: int
    roi_hw: Optional[tuple[int, int]] = None

    @property
    def slot_bytes(self) -> int:
        n = 4 * self.feat_dim
        if self.roi_hw:
            n += self.roi_hw[0] * self.roi_hw[1]
        return n

    def pack(self, feat: np.ndarray, roi: Optional[np.ndarray]) -> np.ndarray:
        parts = [np.asarray(feat, np.float32).view(np.uint8).reshape(-1)]
        if self.roi_hw:
            if roi is None:
                roi = np.zeros(self.roi_hw, np.uint8)
            parts.append(np.asarray(roi, np.uint8).reshape(-1))
        return np.concatenate(parts)

    def unpack(self, payload: np.ndarray):
        fbytes = 4 * self.feat_dim
        feat = payload[:fbytes].view(np.float32).copy()
        roi = None
        if self.roi_hw:
            H, W = self.roi_hw
            roi = payload[fbytes : fbytes + H * W].reshape(H, W).copy()
        return feat, roi


class LivePipeline:
    """Producer/consumer streaming loop.

    ``source``: yields (feat, roi_or_None, ts_ms) tuples (camera shim or a
    synthetic generator). ``sink``: called with (feat, roi, ts_ms) on the
    dispatch thread — typically SlidingWindowEngine.push or
    OpennessGate.push wrapped by the app.
    """

    def __init__(
        self,
        source,
        sink: Callable,
        packer: FramePacker,
        capacity: int = 256,
    ):
        self.source = source
        self.sink = sink
        self.packer = packer
        self.ring = FrameRing(capacity, packer.slot_bytes)
        self.timer = StageTimer()
        self._stop = threading.Event()
        self._quit = threading.Event()
        self._produced = 0
        self._consumed = 0
        self._discarded = 0
        self._error: Optional[BaseException] = None
        self._tp: Optional[threading.Thread] = None
        self._tc: Optional[threading.Thread] = None

    def _producer(self):
        try:
            it = iter(self.source)
            has_send = hasattr(it, "send")
            accepted = None  # push result fed back into a generator source
            while not self._stop.is_set():
                try:
                    # a generator source receives whether its PREVIOUS frame
                    # was actually enqueued (False = dropped by a full ring)
                    # via `accepted = yield payload` — the apps' flagged
                    # sources use this to keep a causal-reset latch armed
                    # until the flagged frame really reaches the consumer
                    item = it.send(accepted) if has_send else next(it)
                except StopIteration:
                    break
                feat, roi, ts = item
                with self.timer.stage("pack_push"):
                    payload = self.packer.pack(feat, roi)
                    accepted = bool(self.ring.push(payload, stamp=int(ts)))
                self._produced += 1
        except BaseException as e:  # surfaced by run(); a silent daemon
            self._error = e         # death would report success-shaped stats
            self._stop.set()

    def _discard_backlog(self):
        """Quit path: launch NO new sink dispatches — pop-and-drop the ring
        backlog (counted) while following the producer out, so pop() stays
        single-threaded (SPSC) and the ring is empty when both workers land.
        Without this, a quit with a deep backlog (accumulated behind a slow
        predict) would keep starting fresh device dispatches post-quit."""
        while (self._tp is not None and self._tp.is_alive()) or len(self.ring):
            if self.ring.pop() is not None:
                self._discarded += 1
            else:
                time.sleep(0.0005)

    def _consumer(self):
        try:
            while not self._stop.is_set() or len(self.ring):
                if self._quit.is_set():
                    self._discard_backlog()
                    return
                item = self.ring.pop()
                if item is None:
                    time.sleep(0.0005)
                    continue
                payload, ts = item
                feat, roi = self.packer.unpack(payload)
                with self.timer.stage("sink"):
                    self.sink(feat, roi, ts)
                self._consumed += 1
        except BaseException as e:
            self._error = e
            self._stop.set()

    def start(self):
        """Launch the producer and dispatch threads without blocking — the
        caller (an app) keeps its own main-thread UI loop and calls
        ``finish()`` when done. ``run()`` is start + finish."""
        self._error: Optional[BaseException] = None
        self._tp = threading.Thread(target=self._producer, daemon=True)
        self._tc = threading.Thread(target=self._consumer, daemon=True)
        self._tp.start()
        self._tc.start()
        return self

    def stop(self):
        """User quit: the producer stops at its next frame and the consumer
        DISCARDS the ring backlog (counted in ``stats()['discarded']``)
        instead of dispatching it — only the sink call already in flight is
        waited out. Natural end-of-source (no stop()) still drains every
        queued frame through the sink."""
        self._quit.set()
        self._stop.set()

    @property
    def running(self) -> bool:
        if self._tp is None:
            return False
        return self._tp.is_alive() or self._tc.is_alive()

    @property
    def drained(self) -> bool:
        """True once the producer has finished AND the ring is empty — the
        UI loop's exit condition (the consumer thread itself only exits via
        stop()/finish(), so waiting on ``running`` would deadlock).

        Also True as soon as a worker has died with an error: a dead consumer
        never empties the ring, so without this a ``while not pipe.drained``
        UI loop would spin forever hiding the failure (finish() re-raises
        it)."""
        if self._error is not None:
            return True
        if self._tp is None or self._tp.is_alive():
            return False
        return len(self.ring) == 0 or not self._tc.is_alive()

    def finish(self, timeout: Optional[float] = None) -> dict:
        """Join both workers and return the run stats (re-raising any worker
        failure). A worker that outlives ``timeout`` (e.g. the dispatch
        thread inside a first kernel build) is reported in
        ``stats()['hung']`` rather than silently shaped as a clean drain —
        the daemon thread dies with the process."""
        if self._tp is not None:
            self._tp.join(timeout)
            self._stop.set()
            self._tc.join(timeout)
            if self._error is not None:
                # about to raise: the SURVIVING worker may still hold a live
                # device dispatch, and the interpreter must not exit under
                # it (CUDA teardown with work in flight): land it first. _stop
                # is set, so the consumer exits after its in-flight item and
                # the producer after its current source read (a wedged
                # camera read can extend this — hence the message).
                if self._tp.is_alive() or self._tc.is_alive():
                    print("pipeline: a worker failed; waiting for the "
                          "surviving worker's in-flight dispatch before "
                          "raising...")
                self._tp.join()
                self._tc.join()
            if not self._tp.is_alive() and (
                    self._tc is None or not self._tc.is_alive()):
                # both workers are down: anything the producer managed to
                # push after the consumer exited (quit/error windows) is
                # counted as discarded, keeping produced ==
                # consumed + dropped + discarded (single-threaded pop here —
                # no live popper remains)
                while self.ring.pop() is not None:
                    self._discarded += 1
        if self._error is not None:
            raise RuntimeError(
                f"pipeline worker failed after produced={self._produced} "
                f"consumed={self._consumed}"
            ) from self._error
        return self.stats()

    def stats(self) -> dict:
        hung = [
            name for name, t in (("producer", self._tp),
                                 ("consumer", self._tc))
            if t is not None and t.is_alive()
        ]
        return dict(
            produced=self._produced,
            consumed=self._consumed,
            dropped=self.ring.dropped,
            discarded=self._discarded,
            hung=hung,
            stages=self.timer.summary(),
        )

    def run(self, timeout: Optional[float] = None):
        self.start()
        return self.finish(timeout)
