"""Live inference apps (port of the JAX apps/live.py).

- ``infer_live``: manual-toggle clip prediction (live_infer_official.py),
  with the top-3 overlay and the fahhh/lebron audio easter eggs.
- ``infer_gated``: openness-gated auto-clip prediction
  (inactive/live_lower_half.py semantics via OpennessGate), sequential or
  threaded through the native ring.
- ``infer_stream``: continuous prediction, the sliding window
  (inactive/live_feed.py semantics via SlidingWindowEngine) or one GRU step
  a frame (CarryStreamingGRU).
- ``infer_ctc``: CTC dictionary-scored clips
  (inactive/facial_landmark_detection.py).

The per-frame features and ROI are the ops' host paths (numpy), so the
camera loop never waits on the device. The official model serves through
``load_predictor`` (K1 and K2 on a card), the GRU-word window through
K2, the CTC model through ``CTCDecoder`` (K1 and K2); ``device`` is
'cuda' unless the CPU is asked for, and 'cuda' without a card raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.config import InferConfig, StreamConfig
from ..core.landmarks import FIXED_IDXS
from ..infer.streaming import OpennessGate, SlidingWindowEngine
from ..ops.features import extract_features_frame
from ..ops.roi import crop_resize_gray_frame_host
from ..runtime.capture import (
    CameraSource,
    FaceLandmarkerSession,
    draw_landmark_points,
    play_audio,
)


def _audio_asset(name: str) -> str:
    """Resolve an easter-egg sound (live_infer_official.py:59-65). The
    reference uses cwd-relative 'audios/...' paths and so only works when
    launched from the repo root; prefer the repo-anchored copy shipped in
    audios/ and keep the cwd-relative form as the fallback so a user's own
    ./audios/ still wins when the shipped one is absent."""
    import os

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    anchored = os.path.join(repo, "audios", name)
    return anchored if os.path.isfile(anchored) else os.path.join(
        "audios", name)


FAH_PATH = _audio_asset("fahhhh.mp3")
BOOM_PATH = _audio_asset("vine-boom.mp3")


def _roi_frame(frame_bgr, center, scale, cfg, mode="area"):
    # host CPU, pure numpy: the 30 fps capture loop must never wait on a
    # device dispatch (the batched device crop's function)
    roi = crop_resize_gray_frame_host(
        frame_bgr, center, scale,
        out_h=cfg.roi_h, out_w=cfg.roi_w, mode=mode, input_layout="bgr",
    )
    if roi is not None:
        return roi
    return np.zeros((cfg.roi_h, cfg.roi_w), np.uint8)


def _overlay_top3(cv2, out, top3):
    y0 = 110
    for i, (word, prob) in enumerate(top3[:3]):
        cv2.putText(out, f"{i + 1}) {word}  {prob:.2f}", (20, y0 + 28 * i),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.8 if i == 0 else 0.7,
                    (0, 255, 0), 2)


def _gated_overlay(cv2, out, open_val, speaking, top3, hold, conf_thresh,
                   dropped=None):
    """The reference gated-demo overlay stack (live_lower_half.py:231-308):
    open= readout, tinted 'PRED:' banner while the hold counter runs
    (green >= conf_thresh else red, alpha 0.18), SPEAKING/IDLE indicator,
    'q to quit'. Returns the (possibly re-blended) frame."""
    cv2.putText(out, f"open={open_val:.3f}", (20, 80),
                cv2.FONT_HERSHEY_SIMPLEX, 0.8, (255, 255, 255), 2)
    if top3 and hold > 0:
        word, conf = top3[0]
        color = (0, 255, 0) if conf >= conf_thresh else (0, 0, 255)
        overlay = out.copy()
        cv2.rectangle(overlay, (0, 0), (out.shape[1], 60), color, -1)
        out = cv2.addWeighted(overlay, 0.18, out, 0.82, 0)
        cv2.putText(out, f"PRED: {word} ({conf:.2f})", (20, 42),
                    cv2.FONT_HERSHEY_SIMPLEX, 1.1, (255, 255, 255), 2)
    cv2.putText(out, "SPEAKING" if speaking else "IDLE", (20, 120),
                cv2.FONT_HERSHEY_SIMPLEX, 0.8,
                (0, 255, 255) if speaking else (200, 200, 200), 2)
    cv2.putText(out, "q to quit", (20, 160),
                cv2.FONT_HERSHEY_SIMPLEX, 0.7, (255, 255, 255), 2)
    if dropped is not None:
        cv2.putText(out, f"drops={dropped}", (20, 190),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.6, (0, 165, 255), 2)
    return out


_GATED_WINDOW = "Live + Word Prediction (Clip Gated)"  # live_lower_half.py:16


def _advise_threaded_host():
    """One-line advisory when pipeline='threaded' runs on a 1-core host.

    The threaded pipeline overlaps the landmarker's host CPU time with the
    engine's device dispatch; with a single host core there is nothing to
    overlap the CPU work *with*, so at light load it only adds handoff/GIL
    latency. It still wins when the engine dispatch dominates the frame
    budget (the dispatch wait releases the GIL), so this is advice, not an
    error.
    """
    import os

    if (os.cpu_count() or 1) <= 1:
        print("[pipeline=threaded] note: single-CPU-core host — threading "
              "only pays when engine dispatch dominates the frame budget")


def _load_predictor(cfg: InferConfig, device: str):
    """Any checkpoint family — official or variant, .pt or npz of either
    package (infer.predictor.load_predictor routing)."""
    from ..core.config import serving_kwargs
    from ..infer.predictor import load_predictor

    pred = load_predictor(cfg.ckpt_path, device=device, **serving_kwargs(cfg))
    if cfg.warmup and hasattr(pred, "warmup"):
        print("Warming up (running every clip shape once)...")
        pred.warmup()
    return pred


class _AsyncClipPredictor:
    """Single-flight async clip prediction for the manual-toggle apps.

    The capture/UI loop keeps running while the device dispatch (the first
    one builds the kernels) happens on a daemon worker thread — the
    reference freezes the camera feed for the whole predict
    (live_infer_official.py:338-359). A worker thread launches on its own
    current CUDA stream, and its result reaches the UI thread as host
    arrays (the predictors end in ``.cpu()``). The newest submission
    supersedes any unread older result, matching the apps'
    result-resets-on-new-recording semantics; worker errors re-raise on the
    UI thread at poll()/drain().
    Daemon threads (not a ThreadPoolExecutor) so the exit policy stays in
    the app's hands rather than an unconditional executor atexit join —
    but see drain(): an in-flight device dispatch must be waited out, never
    abandoned to interpreter teardown.
    """

    def __init__(self, fn):
        import threading

        self._fn = fn
        self._lk = threading.Lock()
        self._gen = 0       # submissions issued
        self._done_gen = 0  # newest submission finished
        self._res = None
        self._err: Optional[Exception] = None
        self._threads: list = []

    def submit(self, *args):
        import threading

        with self._lk:
            self._gen += 1
            gen = self._gen
        t = threading.Thread(target=self._run, args=(gen, args), daemon=True)
        self._threads = [x for x in self._threads if x.is_alive()] + [t]
        t.start()

    def _run(self, gen, args):
        # Exception only: a BaseException in the worker (SystemExit-class
        # library aborts) must not re-raise on the UI thread through
        # poll() — the apps' cleanup handlers catch Exception
        try:
            val = self._fn(*args)
            with self._lk:
                if gen > self._done_gen:
                    self._done_gen, self._res, self._err = gen, val, None
        except Exception as e:
            with self._lk:
                if gen > self._done_gen:
                    self._done_gen, self._res, self._err = gen, None, e

    def invalidate(self):
        """Discard any in-flight or unread result — called when a NEW
        recording starts, so a stale prediction from the previous clip can
        never be published (or fire its audio egg) over it."""
        with self._lk:
            self._gen += 1
            self._done_gen = self._gen
            self._res = None
            self._err = None

    @property
    def pending(self) -> bool:
        """The newest submission has not produced a result yet."""
        with self._lk:
            return self._done_gen < self._gen

    @property
    def busy(self) -> bool:
        """Any worker thread still running — including a SUPERSEDED one whose
        result will be discarded but whose device dispatch is still live
        (pending can be False while busy is True)."""
        self._threads = [t for t in self._threads if t.is_alive()]
        return bool(self._threads)

    def join(self):
        """Block until every worker thread has landed. MUST be called before
        the app returns: exiting the interpreter with a live device dispatch
        aborts the process (see drain)."""
        for t in list(self._threads):
            t.join()
        self._threads = []

    def poll(self):
        """Newest finished result (once), or None; re-raises worker errors."""
        with self._lk:
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            res, self._res = self._res, None
            return res

    def drain(self, timeout: Optional[float] = 10.0):
        """Wait for the NEWEST submission's result: returns it, or None if
        nothing lands within ``timeout`` (None = wait forever). Result-only —
        superseded dispatches may still be live afterwards; exit safety is
        join()/shutdown()'s job."""
        import time

        deadline = None if timeout is None else time.monotonic() + timeout
        while self.pending and (deadline is None
                                or time.monotonic() < deadline):
            time.sleep(0.01)
        return self.poll()

    def poll_overlay(self, cv2, out, busy_text: str):
        """Per-frame UI step: the newest finished result (once) or None,
        drawing ``busy_text`` while a result is still being computed."""
        res = self.poll()
        if res is None and self.pending:
            cv2.putText(out, busy_text, (20, 260),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.8, (0, 200, 255), 2)
        return res

    def shutdown(self, what: str = "prediction"):
        """App-exit policy: grace-drain the result, then wait out EVERY live
        worker dispatch — the interpreter must not exit with one in flight
        (CUDA teardown under a live launch). Returns the final result
        (possibly landing during the join) or None; prints rather than
        raises worker errors so the caller's cleanup always proceeds."""
        res = None
        try:
            res = self.drain(timeout=10)
        except KeyboardInterrupt:
            # even on Ctrl-C the in-flight dispatch must be waited out
            # (interpreter exit with one live SIGABRTs) — fall through to
            # the join phase below; a SECOND Ctrl-C there force-quits
            print(f"Ctrl-C during the {what} grace wait")
        except Exception as e:
            print(f"{what} failed: {e}")
        if self.busy:
            print(f"waiting for the in-flight {what} — the first one builds "
                  "the kernels; Ctrl-C abandons it (the runtime may abort "
                  "during teardown)...")
            try:
                self.join()
            except KeyboardInterrupt:
                print("force-quit: abandoning the in-flight dispatch")
                raise
        if res is None:
            try:
                res = self.poll()  # a result that landed during the join
            except Exception as e:
                print(f"{what} failed: {e}")
        return res


def infer_live(cfg: InferConfig = InferConfig(),
               model_path: str = "models/face_landmarker.task",
               device: str = "cuda"):
    import cv2

    predictor = _load_predictor(cfg, device)
    print(f"Loaded model. use_roi={predictor.cfg.use_roi} "
          f"max_t={predictor.max_t} classes={len(predictor.id_to_label)}")

    lm = FaceLandmarkerSession(model_path, video_mode=True)
    try:
        cam = CameraSource(cfg.cam_index)
    except Exception:
        lm.close()
        raise

    recording = False
    bufX, bufR = [], []
    prev_xy = None
    last_top3 = None
    last_pred = None
    ap = (_AsyncClipPredictor(
        lambda X, R: predictor.predict_arrays(X, R, k=cfg.topk))
        if cfg.predict_async else None)

    try:
        for frame, ts in cam.frames():
            face = lm.detect(frame, ts)
            out = frame.copy()
            if ap is not None:
                res = ap.poll_overlay(cv2, out, "Predicting...")
                if res is not None:
                    last_top3 = res
                    print("Top3:", last_top3)
            if face is not None:
                h, w = out.shape[:2]
                feat, xy_n, center, mw = extract_features_frame(face, w, h, prev_xy)
                in_range = cfg.mouth_w_min_px <= mw <= cfg.mouth_w_max_px
                if cfg.draw_points:
                    draw_landmark_points(out, face, FIXED_IDXS)
                cv2.putText(out, f"mouth_w={mw:.1f}px {'OK' if in_range else 'OUT'}",
                            (20, 300), cv2.FONT_HERSHEY_SIMPLEX, 0.6,
                            (0, 255, 0) if in_range else (0, 0, 255), 2)
                if recording and in_range:
                    prev_xy = xy_n
                    bufX.append(feat)
                    if predictor.cfg.use_roi:
                        bufR.append(_roi_frame(frame, center, mw, predictor.cfg))
                elif recording:
                    prev_xy = None

            cv2.putText(out, f"{'REC' if recording else 'IDLE'} | r start/stop | q quit",
                        (20, 40), cv2.FONT_HERSHEY_SIMPLEX, 0.9, (255, 255, 255), 2)
            if recording:
                cv2.putText(out, f"frames: {len(bufX)}", (20, 75),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.8, (255, 255, 255), 2)
            if last_top3 is not None:
                _overlay_top3(cv2, out, last_top3)
                if last_pred != "FAH" and last_top3[0][0] == "fahhh":
                    play_audio(FAH_PATH)
                    last_pred = "FAH"
                if last_pred != "LEBRON" and last_top3[0][0] == "lebron":
                    play_audio(BOOM_PATH)
                    last_pred = "LEBRON"

            cv2.imshow("Live Infer", out)
            key = cv2.waitKey(1) & 0xFF
            if key in (27, ord("q")):
                break
            if key == ord("r"):
                recording = not recording
                if recording:
                    bufX, bufR = [], []
                    prev_xy, last_top3 = None, None
                    if ap is not None:
                        # a stale in-flight prediction from the previous
                        # clip must not publish (or fire its audio egg)
                        # over the new recording
                        ap.invalidate()
                    print("Recording started...")
                else:
                    print(f"Recording stopped. frames={len(bufX)}. Predicting...")
                    last_pred = None
                    if len(bufX) < cfg.min_frames:
                        print("Too short.")
                        continue
                    roi = np.stack(bufR) if bufR else None
                    if ap is not None:
                        ap.submit(np.stack(bufX), roi)
                    else:
                        last_top3 = predictor.predict_arrays(
                            np.stack(bufX), roi, k=cfg.topk)
                        print("Top3:", last_top3)
    finally:
        try:
            if ap is not None:
                res = ap.shutdown("prediction")
                if res is not None:
                    print("Top3:", res)
        finally:
            cam.release()
            lm.close()
            cv2.destroyAllWindows()


def infer_gated(cfg: InferConfig = InferConfig(),
                stream_cfg: StreamConfig = StreamConfig(),
                model_path: str = "models/face_landmarker.task",
                device: str = "cuda"):
    """Openness-gated auto-clip inference (inactive/live_lower_half.py).

    ``stream_cfg.pipeline='threaded'`` moves capture+landmarker+ROI
    extraction onto a producer thread feeding the native SPSC ring; the
    gate and the clip predict run on the dispatch thread, so a prediction
    never stalls the camera (the reference freezes the feed for the whole
    predict). ``cfg.predict_async`` additionally moves the clip predict off
    the gating thread (sequential: off the camera loop; threaded: off the
    dispatch thread, so gating keeps pace through the first kernel build).
    """
    import cv2

    if stream_cfg.pipeline not in ("sequential", "threaded"):
        raise ValueError(f"unknown pipeline {stream_cfg.pipeline!r} "
                         "(expected 'sequential' or 'threaded')")
    predictor = _load_predictor(cfg, device)
    gate = OpennessGate(stream_cfg)
    lm = FaceLandmarkerSession(model_path, video_mode=True)
    try:
        cam = CameraSource(cfg.cam_index)
    except Exception:
        lm.close()
        raise
    try:
        if stream_cfg.pipeline == "threaded":
            _advise_threaded_host()
            _run_gated_threaded(cv2, cam, lm, predictor, gate, cfg,
                                stream_cfg)
        else:
            _run_gated_sequential(cv2, cam, lm, predictor, gate, cfg,
                                  stream_cfg)
    finally:
        cam.release()
        lm.close()
        cv2.destroyAllWindows()


def _run_gated_sequential(cv2, cam, lm, predictor, gate, cfg, stream_cfg):
    last_top3, hold = None, 0
    prev_xy = None
    # predict_async: the gated clip predict runs off-thread so the camera
    # keeps rolling through the first kernel build (newest-wins, like
    # infer_live)
    ap = (_AsyncClipPredictor(
        lambda X, R: predictor.predict_arrays(X, R, k=3))
        if cfg.predict_async else None)
    try:
        for frame, ts in cam.frames():
            face = lm.detect(frame, ts)
            out = frame.copy()
            if ap is not None:
                res = ap.poll_overlay(cv2, out, "Predicting...")
                if res is not None:
                    last_top3, hold = res, stream_cfg.hold_frames
                    print("Top3:", last_top3)
            if face is None:
                # face lost: reset the segmentation state, velocity chain,
                # and the prediction display so one clip can't splice two
                # utterances together (live_lower_half.py:298-306)
                gate.reset()
                prev_xy = None
                last_top3, hold = None, 0
                cv2.putText(out, "NO FACE", (20, 40),
                            cv2.FONT_HERSHEY_SIMPLEX, 1.0, (0, 0, 255), 2)
                cv2.putText(out, "q to quit", (20, 160),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.7,
                            (255, 255, 255), 2)
            else:
                h, w = out.shape[:2]
                draw_landmark_points(out, face, FIXED_IDXS)
                feat, xy_n, center, mw = extract_features_frame(
                    face, w, h, prev_xy)
                prev_xy = xy_n  # velocity chains as in training clips
                openness = feat[-1]  # mouth_aspect (normalized openness)
                roi = (_roi_frame(frame, center, mw, predictor.cfg)
                       if predictor.cfg.use_roi else None)
                ev = gate.push(float(openness), feat, roi)
                if ev is not None and len(ev.frames) > cfg.min_frames:
                    if ap is not None:
                        ap.submit(ev.frames, ev.rois)
                    else:
                        last_top3 = predictor.predict_arrays(
                            ev.frames, ev.rois, k=3)
                        hold = stream_cfg.hold_frames
                        print("Top3:", last_top3)
                out = _gated_overlay(cv2, out, float(openness), gate.speaking,
                                     last_top3, hold, stream_cfg.conf_thresh)
                if last_top3 is not None and hold > 0:
                    hold -= 1
            cv2.imshow(_GATED_WINDOW, out)
            if cv2.waitKey(1) & 0xFF in (27, ord("q")):
                break
    finally:
        if ap is not None:
            res = ap.shutdown("prediction")
            if res is not None:
                print("Top3:", res)


def _run_threaded_ui(cv2, pipe, stop, lock, ui, draw, window,
                     on_new_frame=None):
    """Shared main-thread UI loop for the threaded pipelines.

    The producer bumps ``ui['seq']`` each time it publishes a frame; the loop
    redraws ONLY when the sequence advances, so per-frame counters decrement
    at camera rate, not poll rate, and an unchanged frame is never re-copied
    and re-annotated at ~500 Hz. ``on_new_frame(ui)`` runs under the lock
    when a new frame is observed (read-modify-write of shared counters stays
    atomic w.r.t. the dispatch thread). Exits when the pipeline drains —
    including a worker death (LivePipeline.drained is True on error, and
    finish() re-raises it)."""
    import time as _time

    last_seq = -1
    try:
        while not pipe.drained:
            with lock:
                seq = ui["seq"]
                new = seq != last_seq
                snap = dict(ui)
                if new and on_new_frame is not None:
                    on_new_frame(ui)
            if new and snap["frame"] is not None:
                last_seq = seq
                out = snap["frame"].copy()
                # a draw may return a REPLACEMENT frame (the gated overlay's
                # alpha-blended banner reallocates)
                res = draw(out, snap, pipe.ring.dropped)
                cv2.imshow(window, out if res is None else res)
            if cv2.waitKey(1) & 0xFF in (27, ord("q")):
                stop.set()
                pipe.stop()
                break
            _time.sleep(0.001)
    finally:
        stop.set()
        try:
            stats = pipe.finish(timeout=10)
            if stats["hung"]:
                # the interpreter must not exit under a live device
                # dispatch — block until the worker lands
                print(f"waiting for the {'/'.join(stats['hung'])} thread "
                      "(the first dispatch builds the kernels; Ctrl-C "
                      "force-quits)...")
                stats = pipe.finish(timeout=None)
        except KeyboardInterrupt:
            # even on Ctrl-C the workers' in-flight dispatch must land
            # before the interpreter exits — a SECOND Ctrl-C knowingly
            # force-quits
            print("Ctrl-C: waiting for the in-flight dispatch before "
                  "exiting (Ctrl-C again force-quits)...")
            try:
                stats = pipe.finish(timeout=None)
            except KeyboardInterrupt:
                print("force-quit: abandoning the in-flight dispatch")
                raise
        print(f"pipeline: produced={stats['produced']} "
              f"consumed={stats['consumed']} dropped={stats['dropped']}"
              + (f" discarded={stats['discarded']}"
                 if stats["discarded"] else ""))


def _flagged_source(cam, lm, stop, lock, ui, produce, front_lost_fn,
                    feat_dim, video_ts=False):
    """Shared producer generator for the threaded pipelines.

    Protocol: every camera frame travels through the ring; the payload's
    first float is a validity flag (0.0 = face-lost sentinel, 1.0 = valid,
    2.0 = valid AND a face-lost gap preceded it) so causal resets happen
    on the dispatch thread in order with the frames around them. The gap is
    LATCHED producer-side and re-announced on the first valid frame after it
    (flag 2.0): a full ring can drop the 0.0 sentinel itself, and without the
    latch that would silently lose the gate/engine reset and splice two
    utterances across the gap. The latch clears only when a flagged frame is
    actually ACCEPTED by the ring (LivePipeline feeds push's result back via
    generator send) — clearing at yield time would lose the reset whenever
    the flagged frame itself is dropped. Sink-side resets are idempotent, so
    seeing both the sentinel and the latched flag is harmless. Producer-side
    causal state (velocity chain via prev_xy, any feature-frontend state) is
    reset HERE, on the thread that mutates it — resetting it from the
    dispatch thread would race the producer's next valid frame.

    ``produce(face, frame, w, h, prev_xy) -> (feat, open_val, prev_xy, roi)``
    runs the app's per-frame feature path. The frame, its seq bump, and its
    openness are published under ONE lock acquisition so the UI can never
    pair a new frame with the previous frame's openness state.
    """
    lost = np.zeros(feat_dim, np.float32)
    prev_xy = None
    pending_gap = False  # a face-lost gap not yet carried by a valid frame
    for frame, ts in cam.frames():
        if stop.is_set():
            break
        face = lm.detect(frame, ts) if video_ts else lm.detect(frame)
        if face is None:
            prev_xy = None
            front_lost_fn()
            with lock:
                ui["frame"] = frame
                ui["seq"] += 1
                ui["open"] = 0.0
            accepted = yield lost, None, ts
            # sentinel delivered -> the reset travels in ring order; dropped
            # -> latch it for the next valid frame
            pending_gap = not accepted
            continue
        h, w = frame.shape[:2]
        feat, open_val, prev_xy, roi = produce(face, frame, w, h, prev_xy)
        with lock:
            ui["frame"] = frame
            ui["seq"] += 1
            ui["open"] = open_val
        flag = 2.0 if pending_gap else 1.0
        accepted = yield np.concatenate([[flag], feat]).astype(np.float32), roi, ts
        if pending_gap and accepted:
            pending_gap = False  # the flagged frame really reached the ring


def _run_gated_threaded(cv2, cam, lm, predictor, gate, cfg, stream_cfg):
    """Producer (camera/landmarker/ROI) -> FrameRing -> dispatch thread
    (gate + clip predict); UI stays on the main thread. The payload's first
    float is a validity flag so face-lost frames travel through the same
    ring and reset the gate in order with the frames around them."""
    import threading

    from ..runtime.pipeline import FramePacker, LivePipeline

    use_roi = predictor.cfg.use_roi
    feat_dim = 181  # [valid flag | official 180-D feature]
    packer = FramePacker(
        feat_dim=feat_dim,
        roi_hw=(predictor.cfg.roi_h, predictor.cfg.roi_w) if use_roi else None,
    )
    lock = threading.Lock()
    ui = {"frame": None, "seq": 0, "open": 0.0, "speaking": False,
          "top3": None, "hold": 0}
    stop = threading.Event()

    def produce(face, frame, w, h, prev_xy):
        feat, xy_n, center, mw = extract_features_frame(face, w, h, prev_xy)
        roi = (_roi_frame(frame, center, mw, predictor.cfg)
               if use_roi else None)
        return feat, float(feat[-1]), xy_n, roi

    source = _flagged_source(cam, lm, stop, lock, ui, produce,
                             front_lost_fn=lambda: None,
                             feat_dim=feat_dim, video_ts=True)
    # predict_async on top of the threaded pipeline: the clip predict moves
    # OFF the dispatch thread too, so gating keeps pace (and the ring stays
    # shallow) through a slow first predict
    ap = (_AsyncClipPredictor(
        lambda X, R: predictor.predict_arrays(X, R, k=3))
        if cfg.predict_async else None)

    def _publish(top3):
        with lock:
            ui["top3"], ui["hold"] = top3, stream_cfg.hold_frames
        print("Top3:", top3)

    def sink(feat_ext, roi, ts):
        if ap is not None:
            # poll BEFORE the face-validity branch: a finished async predict
            # must publish even while the face is lost (the sequential loop
            # polls every frame regardless)
            res = ap.poll()
            if res is not None:
                _publish(res)
        if feat_ext[0] < 0.5:  # face lost (live_lower_half.py:298-306)
            gate.reset()
            with lock:
                ui["speaking"] = False
                ui["top3"], ui["hold"] = None, 0  # display resets too
            return
        if feat_ext[0] > 1.5:
            # latched gap flag: the 0.0 sentinel itself was dropped by a
            # full ring — reset before this first post-gap frame
            gate.reset()
        feat = feat_ext[1:]
        ev = gate.push(float(feat[-1]), feat, roi if use_roi else None)
        with lock:
            ui["speaking"] = gate.speaking
        if ev is not None and len(ev.frames) > cfg.min_frames:
            if ap is not None:
                ap.submit(ev.frames, ev.rois)
            else:
                _publish(predictor.predict_arrays(ev.frames, ev.rois, k=3))

    def draw(out, snap, dropped):
        return _gated_overlay(cv2, out, float(snap["open"]),
                              snap["speaking"], snap["top3"], snap["hold"],
                              stream_cfg.conf_thresh, dropped=dropped)

    def on_new_frame(u):
        # per-camera-frame hold countdown, matching _run_gated_sequential
        if u["top3"] is not None and u["hold"] > 0:
            u["hold"] -= 1

    pipe = LivePipeline(source, sink, packer,
                        capacity=stream_cfg.ring_capacity)
    pipe.start()
    try:
        _run_threaded_ui(cv2, pipe, stop, lock, ui, draw, _GATED_WINDOW,
                         on_new_frame)
    finally:
        if ap is not None:
            # the dispatch thread is down (finish() joined it inside
            # _run_threaded_ui) — land any still-running async predict
            # before the interpreter exits
            res = ap.shutdown("prediction")
            if res is not None:
                print("Top3:", res)


class _CausalUniGRUFrontend:
    """Causal per-frame preprocessing for carry-streaming a uni-GRU checkpoint.

    The clip pipeline for this family (train/legacy_loops._unigru_preprocess,
    reference inactive/train_model_1130pm.py:117-127) is non-causal: activity
    trim, deltas, per-clip z-score, resample to t_target. A continuous stream
    has no clip to trim/normalize over, so this frontend makes the conscious
    causal adaptations: deltas become frame-to-frame differences (first
    frame 0) and the per-clip z-score becomes a running (Welford)
    standardization that converges to the clip statistics as the stream runs.
    """

    def __init__(self, d_target: int, use_deltas: bool):
        self.d_target = d_target
        self.use_deltas = use_deltas
        self.prev: Optional[np.ndarray] = None
        d_in = 2 * d_target if use_deltas else d_target
        self.n = 0
        self.mean = np.zeros(d_in, np.float64)
        self.m2 = np.zeros(d_in, np.float64)

    def reset(self):
        self.prev = None
        self.n = 0
        self.mean[:] = 0.0
        self.m2[:] = 0.0

    def __call__(self, feat: np.ndarray) -> np.ndarray:
        from ..core.schema import fix_dim

        f = fix_dim(np.asarray(feat, np.float32)[None], self.d_target)[0]
        if self.use_deltas:
            d = np.zeros_like(f) if self.prev is None else f - self.prev
            self.prev = f
            f = np.concatenate([f, d])
        self.n += 1
        delta = f - self.mean
        self.mean += delta / self.n
        self.m2 += delta * (f - self.mean)
        if self.n < 2:
            return np.zeros_like(f)
        std = np.sqrt(self.m2 / self.n)
        return ((f - self.mean) / (std + 1e-6)).astype(np.float32)


def _stream_engine(params, meta, ckpt_path: str, stream_cfg: StreamConfig,
                   device: str, gru_impl: str):
    """Build (frame_fn, push_fn, front_lost_fn, engine_lost_fn, input_dim)
    for the selected engine, its model from the checkpoint's JAX-layout
    tree (either package's npz) through its family's ``from_jax_params``
    (models/variants.py), on ``device``.

    frame_fn(face, w, h) -> (feat, open_val); push_fn(feat) ->
    Optional[(label, conf)]. The two lost callbacks reset frame-to-frame
    causal state when the face is lost, split by which thread owns the state
    in the threaded pipeline (both are idempotent): ``front_lost_fn`` resets
    frame_fn-side state and MUST run on the thread that calls frame_fn (the
    producer); ``engine_lost_fn`` resets push_fn-side state and MUST run on
    the thread that calls push_fn (the dispatcher). The sequential loop
    calls both from its single thread.
    """
    import torch

    from ..infer.predictor import full_f32
    from ..models import variants as V
    from ..ops._kernels import IMPLS

    if gru_impl not in IMPLS:  # before the camera opens, not mid-session
        raise ValueError(f"gru_impl={gru_impl!r}: the port takes one of "
                         f"{IMPLS}")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch sees no CUDA device; "
                           "pass device=cpu to stream on the CPU")
    # the uni-GRU family's checkpoint contract names the label map
    # 'id_to_word' (mirroring the reference .pt schema,
    # inactive/train_model_1130pm.py save dict); the window family uses
    # 'id_to_label' — accept both
    labels = meta.get("id_to_label") or meta.get("id_to_word") or {}
    id_to_label = {int(k): v for k, v in labels.items()}

    if stream_cfg.engine == "carry":
        # unidirectional family only: the GRU carry IS the context
        if "t_target" not in meta:
            raise ValueError(
                "engine=carry needs a uni-GRU checkpoint (the unidirectional "
                f"train-unigru family); {ckpt_path} is not one — use "
                "engine=window for the 83-D sliding-window family"
            )
        from ..infer.streaming import CarryStreamingGRU, stream_probs
        from ..ops.features import extract_features_frame as _eff
        from ..ops.nn import dense

        d_target = int(meta["d_target"])
        if d_target != 180:
            raise ValueError(
                f"carry streaming extracts the official 180-D live features; "
                f"this checkpoint was trained at d_target={d_target}"
            )
        if not id_to_label:
            raise ValueError(
                f"{ckpt_path} has no id_to_word/id_to_label map in its "
                "metadata — cannot name predictions (re-save the "
                "checkpoint with its label map)"
            )
        tree = V.UniGRUClassifier.from_jax_params(params).to(
            dev).params_tree()
        eng = CarryStreamingGRU(tree["gru"],
                                lambda h: dense(h, tree["head"]))
        front = _CausalUniGRUFrontend(d_target, bool(meta.get("use_deltas")))
        state = {"i": 0}

        def frame_fn(face, w, h, prev_xy):
            feat, xy_n, _c, _mw = _eff(face, w, h, prev_xy)
            return front(feat), float(feat[-1]), xy_n

        def push_fn(feat):
            logits = eng.push(feat)
            state["i"] += 1
            if state["i"] % stream_cfg.pred_every:
                return None
            p = stream_probs(logits)
            pid = int(p.argmax())
            return id_to_label.get(pid, str(pid)), float(p[pid])

        def front_lost_fn():
            # face lost: break the delta chain (otherwise the first
            # post-gap frame emits a seconds-spanning delta spike into the
            # persistent carry). Runs producer-side — front.prev is written
            # by frame_fn on that thread. The Welford standardization stats
            # are long-run calibration and survive the gap.
            front.prev = None

        def engine_lost_fn():
            # drop the stale GRU context — the gap ended the utterance.
            # Runs dispatch-side, in ring order with the frames around it.
            eng.reset()

        return (frame_fn, push_fn, front_lost_fn, engine_lost_fn,
                eng.layers[0]["fwd"]["wi"].shape[0])

    # sliding-window (83-D GRUWordClassifier family)
    if "input_dim" not in meta and ("x_dim" in meta or "vocab" in meta):
        # the reference's own guard (inactive/live_feed.py:137-138): this
        # mode is built for the 83-D streaming family, not the official
        # BiGRU / CTC checkpoints
        kind = "official BiGRU" if "x_dim" in meta else "CTC"
        raise ValueError(
            f"infer-stream needs a GRUWordClassifier checkpoint "
            f"(83-D streaming family); {ckpt_path} looks like a {kind} "
            f"checkpoint — use "
            f"{'infer-live' if kind != 'CTC' else 'infer-ctc'} for it"
        )
    from ..ops.features import lip83_features_frame_host

    input_dim = int(meta.get("input_dim", 83))  # the family's fixed default
    if not id_to_label:
        # fail at load time, before the camera opens — without this the
        # first prediction dies mid-session on a KeyError
        raise ValueError(
            f"{ckpt_path} has no id_to_label/id_to_word map in its "
            "metadata — cannot name predictions (re-save the checkpoint "
            "with its label map)"
        )
    model = V.GRUWordClassifier.from_jax_params(params).to(dev)

    def fwd(X):
        # the window's forward on the device: K2 on a card (gru_impl),
        # TF32 off; the logits come back to the host
        with torch.inference_mode(), full_f32():
            return model(torch.as_tensor(X, device=dev),
                         gru_impl=gru_impl).cpu().numpy()

    engine = SlidingWindowEngine(fwd, input_dim, stream_cfg)

    def frame_fn(face, w, h, prev_xy):
        # host numpy: the per-frame producer path never dispatches to the
        # device (only the window FORWARD, every pred_every frames, does)
        feat, openness = lip83_features_frame_host(face)
        return feat, float(openness), None

    def push_fn(feat):
        res = engine.push(feat)
        if res is None:
            return None
        pred, conf, _ = res
        return id_to_label.get(pred, str(pred)), conf

    def no_op_lost_fn():
        # reference behavior (inactive/live_feed.py:179-185): face-less
        # frames are skipped and the sliding window persists across the gap;
        # the 83-D features carry no frame-to-frame state to reset
        pass

    return frame_fn, push_fn, no_op_lost_fn, no_op_lost_fn, input_dim


def _stream_overlay(cv2, out, label, conf, open_val, dropped=None):
    cv2.putText(out, f"{label} ({conf:.2f})", (10, 45),
                cv2.FONT_HERSHEY_SIMPLEX, 1.5, (0, 255, 0), 3)
    cv2.putText(out, "Talking" if open_val > 0.04 else "Not talking",
                (10, 90), cv2.FONT_HERSHEY_SIMPLEX, 1, (255, 255, 255), 2)
    if dropped is not None:
        cv2.putText(out, f"drops={dropped}", (10, 130),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.7, (0, 165, 255), 2)


def infer_stream(ckpt_path: str, stream_cfg: StreamConfig = StreamConfig(),
                 model_path: str = "models/face_landmarker.task",
                 cam_index: int = 0, device: str = "cuda",
                 gru_impl: str = "auto"):
    """Continuous streaming inference (inactive/live_feed.py:154-227).

    ``stream_cfg.engine``: 'window' = sliding-window re-score (83-D
    GRUWordClassifier family, on K2 on a card; ``gru_impl`` 'auto',
    'kernel' or 'plain'); 'carry' = one GRU step a frame for uni-GRU
    checkpoints. ``stream_cfg.pipeline``: 'sequential' = the reference's
    one-thread loop; 'threaded' = camera+landmarker producer -> native SPSC
    ring -> dispatch thread (runtime/pipeline.LivePipeline) with the drop
    counter on the overlay and pipeline stats on stdout.
    """
    import cv2

    from ..train.checkpoint import load_checkpoint

    if stream_cfg.engine not in ("window", "carry"):
        raise ValueError(f"unknown engine {stream_cfg.engine!r} "
                         "(expected 'window' or 'carry')")
    if stream_cfg.pipeline not in ("sequential", "threaded"):
        raise ValueError(f"unknown pipeline {stream_cfg.pipeline!r} "
                         "(expected 'sequential' or 'threaded')")

    params, meta, _ = load_checkpoint(ckpt_path)
    frame_fn, push_fn, front_lost_fn, engine_lost_fn, input_dim = (
        _stream_engine(params, meta, ckpt_path, stream_cfg, device,
                       gru_impl))

    lm = FaceLandmarkerSession(model_path, video_mode=False)
    try:
        cam = CameraSource(cam_index)
    except Exception:
        lm.close()
        raise

    try:
        if stream_cfg.pipeline == "threaded":
            _advise_threaded_host()
            _run_stream_threaded(cv2, cam, lm, frame_fn, push_fn,
                                 front_lost_fn, engine_lost_fn,
                                 input_dim, stream_cfg)
        else:
            _run_stream_sequential(cv2, cam, lm, frame_fn, push_fn,
                                   front_lost_fn, engine_lost_fn)
    finally:
        cam.release()
        lm.close()
        cv2.destroyAllWindows()


def _run_stream_sequential(cv2, cam, lm, frame_fn, push_fn, front_lost_fn,
                           engine_lost_fn):
    last_label, last_conf = "...", 0.0
    prev_xy = None
    for frame, ts in cam.frames():
        face = lm.detect(frame)
        out = frame
        if face is None:
            # break the velocity/delta chain so post-gap frames can't splice
            # against seconds-old state (mirrors _run_gated_sequential) —
            # a conscious fix over the reference, which keeps the stale
            # buffer across the gap
            prev_xy = None
            front_lost_fn()
            engine_lost_fn()
            # reference face-lost frame: the message alone, no label overlay
            # (inactive/live_feed.py:179-184)
            cv2.putText(out, "No face found", (10, 30),
                        cv2.FONT_HERSHEY_SIMPLEX, 1, (0, 0, 255), 2)
            cv2.imshow("live", out)
            if cv2.waitKey(1) & 0xFF == ord("q"):
                break
            continue
        h, w = out.shape[:2]
        feat, open_val, prev_xy = frame_fn(face, w, h, prev_xy)
        res = push_fn(feat)
        if res is not None:
            last_label, last_conf = res
        _stream_overlay(cv2, out, last_label, last_conf, open_val)
        cv2.imshow("live", out)
        if cv2.waitKey(1) & 0xFF == ord("q"):
            break


def _run_stream_threaded(cv2, cam, lm, frame_fn, push_fn, front_lost_fn,
                         engine_lost_fn, input_dim,
                         stream_cfg: StreamConfig):
    """Producer (camera+landmarker+features) -> FrameRing -> dispatch thread
    (engine push); the main thread keeps the UI. MediaPipe latency overlaps
    the device's work; ring overflow drops frames (counted and displayed)
    instead of building hidden lag — the upgrade the reference's sequential
    loop (inactive/live_feed.py:154-227) couldn't express. Like the gated
    pipeline, the payload's first float is a validity flag so face-lost
    frames reset the engine's causal state in order on the dispatch thread
    (_flagged_source resets the producer-owned frontend state on its own
    thread).
    """
    import threading

    from ..runtime.pipeline import FramePacker, LivePipeline

    lock = threading.Lock()
    ui = {"frame": None, "seq": 0, "label": "...", "conf": 0.0, "open": 0.0}
    stop = threading.Event()
    feat_dim = input_dim + 1  # [valid flag | engine feature]

    def produce(face, frame, w, h, prev_xy):
        feat, open_val, prev_xy = frame_fn(face, w, h, prev_xy)
        return feat, open_val, prev_xy, None

    source = _flagged_source(cam, lm, stop, lock, ui, produce, front_lost_fn,
                             feat_dim=feat_dim)

    def sink(feat_ext, roi, ts):
        if feat_ext[0] < 0.5:  # face lost
            engine_lost_fn()
            return
        if feat_ext[0] > 1.5:
            # latched gap flag: the 0.0 sentinel was dropped by a full
            # ring — reset before this first post-gap frame
            engine_lost_fn()
        res = push_fn(feat_ext[1:])
        if res is not None:
            with lock:
                ui["label"], ui["conf"] = res

    def draw(out, snap, dropped):
        _stream_overlay(cv2, out, snap["label"], snap["conf"], snap["open"],
                        dropped=dropped)

    pipe = LivePipeline(source, sink, FramePacker(feat_dim=feat_dim),
                        capacity=stream_cfg.ring_capacity)
    pipe.start()
    _run_threaded_ui(cv2, pipe, stop, lock, ui, draw, "live")


def _print_ctc_prediction(ranked):
    """Reference console line (facial_landmark_detection.py:387-391)."""
    if not ranked:
        print("No prediction.")
    else:
        print("Prediction:", ranked[0][0], "Top3:", ranked[:3])


def infer_ctc(ckpt_path: str, model_path: str = "models/face_landmarker.task",
              cam_index: int = 0, chunk_words: int = 0,
              predict_async: bool = False, compute_dtype: str = "float32",
              roi_impl: str = "auto", roi_variant: str = "tiled3",
              gru_impl: str = "auto", matmul_precision: str = "",
              device: str = "cuda"):
    """CTC dictionary-scored live inference
    (inactive/facial_landmark_detection.py semantics): manual-toggle clips,
    silence-trimmed, every dictionary word scored in one lattice
    (``CTCDecoder.score_clip``: K1 and K2 on a card). ``predict_async``
    keeps the camera live during the dictionary sweep instead of freezing
    like the reference. The serving knobs are ``CTCDecoder``'s."""
    import cv2

    from ..infer.ctc_decode import CTCDecoder, Dictionary, trim_silence
    from ..train.checkpoint import load_checkpoint

    params, meta, _ = load_checkpoint(ckpt_path)
    max_t = int(meta["max_t"])
    len_lambda = float(meta.get("len_lambda", 0.02))
    exp_len = int(meta.get("exp_len", 5))
    knob_kw = {}
    if matmul_precision:
        knob_kw["matmul_precision"] = (
            None if matmul_precision in ("default", "none")
            else matmul_precision
        )
    dec = CTCDecoder(
        params, Dictionary.from_words(list(meta["uniq_labels"])),
        device=device, max_t=max_t, len_lambda=len_lambda,
        len_per_char=exp_len, chunk_words=chunk_words,
        compute_dtype=compute_dtype, roi_impl=roi_impl,
        roi_variant=roi_variant, gru_impl=gru_impl,
        roi_h=int(meta.get("roi_h", 48)), roi_w=int(meta.get("roi_w", 96)),
        **knob_kw)
    # reference startup lines (facial_landmark_detection.py:290-291)
    print("Loaded ROI+CTC model. max_t =", max_t, "len_lambda =", len_lambda)
    print("exp_len:", exp_len)
    roi_cfg = InferConfig()
    lm = FaceLandmarkerSession(model_path, video_mode=True)
    try:
        cam = CameraSource(cam_index)
    except Exception:
        lm.close()
        raise
    recording, bufX, bufR, prev_xy = False, [], [], None
    last = None
    ap = (_AsyncClipPredictor(dec.score_clip) if predict_async else None)
    try:
        for frame, ts in cam.frames():
            face = lm.detect(frame, ts)
            out = frame.copy()
            if ap is not None:
                res = ap.poll_overlay(cv2, out, "Scoring...")
                if res is not None:
                    last = res
                    _print_ctc_prediction(last)
            if face is not None and recording:
                h, w = out.shape[:2]
                feat, xy_n, center, mw = extract_features_frame(face, w, h, prev_xy)
                prev_xy = xy_n
                bufX.append(feat)
                bufR.append(_roi_frame(frame, center, mw, roi_cfg))
            # overlay contract: facial_landmark_detection.py:338-354
            cv2.putText(out, f"{'REC' if recording else 'IDLE'} "
                        "| r start/stop | q quit",
                        (20, 40), cv2.FONT_HERSHEY_SIMPLEX, 0.9,
                        (0, 255, 0), 2)
            if recording:
                cv2.putText(out, f"frames: {len(bufX)}", (20, 75),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.8, (0, 255, 0), 2)
            if last:
                cv2.putText(out, f"Best: {last[0][0]}", (20, 110),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.9, (0, 255, 0), 2)
                for k, (lab, score) in enumerate(last[:3]):
                    cv2.putText(out, f"{k + 1}) {lab}  {score:.1f}",
                                (20, 110 + 30 * (k + 1)),
                                cv2.FONT_HERSHEY_SIMPLEX, 0.8,
                                (0, 255, 0), 2)
            cv2.imshow("Lips Only", out)
            key = cv2.waitKey(1) & 0xFF
            if key in (27, ord("q")):
                break
            if key == ord("r"):
                recording = not recording
                if recording:
                    bufX, bufR, prev_xy, last = [], [], None, None
                    if ap is not None:
                        ap.invalidate()  # no stale sweep over the new clip
                else:
                    print(f"Recording stopped. frames={len(bufX)}. "
                          "Predicting...")
                    if len(bufX) < 5:
                        print("Clip too short / no ROI.")
                        continue
                    X, R = np.stack(bufX), np.stack(bufR)
                    Xt, _ = trim_silence(X.astype(np.float32), R,
                                         **dec.trim_kw)
                    print("raw T", len(bufX), "trimmed T", Xt.shape[0])
                    if ap is not None:
                        ap.submit(X, R)
                    else:
                        last = dec.score_clip(X, R)
                        _print_ctc_prediction(last)
    finally:
        try:
            if ap is not None:
                res = ap.shutdown("dictionary sweep")
                if res is not None:
                    _print_ctc_prediction(res)
        finally:
            cam.release()
            lm.close()
            cv2.destroyAllWindows()
