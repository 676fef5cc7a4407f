"""Metrics logging, stage timers and trace capture (port of the JAX
train/metrics.py: ``MetricsLogger``, ``StageTimer``, ``profiler_trace`` and
``annotate``; the JAX package's trace is ``jax.profiler``'s, the port's
torch.profiler's)."""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Optional

import torch


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """A torch.profiler trace of the block (host ops, and the device's
    kernels and copies where a CUDA device is present) written to
    ``log_dir`` as a Chrome trace (``trace_<pid>.json``) when the block
    ends, also by an exception; no-op when log_dir is None or empty."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir,
                                              f"trace_{os.getpid()}.json"))


class MetricsLogger:
    """Append-only JSONL metrics writer with wall-clock stamping."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._f = open(path, "a") if path else None
        self.t0 = time.time()

    def log(self, step: Optional[int] = None, **metrics):
        rec = {"t": round(time.time() - self.t0, 4)}
        if step is not None:
            rec["step"] = step
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        if self._f:
            # default=str: a value that is not a float degrades to its repr
            # instead of stopping the training loop
            self._f.write(json.dumps(rec, default=str) + "\n")
            self._f.flush()
        return rec

    def close(self):
        if self._f:
            self._f.close()
            self._f = None


class StageTimer:
    """Accumulating per-stage host timers (capture / landmark / pack /
    sink): ``with timer.stage("landmark"): ...``, then ``summary()`` ->
    n, mean, p50 and p95 in ms per stage."""

    def __init__(self):
        self.samples = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    def summary(self) -> dict:
        out = {}
        for name, xs in self.samples.items():
            xs_sorted = sorted(xs)
            n = len(xs_sorted)
            out[name] = {
                "n": n,
                "mean_ms": 1e3 * sum(xs_sorted) / n,
                "p50_ms": 1e3 * xs_sorted[n // 2],
                "p95_ms": 1e3 * xs_sorted[min(n - 1, int(0.95 * n))],
            }
        return out


@contextlib.contextmanager
def annotate(name: str):
    """A named range in torch.profiler traces (``record_function``)."""
    with torch.profiler.record_function(name):
        yield
