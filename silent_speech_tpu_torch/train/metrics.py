"""Metrics logging and trace capture (port of the JAX train/metrics.py
``MetricsLogger`` and ``profiler_trace``; the JAX package's trace is
``jax.profiler``'s, the port's torch.profiler's)."""

from __future__ import annotations

import contextlib
import json
import os
import time
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
