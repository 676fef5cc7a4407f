"""Metrics logging (port of the JAX train/metrics.py ``MetricsLogger``).

The JAX package's ``profiler_trace`` wraps ``jax.profiler``; its
torch.profiler counterpart is not ported yet, and the trainer raises on
``profile_dir``.
"""

from __future__ import annotations

import json
import time
from typing import Optional


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
