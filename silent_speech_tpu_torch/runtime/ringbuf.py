"""SPSC frame ring buffer on the native ring (port of the JAX
runtime/ringbuf.py).

Carries fixed-size per-frame payloads (a feature vector and a 48x96 ROI)
from the capture / landmark thread to the dispatch thread. ``push`` fails
(returns False) when the ring is full, counted in ``dropped``, rather than
overwriting a clip in flight. The JAX ring becomes a Python deque when its
library does not build or load; this one builds and loads
``csrc/ringbuf.cpp`` (runtime/native.py) or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from . import native

_P8 = ctypes.POINTER(ctypes.c_uint8)


class FrameRing:
    """Fixed-capacity SPSC ring of ``slot_bytes``-sized byte payloads; the
    capacity rounds up to a power of two (at least 2)."""

    def __init__(self, capacity: int, slot_bytes: int):
        self.slot_bytes = int(slot_bytes)
        self._lib = native.load()
        self._h = self._lib.rb_create(capacity, slot_bytes)
        if not self._h:
            raise MemoryError(f"rb_create({capacity}, {slot_bytes}) failed")
        self.capacity = int(self._lib.rb_capacity(self._h))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rb_destroy(self._h)
            self._h = None

    @property
    def native(self) -> bool:
        """Always True: the port's ring is the native one."""
        return True

    def __len__(self) -> int:
        return int(self._lib.rb_size(self._h))

    @property
    def dropped(self) -> int:
        return int(self._lib.rb_dropped(self._h))

    def push(self, payload: np.ndarray, stamp: int = 0) -> bool:
        buf = np.ascontiguousarray(payload).view(np.uint8).reshape(-1)
        return bool(self._lib.rb_push(self._h, buf.ctypes.data_as(_P8),
                                      buf.nbytes, stamp))

    def pop(self) -> Optional[tuple[np.ndarray, int]]:
        out = np.empty(self.slot_bytes, np.uint8)
        stamp = ctypes.c_uint64()
        ok = self._lib.rb_pop(self._h, out.ctypes.data_as(_P8), out.nbytes,
                              ctypes.byref(stamp))
        return (out, int(stamp.value)) if ok else None

    def pop_batch(self, max_items: int) -> tuple[np.ndarray, np.ndarray]:
        """Drain up to max_items; returns (payloads (n, slot_bytes) u8,
        stamps (n,) u64)."""
        out = np.empty((max_items, self.slot_bytes), np.uint8)
        stamps = np.empty(max_items, np.uint64)
        n = int(self._lib.rb_pop_batch(
            self._h, out.ctypes.data_as(_P8), max_items,
            stamps.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))))
        return out[:n], stamps[:n]
