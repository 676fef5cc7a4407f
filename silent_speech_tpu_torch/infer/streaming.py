"""Streaming inference engines (port of the JAX infer/streaming.py).

- ``SlidingWindowEngine``: a rolling feature buffer re-scored every Nth
  frame after a warm-up (inactive/live_feed.py:154-227); the window is
  always (1, max_t, D), so every prediction runs the same shapes.
- ``OpennessGate``: the hysteresis auto-clip segmentation of
  inactive/live_lower_half.py:143-151 and its loop: speaking starts after
  ``start_n`` frames above ``open_thresh``, the clip ends after ``end_n``
  frames below (or at ``max_clip``) and is emitted for prediction.
- ``CarryStreamingGRU``: for unidirectional GRUs the carry is the context,
  so each frame is one GRU step from the kept carry instead of a re-run of
  the window. In the JAX package that step is XLA, with no Pallas kernel
  (ops/gru.py:52); the port's is plain PyTorch on the weights' device,
  TF32 off.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from ..core.config import StreamConfig
from ..ops.gru import gru_cell_step
from .predictor import full_f32


def stream_probs(logits: np.ndarray) -> np.ndarray:
    """Stable softmax for the streaming engines' per-frame logits.

    One definition for every streaming consumer; deliberately not
    ``infer.predictor.topk_from_logits``, which keeps the reference's
    formatted-output math (float64, no epsilon,
    live_infer_official.py:223-226)."""
    logits = np.asarray(logits)
    p = np.exp(logits - logits.max())
    p /= p.sum() + 1e-9
    return p


class SlidingWindowEngine:
    """Rolling-buffer word scorer.

    ``forward(X_padded (1, max_t, D) f32 numpy) -> logits (1, C)`` is any
    window model (the 83-D GRU-word classifier in ``infer-stream``). Feed
    frames with ``push(feat) -> Optional[(label_id, conf, probs)]``."""

    def __init__(self, forward: Callable, input_dim: int,
                 cfg: StreamConfig = StreamConfig()):
        self.forward = forward
        self.input_dim = input_dim
        self.cfg = cfg
        self.buf: deque = deque(maxlen=cfg.max_t)
        self.frame_idx = 0
        self.warmup = min(cfg.warmup_min, cfg.max_t)

    def reset(self):
        self.buf.clear()
        self.frame_idx = 0

    def push(self, feat: np.ndarray):
        self.buf.append(np.asarray(feat, np.float32))
        self.frame_idx += 1
        if len(self.buf) < self.warmup or self.frame_idx % self.cfg.pred_every:
            return None
        X = np.zeros((self.cfg.max_t, self.input_dim), np.float32)
        seq = np.stack(self.buf)
        t = min(len(seq), self.cfg.max_t)
        X[:t] = seq[:t]
        logits = np.asarray(self.forward(X[None]))[0]
        p = stream_probs(logits)
        pred = int(p.argmax())
        return pred, float(p[pred]), p


@dataclasses.dataclass
class ClipEvent:
    """Emitted by OpennessGate when a gated clip completes."""

    frames: np.ndarray  # (T, D) features collected during the clip
    rois: Optional[np.ndarray]  # (T, H, W) or None


class OpennessGate:
    """Hysteresis-counter speech gating (VAD-like clip segmentation)."""

    def __init__(self, cfg: StreamConfig = StreamConfig()):
        self.cfg = cfg
        self.speaking = False
        self.above = 0
        self.below = 0
        self.bufX: list[np.ndarray] = []
        self.bufR: list[np.ndarray] = []

    def reset(self):
        self.speaking = False
        self.above = self.below = 0
        self.bufX, self.bufR = [], []

    def push(self, openness: float, feat: np.ndarray,
             roi: Optional[np.ndarray] = None) -> Optional[ClipEvent]:
        """Feed one frame; returns a ClipEvent when a clip just ended."""
        cfg = self.cfg
        if not self.speaking:
            if openness > cfg.open_thresh:
                self.above += 1
                if self.above >= cfg.start_n:
                    self.speaking = True
                    self.below = 0
                    self.bufX, self.bufR = [], []
            else:
                self.above = 0
            return None
        self.bufX.append(np.asarray(feat, np.float32))
        if roi is not None:
            self.bufR.append(np.asarray(roi))
        if openness <= cfg.open_thresh:
            self.below += 1
        else:
            self.below = 0
        if self.below >= cfg.end_n or len(self.bufX) >= cfg.max_clip:
            ev = ClipEvent(frames=np.stack(self.bufX),
                           rois=np.stack(self.bufR) if self.bufR else None)
            self.reset()
            return ev
        return None


class CarryStreamingGRU:
    """One GRU step a frame for stacked *unidirectional* GRUs.

    ``layers``: the 'gru' parameter list ({'fwd': {...}} per layer) as
    tensors on one device, where the steps run. ``head``: (top hidden
    (1, H) tensor) -> logits (1, C). The carry is a tuple of per-layer
    hidden states."""

    def __init__(self, layers: list[dict], head: Callable):
        self.layers = layers
        self.head = head
        w = layers[0]["fwd"]["wh"]
        self._h0 = tuple(w.new_zeros((1, lp["fwd"]["wh"].shape[0]))
                         for lp in layers)
        self.carry = self._h0

    def reset(self):
        self.carry = self._h0

    def _step(self, carry, x):
        new_carry = []
        inp = x
        for lp, h in zip(self.layers, carry):
            p = lp["fwd"]
            h_new = gru_cell_step(h, inp @ p["wi"] + p["bi"], p["wh"],
                                  p["bh"])
            new_carry.append(h_new)
            inp = h_new
        return tuple(new_carry), inp

    def push(self, feat: np.ndarray) -> np.ndarray:
        """feat: (D,) -> logits (C,) after this frame."""
        w = self.layers[0]["fwd"]["wi"]
        x = torch.as_tensor(np.asarray(feat, np.float32),
                            device=w.device)[None]
        with torch.inference_mode(), full_f32():
            self.carry, top = self._step(self.carry, x)
            return self.head(top)[0].cpu().numpy()
