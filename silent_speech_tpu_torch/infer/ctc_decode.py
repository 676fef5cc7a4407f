"""CTC dictionary decoding, the open-vocabulary inference path (port of the
JAX infer/ctc_decode.py).

Reference flow (inactive/facial_landmark_detection.py:285-394): at a clip's
end, trim the silence by the openness channel, run the CTC model, score
every dictionary word with the CTC forward algorithm plus a length prior
and take the argmax. The reference's per-word double loop becomes one
lattice over the whole padded dictionary (ops/ctc.py), and a batch of
clips scores against a dictionary chunk in one lattice.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ..models import ctc_model
from ..ops.ctc import ctc_word_logprobs_clips, length_prior_penalty
from ..train.checkpoint import load_checkpoint
from .predictor import _check_knobs, full_f32

# the emission tensor of one lattice in score_batch, (B, n, T, S) f32, is
# the sweep's largest allocation; the auto word chunk keeps it at or under
# this many bytes (CTCDecoder.score_batch)
EMIT_BUDGET_BYTES = 1 << 30


def trim_silence(X: np.ndarray, R: Optional[np.ndarray], *,
                 open_idx: int = -3, thresh: float = 0.05, pad: int = 2):
    """Trim leading and trailing frames whose openness channel is at or
    below ``thresh`` (inactive/train_model.py:48-57), keeping ``pad``
    frames either side. open_idx=-3 addresses the mouth_open_px scalar of
    the official 180-D layout."""
    if len(X) == 0:
        return X, R
    active = np.where(X[:, open_idx] > thresh)[0]
    if len(active) == 0:
        return X, R
    s = max(0, active[0] - pad)
    e = min(len(X), active[-1] + pad + 1)
    return X[s:e], None if R is None else R[s:e]


def trim_pad(X: np.ndarray, R: np.ndarray, max_t: int, **trim_kw):
    """One clip as the CTC paths batch it: silence trimmed
    (:func:`trim_silence`), truncated and zero-padded to ``max_t`` frames.
    Returns (X (max_t, D) f32, R (max_t, H, W) uint8, T), T the frames
    kept (0 for an empty clip)."""
    X, R = trim_silence(np.asarray(X, np.float32), np.asarray(R), **trim_kw)
    T = min(len(X), max_t)
    Xp = np.zeros((max_t, X.shape[1]), np.float32)
    Rp = np.zeros((max_t,) + R.shape[1:], np.uint8)
    Xp[:T], Rp[:T] = X[:T], R[:T]
    return Xp, Rp, T


@dataclasses.dataclass
class Dictionary:
    """A padded, id-encoded word list for batch scoring."""

    words: list[str]
    ids: np.ndarray  # (N, L_max) int32
    lens: np.ndarray  # (N,) int32

    @classmethod
    def from_words(cls, words: list[str]) -> "Dictionary":
        encoded = [ctc_model.encode_text(ctc_model.normalize_label(w))
                   for w in words]
        L = max(len(e) for e in encoded)
        ids = np.zeros((len(words), L), np.int32)
        lens = np.zeros(len(words), np.int32)
        for i, e in enumerate(encoded):
            ids[i, :len(e)] = e
            lens[i] = len(e)
        return cls(words=list(words), ids=ids, lens=lens)


def _chunks(dictionary: Dictionary, cw: int):
    """(ids, lens, n) of each chunk of ``cw`` words; the ragged tail is
    padded to the chunk's shape with empty words of length 1 (the JAX
    package's fixed chunk shape; their scores are dropped)."""
    for s0 in range(0, len(dictionary.words), cw):
        ids = dictionary.ids[s0:s0 + cw]
        lens = dictionary.lens[s0:s0 + cw]
        n = len(ids)
        if n < cw:
            ids = np.concatenate([ids, np.zeros((cw - n, ids.shape[1]),
                                                np.int32)])
            lens = np.concatenate([lens, np.ones(cw - n, np.int32)])
        yield ids, lens, n


class CTCDecoder:
    """Dictionary-constrained decoder over a BiGRU-CTC model on one torch
    device.

    ``params``: a JAX-layout parameter tree (numpy or tensors, as either
    package's checkpoint holds it) or a ``BiGRUCTC``. ``device`` defaults
    to 'cuda' and raises without a card; the CPU must be asked for. The
    serving knobs are the Predictor's (infer/predictor.py): ``roi_impl`` /
    ``gru_impl`` 'auto' | 'kernel' | 'plain', ``roi_variant`` 'tiled3' |
    'tiled3_q8' | 'im2col', ``compute_dtype`` 'float32' | 'bfloat16',
    ``matmul_precision`` 'parity' or 'highest' (TF32 off on the card) or
    None.

    ``chunk_words``: score the dictionary in chunks of that many words
    instead of all at once, bounding the lattice's memory for large
    dictionaries; 0 scores it in one lattice (score_batch still bounds the
    chunk by :data:`EMIT_BUDGET_BYTES`). The scores do not depend on the
    chunking: every word's lattice is elementwise its own."""

    def __init__(self, params: Union[dict, "ctc_model.BiGRUCTC"],
                 dictionary: Dictionary, *,
                 device: Union[str, torch.device] = "cuda", max_t: int = 80,
                 len_lambda: float = 0.02, len_per_char: int = 5,
                 trim_open_idx: int = -3, trim_thresh: float = 0.05,
                 trim_pad: int = 2, chunk_words: int = 0,
                 compute_dtype: str = "float32", roi_impl: str = "auto",
                 roi_variant: str = "tiled3", gru_impl: str = "auto",
                 matmul_precision: Optional[str] = "parity",
                 roi_h: int = 48, roi_w: int = 96):
        _check_knobs(roi_impl, gru_impl, roi_variant, compute_dtype,
                     matmul_precision)
        self.chunk_words = int(chunk_words)
        if self.chunk_words < 0:
            raise ValueError(f"chunk_words must be >= 0 (0 = one lattice), "
                             f"got {self.chunk_words}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but torch sees no CUDA device; "
                               "pass device='cpu' to decode on the CPU")
        model = params if isinstance(params, ctc_model.BiGRUCTC) else \
            ctc_model.BiGRUCTC.from_jax_params(params, ctc_model.CTCConfig
                                               .from_params(params,
                                                            roi_h=roi_h,
                                                            roi_w=roi_w))
        self.model = model.to(self.device).eval()
        self.dict = dictionary
        self.max_t = max_t
        self.len_lambda = len_lambda
        self.len_per_char = len_per_char
        self.trim_kw = dict(open_idx=trim_open_idx, thresh=trim_thresh,
                            pad=trim_pad)
        self._fwd_kw = dict(roi_impl=roi_impl, gru_impl=gru_impl,
                            roi_variant=roi_variant,
                            compute_dtype=compute_dtype)
        self.matmul_precision = matmul_precision

    @classmethod
    def from_checkpoint(cls, path: str, _loaded=None, **kw) -> "CTCDecoder":
        """A decoder over an npz CTC checkpoint written by either package:
        its dictionary (``uniq_labels``), ``max_t``, length prior and ROI
        geometry come from the metadata, the widths from the parameters'
        shapes."""
        params, meta, _ = _loaded if _loaded is not None else \
            load_checkpoint(path)
        if not meta.get("vocab"):
            raise ValueError(f"{path} is not a CTC checkpoint (no vocab in "
                             "its metadata)")
        kw.setdefault("max_t", int(meta["max_t"]))
        kw.setdefault("len_lambda", float(meta.get("len_lambda", 0.02)))
        kw.setdefault("len_per_char", int(meta.get("exp_len", 5)))
        kw.setdefault("roi_h", int(meta.get("roi_h", 48)))
        kw.setdefault("roi_w", int(meta.get("roi_w", 96)))
        return cls(params, Dictionary.from_words(list(meta["uniq_labels"])),
                   **kw)

    def logprobs(self, X: np.ndarray, roi: np.ndarray,
                 lengths: np.ndarray) -> torch.Tensor:
        """The model's per-frame log-probabilities (B, T, C) on the device
        for padded host arrays: X (B, T, D) f32, roi (B, T, H, W) uint8,
        lengths (B,)."""
        precision = (full_f32() if self.matmul_precision is not None
                     else contextlib.nullcontext())
        with torch.inference_mode(), precision:
            # the raw uint8 frames cross: the ROI CNN normalizes (/255) on
            # the device, bitwise the reference collate division
            X = torch.as_tensor(np.asarray(X, np.float32), device=self.device)
            R = torch.as_tensor(np.asarray(roi, np.uint8), device=self.device)
            L = torch.as_tensor(np.asarray(lengths, np.int32),
                                device=self.device)
            return self.model(X, L, R, **self._fwd_kw)

    def score_clip(self, X: np.ndarray, roi: np.ndarray
                   ) -> list[tuple[str, float]]:
        """X: (T, D) f32; roi: (T, H, W) uint8. Returns (word, score) sorted
        best first, the scores including the length prior: the clip trimmed
        and padded (:func:`trim_pad`), then :meth:`score_batch` at B=1."""
        Xp, Rp, T = trim_pad(X, roi, self.max_t, **self.trim_kw)
        if T == 0:
            return []
        s = self.score_batch(Xp[None], Rp[None], np.asarray([T], np.int32))[0]
        order = np.argsort(s)[::-1]
        return [(self.dict.words[i], float(s[i])) for i in order]

    def predict(self, X: np.ndarray, roi: np.ndarray) -> Optional[str]:
        ranked = self.score_clip(X, roi)
        return ranked[0][0] if ranked else None

    def shard(self, mesh) -> "CTCDecoder":
        """The sweep over a device mesh: not ported yet."""
        raise NotImplementedError(
            "CTCDecoder.shard: the sweep over a device mesh is not ported to "
            "silent_speech_tpu_torch (ROADMAP.md queue 1, slice 7: "
            "multi-GPU)")

    def word_chunk(self, B: int) -> int:
        """The words a lattice of :meth:`score_batch` scores at once for a
        batch of B clips: ``chunk_words`` (all N where 0), at most what
        keeps the gathered emissions, B * n * max_t * S f32 with S =
        2 L_max + 1 states, at or under EMIT_BUDGET_BYTES. The emissions
        are the largest tensor of the no-grad lattice: each of its steps
        allocates a few (B, n, S) temporaries, max_t times less, and frees
        them at the next."""
        N = len(self.dict.words)
        S = 2 * self.dict.ids.shape[1] + 1
        cw_auto = max(1, EMIT_BUDGET_BYTES // (B * self.max_t * S * 4))
        return min(self.chunk_words or N, cw_auto, N)

    def score_batch(self, X: np.ndarray, roi: np.ndarray,
                    lengths: np.ndarray) -> np.ndarray:
        """Batched dictionary scores for clips already trimmed and padded:
        X (B, max_t, D) f32, roi (B, max_t, H, W) uint8, lengths (B,) ->
        (B, n_words) scores including the length prior. One batched forward,
        then one lattice a word chunk (:meth:`word_chunk`)."""
        lp = self.logprobs(X, roi, lengths)
        T = torch.as_tensor(np.asarray(lengths, np.int32), device=self.device)
        cw = self.word_chunk(len(lp))
        outs = []
        with torch.inference_mode():
            for ids, lens, n in _chunks(self.dict, cw):
                s = ctc_word_logprobs_clips(lp, T, ids, lens)
                if self.len_lambda > 0:
                    s = length_prior_penalty(s, lens, T[:, None],
                                             self.len_lambda,
                                             self.len_per_char)
                outs.append(s[:, :n].cpu().numpy())
        return np.concatenate(outs, axis=1)
