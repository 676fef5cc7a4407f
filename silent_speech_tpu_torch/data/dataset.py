"""The corpus as padded tensors on one device (port of the JAX
data/dataset.py).

The corpus is loaded once through numpy (the JAX package's
``prefer_native=False`` branch), padded to ``max_t`` and moved to the
device; a batch is an ``index_select`` there. ``epoch_batches`` stays numpy,
so the same ``np.random.Generator`` gives the same batches in both packages.
The JAX package's native C++ loader is not ported (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Union

import numpy as np
import torch

from ..core.schema import batch_clips, fix_dim
from .corpus import load_clips


@dataclasses.dataclass
class TorchDataset:
    """Padded, stacked corpus tensors on one device."""

    X: torch.Tensor  # (N, max_t, D) float32
    lengths: torch.Tensor  # (N,) int32
    y: torch.Tensor  # (N,) int64
    roi: Optional[torch.Tensor]  # (N, max_t, H, W) uint8
    labels: list[str]

    @property
    def n(self) -> int:
        return int(self.X.shape[0])

    @property
    def max_t(self) -> int:
        return int(self.X.shape[1])

    def gather(self, idx: Union[np.ndarray, torch.Tensor]):
        """(X, lengths, roi, y) of the rows ``idx``, on the dataset's
        device."""
        i = torch.as_tensor(np.asarray(idx, np.int64), device=self.X.device)
        roi = None if self.roi is None else self.roi.index_select(0, i)
        return (self.X.index_select(0, i), self.lengths.index_select(0, i),
                roi, self.y.index_select(0, i))


def build_dataset(
    files: list[str],
    label_to_id: dict[str, int],
    max_t: int,
    use_roi: bool,
    x_dim: Optional[int] = None,
    roi_hw: tuple[int, int] = (48, 96),
    device: Union[str, torch.device] = "cuda",
    labels: Optional[list[str]] = None,
) -> TorchDataset:
    """Load, pad and stack a clip list onto ``device``. ``labels``
    (parallel to ``files``, as a corpus scan gives them) take precedence
    over each clip's own, as in the JAX package."""
    if labels is not None and len(labels) != len(files):
        raise ValueError(
            f"labels has {len(labels)} entries for {len(files)} files")
    clips = load_clips(files)
    if labels is not None:
        for c, lab in zip(clips, labels):
            c.label = lab
    if x_dim is not None:
        for c in clips:
            c.X = fix_dim(c.X, x_dim)
    batch = batch_clips(clips, label_to_id, max_t, use_roi, roi_hw)
    put = lambda a: torch.from_numpy(a).to(device)
    return TorchDataset(
        X=put(batch.X),
        lengths=put(batch.lengths),
        y=put(batch.y.astype(np.int64)),
        roi=None if batch.roi is None else put(batch.roi),
        labels=[c.label for c in clips],
    )


def epoch_batches(
    n: int,
    batch_size: int,
    rng: np.random.Generator,
    *,
    weights: Optional[np.ndarray] = None,
    shuffle: bool = True,
    drop_last: bool = False,
    pad: bool = True,
) -> Iterator[np.ndarray]:
    """Yield index arrays for one epoch (the JAX package's, unchanged).

    With ``weights``, samples n indices with replacement (the reference's
    WeightedRandomSampler); otherwise a shuffled (or sequential) permutation.
    With ``pad``, the final short batch is padded by wrapping; evaluation
    uses ``pad=False`` (a wrapped sample would be counted twice).
    """
    if weights is not None:
        p = weights / weights.sum()
        order = rng.choice(n, size=n, replace=True, p=p)
    elif shuffle:
        order = rng.permutation(n)
    else:
        order = np.arange(n)
    for s in range(0, n, batch_size):
        chunk = order[s : s + batch_size]
        if len(chunk) < batch_size:
            if drop_last:
                return
            if pad:
                padding = order[: batch_size - len(chunk)]
                if len(padding) < batch_size - len(chunk):  # tiny corpus
                    reps = -(-(batch_size - len(chunk)) // max(1, len(order)))
                    padding = np.tile(order, reps)[: batch_size - len(chunk)]
                chunk = np.concatenate([chunk, padding])
        yield chunk.astype(np.int32)
