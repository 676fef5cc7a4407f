"""Corpus scanning, filtering, splitting and sampling (port of the JAX
data/corpus.py; plain Python and numpy, so both packages split and sample
the same way).

Reproduces the official trainer's preflight semantics exactly
(train_model_official.py:316-398): scan every clip's label/dim/roi/idxs,
filter to the modal feature dim, warn on mixed idx signatures, stratified
split by label with the pinned RNG, and inverse-frequency weighted sampling.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import random
from collections import Counter, defaultdict
from typing import Optional

import numpy as np

from ..core.schema import Clip, load_clip


@dataclasses.dataclass
class CorpusIndex:
    files: list[str]
    labels: list[str]
    dims: list[int]
    has_roi: list[bool]
    idx_signatures: list[Optional[tuple]]

    @property
    def n_roi(self) -> int:
        return sum(self.has_roi)

    def label_counts(self) -> Counter:
        return Counter(self.labels)


def _npy_member_shape(zf, name: str) -> tuple:
    """Shape of one .npy member from its HEADER alone — no array inflate.

    The preflight only needs X's feature dim; NpzFile.__getitem__ would
    decompress the whole (T, D) payload per clip, making the scan an
    O(corpus bytes) pass; zf.open streams, so only the ~100 header bytes
    are inflated."""
    from numpy.lib import format as npf

    with zf.open(name) as fp:
        version = npf.read_magic(fp)
        if version == (1, 0):
            return npf.read_array_header_1_0(fp)[0]
        if version == (2, 0):
            return npf.read_array_header_2_0(fp)[0]
    # exotic/future npy version (e.g. (3,0) utf-8 headers): pay the full
    # read rather than fail — RE-OPENED, since read_array wants to consume
    # the magic bytes read_magic already took
    with zf.open(name) as fp:
        return npf.read_array(fp, allow_pickle=False).shape


def scan_corpus(clip_dir: str, verbose: bool = True) -> CorpusIndex:
    import io
    import zipfile

    files = sorted(glob.glob(os.path.join(clip_dir, "*.npz")))
    if not files:
        raise RuntimeError(f"No .npz files found in {clip_dir}")
    labels, dims, has_roi, sigs = [], [], [], []
    for f in files:
        try:
            with zipfile.ZipFile(f) as zf:
                names = set(zf.namelist())
                if "X.npy" not in names:
                    raise KeyError(f"{f}: no X entry")
                shape = _npy_member_shape(zf, "X.npy")
                if len(shape) != 2:
                    raise ValueError(f"{f}: X must be (T, D), got {shape}")
                dims.append(int(shape[1]))
                has_roi.append("roi.npy" in names)
                # label/idxs are tiny members — full read is fine
                if "label.npy" in names:
                    lab = np.load(io.BytesIO(zf.read("label.npy")),
                                  allow_pickle=False)
                    labels.append(str(lab))
                else:
                    labels.append("")
                if "idxs.npy" in names:
                    ix = np.load(io.BytesIO(zf.read("idxs.npy")),
                                 allow_pickle=False)
                    sigs.append(tuple(ix.tolist()))
                else:
                    sigs.append(None)
        except zipfile.BadZipFile as e:
            raise IOError(f"{f}: corrupt npz container: {e}") from e
    idx = CorpusIndex(files, labels, dims, has_roi, sigs)
    if verbose:
        print("Total clips:", len(files))
        print("Label counts:", idx.label_counts())
        print("X dims:", Counter(dims))
        print("ROI present in:", idx.n_roi, "files")
    return idx


def filter_modal_dim(index: CorpusIndex, verbose: bool = True) -> tuple[CorpusIndex, int]:
    """Keep only clips whose feature dim equals the modal dim
    (train_model_official.py:341-353). Returns (filtered index, x_dim)."""
    counter = Counter(index.dims)
    x_dim = counter.most_common(1)[0][0]
    if len(counter) == 1:
        return index, x_dim
    if verbose:
        print("[warn] Multiple feature dims found. Keeping only dim =", x_dim)
    keep = [i for i, d in enumerate(index.dims) if d == x_dim]
    out = CorpusIndex(
        files=[index.files[i] for i in keep],
        labels=[index.labels[i] for i in keep],
        dims=[index.dims[i] for i in keep],
        has_roi=[index.has_roi[i] for i in keep],
        idx_signatures=[index.idx_signatures[i] for i in keep],
    )
    return out, x_dim


def warn_mixed_idx_signatures(index: CorpusIndex, verbose: bool = True) -> int:
    """Count distinct landmark-index signatures; warn when >1
    (train_model_official.py:355-361)."""
    counter = Counter(s for s in index.idx_signatures if s is not None)
    if len(counter) > 1 and verbose:
        most = counter.most_common(1)[0]
        print(
            f"[warn] Multiple idx signatures detected ({len(counter)}). "
            f"Most common occurs {most[1]} times. "
            f"If accuracy is weird, record using a fixed idx list across clips."
        )
    return len(counter)


def split_by_label(
    files: list[str],
    labels: list[str],
    val_frac: float = 0.15,
    seed: int = 42,
    verbose: bool = True,
) -> tuple[list[str], list[str]]:
    """Per-label stratified split, identical RNG protocol to the reference
    (train_model_official.py:52-77): shuffle each label's files, take
    max(1, round(n*val_frac)) capped at n-1 for validation, then shuffle both
    result lists."""
    rng = random.Random(seed)
    by_lab = defaultdict(list)
    for f, lab in zip(files, labels):
        by_lab[lab].append(f)
    train, val = [], []
    for lab, fs in by_lab.items():
        rng.shuffle(fs)
        n = len(fs)
        n_val = max(1, int(round(n * val_frac)))
        n_val = min(n_val, n - 1)
        val.extend(fs[:n_val])
        train.extend(fs[n_val:])
        if verbose:
            print(f"{lab:>10}: total={n:4d}  train={n - n_val:4d}  val={n_val:4d}")
    rng.shuffle(train)
    rng.shuffle(val)
    return train, val


def stratified_split_3way(
    files: list[str],
    labels: list[str],
    seed: int = 42,
    train_frac: float = 0.70,
    val_frac: float = 0.15,
) -> tuple[list[str], list[str], list[str]]:
    """70/15/15 train/val/test split (inactive/train_5_quick.py:52-79):
    each label's files shuffled, round(n * frac) to train and to val, the
    rest to test, then the three lists shuffled."""
    rng = random.Random(seed)
    by_lab = defaultdict(list)
    for f, lab in zip(files, labels):
        by_lab[lab].append(f)
    train, val, test = [], [], []
    for fs in by_lab.values():
        rng.shuffle(fs)
        n = len(fs)
        n_train = int(round(n * train_frac))
        n_val = int(round(n * val_frac))
        train += fs[:n_train]
        val += fs[n_train:n_train + n_val]
        test += fs[n_train + n_val:]
    rng.shuffle(train)
    rng.shuffle(val)
    rng.shuffle(test)
    return train, val, test


def inverse_frequency_weights(labels: list[str]) -> np.ndarray:
    """Per-sample weights 1/count[label] (train_model_official.py:385-389)."""
    counts = Counter(labels)
    return np.asarray([1.0 / counts[lab] for lab in labels], dtype=np.float64)


def top_confusions(
    y_true, y_pred, id_to_label: dict[int, str], k: int = 8
) -> list[str]:
    """Most frequent (true -> predicted) error pairs, formatted as the
    reference prints them (train_model_official.py:79-91)."""
    c = Counter()
    for t, p in zip(y_true, y_pred):
        if t != p:
            c[(int(t), int(p))] += 1
    return [
        f"{id_to_label[t]}→{id_to_label[p]}({n})" for (t, p), n in c.most_common(k)
    ]


def build_label_maps(labels: list[str]) -> tuple[dict[str, int], dict[int, str]]:
    uniq = sorted(set(labels))
    label_to_id = {lab: i for i, lab in enumerate(uniq)}
    id_to_label = {i: lab for lab, i in label_to_id.items()}
    return label_to_id, id_to_label


def load_clips(files: list[str]) -> list[Clip]:
    return [load_clip(f) for f in files]
