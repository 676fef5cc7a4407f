"""Training (ported: the official trainer, the CTC trainer, the legacy
trainers of train/legacy_loops.py, steps, npz checkpoints, metrics).

``train_ctc`` loads at first use: its validation decodes through
infer.ctc_decode, whose predictor imports this package's checkpoint module.
"""

from .checkpoint import load_checkpoint, reference_meta, save_checkpoint
from .loop import train
from .step import StepConfig, make_optimizer, smoothed_cross_entropy

__all__ = ["load_checkpoint", "reference_meta", "save_checkpoint", "train",
           "train_ctc", "StepConfig", "make_optimizer",
           "smoothed_cross_entropy"]


def __getattr__(name):
    if name == "train_ctc":
        from .ctc_loop import train_ctc

        return train_ctc
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
