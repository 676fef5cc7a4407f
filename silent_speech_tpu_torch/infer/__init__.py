"""Inference (ported: the official family's Predictor, the corpus sweeps,
the CTC decoder)."""

from .ctc_decode import CTCDecoder, Dictionary, trim_silence
from .evaluator import evaluate_ctc_dataset, evaluate_dataset
from .predictor import Predictor, load_predictor, topk_from_logits

__all__ = ["CTCDecoder", "Dictionary", "trim_silence",
           "evaluate_ctc_dataset", "evaluate_dataset", "Predictor",
           "load_predictor", "topk_from_logits"]
