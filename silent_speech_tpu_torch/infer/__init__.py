"""Inference (ported: the official family's Predictor, the variant
families' VariantPredictor, the corpus sweeps, the CTC decoder)."""

from .ctc_decode import CTCDecoder, Dictionary, trim_silence
from .evaluator import (evaluate_ctc_dataset, evaluate_dataset,
                        evaluate_temporal_cnn, evaluate_variant_dataset)
from .predictor import Predictor, load_predictor, topk_from_logits
from .variant_predictor import VariantPredictor

__all__ = ["CTCDecoder", "Dictionary", "trim_silence",
           "evaluate_ctc_dataset", "evaluate_dataset",
           "evaluate_temporal_cnn", "evaluate_variant_dataset", "Predictor",
           "load_predictor", "topk_from_logits", "VariantPredictor"]
