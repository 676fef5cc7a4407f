"""Clip prediction (ported: the official-family Predictor)."""
