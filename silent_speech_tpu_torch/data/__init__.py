"""Corpus, dataset and augmentation (ported: the official trainer's)."""
