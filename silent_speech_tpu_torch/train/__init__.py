"""Checkpointing (ported: the npz format)."""
