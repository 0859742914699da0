"""Erasure-coded checkpointing of training state."""
