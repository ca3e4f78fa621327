"""Atomic, retained, corruption-tolerant checkpoints."""
