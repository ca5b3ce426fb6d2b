"""Compact checkpoints."""
