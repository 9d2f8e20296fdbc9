"""Checkpoints and metrics logging."""
