"""Application layer: the serving driver."""
