"""Anchors, uncertainty decoding, soft-NMS (plain and CUDA) and postprocess."""
