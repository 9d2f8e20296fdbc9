"""Evaluation: COCO-style AP metrics and the AP-vs-IoU curve."""
