"""Training metrics as JSON lines: the port's copy of the JAX package's
``MetricsWriter`` without its TensorBoard branch (which imports
TensorFlow)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsWriter:
    """Appends one JSON object a call to ``<log_dir>/metrics.jsonl``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time(),
               **{k: float(v) for k, v in metrics.items()}}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def write_image(self, step: int, tag: str, image) -> None:
        """Does nothing. The JAX package writes an image summary only to
        TensorBoard and returns when there is none; the port has no
        TensorBoard, so callers write their images as PNG files themselves
        (``data.image_codec.write_png``)."""

    def close(self) -> None:
        self._jsonl.close()
