"""The training step's model FLOPs (3 × the forward's of ``flops.py``, one
pass an image, times the batch) over the window's seconds, as a share of
the card's bf16 tensor-core peak."""

from bench_torch import roofline

UNIT = "%"


def read(record):
    if record["kind"] != "train":
        return None
    rate = record["flops_per_call"] * record["window_calls"] / record["window_s"]
    return 100.0 * rate / roofline.BF16_RATE
