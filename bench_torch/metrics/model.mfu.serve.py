"""The served model's FLOPs (``flops.py``: the configuration's layers, T
samples where dropout feeds them) over the window's seconds, as a share
of the card's bf16 tensor-core peak: what bounds a kernel's gain once the
kernel is gone."""

from bench_torch import roofline

UNIT = "%"


def read(record):
    if record["kind"] != "serve":
        return None
    rate = record["flops_per_call"] * record["window_calls"] / record["window_s"]
    return 100.0 * rate / roofline.BF16_RATE
