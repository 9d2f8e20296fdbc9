"""The card's peaks and the least time a kernel's work could take on it.

Copied from ``chip_smoke.py`` (``bound``, ``expand_bound``) so that the
yardstick stays with the benchmark: the bytes in and out once at the HBM
rate, bf16 tensor-core operations at 989 TFLOP/s and f32 operations at
67 TFLOP/s (H100 SXM data sheet, 700 W).
"""

from __future__ import annotations

# bytes/s, bf16 tensor-core FLOP/s, f32 FLOP/s
HBM_RATE, BF16_RATE, F32_RATE = 3.35e12, 989e12, 67e12


def bound(nbytes, bf16_flops=0.0, f32_flops=0.0):
    """(ms, "bytes" or "operations"): the largest of the bytes over the
    memory rate and the operations of each type over that type's peak rate
    (tensor cores and CUDA cores run side by side)."""
    t_bytes = nbytes / HBM_RATE * 1e3
    t_ops = max(bf16_flops / BF16_RATE, f32_flops / F32_RATE) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def expand_bound(n, cin, ce, h, w, k, s, itemsize=2):
    """The fused expand + depthwise's bound: x in and y out once (masks,
    parameters and SE sums are small), the expand on tensor cores, the
    depthwise and the per-value bias, swish and mask in f32."""
    ho, wo = -(-h // s), -(-w // s)
    nbytes = (n * cin * h * w + n * ce * ho * wo) * itemsize + n * ce * 4
    return bound(nbytes, 2.0 * n * h * w * cin * ce,
                 n * ce * (h * w * 4.0 + ho * wo * (2 * k * k + 4)))
