"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a traceback and a nonzero
exit code:

1. device: a CUDA card is required; prints its name and power limit
   (nvidia-smi), the torch and CUDA versions; turns TF32 off.
2. build: compiles ``udal_tpu_torch/csrc/*.cu`` with nvcc (sm_90a).
3. kernel vs plain: the soft-NMS kernel against its plain PyTorch version
   on the card at the main path's shapes (B=8, N=5000, K=100), gaussian
   and hard, random and tied scores: equal valid_len, equal indices over
   it, scores within 1e-6; median times of both from CUDA events.
4. the slice at full width: MC-dropout EfficientDet-d0 (1024x512, 8
   classes, loss attenuation, T=10 at rate 0.05, batch 8, bf16, random
   weights from a seed) serves uint8 batches; checks the packed shapes,
   finiteness, detections, and that every serve call launched the NMS
   kernel once.
5. device parity: the same weights (numpy from a seed, through
   ``convert.py``) at 128x128 in f32 served on the CPU (plain NMS) and on
   the card (kernel) with the same dropout masks; detections agree as
   matched sets.

The line before the last is a JSON summary of the kernels; the last line
is ``{"ok": true, "device": {...}}``.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from udal_tpu_torch.apps.serving import ServingDriver
from udal_tpu_torch.config import get_detection_config
from udal_tpu_torch.convert import flax_to_torch, torch_to_flax
from udal_tpu_torch.models.efficientdet import EfficientDetNet
from udal_tpu_torch.models.efficientnet import ChannelDropout
from udal_tpu_torch.ops import _build, cuda_nms, nms

MAIN_PATH = dict(image_size="1024x512", num_classes=8, loss_attenuation=True,
                 mc_dropout=True, mc_dropoutrate=0.05, mc_dropoutsamp=10)
BATCH, N_CAND, K = 8, 5000, 100
SERVE_CALLS = 4


def phase(n, msg):
    print(f"[phase {n}] {msg}", flush=True)


def random_boxes(rng, b, n, tied=False, size=256):
    y1 = rng.uniform(0, size - 30, (b, n))
    x1 = rng.uniform(0, size - 30, (b, n))
    h = rng.uniform(10, 80, (b, n))
    w = rng.uniform(10, 80, (b, n))
    boxes = np.stack([y1, x1, y1 + h, x1 + w], -1).astype(np.float32)
    scores = rng.uniform(0.01, 1.0, (b, n)).astype(np.float32)
    if tied:
        scores = np.asarray([0.3, 0.6, 0.9], np.float32)[rng.randint(0, 3, (b, n))]
    return boxes, scores


def cuda_median_ms(fn, runs=25, warmup=5):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class HostMasks(ChannelDropout):
    """Dropout masks drawn on the host, so a CPU and a CUDA run share them."""

    def draw(self, n, c, keep, device):
        return super().draw(n, c, keep, "cpu").to(device)


def random_flax_variables(model, seed):
    """Numpy weights from ``seed`` in the flax variable layout (lecun-scale
    kernels, BN scales and variances in [0.5, 1.5])."""
    rng = np.random.RandomState(seed)

    def fill(tree):
        out = {}
        for k, v in sorted(tree.items()):
            if isinstance(v, dict):
                out[k] = fill(v)
            elif k == "kernel":
                out[k] = rng.normal(0, np.sqrt(1.0 / np.prod(v.shape[:-1])), v.shape)
            elif k in ("scale", "var", "edge_weights"):
                out[k] = rng.uniform(0.5, 1.5, v.shape)
            else:
                out[k] = rng.normal(0, 0.1, v.shape)
            if not isinstance(out[k], dict):
                out[k] = out[k].astype(np.float32)
        return out

    params, stats = torch_to_flax(model)
    return fill(params), fill(stats)


def matched_sets(got, want, tag):
    """Same count per image; each reference detection pairs with one of the
    same class, box IoU >= 0.99 and score within 1e-4; aleatoric sigma to
    rtol 1e-3. Returns the largest score difference of the pairs."""
    g_boxes, g_scores, g_classes, g_len = (t.float().cpu().numpy() for t in got)
    w_boxes, w_scores, w_classes, w_len = (t.float().cpu().numpy() for t in want)
    if not np.array_equal(g_len, w_len) or w_len.min() <= 0:
        raise AssertionError(f"{tag}: valid_len {g_len} vs {w_len}")
    worst = 0.0
    for b in range(len(w_len)):
        n = int(w_len[b])
        used = np.zeros(n, bool)
        for i in range(n):
            tl = np.maximum(g_boxes[b, :n, :2], w_boxes[b, i, :2])
            br = np.minimum(g_boxes[b, :n, 2:4], w_boxes[b, i, 2:4])
            inter = np.prod(np.clip(br - tl, 0, None), -1)
            area = lambda x: np.prod(np.clip(x[..., 2:4] - x[..., :2], 0, None), -1)  # noqa: E731
            iou = inter / np.maximum(area(g_boxes[b, :n]) + area(w_boxes[b, i]) - inter, 1e-12)
            diff = np.abs(g_scores[b, :n] - w_scores[b, i])
            ok = (iou >= 0.99) & (diff <= 1e-4) & (g_classes[b, :n, 0] == w_classes[b, i, 0]) & ~used
            if not ok.any():
                raise AssertionError(f"{tag}: image {b} detection {i} has no match")
            j = int(np.argmax(ok))
            used[j] = True
            worst = max(worst, float(diff[j]))
            np.testing.assert_allclose(g_boxes[b, j, 4:8], w_boxes[b, i, 4:8], rtol=1e-3,
                                       atol=1e-6, err_msg=tag)
    return worst


def main():
    # -- 1. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; torch.cuda.is_available() "
                           "is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    phase(1, f"device {torch.cuda.get_device_name(0)} ({smi}); torch {torch.__version__}, "
             f"CUDA {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library("soft_nms")
    phase(2, f"built csrc/soft_nms.cu in {time.perf_counter() - t0:.2f} s")
    log = _build.library_path("soft_nms").with_suffix(".log").read_text()
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # -- 3. kernel vs plain at the main path's shapes ------------------------
    rng = np.random.RandomState(0)
    max_err, times = 0.0, {}
    for sigma, tied in ((0.5, False), (0.0, False), (0.5, True)):
        boxes, scores = random_boxes(rng, BATCH, N_CAND, tied)
        b = torch.from_numpy(boxes).to(dev)
        s = torch.from_numpy(scores).to(dev)
        thr = 0.001 if sigma > 0 else float("-inf")
        want = nms.batched_soft_nms(b, s, K, 0.5, thr, sigma)
        got = cuda_nms.soft_nms_cuda(b, s, K, 0.5, thr, sigma)
        torch.cuda.synchronize()
        vlen = want.valid_len.cpu()
        if not torch.equal(got.valid_len.cpu(), vlen):
            raise AssertionError(f"valid_len {got.valid_len.tolist()} vs {vlen.tolist()}")
        for i, n in enumerate(vlen.tolist()):
            if not torch.equal(got.indices[i, :n], want.indices[i, :n]):
                raise AssertionError(f"sigma={sigma} tied={tied} image {i}: picks differ")
            max_err = max(max_err, float((got.scores[i, :n] - want.scores[i, :n]).abs().max()))
        if max_err > 1e-6:
            raise AssertionError(f"kernel scores differ from the plain version by {max_err}")
        mode = ("gaussian" if sigma > 0 else "hard") + (" tied" if tied else "")
        if not tied:
            times[mode] = (cuda_median_ms(lambda: cuda_nms.soft_nms_cuda(b, s, K, 0.5, thr, sigma)),
                           cuda_median_ms(lambda: nms.batched_soft_nms(b, s, K, 0.5, thr, sigma)))
            extra = f"kernel {times[mode][0]:.4f} ms, plain {times[mode][1]:.4f} ms (median of 25)"
        else:
            extra = "ties broken alike"
        phase(3, f"soft-NMS {mode} B={BATCH} N={N_CAND} K={K}: valid_len "
                 f"{vlen.tolist()} equal, indices equal; {extra}; {smi}")

    # -- 4. the slice at full width -------------------------------------------
    driver = ServingDriver.create("efficientdet-d0", overrides=MAIN_PATH,
                                  seed=0, device=dev)
    raw = np.random.RandomState(1).randint(0, 256, (BATCH, 512, 1024, 3)).astype(np.uint8)
    torch.cuda.reset_peak_memory_stats()
    cuda_nms.launches = 0
    walls = []
    for _ in range(SERVE_CALLS):
        t0 = time.perf_counter()
        out = driver.serve(raw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = cuda_nms.launches
    if launches != SERVE_CALLS:
        raise AssertionError(f"{launches} NMS kernel launches in {SERVE_CALLS} serve calls")
    shapes = [tuple(t.shape) for t in out]
    if shapes != [(BATCH, K, 12), (BATCH, K), (BATCH, K, 9), (BATCH,)]:
        raise AssertionError(f"packed shapes {shapes}")
    if not all(bool(torch.isfinite(t.float()).all()) for t in out):
        raise AssertionError("non-finite detections")
    if int(out[3].max()) <= 0:
        raise AssertionError("no detections at full width")
    ms = statistics.median(walls[1:]) * 1e3
    phase(4, f"d0 1024x512 T=10 B={BATCH} bf16: packed {shapes}, valid_len "
             f"{out[3].tolist()}, {launches} NMS launches in {SERVE_CALLS} calls; "
             f"{ms:.1f} ms/batch ({BATCH / ms * 1e3:.1f} img/s, median of calls 2-"
             f"{SERVE_CALLS}, first {walls[0] * 1e3:.0f} ms), peak "
             f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")

    # -- 5. device parity: CPU (plain NMS) vs card (kernel), f32 --------------
    small = dict(image_size="128x128", num_classes=8, loss_attenuation=True,
                 fpn_cell_repeats=1, box_class_repeats=1, mc_dropout=True,
                 mc_dropoutrate=0.05, mc_dropoutsamp=3)
    config = get_detection_config("efficientdet-d0").override(small)
    params, stats = random_flax_variables(EfficientDetNet(config), seed=2)
    state = flax_to_torch(params, stats)
    images = np.random.RandomState(3).uniform(-2, 2, (2, 128, 128, 3)).astype(np.float32)
    outs = []
    for device in ("cpu", dev):
        d = ServingDriver(config, state, dtype=torch.float32, device=device)
        d.masks = HostMasks(torch.Generator().manual_seed(4))
        before = cuda_nms.launches
        outs.append(d.serve_preprocessed(images))
        expected = 0 if device == "cpu" else 1
        if cuda_nms.launches - before != expected:
            raise AssertionError(f"NMS launches on {device}: {cuda_nms.launches - before}")
    worst = matched_sets(outs[1], outs[0], "cuda vs cpu")
    phase(5, f"128x128 f32 MC T=3: card (kernel) and CPU (plain) detections agree as "
             f"matched sets, valid_len {outs[0][3].tolist()}, max score diff {worst:.2e}")

    kernel_ms, plain_ms = times["gaussian"]
    print(json.dumps({"kernels": [{
        "name": "soft_nms", "route": "cuda", "source": "udal_tpu_torch/csrc/soft_nms.cu",
        "replaces": "udal_tpu/ops/pallas_nms.py:36", "launches": launches,
        "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
