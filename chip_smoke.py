"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, in order; any failure ends the run with a traceback and a nonzero
exit code:

1. device: a CUDA card is required; prints its name and power limit
   (nvidia-smi), the torch and CUDA versions; turns TF32 off.
2. build: compiles ``udal_tpu_torch/csrc/{soft_nms,fused_dw,
   fused_expand_dw}.cu`` with nvcc (sm_90a), one process each, all at once;
   prints each kernel's registers, shared memory and spills.
3. kernels vs plain, on the card:
   - soft-NMS at the main path's shapes (B=8, N=5000, K=100), gaussian and
     hard, random and tied scores: equal valid_len, equal indices over it,
     scores within 1e-6.
   - fused depthwise and fused expand + depthwise in f32 at N=8, every
     (k, s) in {3,5}x{1,2}: the depthwise with act swish and identity, with
     and without mask and mean; the expand with and without masks. Both
     sides sum in f32 in another order: 1e-5 (depthwise) and 1e-4 (expand,
     up to 192 products a sum), absolute and relative.
   - both in bf16 at the main path's shapes (the MC prefix at B=8, blocks
     1, 3 and 12 at T*B=80), against the plain version on the same bf16
     inputs, which computes in f32 and rounds where the kernel rounds:
     within 1 bf16 ulp plus 1% of an ulp of the largest value (depthwise:
     one rounding of values that differ in the f32 sum order; near zero,
     where the pre-activation cancels, that difference scales with the
     terms, not the result), 2 ulps plus 1 ulp of the largest value
     (expand: an expanded value can round the other way), SE sums and
     means to 1e-3 of their largest value.
   Median times of kernel, plain version and the unfused bf16 eager chain
   (the unfused block code), from CUDA events.
4. the slice at full width: MC-dropout EfficientDet-d0 (1024x512, 8
   classes, loss attenuation, T=10 at rate 0.05, batch 8, bf16, random
   weights from a seed) serves uint8 batches; checks the packed shapes,
   finiteness, detections, and that every serve call launched the fused
   depthwise kernel once (the MC prefix), the fused expand + depthwise
   kernel 15 times (blocks 1-15) and the NMS kernel once. With
   ``--profile``, a torch.profiler operator split of two serves follows.
5. device parity: the same weights (numpy from a seed, through
   ``convert.py``) at 128x128 in f32 served on the CPU (plain versions) and
   on the card (kernels) with the same dropout masks, on the MC fold path,
   the MC path without the fold (block 0 masked at T*B) and the
   deterministic path; detections agree as matched sets, and the kernels
   ran on the card only.

The line before the last is a JSON summary of the kernels; the last line
is ``{"ok": true, "device": {...}}``.
"""

import json
import re
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
from udal_tpu_torch.models.efficientnet import (BatchNorm, ChannelDropout, Conv2d,
                                                activation_fn)
from udal_tpu_torch.ops import _build, cuda_nms, fused_dw, fused_mbconv, nms

MAIN_PATH = dict(image_size="1024x512", num_classes=8, loss_attenuation=True,
                 mc_dropout=True, mc_dropoutrate=0.05, mc_dropoutsamp=10)
BATCH, N_CAND, K = 8, 5000, 100
SERVE_CALLS = 4
SOURCES = ("soft_nms", "fused_dw", "fused_expand_dw")
# the fused kernels at the main path's shapes: (what, N, Cin, Ce, H, W, k, s)
PREFIX = ("MC prefix (block 0)", BATCH, 32, 32, 256, 512, 3, 1)
BLOCKS = (("block 1", 80, 16, 96, 256, 512, 3, 2),
          ("block 3", 80, 24, 144, 128, 256, 5, 2),
          ("block 12", 80, 192, 1152, 16, 32, 5, 1))
# f32 checks at N=8 over every (k, s): shapes of d0's blocks at 1024x512
F32_BLOCKS = {(3, 2): (16, 96, 256, 512), (3, 1): (24, 144, 128, 256),
              (5, 2): (24, 144, 128, 256), (5, 1): (192, 1152, 16, 32)}


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


def ptxas_summary(name):
    """One line per kernel instance: registers, shared memory, spills."""
    spills, entry = "", None
    for line in _build.library_path(name).with_suffix(".log").read_text().splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            base = re.search(r"(soft_nms_kernel|fused_dw_kernel|fused_expand_dw_kernel|"
                             r"sum_partials)(I.*?EE)?", m.group(1))
            args = base.group(2) or ""
            kind = "bf16" if "bfloat16" in args else ("f32" if args.startswith("If") else "")
            entry = base.group(1) + "<" + ",".join(
                [kind] * bool(kind) + re.findall(r"Li(\d+)E", args)) + ">"
        elif "spill" in line:
            spills = line.split(":")[-1].strip()
        elif "registers" in line:
            print(f"  ptxas {entry}: {line.split(':', 1)[1].strip()}; {spills}")


def bf16_excess(got, want, ulps, top_ulps):
    """Largest amount by which |got - want| exceeds ulps · ulp(|want|) +
    top_ulps · ulp(max |want|) (bf16 spacing: 8 significant bits); <= 0
    passes. Also returns the largest error in ulps of the largest value."""
    got, want = got.float(), want.float()

    def ulp(t):
        return torch.ldexp(torch.ones_like(t), torch.frexp(t.abs())[1] - 8)

    top = ulp(want.abs().max())
    err = (got - want).abs()
    return (float((err - ulps * ulp(want) - top_ulps * top).max()),
            float(err.max() / top))


def eager_chain(x, block, m1, m2):
    """The unfused chain the fused kernels replace, op by op as the unfused
    ``MBConvBlock`` ran it in x's type: expand conv, bn0, swish, mask, TF
    SAME pad, depthwise conv, bn1, swish, mask, spatial mean."""
    act = activation_fn("swish")
    if "expand_conv" in block:
        x = act(block["bn0"](block["expand_conv"](x))) * m1.to(x.dtype)[:, :, None, None]
    x = act(block["bn1"](block["depthwise_conv"](x)))
    if m2 is not None:
        x = x * m2.to(x.dtype)[:, :, None, None]
    return x, torch.mean(x, dim=(2, 3))


def fused_operands(rng, n, cin, ce, h, w, k, dev, dtype, masked=True):
    """Random operands of one fused call, f32 parameters, x in ``dtype``;
    BN stats in the ranges of the parity tests."""
    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    x = f32(rng.normal(0, 1, (n, cin, h, w))).to(dtype)
    masks = [f32((rng.uniform(size=(n, ce)) < 0.95) / 0.95) if masked else None
             for _ in range(2)]
    return dict(x=x, we=f32(rng.normal(0, 1 / np.sqrt(cin), (cin, ce))),
                b0=f32(rng.normal(0, 0.1, ce)), wd=f32(rng.normal(0, 1.0 / k, (ce, k, k))),
                scale=f32(rng.uniform(0.5, 1.5, ce)), b1=f32(rng.normal(0, 0.1, ce)),
                m1=masks[0], m2=masks[1])


def check_fused_f32(dev, rng):
    """Phase 3, f32 at N=8 over every (k, s). Returns the largest errors."""
    worst = {"fused_dw": 0.0, "fused_expand_dw": 0.0}
    for (k, s), (cin, ce, h, w) in sorted(F32_BLOCKS.items()):
        o = fused_operands(rng, 8, cin, ce, h, w, k, dev, torch.float32)
        for masked in (True, False):
            m1, m2 = (o["m1"], o["m2"]) if masked else (None, None)
            got = fused_mbconv.fused_expand_dw_cuda(o["x"], o["we"], o["b0"], m1, o["wd"],
                                                    o["b1"], m2, s, k)
            want = fused_mbconv.fused_expand_dw_plain(o["x"], o["we"], o["b0"], m1, o["wd"],
                                                      o["b1"], m2, s, k)
            for g, wt in zip(got, want):
                torch.testing.assert_close(g, wt, atol=1e-4, rtol=1e-4)
            worst["fused_expand_dw"] = max(worst["fused_expand_dw"],
                                           float((got[0] - want[0]).abs().max()))
        phase(3, f"fused_expand_dw f32 N=8 {cin}->{ce} {h}x{w} k{k} s{s}, masks on/off: "
                 f"within 1e-4")
        d = fused_operands(rng, 8, ce, ce, h, w, k, dev, torch.float32)
        taps = d["wd"]
        for act in ("swish", "identity"):
            for masked in (True, False):
                mask = d["m2"] if masked else None
                got = fused_dw.fused_depthwise_cuda(d["x"], taps, d["scale"], d["b1"], mask, s,
                                                    act, masked)
                want = fused_dw.fused_depthwise_plain(d["x"], taps, d["scale"], d["b1"], mask,
                                                      s, act, masked)
                for g, wt in zip(*((got, want) if masked else ((got,), (want,)))):
                    torch.testing.assert_close(g, wt, atol=1e-5, rtol=1e-5)
                y = got[0] if masked else got
                worst["fused_dw"] = max(worst["fused_dw"], float(
                    (y - (want[0] if masked else want)).abs().max()))
        phase(3, f"fused_dw f32 N=8 C={ce} {tuple(d['x'].shape[2:])} k{k} s{s}, swish and "
                 f"identity, mask+mean on/off: within 1e-5")
    return worst


def check_fused_bf16(dev, rng, smi):
    """Phase 3, bf16 at the main path's shapes. Returns {kernel: largest
    error} and {kernel: (kernel ms, plain ms)} at its first shape."""
    errs, times = {}, {}
    for what, n, cin, ce, h, w, k, s in (PREFIX,) + BLOCKS:
        expand = what != PREFIX[0]
        o = fused_operands(rng, n, cin, ce, h, w, k, dev, torch.bfloat16, masked=expand)
        if expand:
            args = (o["x"], o["we"], o["b0"], o["m1"], o["wd"], o["b1"], o["m2"], s, k)
            kernel = lambda: fused_mbconv.fused_expand_dw_cuda(*args)  # noqa: E731
            plain = lambda: fused_mbconv.fused_expand_dw_plain(*args)  # noqa: E731
            ulps, top_ulps, name = 2, 1, "fused_expand_dw"
        else:
            args = (o["x"], o["wd"], o["scale"], o["b1"], None, s, "swish", True)
            kernel = lambda: fused_dw.fused_depthwise_cuda(*args)  # noqa: E731
            plain = lambda: fused_dw.fused_depthwise_plain(*args)  # noqa: E731
            ulps, top_ulps, name = 1, 0.01, "fused_dw"
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        excess, in_top = bf16_excess(got[0], want[0], ulps, top_ulps)
        if excess > 0:
            raise AssertionError(f"{name} {what}: y beyond {ulps} + {top_ulps} top bf16 ulps "
                                 f"by {excess}")
        torch.testing.assert_close(got[1], want[1], rtol=1e-3,
                                   atol=1e-3 * float(want[1].abs().max()))
        block = eager_modules(o, expand, cin, ce, k, s, dev)
        t_kernel = cuda_median_ms(kernel, runs=15, warmup=3)
        t_plain = cuda_median_ms(plain, runs=15, warmup=3)
        t_eager = cuda_median_ms(lambda: eager_chain(o["x"], block, o["m1"], o["m2"]),
                                 runs=15, warmup=3)
        err = float((got[0].float() - want[0].float()).abs().max())
        phase(3, f"{name} bf16 {what}: N={n} {cin}->{ce} {h}x{w} k{k} s{s}: max err "
                 f"{err:.3g} ({in_top:.2f} ulp of max|y|); kernel {t_kernel:.4f} ms, plain "
                 f"(f32 inside) {t_plain:.4f} ms, unfused bf16 eager chain {t_eager:.4f} ms "
                 f"(medians of 15); {smi}")
        errs[name] = max(errs.get(name, 0.0), err)
        times.setdefault(name, (t_kernel, t_plain))
    return errs, times


def eager_modules(o, expand, cin, ce, k, s, dev):
    """bf16 modules holding the operands unfolded (BN with unit variance
    and zero mean carries the bias), for ``eager_chain``."""
    mods = {}
    with torch.no_grad():
        if expand:
            mods["expand_conv"] = Conv2d(cin, ce, 1, bias=False)
            mods["expand_conv"].weight.copy_(o["we"].t()[:, :, None, None])
            mods["bn0"] = BatchNorm(ce)
            mods["bn0"].bias.copy_(o["b0"])
        mods["depthwise_conv"] = Conv2d(ce, ce, k, s, groups=ce, bias=False)
        mods["depthwise_conv"].weight.copy_(o["wd"][:, None])
        mods["bn1"] = BatchNorm(ce)
        mods["bn1"].bias.copy_(o["b1"])
    return {n: m.to(dev, torch.bfloat16).eval() for n, m in mods.items()}


def reset_counts():
    cuda_nms.launches = fused_dw.launches = fused_mbconv.launches = 0


def counts():
    return (fused_dw.launches, fused_mbconv.launches, cuda_nms.launches)


def profile_serve(server, raw):
    """torch.profiler over two serves: device time by operator."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            server.serve(raw)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))


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
    # without MC the class column has no sigma beside it
    g_classes, w_classes = (c.reshape(*c.shape[:2], -1) for c in (g_classes, w_classes))
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
    _build.build(SOURCES)
    phase(2, f"built csrc/{{{','.join(SOURCES)}}}.cu in {time.perf_counter() - t0:.2f} s "
             f"(one nvcc each, in parallel)")
    for name in SOURCES:
        ptxas_summary(name)

    # -- 3. kernels vs plain ---------------------------------------------------
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
    f32_err = check_fused_f32(dev, rng)
    bf16_err, fused_times = check_fused_bf16(dev, rng, smi)
    torch.cuda.empty_cache()

    # -- 4. the slice at full width -------------------------------------------
    server = ServingDriver.create("efficientdet-d0", overrides=MAIN_PATH,
                                  seed=0, device=dev)
    raw = np.random.RandomState(1).randint(0, 256, (BATCH, 512, 1024, 3)).astype(np.uint8)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    walls = []
    for _ in range(SERVE_CALLS):
        t0 = time.perf_counter()
        out = server.serve(raw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = counts()
    if launches != (SERVE_CALLS, 15 * SERVE_CALLS, SERVE_CALLS):
        raise AssertionError(f"(fused_dw, fused_expand_dw, soft_nms) launches {launches} in "
                             f"{SERVE_CALLS} serve calls; want 1, 15 and 1 a call")
    shapes = [tuple(t.shape) for t in out]
    if shapes != [(BATCH, K, 12), (BATCH, K), (BATCH, K, 9), (BATCH,)]:
        raise AssertionError(f"packed shapes {shapes}")
    if not all(bool(torch.isfinite(t.float()).all()) for t in out):
        raise AssertionError("non-finite detections")
    if int(out[3].max()) <= 0:
        raise AssertionError("no detections at full width")
    ms = statistics.median(walls[1:]) * 1e3
    phase(4, f"d0 1024x512 T=10 B={BATCH} bf16: packed {shapes}, valid_len "
             f"{out[3].tolist()}; launches in {SERVE_CALLS} calls: fused_dw {launches[0]}, "
             f"fused_expand_dw {launches[1]}, soft_nms {launches[2]}; {ms:.1f} ms/batch "
             f"({BATCH / ms * 1e3:.1f} img/s, median of calls 2-{SERVE_CALLS}, first "
             f"{walls[0] * 1e3:.0f} ms), peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
             f"GiB (unfused eager serve on this card model: 91.4 ms/batch, 4.73 GiB); {smi}")
    if "--profile" in sys.argv[1:]:
        profile_serve(server, raw)
    del server, out
    torch.cuda.empty_cache()

    # -- 5. device parity: CPU (plain versions) vs card (kernels), f32 -------
    small = dict(image_size="128x128", num_classes=8, loss_attenuation=True,
                 fpn_cell_repeats=1, box_class_repeats=1, mc_dropout=True,
                 mc_dropoutrate=0.05, mc_dropoutsamp=3)
    config = get_detection_config("efficientdet-d0").override(small)
    params, stats = random_flax_variables(EfficientDetNet(config), seed=2)
    state = flax_to_torch(params, stats)
    images = np.random.RandomState(3).uniform(-2, 2, (2, 128, 128, 3)).astype(np.float32)
    for path, extra in (("MC fold", {}), ("MC without the fold", {"mc_fast_fold": False}),
                        ("deterministic", {"mc_dropout": False, "mc_dropoutrate": 0.0})):
        cfg = get_detection_config("efficientdet-d0").override({**small, **extra},
                                                               allow_new_keys=True)
        outs = []
        for device in ("cpu", dev):
            d = ServingDriver(cfg, state, dtype=torch.float32, device=device)
            d.masks = HostMasks(torch.Generator().manual_seed(4))
            reset_counts()
            outs.append(d.serve_preprocessed(images))
            want = (0, 0, 0) if device == "cpu" else (1, 15, 1)
            if counts() != want:
                raise AssertionError(f"{path} on {device}: (fused_dw, fused_expand_dw, "
                                     f"soft_nms) launches {counts()}, want {want}")
        worst = matched_sets(outs[1], outs[0], f"{path}: cuda vs cpu")
        phase(5, f"128x128 f32 {path}: card (kernels, launches 1/15/1) and CPU (plain) "
                 f"detections agree as matched sets, valid_len {outs[0][3].tolist()}, max "
                 f"score diff {worst:.2e}")

    kernel_ms, plain_ms = times["gaussian"]
    rows = [{"name": "soft_nms", "route": "cuda", "source": "udal_tpu_torch/csrc/soft_nms.cu",
             "replaces": "udal_tpu/ops/pallas_nms.py:36", "launches": launches[2],
             "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms}]
    for name, i, replaces in (("fused_dw", 0, "udal_tpu/ops/pallas_dw.py:37"),
                              ("fused_expand_dw", 1, "udal_tpu/ops/pallas_mbconv.py:36")):
        k_ms, p_ms = fused_times[name]
        rows.append({"name": name, "route": "cuda", "source": f"udal_tpu_torch/csrc/{name}.cu",
                     "replaces": replaces, "launches": launches[i],
                     "max_abs_err": max(bf16_err[name], f32_err[name]), "ms": k_ms,
                     "plain_ms": p_ms})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
