"""The port's packed-layout microbench: the counterpart of
``tools/perf_packed.py``, run through the kernels of ``ops/packed.py``.

    python -m udal_tpu_torch.tools.perf_packed [a1_pw|a1_roll|p1|p2|a2|check ...] [--cpu]

The cases keep the JAX script's shapes, seeds and module constants (N = 80
images, G = 8 pixels packed into a row, blocks 3's 24 -> 144 at 128x256):

  a1_pw    packed pointwise (B4) vs its plain version, the unpacked 1x1
           conv (``F.conv2d``, bf16, channels-last: cuDNN), the counterpart
           of the script's XLA conv, and ``torch.matmul`` (cuBLAS) on the
           same packed operands.
  a1_roll  the shift along W of the packed expanded tensor (B5) vs its
           plain version and ``F.pad`` of the unpacked view.
  p1       x + 1 through the natural view (B6) and the packed view (B7).
  p2       the 3-tap depthwise along W with per-lane taps (B8) vs its plain
           version and the depthwise ``F.conv2d`` (``groups = C``, cuDNN)
           on the channels-last view of the same memory.
  a2       B4 at m_tile 512, 2048 and 4096 vs ``torch.matmul`` in bf16
           (cuBLAS).
  check    each function against the script's numpy references, the two
           library calls against B5's and B8's plain versions and, on a
           card, each kernel against its plain version; every check asserts.
With no case, a1_pw and a1_roll run, as in the JAX script.

A timed case prints one JSON line per function: the medians of CUDA-event
times of ``RUNS`` eager calls and of ``RUNS`` replays of the call captured
in a CUDA graph, after ``WARMUP`` calls, with the card's name and power
limit as nvidia-smi prints them. Everything runs on the card and raises
without one; ``check --cpu`` asks for the CPU, where ``check`` holds the
plain versions against the references.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from udal_tpu_torch.ops import packed

N = 80
G = 8  # spatial positions packed into a row
H, W, CI, CE = 128, 256, 24, 144
RUNS, WARMUP = 20, 3
P1_ROUNDS = 5
P1_COPIES = 8   # p1_rounds' inputs: 8 x 31.5 MB in and out, well past the 50 MB L2
M_TILES = (512, 2048, 4096)


def block_diag_weight(w: np.ndarray, g: int) -> np.ndarray:
    """[C, D] -> [g*C, g*D] with w on the diagonal blocks."""
    c, d = w.shape
    out = np.zeros((g * c, g * d), w.dtype)
    for j in range(g):
        out[j * c:(j + 1) * c, j * d:(j + 1) * d] = w
    return out


@functools.cache
def gpu_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def cuda_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("the tool runs on a CUDA device (check --cpu asks for the CPU); "
                           "torch.cuda.is_available() is False")
    return torch.device("cuda:0")


def bf16(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev).bfloat16()


def emit(row: dict) -> dict:
    print(json.dumps(row), flush=True)
    return row


def median_ms(fn) -> float:
    """Median CUDA-event time of RUNS calls of ``fn``, one at a time."""
    times = []
    for _ in range(RUNS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timed(fn, label: str, impl: str, nbytes: int) -> dict:
    """Two medians of ``fn`` after WARMUP calls: ``ms`` of eager calls (what
    a caller waits, the host's Python and launch overhead included where the
    device is done sooner) and ``graph_ms`` of replays of one call captured
    in a CUDA graph (the device's time). With the bytes the call moves at
    least (inputs and output) per second of ``graph_ms``. A kernel launches
    WARMUP + RUNS + 1 times through its wrapper (the last one captured)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(WARMUP):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    ms = median_ms(fn)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph_ms = median_ms(graph.replay)
    return emit({"case": label, "impl": impl, "ms": ms, "graph_ms": graph_ms, "runs": RUNS,
                 "tb_s": nbytes / graph_ms / 1e9, "gpu": gpu_line()})


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 values at |t| (8 significant bits)."""
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), torch.frexp(t.float().abs())[1] - 8)


def assert_bf16_close(got: torch.Tensor, want: torch.Tensor, ulps: float, top_ulps: float,
                      what: str) -> float:
    """|got - want| <= ulps · ulp(|want|) + top_ulps · ulp(max |want|);
    returns the largest absolute difference."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bound = ulps * bf16_ulp(want) + top_ulps * bf16_ulp(want.abs().max())
    excess = float((err - bound).max())
    if excess > 0:
        raise AssertionError(f"{what}: beyond {ulps} + {top_ulps} top bf16 ulps by {excess}")
    return float(err.max())


def assert_equal(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{what}: not equal (shapes {tuple(got.shape)}, "
                             f"{tuple(want.shape)})")
    return 0.0


# -- operands, made with numpy from the JAX script's seeds ----------------------

def pointwise_operands(dev):
    """a1_pw's: x [N, H, W, CI] and w [CI, CE] in f32, and the packed
    xp [N·H·W/G, G·CI] and block-diagonal wbd [G·CI, G·CE] in bf16 on dev."""
    rng = np.random.RandomState(0)
    x = rng.randn(N, H, W, CI).astype(np.float32)
    w = (rng.randn(CI, CE) * 0.1).astype(np.float32)
    return x, w, bf16(x.reshape(N * H * (W // G), G * CI), dev), bf16(block_diag_weight(w, G), dev)


def wide_operands(n: int, dev):
    """a1_roll's and p2's: x [n, H, W/G, G·CE] and the taps k3 [3, CE] in
    f32, and x and the per-lane taps [3, G·CE] in bf16 on dev."""
    rng = np.random.RandomState(0)
    x = rng.randn(n, H, W // G, G * CE).astype(np.float32)
    k3 = (rng.randn(3, CE) * 0.5).astype(np.float32)
    return x, k3, bf16(x, dev), bf16(np.tile(k3[:, None, :], (1, G, 1)).reshape(3, G * CE), dev)


def library_wshift(xb: torch.Tensor) -> torch.Tensor:
    """B5's function (the shift toward w + 1) as one PyTorch call: ``F.pad``
    of the unpacked view [N, H, W, C], cropping column 0 and zero-filling
    one past the end."""
    n, h, wp, ge = xb.shape
    return F.pad(xb.view(n, h, wp * G, CE), (0, 0, -1, 1))


def dw_w3_weight(k3: torch.Tensor, dtype) -> torch.Tensor:
    """The taps [3, C] as the depthwise ``F.conv2d``'s weight [C, 1, 1, 3]:
    contiguous, in ``dtype``, made once outside the timed call."""
    return k3.t().contiguous().to(dtype)[:, None, None, :].contiguous(
        memory_format=torch.channels_last)


def library_dw_w3(xb: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """B8's function as one PyTorch call: the 1x3 depthwise ``F.conv2d``
    (``groups = C``, SAME along W) on the channels-last NCHW view of the
    packed rows' memory, with the taps that every lane of a channel shares
    in the timed cases (``dw_w3_weight``). Its output is channels-last, the
    packed layout."""
    n, h, wp, ge = xb.shape
    xc = xb.view(n, h, wp * G, CE).permute(0, 3, 1, 2)
    return F.conv2d(xc, weight, padding=(0, 1), groups=CE)


def cuda_kernels(fn) -> list:
    """The names of the CUDA kernels one call of ``fn`` launches, from
    torch.profiler's trace (which says what algorithm a library call
    chose); the profiler's error when it traces nothing."""
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = sorted({e.name for e in prof.events()
                        if str(getattr(e, "device_type", "")).endswith("CUDA")})
    except Exception as e:          # noqa: BLE001 - a tracing failure is reported, not fatal
        return [f"not traced: {type(e).__name__}: {e}"[:200]]
    return names or ["not traced: the profiler recorded no device activity"]


def p1_operands(dev):
    """p1's: x [Mp, G·CI] in f32 and bf16 on dev, Mp = 4096·N/8."""
    x = np.random.RandomState(0).randn(4096 * N // 8, G * CI).astype(np.float32)
    return x, bf16(x, dev)


# -- check ----------------------------------------------------------------------

def check(dev) -> dict:
    """Every function against the JAX script's references; on a card every
    kernel against its plain version at the timed shapes. Returns the
    largest kernel-vs-plain difference of each kernel (empty on the CPU)."""
    on_card = dev.type == "cuda"
    errs = {}

    x, w, xp, wbd = pointwise_operands(dev)
    got = packed.packed_pointwise(xp, wbd).float().cpu().numpy().reshape(N, H, W, CE)
    want = (x.reshape(-1, CI) @ w).reshape(N, H, W, CE)
    rel = float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))
    emit({"case": "a1_pw_check", "max_rel_err": rel, "device": str(dev)})
    if not rel < 2e-2:
        raise AssertionError(f"a1_pw: {rel} relative to the f32 product")
    if on_card:
        errs["packed_pointwise"] = assert_bf16_close(
            packed.packed_pointwise_cuda(xp, wbd), packed.packed_pointwise_plain(xp, wbd),
            1, 0.01, "packed_pointwise vs plain")
    del x, w, xp, wbd, got, want

    x, _, xb, _ = wide_operands(2, dev)
    xu = x.reshape(2, H, W, CE)
    for direction in (1, -1):
        ref = np.zeros_like(xu)
        if direction > 0:
            ref[:, :, :-1] = xu[:, :, 1:]
        else:
            ref[:, :, 1:] = xu[:, :, :-1]
        got = packed.packed_wshift(xb, CE, G, direction).cpu()
        assert_equal(got, bf16(ref.reshape(x.shape), "cpu"), f"a1_roll {direction:+d}")
        emit({"case": "a1_roll_check" + ("_neg" if direction < 0 else ""), "max_err": 0.0,
              "device": str(dev)})

    x, xb = p1_operands(dev)
    # one rounding of bf16(x) + 1, what the kernel computes; the script's
    # reference rounds x + 1 from the f32 x, so it differs by the rounding
    # of x: up to an ulp of the largest value (ROADMAP C6)
    want = (torch.from_numpy(x).bfloat16().float() + 1).bfloat16()
    script = torch.from_numpy(x + 1).bfloat16()
    for name, fn in (("p1_check", packed.add_one_natural), ("p1_copy_check", packed.add_one_packed)):
        got = fn(xb[:1024], CI).cpu()      # the input's length, not Mp (C5)
        assert_equal(got, want[:1024], name)
        assert_equal(fn(xb, CI).cpu(), want, name)
        script_err = assert_bf16_close(got, script[:1024], 0, 1, f"{name} vs x + 1 from f32")
        emit({"case": name, "rows": got.shape[0], "max_err": 0.0,
              "script_reference_err": script_err, "device": str(dev)})
    if on_card:
        errs["add_one_natural"] = assert_equal(packed.add_one_natural_cuda(xb, CI),
                                               packed.add_one_plain(xb, CI), "B6 vs plain")
        errs["add_one_packed"] = assert_equal(packed.add_one_packed_cuda(xb, CI),
                                              packed.add_one_plain(xb, CI), "B7 vs plain")
    del x, xb, want, script

    x, k3, xb, kl = wide_operands(2, dev)
    got = packed.packed_dw_w3(xb, kl, CE).cpu()
    xs = x.reshape(2, H, W, CE)
    ref = xs * k3[1]
    ref[:, :, :-1] += xs[:, :, 1:] * k3[2]
    ref[:, :, 1:] += xs[:, :, :-1] * k3[0]
    rel = float(np.abs(got.float().numpy().reshape(ref.shape) - ref).max() / (np.abs(ref).max() + 1e-6))
    if not rel < 2e-2:
        raise AssertionError(f"p2: {rel} relative to the f32 reference on unrounded inputs")
    # the same sum on the bf16 inputs, in the kernel's order, rounded once
    xr = xb.float().cpu().numpy().reshape(2, H, W, CE)
    t = np.tile(kl.float().cpu().numpy().reshape(3, G, CE), (1, W // G, 1))
    left, right = np.zeros_like(xr), np.zeros_like(xr)
    left[:, :, 1:], right[:, :, :-1] = xr[:, :, :-1], xr[:, :, 1:]
    exact = bf16(((left * t[0] + xr * t[1]) + right * t[2]).reshape(x.shape), "cpu")
    err = assert_bf16_close(got, exact, 1, 0, "p2 vs the reference on its bf16 inputs")
    emit({"case": "p2_check", "max_rel_err": rel, "max_err_bf16_inputs": err, "device": str(dev)})
    del x, xb, kl, got, ref, xr, t, left, right, exact

    # the library calls the timed cases beside B5 and B8 compute the same functions
    x, k3, xb, kl = wide_operands(2, dev)
    assert_equal(library_wshift(xb).reshape(xb.shape), packed.packed_wshift_plain(xb, CE, G, 1),
                 "F.pad vs B5's plain version")
    lib = library_dw_w3(xb, dw_w3_weight(torch.from_numpy(k3).to(dev), xb.dtype))
    lib = lib.permute(0, 2, 3, 1).reshape(xb.shape)
    lib_err = assert_bf16_close(lib, packed.packed_dw_w3_plain(xb, kl, CE), 1, 0,
                                "depthwise F.conv2d vs B8's plain version")
    emit({"case": "library_check", "pad_max_err": 0.0, "conv_max_err": lib_err,
          "device": str(dev)})
    del x, k3, xb, kl, lib

    if on_card:
        _, _, xb, kl = wide_operands(N, dev)
        errs["packed_wshift"] = max(assert_equal(packed.packed_wshift_cuda(xb, CE, G, d),
                                                 packed.packed_wshift_plain(xb, CE, G, d),
                                                 f"B5 {d:+d} vs plain") for d in (1, -1))
        errs["packed_dw_w3"] = assert_bf16_close(packed.packed_dw_w3_cuda(xb, kl, CE),
                                                 packed.packed_dw_w3_plain(xb, kl, CE), 1, 0,
                                                 "B8 vs plain")
        emit({"case": "kernels_vs_plain", "max_abs_err": errs, "gpu": gpu_line()})
    return errs


# -- timed cases ----------------------------------------------------------------

def case_a1_pw(dev) -> list:
    x, w, xp, wbd = pointwise_operands(dev)
    moved = nbytes(xp, wbd) + xp.shape[0] * wbd.shape[1] * 2
    xc = bf16(x, dev).permute(0, 3, 1, 2)             # NCHW view of NHWC memory
    wc = bf16(w.T[:, :, None, None], dev)             # [CE, CI, 1, 1]
    label = f"{H}x{W}x{CI}to{CE}"
    return [timed(lambda: packed.packed_pointwise(xp, wbd), f"packed_pw_{label}", "kernel",
                  moved),
            timed(lambda: packed.packed_pointwise_plain(xp, wbd), f"plain_pw_{label}", "plain",
                  moved),
            timed(lambda: F.conv2d(xc, wc), f"conv_pw_{label}", "cudnn_conv", moved),
            timed(lambda: torch.matmul(xp, wbd), f"matmul_pw_{label}", "cublas_matmul", moved)]


def case_a1_roll(dev) -> list:
    _, _, xb, _ = wide_operands(N, dev)
    label = f"packed_wshift_{H}x{W // G}x{G * CE}"
    return [timed(lambda: packed.packed_wshift(xb, CE, G, 1), label, "kernel", 2 * nbytes(xb)),
            timed(lambda: packed.packed_wshift_plain(xb, CE, G, 1), "plain_" + label, "plain",
                  2 * nbytes(xb)),
            timed(lambda: library_wshift(xb), "pad_" + label, "torch_pad", 2 * nbytes(xb))]


def case_p1(dev) -> list:
    _, xb = p1_operands(dev)
    return [timed(lambda: packed.add_one_natural(xb, CI), "p1_reshape_roundtrip", "kernel",
                  2 * nbytes(xb)),
            timed(lambda: packed.add_one_packed(xb, CI), "p1_copy_baseline", "kernel",
                  2 * nbytes(xb)),
            timed(lambda: packed.add_one_plain(xb, CI), "p1_plain", "plain", 2 * nbytes(xb))]


def p1_rounds(dev, rounds: int = P1_ROUNDS, copies: int = P1_COPIES) -> dict:
    """B6, B7 and the plain ``x + 1`` at p1's shape, streamed from HBM: each
    captured, after WARMUP calls, in one CUDA graph of ``copies`` calls on
    as many copies of x with every output kept, so the calls touch
    ``copies`` x 31.5 MB, past the 50 MB L2, and each finds its input and
    output cold. Then ``rounds`` rounds of RUNS replays of each graph in
    turn: {case: [median ms a call of each round]}. Each kernel launches
    WARMUP + ``copies`` times."""
    _, xb = p1_operands(dev)
    xs = [xb.clone() for _ in range(copies)]
    fns = {"p1_reshape_roundtrip": lambda x: packed.add_one_natural(x, CI),
           "p1_copy_baseline": lambda x: packed.add_one_packed(x, CI),
           "p1_plain": lambda x: packed.add_one_plain(x, CI)}
    graphs, outputs = {}, []
    for name, fn in fns.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                fn(xb)
        torch.cuda.current_stream().wait_stream(side)
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            outputs.append([fn(x) for x in xs])
    medians = {name: [] for name in fns}
    for _ in range(rounds):
        for name, graph in graphs.items():
            medians[name].append(median_ms(graph.replay) / copies)
    emit({"case": "p1_rounds", "runs": RUNS, "copies": copies, "round_medians_ms": medians,
          "gpu": gpu_line()})
    return medians


def case_p2(dev) -> list:
    _, k3, xb, kl = wide_operands(N, dev)
    wt = dw_w3_weight(torch.from_numpy(k3).to(dev), xb.dtype)
    label = f"p2_packed_dwW_{H}x{W // G}x{G * CE}"
    rows = [timed(lambda: packed.packed_dw_w3(xb, kl, CE), label, "kernel", 2 * nbytes(xb)),
            timed(lambda: packed.packed_dw_w3_plain(xb, kl, CE), "plain_" + label, "plain",
                  2 * nbytes(xb))]
    # the library call with cuDNN free to benchmark its algorithms; the
    # kernels it then launches name the one it chose
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        rows.append(timed(lambda: library_dw_w3(xb, wt), "conv_" + label, "cudnn_conv",
                          2 * nbytes(xb)))
        rows[-1]["cuda_kernels"] = emit({"case": "conv_" + label + "_kernels",
                                         "cuda_kernels": cuda_kernels(
                                             lambda: library_dw_w3(xb, wt))})["cuda_kernels"]
    finally:
        torch.backends.cudnn.benchmark = benchmark
    return rows


def case_a2(dev) -> list:
    rng = np.random.RandomState(0)
    m = N * H * (W // G)
    xp = bf16(rng.randn(m, G * CI), dev)
    wbd = bf16(block_diag_weight((rng.randn(CI, CE) * 0.1).astype(np.float32), G), dev)
    moved = nbytes(xp, wbd) + m * wbd.shape[1] * 2
    rows = [timed(lambda mt=mt: packed.packed_pointwise(xp, wbd, mt), f"packed_pw_mt{mt}",
                  "kernel", moved) for mt in M_TILES]
    rows.append(timed(lambda: torch.matmul(xp, wbd), "packed_pw_torch_matmul_bf16out",
                      "cublas_matmul", moved))
    return rows


CASES = {"a1_pw": case_a1_pw, "a1_roll": case_a1_roll, "p1": case_p1, "p2": case_p2,
         "a2": case_a2}


def main(argv=None):
    """Runs the cases named in ``argv`` (default: the command line). Returns
    ``check``'s dict of kernel-vs-plain differences, or the timed rows."""
    args = list(sys.argv[1:] if argv is None else argv)
    cpu = "--cpu" in args
    cases = [a for a in args if a != "--cpu"] or ["a1_pw", "a1_roll"]
    unknown = sorted(set(cases) - set(CASES) - {"check"})
    if unknown:
        raise SystemExit(f"unknown case(s) {unknown}; choose from {sorted(CASES)} or check")
    if cpu and cases != ["check"]:
        raise SystemExit("--cpu goes with check alone: the timed cases need a CUDA device")
    if "check" in cases:
        return check(torch.device("cpu") if cpu else cuda_device())
    dev = cuda_device()
    rows = []
    for name, case in CASES.items():
        if name in cases:
            rows += case(dev)
    return rows


if __name__ == "__main__":
    main()
