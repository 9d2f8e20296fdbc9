"""The benchmark's driver: one cell, one seed, one window, one result line.

    python bench_torch/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one cell, configuration, traffic mix, entry or
per-layer metric is a file found by its name:

- ``workloads/<cell>.json``: the configuration's name, the traffic mix's,
  the entry's, each compared number's limit and, where not all of the
  entry's, the end-to-end metrics the cell reports (``end_to_end``);
- ``configs/<config>.json``: the program's configuration (its overrides)
  and every size the plain reference reads (``arch``);
- ``mixes/<mix>.json``: the traffic mix, the parameters ``traffic.py`` makes the inputs
  from;
- ``entries/<entry>.py``: an ``Entry`` class that sets the program up and
  makes one call of the closed loop, and checks the kept calls against the
  reference;
- ``metrics/<metric>.py``: ``read(record)``, one per-layer metric from the
  traced run's record, or None where the record has nothing for it.

Set-up (the process's start to the window's, less the seconds the plain
reference spends in it) builds the entry and warms the cell's shapes; the
window then calls the entry back to back for ``--seconds``, each call
ending with its result on the host. With ``--trace 1`` a few calls more
are traced with torch.profiler, and the per-layer metrics are read from
that record. After the window the program is freed and the kept calls
(every ``check_every``-th of ``HARNESS`` from a phase drawn from the seed,
at most ``check_most``) are compared with the reference.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from bench_torch import profile

ROOT = Path(__file__).resolve().parent
NOT_MEASURED = "not measured"
# calls before the window (the cell's shapes), calls traced after it, and
# which calls of the window the check compares; ``overrides["harness"]``
# replaces them in the CPU tests
HARNESS = dict(warm_calls=2, trace_calls=10, check_every=50, check_most=8)


# -- lookup by name ----------------------------------------------------------------

def find(kind: str, name: str, suffix: str, roots: Sequence[Path]) -> Path:
    for root in roots:
        path = Path(root) / kind / f"{name}{suffix}"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no {kind}/{name}{suffix} under {[str(r) for r in roots]}")


def load(kind: str, name: str, roots: Sequence[Path] = (ROOT,)) -> Dict:
    return json.loads(find(kind, name, ".json", roots).read_text())


def module(kind: str, name: str, roots: Sequence[Path] = (ROOT,)):
    path = find(kind, name, ".py", roots)
    spec = importlib.util.spec_from_file_location(f"bench_torch.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_readers(roots: Sequence[Path] = (ROOT,)) -> Dict[str, object]:
    """Every per-layer metric's reader, by name."""
    names = sorted({p.stem for root in roots for p in (Path(root) / "metrics").glob("*.py")})
    return {n: module("metrics", n, roots) for n in names}


def seeds_from(seed: int, n: int = 6) -> List[int]:
    """Independent sub-seeds of the run's seed (any whole number)."""
    return [int(s) for s in np.random.SeedSequence(seed % 2**64).generate_state(n)]


# -- statistics ------------------------------------------------------------------------

def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile with linear interpolation between order statistics."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def window_metrics(latencies: Sequence[float], items: int, elapsed: float) -> Dict[str, float]:
    """Over all calls and all time of a window: items a second, the 95th
    percentile and median of a call's ms, ms a call."""
    return dict(rate=len(latencies) * items / elapsed,
                p95_ms=percentile(latencies, 95) * 1e3,
                median_ms=statistics.median(latencies) * 1e3,
                mean_ms=elapsed / len(latencies) * 1e3)


# -- one run ----------------------------------------------------------------------------

def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def run(workload: str, seed: int, seconds: float, trace: bool, t0: float,
        device="cuda", roots: Sequence[Path] = (ROOT,), overrides: Optional[Dict] = None,
        log=print) -> Dict:
    """One run of cell ``workload``: the result object of the last line."""
    device = torch.device(device)
    opts = dict(HARNESS, **(overrides or {}).get("harness", {}))
    cell = load("workloads", workload, roots)
    config = load("configs", cell["config"], roots)
    mix = dict(load("mixes", cell["traffic"], roots), **(overrides or {}).get("traffic", {}))
    seeds = seeds_from(seed)
    phases = dict(start_s=time.perf_counter() - t0)     # imports (and the CUDA context below)
    if device.type == "cuda":
        torch.cuda.init()
        phases["cuda_s"] = time.perf_counter() - t0 - phases["start_s"]
    t = time.perf_counter()
    entry = module("entries", cell["entry"], roots).Entry(config, mix, seeds, device, overrides)
    phases["entry_s"] = time.perf_counter() - t
    phases.update(getattr(entry, "setup_times", {}))
    t = time.perf_counter()
    for i in range(opts["warm_calls"]):
        entry.call(i)
    sync(device)
    phases["warm_s"] = time.perf_counter() - t
    # the reference's own seconds in set-up (the weights' calibration) are
    # the yardstick's, not the program's
    setup_s = time.perf_counter() - t0 - phases.get("calibrate_s", 0.0)
    log(f"[bench] set-up {setup_s:.3f} s: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))

    every, most = opts["check_every"], opts["check_most"]
    phase = seeds[4] % every
    kept: Dict[int, tuple] = {}
    latencies: List[float] = []
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = entry.counters()
    start = time.perf_counter()
    i = 0
    while True:
        keep = i % every == phase and len(kept) < most
        t = time.perf_counter()
        out = entry.call(i, keep)
        end = time.perf_counter()
        latencies.append(end - t)
        if keep:
            kept[i] = out
        i += 1
        if end - start >= seconds and kept:    # the window holds a compared call
            break
    elapsed = end - start
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    after = entry.counters()
    w = window_metrics(latencies, entry.items, elapsed)
    launches = {k: (after[k] - before[k]) / i for k in after}
    log(f"[bench] {workload} seed {seed}: {i} calls of {entry.items} in {elapsed:.3f} s; a "
        f"call's ms: median {w['median_ms']:.3f}, p95 {w['p95_ms']:.3f}, mean "
        f"{w['mean_ms']:.3f}; set-up {setup_s:.3f} s")
    log(f"[bench] kernel launches a call: {json.dumps(launches)}")

    record = None
    if trace and device.type == "cuda":
        record = profile.trace(entry.call, opts["trace_calls"], i)
        record.update(kind=entry.kind, items=entry.items,
                      flops_per_call=entry.flops_per_call(),
                      window_calls=i, window_s=elapsed,
                      expand_bound_s=entry.expand_bound_s(),
                      expand_launches_per_call=len(entry.expand_launches()))
        log(f"[bench] traced {record['calls']} calls with the device alone in "
            f"{record['traced_s']:.4f} s, busy {profile.busy_s(record['device']):.4f} s")

    metrics: Dict[str, Dict] = {}
    measured = device.type == "cuda"
    if not trace:
        values = dict(img_per_s=w["rate"], batch_ms_p95=w["p95_ms"],
                      peak_mem_gib=None if peak is None else peak / 2**30, setup_s=setup_s)
        for name, unit in entry.end_to_end.items():
            if name in cell.get("end_to_end", entry.end_to_end):
                metrics[name] = dict(value=values[name] if measured else NOT_MEASURED, unit=unit)
    else:
        for name, reader in metric_readers(roots).items():
            value = reader.read(record) if record is not None else None
            if value is not None or not measured:
                metrics[name] = dict(value=value if measured else NOT_MEASURED,
                                     unit=reader.UNIT)

    entry.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = entry.check(kept)
    limits = cell["limits"]
    correct = all(numbers[k] <= limits[k] for k in limits)
    result = dict(correct=correct, attempted=i, failed=0, metrics=metrics,
                  device=dict(platform="gpu" if measured else "cpu",
                              kind=torch.cuda.get_device_name(device) if measured else "cpu",
                              count=1, memory_peak_bytes=peak))
    if record is not None:
        result["device"].update(busy_s=profile.busy_s(record["device"]),
                                window_s=record["traced_s"])
        result["breakdown"] = dict(device_ops=profile.top_device_ops(record["device"]),
                                   idle_gaps=profile.idle_gaps(record["gap_device"],
                                                               record["host"]))
    result["compared_calls"] = len(kept)
    result["checked"] = {k: dict(value=numbers[k], limit=limits[k]) for k in limits}
    return result


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = load("workloads", args.workload).get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the benchmark runs on {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace), t0)
    print(f"[bench] card: {card()}", flush=True)
    for name, c in result["checked"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"[check] correct {result['correct']} over {result['compared_calls']} calls",
          file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
