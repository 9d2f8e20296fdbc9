"""Readings that the check's limits are set from, on the card at a cell's size.

    python bench_torch/readings.py --workload <cell> --seeds 1,2,3 [--calls 4] [--dump DIR]

For each seed, in one process: the cell's set-up, ``--calls`` calls of
its entry kept as the window keeps them, then the compared numbers
(``compare.compared``) of the program and of the control: the reference
in float8 (``reference.Arith``, the step below the configuration's bf16)
put in the program's place, on the same frames and masks. Beside them,
the raw numbers (``compare.NAMES``) of the program, the control and the
witness (the reference in bf16), each against the f32 reference. Prints
one JSON line a seed; ``--dump`` saves the packed tuples (program,
reference, witness, control; no logits) for a look at them. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from bench_torch import compare, harness  # noqa: E402


def readings(workload: str, seed: int, calls: int, device="cuda", roots=(harness.ROOT,),
             overrides=None, dump=None):
    cell = harness.load("workloads", workload, roots)
    config = harness.load("configs", cell["config"], roots)
    mix = dict(harness.load("mixes", cell["traffic"], roots),
               **(overrides or {}).get("traffic", {}))
    seeds = harness.seeds_from(seed)
    entry = harness.module("entries", cell["entry"], roots).Entry(
        config, mix, seeds, torch.device(device), overrides)
    kept = {i: entry.call(i, keep=True) for i in range(calls)}
    entry.release()
    torch.cuda.empty_cache() if device == "cuda" else None
    raw = {k: [] for k in ("program", "witness", "control")}
    saved = []
    for i, served in kept.items():
        ref, wit, low = entry.reference_serves(i, ("f32", "bf16", "fp8"))
        for name, t in (("program", served), ("witness", wit), ("control", low)):
            raw[name] += compare.batch_numbers(t, ref)
        saved.append({k: v[:4] for k, v in dict(program=served, reference=ref, witness=wit,
                                                  control=low).items()})
    if dump:
        Path(dump).mkdir(parents=True, exist_ok=True)
        torch.save(saved, Path(dump) / f"{workload}_{seed}.pt")
    raw = {k: compare.aggregate(v) for k, v in raw.items()}
    return dict(workload=workload, seed=seed, calls=calls,
                program=compare.compared(raw["program"], raw["witness"]),
                control=compare.compared(raw["control"], raw["witness"]), raw=raw)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--calls", type=int, default=4)
    ap.add_argument("--dump")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("the readings run on a CUDA card", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        t = time.perf_counter()
        r = readings(args.workload, int(s), args.calls, dump=args.dump)
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
