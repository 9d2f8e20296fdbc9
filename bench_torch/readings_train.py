"""Readings that the training cell's limits are set from, on the card.

    python bench_torch/readings_train.py --workload kitti_mc.train_b8 --seeds 1,2,3 [--calls 4] [--every 1]

For each seed, in one process: the cell's set-up, ``--calls`` training
steps, every ``--every``-th kept as the window keeps them (the window keeps
every 50th), then the compared numbers
(``loss_gap``, ``update_gap``; ``entries/train_step.py``) of the program
and of the control, the reference's step computed in float8 e4m3 (the
step below the configuration's bf16) put in the program's place, and of
the witness, the reference in bf16, and of the fault, the f32 reference
on the batch's first half at the whole batch's rate (a step that leaves
half of the batch out); the largest over the steps and each step's.
Prints one JSON line a seed. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from bench_torch import harness  # noqa: E402

NAMES = ("loss_gap", "update_gap")


def readings(workload: str, seed: int, calls: int, device="cuda", roots=(harness.ROOT,),
             overrides=None, every: int = 1):
    cell = harness.load("workloads", workload, roots)
    config = harness.load("configs", cell["config"], roots)
    mix = dict(harness.load("mixes", cell["traffic"], roots),
               **(overrides or {}).get("traffic", {}))
    entry = harness.module("entries", cell["entry"], roots).Entry(
        config, mix, harness.seeds_from(seed), torch.device(device), overrides)
    kept = {}
    for i in range(calls):
        out = entry.call(i, keep=i % every == every - 1)
        if i % every == every - 1:
            kept[i] = out
    entry.release()
    steps = {k: [] for k in ("program", "witness", "control", "half")}
    for i, out in kept.items():
        ref = entry.reference_step(i, "f32")
        steps["program"].append(entry.gaps(i, out, entry.kept[i]["after"], ref))
        for name, precision in (("witness", "bf16"), ("control", "fp8")):
            steps[name].append(entry.gaps(i, *entry.reference_step(i, precision), ref))
        steps["half"].append(entry.gaps(i, *entry.reference_step(i, rows=entry.items // 2),
                                        ref))
    largest = {k: {n: max(r[n] for r in v) for n in NAMES} for k, v in steps.items()}
    return dict(workload=workload, seed=seed, calls=calls, **largest, steps=steps)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--calls", type=int, default=4)
    ap.add_argument("--every", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("the readings run on a CUDA card", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        t = time.perf_counter()
        r = readings(args.workload, int(s), args.calls, every=args.every)
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
