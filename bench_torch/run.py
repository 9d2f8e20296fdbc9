"""Run one cell of the port's benchmark on the card and print its result line.

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See ``harness.py``; ``README.md`` says how to add a cell, an entry or a
metric.
"""

import time

T0 = time.perf_counter()     # the process's start, for setup_s

import sys                   # noqa: E402
from pathlib import Path     # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_torch.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
