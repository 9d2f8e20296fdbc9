"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
with ``nvcc`` for Hopper (``sm_90a``) into ``build/udal_tpu_torch/`` at the
repository root, then loaded with ``ctypes``. The library's file name carries
a hash of the source, the shared headers (``csrc/*.cuh``) and the flags, so
an edited source is rebuilt and an unchanged one is reused. ``build`` starts
one ``nvcc`` per missing library, all at once. Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "udal_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
# soft-NMS keeps `area + barea - inter` uncontracted, so its picks equal the
# plain version's index for index
EXTRA_FLAGS = {"soft_nms": ("--fmad=false",)}


def find_nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, then $PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append(shutil.which("nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built, keyed by a hash of source, headers
    and flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(flags(name)).encode())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> None:
    """Compile every ``csrc/<name>.cu`` whose library is missing, one
    ``nvcc`` each, all started together.

    The compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside each library as ``.log``. Raises RuntimeError when nvcc
    is missing or a build fails.
    """
    todo = [n for n in dict.fromkeys(names) if not library_path(n).exists()]
    if not todo:
        return
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([nvcc, *flags(name), "-o", tmp, str(CSRC / f"{name}.cu")],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((name, tmp, proc))
    failed = []
    for name, tmp, proc in jobs:
        stdout, stderr = proc.communicate()
        try:
            if proc.returncode != 0:
                failed.append(f"nvcc failed on csrc/{name}.cu:\n{stderr}")
                continue
            out = library_path(name)
            out.with_suffix(".log").write_text(stdout + stderr)
            os.replace(tmp, out)  # atomic: concurrent builds race harmlessly
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its library is missing, then load it."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
