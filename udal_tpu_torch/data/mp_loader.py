"""Process-parallel input production for the detection reader.

Port of ``udal_tpu/data/mp_loader.py``: one ``InputReader`` fanned out
over ``num_proc`` worker processes, worker ``wid`` producing the batches
whose sequence number is ``wid`` modulo ``num_proc``. Every worker replays
the same RNG stream (``InputReader._batches(wid, nproc)``), so the
in-order merge equals one process's batches.

Workers start by ``spawn``, not ``fork``: the parent may have initialised
CUDA and torch's thread pools by then, and a forked child inherits both in
a state it cannot use (a CUDA context does not survive a fork; an OpenMP
pool forked mid-use can hang). A spawned worker imports the package
afresh, sets torch to one intra-op thread, never touches CUDA, and yields
compact groundtruth; the parent builds the classic contract's per-level
targets.
"""

from __future__ import annotations

import multiprocessing as mp
import queue as queuelib
from typing import Iterator

_END = "__udal_end__"
_ERROR = "__udal_error__"


def _worker_main(reader, config, batch_size: int, wid: int, nproc: int, q) -> None:
    """Worker body: this worker's batches into ``q``, then the end mark, or
    the error that stopped it."""
    try:
        import torch

        torch.set_num_threads(1)
        for batch in reader._batches(config, batch_size, wid=wid, nproc=nproc,
                                     host_labels=False):
            q.put(batch)
        q.put(_END)
    except BaseException as e:  # noqa: BLE001 - reported to the consumer, which raises
        try:
            q.put((_ERROR, f"{type(e).__name__}: {e}"))
        except Exception:  # noqa: BLE001 - the queue is already closed
            pass


class MultiProcessProducer:
    """Ordered round-robin merge of ``num_proc`` spawned worker processes.

    Iterating yields batches in the order ``InputReader._batches`` yields
    them in one process; a worker's error is raised on the consumer as a
    RuntimeError naming it. ``close()`` (called by the reader when its
    generator closes) terminates the workers.
    """

    def __init__(self, reader, config, batch_size: int, num_proc: int, prefetch: int = 2):
        self._config = config
        self._finalize = not reader._fast_input
        ctx = mp.get_context("spawn")
        self._queues = [ctx.Queue(maxsize=max(1, prefetch)) for _ in range(num_proc)]
        self._procs = []
        for wid in range(num_proc):
            p = ctx.Process(target=_worker_main,
                            args=(reader, config, batch_size, wid, num_proc, self._queues[wid]),
                            daemon=True, name=f"udal-input-{wid}")
            p.start()
            self._procs.append(p)
        self._num_proc = num_proc
        self._closed = False

    def __iter__(self) -> Iterator:
        seq = 0
        while True:
            wid = seq % self._num_proc
            while True:
                try:
                    item = self._queues[wid].get(timeout=5.0)
                    break
                except queuelib.Empty:
                    w = self._procs[wid]
                    if not w.is_alive():
                        raise RuntimeError(f"input worker {wid} died "
                                           f"(exitcode {w.exitcode})") from None
            if isinstance(item, str) and item == _END:
                return
            if isinstance(item, tuple) and isinstance(item[0], str) and item[0] == _ERROR:
                raise RuntimeError(f"input worker failed: {item[1]}")
            if self._finalize:
                item = self._build_host_labels(item)
            yield item
            seq += 1

    def _build_host_labels(self, batch):
        """The classic contract's targets from a worker's compact groundtruth."""
        from udal_tpu_torch.data.dataloader import build_host_labels

        images, labels = batch
        labels.update(build_host_labels(self._config, labels.pop("gt_boxes"),
                                        labels.pop("gt_classes"), labels.pop("gt_pseudo", None)))
        return images, labels

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=5.0)
        for q in self._queues:
            q.close()
            q.cancel_join_thread()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
