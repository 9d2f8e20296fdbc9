"""The active-learning loop over a TFRecord pool (``cli al``).

Port of ``udal_tpu/apps/al_runner.py``. One process runs the whole loop:
for each budget iteration the selection is written as a TFRecord (records
copied byte for byte, no re-encode), a model trains on it through
``train.loop.train_and_evaluate``, the remaining pool is served through
the port's ``ServingDriver`` (on the card unless ``--device cpu``),
packed into a ``DetectionPool`` by ``apps.al_scoring.collect_pool``, and
the next acquisition batch is chosen by ``select_pool`` in the strategy
grammar of ``apps.active_learning``.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from udal_tpu_torch.apps import active_learning as alm
from udal_tpu_torch.apps import al_scoring as als
from udal_tpu_torch.data import example_codec as codec
from udal_tpu_torch.data import tfrecord as tfr
from udal_tpu_torch.data.image_codec import decode_image


class PoolIndex:
    """name -> (shard, offset, length) over TFRecord shards, so subsets are
    byte copies instead of decode and re-encode round trips."""

    def __init__(self, file_pattern: str):
        self.paths = sorted(glob.glob(file_pattern))
        if not self.paths:
            raise FileNotFoundError(f"no TFRecords match {file_pattern}")
        self.entries: Dict[str, Tuple[str, int, int]] = {}
        self.names: List[str] = []
        for p in self.paths:
            offs, lens = tfr.scan_tfrecord(p)
            for off, ln in zip(offs.tolist(), lens.tolist()):
                f = codec.parse_example(tfr.read_record(p, off, ln))
                name = f.get("image/filename", [b""])[0].decode() or \
                    f.get("image/source_id", [b""])[0].decode()
                self.entries[name] = (p, off, ln)
                self.names.append(name)

    def record(self, name: str) -> bytes:
        p, off, ln = self.entries[name]
        return tfr.read_record(p, off, ln)

    def write_subset(self, names: Sequence[str], out_path: str,
                     pad_multiple: Optional[int] = None) -> int:
        """Copy the named records; with ``pad_multiple``, pad to a full
        final batch with copies of the last record renamed ``__pad<i>__``,
        so padding is never taken for (or merged into) a pool image."""
        n_pad = (-len(names)) % pad_multiple if pad_multiple else 0
        with tfr.TFRecordWriter(out_path) as w:
            for n in names:
                w.write(self.record(n))
            if n_pad:
                feats = codec.parse_example(self.record(names[-1]))
                for i in range(n_pad):
                    feats["image/filename"] = [f"__pad{i}__".encode()]
                    w.write(codec.serialize_example(feats))
        return len(names) + n_pad

    def decoded_images(self, names: Sequence[str]) -> List[np.ndarray]:
        """The named records' images, decoded to RGB uint8 by the port's
        PNG/JPEG decoder (bit for bit cv2's ``imdecode`` + BGR → RGB)."""
        return [decode_image(codec.parse_example(self.record(n))["image/encoded"][0])
                for n in names]


def run_al(args, log=print) -> List[str]:
    """``ActiveLearning.run`` end to end from the CLI's arguments; returns
    the final selection (also written to ``<work_dir>/selected.txt`` and,
    with ``--out_tfrecord``, as a training-ready TFRecord)."""
    from udal_tpu_torch.apps.serving import ServingDriver, checkpoint_state_dict
    from udal_tpu_torch.config import config_from_args
    from udal_tpu_torch.data.dataloader import InputReader
    from udal_tpu_torch.train.loop import train_and_evaluate

    config = config_from_args(args)
    device = getattr(args, "device", "cuda")
    index = PoolIndex(args.pool_file_pattern)
    pool = list(index.names)
    log(f"[al] pool: {len(pool)} images from {args.pool_file_pattern}")

    if args.prune_thr is not None:
        kept = alm.prune_pool(index.decoded_images(pool), max_distance=args.prune_thr,
                              method=args.hash_method)
        log(f"[al] prune ({args.hash_method}, thr={args.prune_thr}): {len(pool)} -> {len(kept)}")
        pool = [pool[i] for i in kept]

    batch = args.batch_size
    last_model_dir: List[Optional[str]] = [None]

    def train_fn(selected: Sequence[str], it_dir: str) -> None:
        sub = os.path.join(it_dir, "train.tfrecord")
        index.write_subset(selected, sub)
        reader = InputReader(sub, is_training=True, seed=args.seed)
        steps = args.steps_per_epoch or max(1, len(selected) // batch)
        model_dir = os.path.join(it_dir, "model")
        it = reader(config, batch)
        try:
            train_and_evaluate(config, it, steps, model_dir, seed=args.seed, device=device,
                               log_fn=log)
        finally:
            it.close()
        last_model_dir[0] = model_dir

    def infer_fn(remaining: Sequence[str], it_dir: str) -> als.DetectionPool:
        rem = os.path.join(it_dir, "remaining.tfrecord")
        # the __pad<i>__ batch padding drops out in the loop's subset to `remaining`
        index.write_subset(remaining, rem, pad_multiple=batch)
        scfg = config.copy()
        scfg.is_training_bn = False
        # the model the previous iteration trained (on a resumed run, its directory)
        prev = last_model_dir[0] or os.path.join(
            os.path.dirname(it_dir), f"iter_{int(it_dir.rsplit('_', 1)[1]) - 1}", "model")
        drv = ServingDriver(scfg, checkpoint_state_dict(scfg, prev), batch_size=batch, device=device)
        reader = InputReader(rem, is_training=False, names=True, seed=args.seed)
        it = reader(drv.config, batch)
        try:
            batches = ((imgs, labels["image_names"], labels["image_scales"])
                       for imgs, labels in it)
            return als.collect_pool(drv, batches, min_score=args.min_score)
        finally:
            it.close()

    opt_params = [float(x) for x in args.opt_params.split(",")] if args.opt_params else None
    budgets = [float(x) for x in args.budgets.split(",")]
    loop = alm.ActiveLearning(
        pool, args.work_dir, args.strategy, budget_steps=budgets,
        train_fn=train_fn, infer_fn=infer_fn, opt_params=opt_params,
        warmup_dir=args.warmup_dir, seed=args.seed)
    selected = loop.run()

    with open(os.path.join(args.work_dir, "selected.txt"), "w") as f:
        f.write("\n".join(str(s) for s in selected))
    if args.out_tfrecord:
        index.write_subset(selected, args.out_tfrecord)
        log(f"[al] wrote {len(selected)} selected examples to {args.out_tfrecord}")
    log(f"[al] done: {len(selected)}/{len(pool)} selected over {len(budgets)} iterations")
    return [str(s) for s in selected]
