"""STAC and CSD over TFRecords (``cli ssl``).

Port of ``udal_tpu/apps/ssl_runner.py``. The stages run in one process
through ``apps.ssl.STAC`` (training retried until its checkpoint exists):
the teacher trains with ``train.loop.train_and_evaluate``, the unlabelled
pool is served through the port's ``ServingDriver`` (on the card unless
``--device cpu``) and ``apps.infer.InferImages``, whose rows feed
``select_pseudo_labels``; the pseudo TFRecord keeps the detection schema
with ``image/object/pseudo_score``; the student trains on zipped labelled
+ pseudo batches split at ``unlabeled_start``, the unlabelled stream
RandAugmented with ``--stac_randaug``. ``--method csd`` trains one model on
zipped labelled + unlabelled batches.

As in the JAX runner, both set ``ssl_method`` to the lower-case
``"stac"`` / ``"csd"`` while ``train.train_lib.compute_loss`` compares
with ``"STAC"`` / ``"CSD"``: the student (and the CSD model) trains with
the plain detection loss (ROADMAP C11).
"""

from __future__ import annotations

import copy
import os
from typing import List, Optional

from udal_tpu_torch.apps.al_runner import PoolIndex
from udal_tpu_torch.apps.serving import checkpoint_state_dict
from udal_tpu_torch.apps.ssl import STAC
from udal_tpu_torch.config import config_from_args


def _train_once(config, reader_iter, steps: int, model_dir: str, seed: int, device,
                log) -> None:
    from udal_tpu_torch.train.loop import train_and_evaluate

    train_and_evaluate(config, reader_iter, steps, model_dir, seed=seed, device=device,
                       log_fn=log)


def run_stac(args, log=print) -> List[str]:
    """Teacher → pseudo-labels → student (and the selftrain rounds);
    returns the pseudo-TFRecord paths, one a round."""
    from udal_tpu_torch.apps.infer import InferImages
    from udal_tpu_torch.apps.serving import ServingDriver
    from udal_tpu_torch.data.composition import ssl_batch_split, zip_readers
    from udal_tpu_torch.data.dataloader import InputReader

    config = config_from_args(args)
    device = getattr(args, "device", "cuda")
    batch = args.batch_size
    labeled_index = PoolIndex(args.train_file_pattern)
    unlabeled_index = PoolIndex(args.unlabeled_file_pattern)
    log(f"[ssl] labeled {len(labeled_index.names)} / unlabeled {len(unlabeled_index.names)}")

    def _model_dir(stage: str, round_idx: int) -> str:
        return os.path.join(args.work_dir, "teacher" if stage == "teacher"
                            else f"student_r{round_idx}", "model")

    def train_fn(stage: str, pseudo_path: Optional[str], round_idx: int) -> None:
        model_dir = _model_dir(stage, round_idx)
        steps = args.steps_per_epoch or max(1, len(labeled_index.names) // batch)
        if stage == "teacher":
            reader = InputReader(args.train_file_pattern, is_training=True, seed=args.seed)
            it = reader(config, batch)
            try:
                _train_once(config, it, steps, model_dir, args.seed, device, log)
            finally:
                it.close()
            return
        # the student: zipped labelled + pseudo batches, the train_ssl contract
        cfg_s = config.copy()
        labeled_per_batch = ssl_batch_split(cfg_s, batch, args.ratio)
        cfg_s.override({"unlabeled_start": labeled_per_batch, "ssl_method": "stac",
                        "stac_lambda": args.stac_lambda}, allow_new_keys=True)
        reader_l = InputReader(args.train_file_pattern, is_training=True, seed=args.seed)
        cfg_u = copy.deepcopy(cfg_s)
        if args.stac_randaug:
            cfg_u.autoaugment_policy = "randaug"
        reader_u = InputReader(pseudo_path, is_training=True, seed=args.seed)
        it = zip_readers(reader_l, lambda c, b: reader_u(cfg_u, b), cfg_s,
                         labeled_per_batch, batch - labeled_per_batch)
        _train_once(cfg_s, it, steps, model_dir, args.seed, device, log)

    def infer_fn(round_idx: int):
        # round 0 predicts with the teacher, selftrain round r with student r - 1
        stage = "teacher" if round_idx == 0 else "student"
        scfg = config.copy()
        scfg.is_training_bn = False
        drv = ServingDriver(scfg, checkpoint_state_dict(scfg, _model_dir(stage, round_idx - 1)),
                            batch_size=batch, device=device)
        rem = os.path.join(args.work_dir, f"pool_round{round_idx}.tfrecord")
        unlabeled_index.write_subset(unlabeled_index.names, rem, pad_multiple=batch)
        reader = InputReader(rem, is_training=False, names=True, seed=args.seed)
        out_dir = os.path.join(args.work_dir, f"infer_round{round_idx}")
        it = reader(drv.config, batch)
        try:
            rows = InferImages(drv, out_dir, min_score=args.min_score).run(it)
        finally:
            it.close()
        return [r for r in rows if not str(r["image_name"]).startswith("__pad")]

    def images_fn(names):
        return dict(zip(names, unlabeled_index.decoded_images(names)))

    stac = STAC(args.work_dir, tau=args.tau, selection_strategy=args.selection_strategy,
                stac_lambda=args.stac_lambda, activate_pseudoscore=args.pseudoscore,
                train_fn=train_fn, infer_fn=infer_fn, images_fn=images_fn,
                opt_params=[float(x) for x in args.opt_params.split(",")]
                if args.opt_params else None,
                selftrain_rounds=args.selftrain_rounds,
                train_done_fn=lambda stage, r: os.path.exists(_model_dir(stage, r)))
    artifacts = stac.run()
    log(f"[ssl] stac done: {len(artifacts)} pseudo rounds -> {artifacts}")
    return artifacts


def run_csd(args, log=print) -> str:
    """CSD: one model, zipped labelled + unlabelled batches, the
    flip-consistency knobs on the config; returns the model's directory."""
    from udal_tpu_torch.data.composition import ssl_batch_split, zip_readers
    from udal_tpu_torch.data.dataloader import InputReader

    config = config_from_args(args)
    batch = args.batch_size
    labeled_per_batch = ssl_batch_split(config, batch, args.ratio)
    config.override({"unlabeled_start": labeled_per_batch, "ssl_method": "csd",
                     "csd_ramp": args.csd_ramp, "csd_BE": args.csd_BE,
                     "csd_BE_thr": args.csd_BE_thr}, allow_new_keys=True)
    reader_l = InputReader(args.train_file_pattern, is_training=True, seed=args.seed)
    reader_u = InputReader(args.unlabeled_file_pattern, is_training=True, seed=args.seed)
    it = zip_readers(reader_l, lambda c, b: reader_u(c, b), config,
                     labeled_per_batch, batch - labeled_per_batch)
    n_labeled = len(PoolIndex(args.train_file_pattern).names)
    steps = args.steps_per_epoch or max(1, n_labeled // batch)
    model_dir = os.path.join(args.work_dir, "csd", "model")
    _train_once(config, it, steps, model_dir, args.seed, getattr(args, "device", "cuda"), log)
    log(f"[ssl] csd done -> {model_dir}")
    return model_dir
