"""Command-line entry points: train, train_ssl, eval, inspect, al and ssl.

Port of ``udal_tpu/cli.py`` with its flags and defaults:

* ``python -m udal_tpu_torch.cli train``: the input reader over TFRecords,
  ``train.loop.train_and_evaluate`` (validation loss, the COCO AP every
  ``map_freq`` epochs, checkpoints in the port's format under
  ``--model_dir``), ``config.yaml`` written beside them. Under
  ``torchrun --nproc_per_node N -m udal_tpu_torch.cli train ...`` every
  process joins the group (``parallel.mesh.initialize_multihost``) and
  trains its share: ``--batch_size`` is the global batch, each data rank
  reads its shard of the records at ``batch_size / n_data`` a step, and
  ``--n_model`` ranks to a model group shard the state (tensor
  parallelism);
* ``train_ssl``: the labelled and unlabelled readers zipped into one batch;
* ``eval``: COCO evaluation (and the detections' ECE) of a checkpoint over a
  TFRecord, through ``ServingDriver``;
* ``inspect --mode {inference, auto-label, ssal, calibrate, validate,
  benchmark}``: the apps over a reader;
* ``al``: the active-learning loop over a TFRecord pool
  (``apps.al_runner.run_al``);
* ``ssl --method {stac, csd}``: STAC's teacher, pseudo-label round and
  student, or CSD's consistency training (``apps.ssl_runner``).

``--hparams`` and ``--config`` take yaml files (the port's own reader) or
``k=v`` strings. Checkpoints are the port's own (``utils/checkpoint.py``);
a JAX checkpoint reaches the port through ``convert.py`` on a machine with
JAX. ``--device`` (default ``cuda``) says where the model runs.

Not ported, each refused with the reason: ``--tf_checkpoint`` (TF
checkpoints go TF → flax → torch), ``--compile_cache`` (XLA's cache),
``inspect --mode export`` (StableHLO) and
``--mode video`` (cv2's video I/O); the ``parity_kitti`` command.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys

import numpy as np

from udal_tpu_torch.config import config_from_args


def _apply_config_file(args) -> None:
    """Fill args from an eval / inference yaml (``configs/{eval,inference}``:
    eval_samples, hparams, model_dir, val_file_pattern, ...). Values given
    on the command line win over the file."""
    if not getattr(args, "config", None):
        return
    from udal_tpu_torch.config import load_yaml

    for key, val in (load_yaml(args.config) or {}).items():
        if getattr(args, key, None) in (None, "", 0):
            setattr(args, key, val)


def _refuse_unported(args) -> None:
    if getattr(args, "compile_cache", None):
        raise SystemExit("--compile_cache: XLA's compilation cache has no counterpart in the "
                         "port (ROADMAP, 'Not to port': utils/compile_cache.py)")
    if getattr(args, "tf_checkpoint", None):
        raise SystemExit("--tf_checkpoint: TF checkpoints are not read by the port (ROADMAP, "
                         "'Not to port': utils/tf_checkpoint.py); load it into flax with "
                         "udal_tpu and convert with udal_tpu_torch.convert on a machine with JAX")


def _train_mesh(args):
    """The training mesh: the process group joined from torchrun's
    environment (none outside torchrun: a world of one), ``--n_model``
    ranks to a model group; None for one process at ``--n_model 1``."""
    from udal_tpu_torch.parallel.mesh import initialize_multihost, make_multihost_mesh

    info = initialize_multihost(device=args.device)
    if info["process_count"] == 1 and args.n_model == 1:
        return None
    if info["process_count"] % args.n_model:
        raise SystemExit(f"--n_model {args.n_model}: tensor-parallel training (ROADMAP A11) "
                         f"needs a multiple of {args.n_model} processes, and this run has "
                         f"{info['process_count']}; launch it with torchrun --nproc_per_node "
                         f"<N> -m udal_tpu_torch.cli train ...")
    return make_multihost_mesh(args.n_model, device=args.device)


def _restore_weights(args, config):
    """The weights of ``--model_dir``'s latest checkpoint (random weights
    from seed 0 without one; ``_`` names no directory)."""
    from udal_tpu_torch.apps.serving import checkpoint_state_dict

    return checkpoint_state_dict(config, None if args.model_dir == "_" else args.model_dir)


def _fast_reader_flags(args):
    """(fast_input, device_resize) for InputReader: device_resize implies
    fast_input; subcommands without the flags read as (False, False)."""
    dev = getattr(args, "device_resize", False)
    return (getattr(args, "fast_input", False) or dev), dev


def cmd_train(args):
    """Train from TFRecords; returns the loop's history with the training
    reader's ``wait_stats()`` as ``input_wait``."""
    from udal_tpu_torch.data.dataloader import InputReader
    from udal_tpu_torch.train.loop import train_and_evaluate

    _refuse_unported(args)
    config = config_from_args(args)
    if args.n_model > 1:
        config.override({"n_model": args.n_model}, allow_new_keys=True)
    mesh = _train_mesh(args)
    # each data rank reads its shard of the records (default_shard of n_model)
    local_batch = args.batch_size // (mesh.shape["data"] if mesh is not None else 1)
    fast, dev_rs = _fast_reader_flags(args)
    reader = InputReader(args.train_file_pattern, is_training=True,
                         use_fake_data=args.use_fake_data,
                         max_instances_per_image=config.max_instances_per_image,
                         fast_input=fast, num_proc=args.input_procs,
                         device_resize=dev_rs)
    steps = args.steps_per_epoch or max(1, args.num_examples_per_epoch // args.batch_size)
    train_iter = reader(config, local_batch)

    val_iter_fn = None
    val_steps = 0
    if args.val_file_pattern:
        val_reader = InputReader(args.val_file_pattern, is_training=False)
        val_steps = max(1, args.eval_samples // args.batch_size)

        def val_iter_fn():
            return val_reader(config, local_batch)

    os.makedirs(args.model_dir, exist_ok=True)
    if mesh is None or mesh.rank == 0:
        config.save_to_yaml(os.path.join(args.model_dir, "config.yaml"))
    try:
        history = train_and_evaluate(config, train_iter, steps, args.model_dir,
                                     val_iter_fn=val_iter_fn, val_steps=val_steps,
                                     seed=args.seed, device=args.device, mesh=mesh)
    finally:
        train_iter.close()
    history["input_wait"] = reader.wait_stats()
    return history


def cmd_train_ssl(args):
    """SSL student training: the labelled and unlabelled (pseudo-labelled)
    readers zipped into one batch split at ``unlabeled_start``, the STAC
    or CSD knobs set on the config."""
    from udal_tpu_torch.data.composition import ssl_batch_split, zip_readers
    from udal_tpu_torch.data.dataloader import InputReader
    from udal_tpu_torch.train.loop import train_and_evaluate

    _refuse_unported(args)
    config = config_from_args(args)
    labeled_per_batch = ssl_batch_split(config, args.batch_size, args.ratio)
    config.override({
        "unlabeled_start": labeled_per_batch,
        "ssl_method": args.ssl_method,
        "stac_lambda": args.stac_lambda,
        "csd_ramp": args.csd_ramp,
        "csd_BE": args.csd_BE,
        "csd_BE_thr": args.csd_BE_thr,
    }, allow_new_keys=True)

    fast, dev_rs = _fast_reader_flags(args)
    reader_l = InputReader(args.train_file_pattern, is_training=True,
                           max_instances_per_image=config.max_instances_per_image,
                           fast_input=fast, device_resize=dev_rs)
    # the unlabelled (pseudo-labelled) stream gets RandAugment on its own config
    cfg_u = copy.deepcopy(config)
    if args.stac_randaug and args.ssl_method == "stac":
        cfg_u.autoaugment_policy = "randaug"
    reader_u = InputReader(args.unlabeled_file_pattern, is_training=True,
                           max_instances_per_image=config.max_instances_per_image,
                           fast_input=fast, device_resize=dev_rs)
    train_iter = zip_readers(reader_l, lambda cfg, bs: reader_u(cfg_u, bs), config,
                             labeled_per_batch, args.batch_size - labeled_per_batch)

    steps = args.steps_per_epoch or max(1, args.num_examples_per_epoch // args.batch_size)
    val_iter_fn = None
    val_steps = 0
    if args.val_file_pattern:
        val_reader = InputReader(args.val_file_pattern, is_training=False)
        val_steps = max(1, (args.eval_samples or 64) // args.batch_size)

        def val_iter_fn():
            return val_reader(config, args.batch_size)

    os.makedirs(args.model_dir, exist_ok=True)
    config.save_to_yaml(os.path.join(args.model_dir, "config.yaml"))
    return train_and_evaluate(config, train_iter, steps, args.model_dir,
                              val_iter_fn=val_iter_fn, val_steps=val_steps, device=args.device)


def cmd_eval(args):
    """COCO evaluation of ``--model_dir``'s latest checkpoint over
    ``--val_file_pattern``, and the ECE of the detections' confidence;
    prints and returns the numbers."""
    from udal_tpu_torch.apps.serving import ServingDriver
    from udal_tpu_torch.data.dataloader import InputReader
    from udal_tpu_torch.data.label_maps import get_label_map
    from udal_tpu_torch.eval.coco import COCOEvaluator
    from udal_tpu_torch.train.callbacks import detection_rows, scaled_groundtruth
    from udal_tpu_torch.apps.reader_batches import serve_reader_batch

    _apply_config_file(args)
    _refuse_unported(args)
    config = config_from_args(args)
    driver = ServingDriver(config, _restore_weights(args, config), batch_size=args.batch_size,
                           device=args.device)
    evaluator = COCOEvaluator(label_map=get_label_map(config.label_map),
                              fine_grid=args.fine_grid)
    fast, dev_rs = _fast_reader_flags(args)
    reader = InputReader(args.val_file_pattern, is_training=False,
                         fast_input=fast, device_resize=dev_rs)
    img_id = 0
    conf_correct = []   # (score, hit) pairs for the detection-confidence ECE
    for images, labels in reader(config, args.batch_size):
        # detections come back in the original image's frame, where the
        # scaled groundtruth lies
        det = serve_reader_batch(driver, images, labels, structured=True)
        rows = detection_rows(det, img_id)
        img_id += rows.shape[0]
        gt_scaled = scaled_groundtruth(labels)
        evaluator.update_state(gt_scaled, rows)
        conf_correct.append(_det_confidence_hits(det, gt_scaled))
    results = evaluator.result()
    if conf_correct:
        pairs = np.concatenate(conf_correct, axis=0)
        results["ECE"] = _expected_calibration_error(pairs[:, 0], pairs[:, 1])
    for k, v in results.items():
        print(f"{k}: {v:.4f}")
    return results


def _det_confidence_hits(det, gt_scaled, iou_thr: float = 0.5, score_thr: float = 0.05):
    """(score, correct) pairs: a detection is correct if it matches a
    groundtruth of its class at IoU >= 0.5."""
    import torch

    from udal_tpu_torch.ops.boxes import pairwise_iou

    out = []
    boxes = det.boxes.float().cpu()
    scores = det.scores.float().cpu().numpy()
    classes = det.classes.float().cpu().numpy()
    for b in range(boxes.shape[0]):
        keep = scores[b] > score_thr
        if not keep.any():
            continue
        gt = gt_scaled[b]
        gt = gt[gt[:, -1] > 0]
        if len(gt) == 0:
            hits = np.zeros(int(keep.sum()), np.float32)
            out.append(np.stack([scores[b][keep], hits], axis=1))
            continue
        ious = pairwise_iou(boxes[b][torch.from_numpy(keep)],
                            torch.from_numpy(np.ascontiguousarray(gt[:, :4]))).numpy()
        same_cls = classes[b][keep][:, None] == gt[None, :, -1]
        hit = ((ious >= iou_thr) & same_cls).any(axis=1)
        out.append(np.stack([scores[b][keep], hit.astype(np.float32)], axis=1))
    return np.concatenate(out, axis=0) if out else np.zeros((0, 2), np.float32)


def _expected_calibration_error(scores, hits, bins: int = 10) -> float:
    edges = np.linspace(0.0, 1.0, bins + 1)
    n = len(scores)
    if n == 0:
        return 0.0
    ece = 0.0
    for i in range(bins):
        m = (scores > edges[i]) & (scores <= edges[i + 1])
        if m.any():
            ece += m.sum() / n * abs(hits[m].mean() - scores[m].mean())
    return float(ece)


def cmd_inspect(args):
    """The apps over a reader of ``--val_file_pattern``: inference and
    auto-labeling (``InferImages``), calibration, validation; or the
    driver's benchmark."""
    from udal_tpu_torch.apps.serving import ServingDriver
    from udal_tpu_torch.data.dataloader import InputReader

    _apply_config_file(args)
    if args.mode == "export":
        raise SystemExit("inspect --mode export: StableHLO export is not ported (ROADMAP, "
                         "'Not to port')")
    if args.mode == "video":
        raise SystemExit("inspect --mode video: video I/O needs cv2, which the port does not "
                         "use; decode the frames elsewhere and run --mode inference on them")
    _refuse_unported(args)
    config = config_from_args(args)
    if getattr(args, "ensemble_dirs", None):
        member_dirs = [d for d in args.ensemble_dirs.split(",") if d]
        driver = ServingDriver.create_ensemble(config, member_dirs, batch_size=args.batch_size,
                                               device=args.device)
    elif args.model_dir and args.model_dir != "_":
        driver = ServingDriver(config, _restore_weights(args, config),
                               batch_size=args.batch_size, device=args.device)
    else:
        driver = ServingDriver.create(args.model_name, batch_size=args.batch_size,
                                      overrides=dict(config.as_dict()), device=args.device)

    fast, dev_rs = _fast_reader_flags(args)
    if args.mode == "benchmark":
        imgs = np.random.rand(args.batch_size, 512, 512, 3).astype(np.float32)
        result = driver.benchmark(imgs)
        print(result)
        return result
    reader = InputReader(args.val_file_pattern, is_training=False, names=True,
                         fast_input=fast, device_resize=dev_rs)
    if args.mode in ("inference", "auto-label", "ssal", "SSAL"):
        from udal_tpu_torch.apps.infer import InferImages

        # SSAL: the same InferImages path with the auto-label gate on
        auto = args.mode != "inference"
        app = InferImages(driver, args.output_dir or "infer_out", calib_dir=args.calib_dir,
                          auto_labeling=auto, opt_params=[0.5, 0.5] if auto else None,
                          opt_thrs_path=args.opt_thrs_path,
                          save_visualizations=args.save_visualizations)
        if fast:
            batches = iter(reader(config, args.batch_size))
        else:
            batches = ((imgs, labels["image_names"], labels["image_scales"])
                       for imgs, labels in reader(config, args.batch_size))
        rows = app.run(batches)
        print(f"wrote {len(rows)} detections")
        return rows
    if args.mode == "validate":
        from udal_tpu_torch.apps.validate import Validator

        v = Validator(driver, args.output_dir or "validate_out", calib_dir=args.calib_dir)
        rows = v.run(reader(config, args.batch_size))
        print(f"validated {len(rows)} ground truths")
        return rows
    if args.mode == "calibrate":
        from udal_tpu_torch.apps.calibrate_model import Calibrate

        out = Calibrate(driver, args.output_dir or "calibration").run(
            reader(config, args.batch_size))
        print("calibrators written")
        return out
    raise SystemExit(f"unknown mode {args.mode}")


def cmd_al(args):
    """The active-learning loop; returns the final selection."""
    from udal_tpu_torch.apps.al_runner import run_al

    _refuse_unported(args)
    return run_al(args)


def cmd_ssl(args):
    """STAC (the pseudo-TFRecords of its rounds) or CSD (the model's
    directory)."""
    from udal_tpu_torch.apps.ssl_runner import run_csd, run_stac

    _refuse_unported(args)
    return run_stac(args) if args.method == "stac" else run_csd(args)


def _not_ported(what: str):
    def refuse(args):
        raise SystemExit(what)
    return refuse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="udal_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("--model_name", default="efficientdet-d0")
        sp.add_argument("--model_dir", default=None)
        sp.add_argument("--compile_cache", default=None, metavar="DIR",
                        help="not ported (XLA's compilation cache); refused")
        sp.add_argument("--hparams", default="")
        sp.add_argument("--batch_size", type=int, default=8)
        sp.add_argument("--num_epochs", type=int, default=None)
        sp.add_argument("--val_file_pattern", default=None)
        sp.add_argument("--config", default=None,
                        help="eval/inference yaml (configs/{eval,inference}) filling the "
                             "args above")
        sp.add_argument("--tf_checkpoint", default=None,
                        help="not ported (TF checkpoints go TF -> flax -> torch); refused")
        sp.add_argument("--eval_samples", type=int, default=0)
        sp.add_argument("--device", default="cuda",
                        help="where the model runs (default cuda; cpu on request)")

    t = sub.add_parser("train")
    common(t)
    t.add_argument("--train_file_pattern", required=True)
    t.add_argument("--num_examples_per_epoch", type=int, default=1024)
    t.add_argument("--steps_per_epoch", type=int, default=None)
    t.add_argument("--use_fake_data", action="store_true")
    t.add_argument("--n_model", type=int, default=1,
                   help="tensor-parallel width: ranks to a model group (under torchrun)")
    t.add_argument("--seed", type=int, default=0,
                   help="init/dropout seed (vary per deep-ensemble member)")
    t.add_argument("--fast_input", action="store_true",
                   help="uint8 batches; normalisation and target assignment on the device")
    t.add_argument("--device_resize", action="store_true",
                   help="implies --fast_input; native-size uint8 frames, the bilinear "
                        "resize on the device too (uniform-size datasets, e.g. KITTI/BDD)")
    t.add_argument("--input_procs", type=int, default=0,
                   help="input worker processes (0 = in-process threads)")
    t.set_defaults(fn=cmd_train)

    ts = sub.add_parser("train_ssl")
    common(ts)
    ts.add_argument("--train_file_pattern", required=True)
    ts.add_argument("--unlabeled_file_pattern", required=True)
    ts.add_argument("--num_examples_per_epoch", type=int, default=1024)
    ts.add_argument("--steps_per_epoch", type=int, default=None)
    ts.add_argument("--ratio", type=float, default=0.5, help="labeled fraction of each batch")
    ts.add_argument("--ssl_method", choices=["stac", "csd"], default="stac")
    ts.add_argument("--stac_lambda", type=float, default=1.0)
    ts.add_argument("--stac_randaug", action="store_true",
                    help="RandAugment on the unlabelled stream (stac)")
    ts.add_argument("--csd_ramp", action="store_true")
    ts.add_argument("--csd_BE", action="store_true")
    ts.add_argument("--csd_BE_thr", type=float, default=0.5)
    ts.add_argument("--fast_input", action="store_true",
                    help="uint8 batches for both SSL streams")
    ts.add_argument("--device_resize", action="store_true",
                    help="implies --fast_input; bilinear resize on the device")
    ts.set_defaults(fn=cmd_train_ssl)

    e = sub.add_parser("eval")
    common(e)
    e.add_argument("--fine_grid", action="store_true")
    e.add_argument("--fast_input", action="store_true",
                   help="uint8 reader batches; normalisation on the device")
    e.add_argument("--device_resize", action="store_true",
                   help="implies --fast_input; the bilinear resize on the device too")
    e.set_defaults(fn=cmd_eval)

    i = sub.add_parser("inspect")
    common(i)
    i.add_argument("--mode", required=True,
                   choices=["export", "inference", "calibrate", "validate", "auto-label",
                            "ssal", "SSAL", "video", "benchmark"])
    i.add_argument("--video_path", default=None)
    i.add_argument("--output_video", default=None)
    i.add_argument("--infer_last_frame", type=int, default=0)
    i.add_argument("--output_dir", default=None)
    i.add_argument("--calib_dir", default=None)
    i.add_argument("--opt_thrs_path", default=None)
    i.add_argument("--save_visualizations", action="store_true",
                   help="write detection overlays and uncertainty panels as PNG "
                        "(<output_dir>/visualizations) and the buckets' contact sheets")
    i.add_argument("--ensemble_dirs", default=None,
                   help="comma-separated member model_dirs served as a deep ensemble")
    i.add_argument("--fast_input", action="store_true",
                   help="uint8 reader batches for inference/validate/calibrate")
    i.add_argument("--device_resize", action="store_true",
                   help="implies --fast_input; the bilinear resize on the device too")
    i.set_defaults(fn=cmd_inspect)

    a = sub.add_parser("al", help="active-learning acquisition loop over a TFRecord pool")
    common(a)
    a.add_argument("--pool_file_pattern", required=True,
                   help="TFRecord shards of the labelled pool to acquire from")
    a.add_argument("--work_dir", required=True,
                   help="per-iteration artifacts in <work_dir>/iter_<i>/ (selected.txt, "
                        "train.tfrecord, model/); the loop resumes from completed iterations")
    a.add_argument("--strategy", default="entropy",
                   help="scoring strategy: random/entropy/mcbox/albox/mcclass/combo/ental/"
                        "alluncert/epuncert/sota/highep_lowal + mean/calib/norm/perc/bottomk/"
                        "nee modifiers")
    a.add_argument("--budgets", default="5,5,5,10,20,30,25",
                   help="percent of the pool added per iteration")
    a.add_argument("--steps_per_epoch", type=int, default=None,
                   help="default: one pass over the current selection")
    a.add_argument("--opt_params", default=None, help="comma weights for combo strategies")
    a.add_argument("--min_score", type=float, default=0.0,
                   help="detection score floor when scoring the pool")
    a.add_argument("--prune_thr", type=int, default=None,
                   help="near-duplicate pool pruning at this Hamming distance")
    a.add_argument("--hash_method", default="phash", choices=["phash", "whash"])
    a.add_argument("--warmup_dir", default=None,
                   help="completed iter_0 directory of another strategy's run to reuse")
    a.add_argument("--out_tfrecord", default=None,
                   help="also write the final selection as a training-ready TFRecord")
    a.add_argument("--seed", type=int, default=0)
    a.set_defaults(fn=cmd_al)

    s = sub.add_parser("ssl", help="STAC/CSD orchestration over TFRecords; train_ssl is the "
                                   "lower-level student trainer")
    common(s)
    s.add_argument("--method", choices=["stac", "csd"], default="stac")
    s.add_argument("--train_file_pattern", required=True, help="labelled TFRecords")
    s.add_argument("--unlabeled_file_pattern", required=True,
                   help="unlabelled pool TFRecords (STAC pseudo-labels these; CSD consumes "
                        "them directly)")
    s.add_argument("--work_dir", required=True)
    s.add_argument("--tau", type=float, default=0.5, help="pseudo-label score threshold")
    s.add_argument("--selection_strategy", default="score",
                   help="score / combo / alluncert / epuncert / ental")
    s.add_argument("--stac_lambda", type=float, default=1.0)
    s.add_argument("--stac_randaug", action="store_true")
    s.add_argument("--pseudoscore", action="store_true",
                   help="write per-detection pseudo_score weights")
    s.add_argument("--selftrain_rounds", type=int, default=0)
    s.add_argument("--ratio", type=float, default=0.5,
                   help="labelled fraction of each student batch")
    s.add_argument("--csd_ramp", action="store_true")
    s.add_argument("--csd_BE", action="store_true")
    s.add_argument("--csd_BE_thr", type=float, default=0.5)
    s.add_argument("--opt_params", default=None)
    s.add_argument("--min_score", type=float, default=0.0)
    s.add_argument("--steps_per_epoch", type=int, default=None)
    s.add_argument("--seed", type=int, default=0)
    s.set_defaults(fn=cmd_ssl)

    pk = sub.add_parser("parity_kitti",
                        help="real-data parity table vs the reference: not to port")
    pk.add_argument("--val_tfrecord", required=True)
    pk.add_argument("--tf_checkpoint", required=True)
    pk.add_argument("--hparams", default=None)
    pk.add_argument("--batch_size", type=int, default=8)
    pk.add_argument("--skip_reference", action="store_true")
    pk.add_argument("--out", default=None)
    pk.set_defaults(fn=_not_ported("parity_kitti: needs KITTI records, a trained TF checkpoint "
                                   "and the reference tree (ROADMAP, 'Not to port': "
                                   "apps/parity.py)"))
    return p


def main(argv=None):
    """Programmatic entry: returns the subcommand's result (the history of
    ``train``, the metrics of ``eval``, ...)."""
    args = build_parser().parse_args(argv)
    return args.fn(args)


def script_main() -> int:
    main()
    return 0


if __name__ == "__main__":
    sys.exit(script_main())
