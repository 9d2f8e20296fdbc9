"""The port loads on a machine with PyTorch, numpy and scipy only."""

import ast
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401


PORT = pathlib.Path(__file__).resolve().parents[1] / "udal_tpu_torch"
FORBIDDEN = ("jax", "flax", "yaml", "udal_tpu", "sklearn", "cv2", "PIL", "matplotlib")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_serving_path_imports_no_jax_flax_yaml_or_jax_package():
    """Every module of the inference surface, and each entry of the serving
    driver, loads without JAX, flax, yaml or the JAX package."""
    code = ("import sys, udal_tpu_torch.apps.serving as s, udal_tpu_torch.ops.cuda_nms, "
            "udal_tpu_torch.ops.image_ops, udal_tpu_torch.models.ensemble, "
            "udal_tpu_torch.apps.reader_batches, udal_tpu_torch.convert; "
            "from udal_tpu_torch.models.efficientdet import EfficientDetModel; "
            "from udal_tpu_torch.ops.postprocess import per_class_nms, generate_detections; "
            "from udal_tpu_torch.convert import flax_to_torch_stacked; "
            "[getattr(s.ServingDriver, e) for e in ('serve', 'serve_detections', "
            "'serve_preprocessed', 'serve_detections_preprocessed', 'serve_preprocessed_uint8', "
            "'serve_detections_preprocessed_uint8', 'benchmark')]; "
            "print('\\n'.join(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PORT.parent, check=True).stdout.split()
    for module in ("torch", "udal_tpu_torch.ops.postprocess", "udal_tpu_torch.ops.image_ops",
                   "udal_tpu_torch.models.ensemble", "udal_tpu_torch.apps.reader_batches"):
        assert module in out
    assert [m for m in out if _forbidden(m)] == []


def test_training_path_imports_no_jax_flax_yaml_or_jax_package():
    """The training modules (losses, schedules, the steps and the loop,
    labels and synthetic batches, checkpoints and metrics) and their
    entries load without JAX, flax, yaml or the JAX package."""
    code = ("import sys, udal_tpu_torch.train.loop as loop, udal_tpu_torch.train.losses, "
            "udal_tpu_torch.train.schedules, udal_tpu_torch.data.labels, "
            "udal_tpu_torch.data.synthetic, udal_tpu_torch.utils.checkpoint, "
            "udal_tpu_torch.utils.metrics_writer; "
            "from udal_tpu_torch.train.train_lib import create_train_state, train_step, eval_step; "
            "from udal_tpu_torch.convert import train_state_from_flax, train_state_to_flax; "
            "from udal_tpu_torch.apps.serving import ServingDriver, load_ensemble_variables; "
            "[loop.train_and_evaluate, ServingDriver.create_ensemble]; "
            "print('\\n'.join(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PORT.parent, check=True).stdout.split()
    for module in ("torch", "udal_tpu_torch.train.train_lib", "udal_tpu_torch.data.labels",
                   "udal_tpu_torch.utils.checkpoint", "udal_tpu_torch.ops.target_assign"):
        assert module in out
    assert [m for m in out if _forbidden(m)] == []


def test_apps_import_nothing_the_card_machine_lacks():
    """Calibration, thresholding, the auto-labeling and validation apps,
    the offline analysis, the label maps and the calibrators' converter
    load with none of JAX, flax, yaml, the JAX package, sklearn, cv2, PIL
    or matplotlib (the machine with the card has none of them)."""
    code = ("import sys, udal_tpu_torch.apps.calibration as c, udal_tpu_torch.apps.thresholding, "
            "udal_tpu_torch.apps.infer as i, udal_tpu_torch.apps.validate as v, "
            "udal_tpu_torch.apps.calibrate_model as m, udal_tpu_torch.apps.uncertainty_analysis, "
            "udal_tpu_torch.data.label_maps, udal_tpu_torch.ops.image_ops; "
            "from udal_tpu_torch.convert import calibrators_from_jax; "
            "[c.IsotonicRegression, c.save_calibrators, c.load_calibrators, i.InferImages.run, "
            "i.consistency_check, v.Validator.run, m.Calibrate.run]; "
            "print('\\n'.join(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PORT.parent, check=True).stdout.split()
    for module in ("torch", "scipy.stats", "udal_tpu_torch.apps.calibration",
                   "udal_tpu_torch.apps.thresholding", "udal_tpu_torch.apps.uncertainty_analysis",
                   "udal_tpu_torch.data.label_maps"):
        assert module in out
    assert [m for m in out if _forbidden(m)] == []


def test_reader_cli_and_evaluation_import_nothing_the_card_machine_lacks():
    """The reader (TFRecords, the tf.Example codec, the image codec, the
    resize, worker processes, composition, the dataset writers, synthetic
    TFRecords), COCO evaluation, the callback, the YAML reader, the CLI and
    the runner load with none of JAX, flax, yaml, the JAX package, sklearn,
    cv2, PIL or matplotlib."""
    code = ("import sys, udal_tpu_torch.data.tfrecord, udal_tpu_torch.data.example_codec, "
            "udal_tpu_torch.data.image_codec as ic, udal_tpu_torch.data.host_io, "
            "udal_tpu_torch.data.dataloader as d, udal_tpu_torch.data.mp_loader, "
            "udal_tpu_torch.data.composition, udal_tpu_torch.data.dataset_creators, "
            "udal_tpu_torch.data.synthetic as s, udal_tpu_torch.eval.coco, "
            "udal_tpu_torch.train.callbacks, udal_tpu_torch.train.runner, "
            "udal_tpu_torch.cli as cli; "
            "from udal_tpu_torch.config import load_yaml, parse_yaml; "
            "from udal_tpu_torch.ops.image_ops import resize_bilinear_uint8; "
            "[d.InputReader, ic.decode_image, ic.encode_png, s.write_synthetic_dataset, "
            "cli.build_parser(), cli.main]; "
            "print('\\n'.join(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PORT.parent, check=True).stdout.split()
    for module in ("torch", "zlib", "udal_tpu_torch.data.image_codec",
                   "udal_tpu_torch.data.dataloader", "udal_tpu_torch.eval.coco",
                   "udal_tpu_torch.train.callbacks", "udal_tpu_torch.cli"):
        assert module in out
    assert [m for m in out if _forbidden(m)] == []


def test_augmentation_active_and_semi_supervised_learning_import_nothing_the_card_lacks():
    """The cv2 replacements, the augmentations and policies, the AL loop,
    scoring, runner and set similarity, STAC / CSD, their runner and
    helpers, and the Validator's augmented serves load with none of JAX,
    flax, yaml, the JAX package, sklearn, cv2, PIL or matplotlib."""
    code = ("import sys, udal_tpu_torch.ops.cv_ops as cv, udal_tpu_torch.data.augment as a, "
            "udal_tpu_torch.data.autoaugment as aa, udal_tpu_torch.apps.active_learning as al, "
            "udal_tpu_torch.apps.al_scoring as als, udal_tpu_torch.apps.al_runner as alr, "
            "udal_tpu_torch.apps.al_eval as ale, udal_tpu_torch.apps.ssl as ssl, "
            "udal_tpu_torch.apps.ssl_utils as su, udal_tpu_torch.apps.ssl_runner as sr, "
            "udal_tpu_torch.apps.validate as v, udal_tpu_torch.cli as cli; "
            "[cv.clahe, cv.lab_to_rgb, a.AugmentVariants, a.apply_policy, aa.apply_op, "
            "al.ActiveLearning.run, al.phash, als.collect_pool, alr.run_al, ale.Similarity, "
            "ssl.STAC.run, ssl.CSD.run, su.rcc_collage, sr.run_stac, sr.run_csd, "
            "v.Validator._augment_variants, cli.cmd_al, cli.cmd_ssl]; "
            "print('\\n'.join(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PORT.parent, check=True).stdout.split()
    for module in ("torch", "scipy.fft", "scipy.stats", "udal_tpu_torch.ops.cv_ops",
                   "udal_tpu_torch.data.autoaugment", "udal_tpu_torch.apps.ssl_runner"):
        assert module in out
    assert [m for m in out if _forbidden(m) or m.startswith("tensorflow")] == []


def test_image_artifacts_and_profiling_import_nothing_the_card_lacks():
    """The drawing (``cv_ops``' rectangle, text size and text, the glyph
    table, ``visualize``), the
    figures' numbers, the GT plots, profiling and the apps that write
    their artifacts load with none of JAX, flax, yaml, the JAX package,
    sklearn, cv2, PIL or matplotlib."""
    code = ("import sys, udal_tpu_torch.utils.visualize as vis, "
            "udal_tpu_torch.utils.uncert_plots as up, udal_tpu_torch.utils.profiling as prof, "
            "udal_tpu_torch.data.plot_gt as pg, udal_tpu_torch.ops.text_metrics, "
            "udal_tpu_torch.ops.text_glyphs as tg, "
            "udal_tpu_torch.apps.infer as i, udal_tpu_torch.apps.uncertainty_analysis as ua, "
            "udal_tpu_torch.train.callbacks as cb; "
            "from udal_tpu_torch.ops.cv_ops import rectangle, get_text_size, put_text, "
            "gaussian_blur_f64; tg.coverage(0.4); "
            "[vis.visualize_boxes_and_labels, vis.overlay_panels, vis.contact_sheet, "
            "vis.draw_detection_grid, up.reliability_diagram, up.brisque_like_score, "
            "up.top10_panel, prof.trace, prof.device_memory_stats, pg.plot_tfrecord_groundtruth, "
            "i.InferImages._save_overlay, ua.export_quadrant_crops, cb.COCOCallback.nms_grid]; "
            "print('\\n'.join(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PORT.parent, check=True).stdout.split()
    for module in ("torch", "udal_tpu_torch.utils.visualize",
                   "udal_tpu_torch.utils.uncert_plots", "udal_tpu_torch.utils.profiling",
                   "udal_tpu_torch.data.plot_gt", "udal_tpu_torch.ops.text_metrics",
                   "udal_tpu_torch.ops.text_glyphs"):
        assert module in out
    assert [m for m in out if _forbidden(m) or m.startswith("tensorflow")] == []


def test_parallel_modules_import_nothing_the_card_lacks():
    """The mesh, its collectives, tensor parallelism and the dry run, with
    the entries that reach them (the sharded serves, the multi-process CLI),
    load with none of JAX, flax, yaml, the JAX package, sklearn, cv2, PIL
    or matplotlib."""
    code = ("import sys, udal_tpu_torch.parallel.mesh as m, "
            "udal_tpu_torch.parallel.collectives as c, "
            "udal_tpu_torch.parallel.tensor_parallel as tp, "
            "udal_tpu_torch.parallel.dryrun as d, udal_tpu_torch.apps.serving as s, "
            "udal_tpu_torch.cli as cli; "
            "[m.initialize_multihost, m.make_mesh, m.make_multihost_mesh, m.shard_batch, "
            "m.replicate_state, m.cross_replica_mean_groups, m.grouped_batch_stats, "
            "m.param_partition_spec, m.shard_params_tp, m.shard_opt_state_tp, "
            "m.shard_state_tp, c.all_reduce_sum, c.gather_replicated, c.copy_to_group, "
            "tp.TensorParallel, d.dryrun_multichip, d.spawn_world, "
            "s.ServingDriver.serve_sharded, s.ServingDriver.serve_sample_parallel]; "
            "print('\\n'.join(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PORT.parent, check=True).stdout.split()
    for module in ("torch", "torch.distributed", "udal_tpu_torch.parallel.mesh",
                   "udal_tpu_torch.parallel.tensor_parallel", "udal_tpu_torch.parallel.dryrun"):
        assert module in out
    assert [m for m in out if _forbidden(m) or m.startswith("tensorflow")] == []


def test_packed_microbench_imports_no_jax_or_the_jax_script():
    """The port's packed-layout tool runs on the machine with the card."""
    code = ("import sys, udal_tpu_torch.tools.perf_packed, udal_tpu_torch.ops.packed; "
            "print('\\n'.join(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PORT.parent, check=True).stdout.split()
    assert "torch" in out and "udal_tpu_torch.ops.packed" in out
    assert [m for m in out if _forbidden(m) or m in ("perf_packed", "tools.perf_packed")] == []


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")), ids=lambda p: p.name)
def test_no_port_module_imports_jax_or_flax(path):
    tree = ast.parse(path.read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert [m for m in names if _forbidden(m)] == []
