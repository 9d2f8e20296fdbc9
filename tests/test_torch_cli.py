"""The port's CLI, training runner and YAML reader against the JAX
package's, on the CPU at a small size (d0 at 64x64, one BiFPN cell and one
head repeat: the test config of ``tests/test_torch_train_*.py``).

- ``cli train`` for 2 epochs of 2 steps with ``map_freq=1`` on a synthetic
  PNG TFRecord writes the checkpoints, ``config.yaml`` (read back by the
  port's reader and by ``yaml.safe_load``), the COCO panels as JSON, and
  records an AP in [0, 1] each epoch.
- ``cli eval`` of weights from a JAX train state (orbax for the JAX CLI,
  converted into the port's checkpoint) gives the JAX ``cli eval``'s
  numbers, AP and ECE included, to 1e-4, dropout off, on a TFRecord whose
  groundtruth is planted on the detections; each batch's groundtruth
  and detections (as matched sets) are held to JAX's too.
- ``inspect --mode validate`` / ``calibrate`` run from the checkpoint.
- ``run_from_ini(dry_run=True)`` gives the JAX runner's argv.
- The port's YAML reader equals ``yaml.safe_load`` on every file under
  ``configs/`` (values and types).
- Each flag and default of the JAX CLI's commands is the port's; the
  commands and flags not ported exit naming why.
"""

import glob
import json
import math
import os
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")

import jax  # noqa: E402

from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from udal_tpu import cli as jax_cli  # noqa: E402
from udal_tpu.config import get_detection_config as jax_config  # noqa: E402
from udal_tpu.eval.coco import COCOEvaluator as JaxCOCOEvaluator  # noqa: E402
from udal_tpu.train import runner as jax_runner  # noqa: E402
from udal_tpu.train.train_lib import create_train_state as jax_create_state  # noqa: E402
from udal_tpu.utils import checkpoint as jax_checkpoint  # noqa: E402
from udal_tpu_torch import cli  # noqa: E402
from udal_tpu_torch.config import get_detection_config, load_yaml  # noqa: E402
from udal_tpu_torch.convert import flax_to_torch  # noqa: E402
from udal_tpu_torch.data.example_codec import parse_example  # noqa: E402
from udal_tpu_torch.data.image_codec import decode_image  # noqa: E402
from udal_tpu_torch.data.synthetic import make_example, write_synthetic_dataset  # noqa: E402
from udal_tpu_torch.data.tfrecord import TFRecordWriter, iterate_tfrecord  # noqa: E402
from udal_tpu_torch.eval.coco import COCOEvaluator  # noqa: E402
from udal_tpu_torch.train import runner  # noqa: E402
from udal_tpu_torch.train.train_lib import create_train_state  # noqa: E402
from udal_tpu_torch.utils.checkpoint import latest_checkpoint, save_checkpoint  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
HPARAMS = ("image_size=64x64,num_classes=8,fpn_cell_repeats=1,box_class_repeats=1,"
           "loss_attenuation=True,mc_dropout=False,map_freq=1,label_map=kitti")


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    train, val = str(d / "train.tfrecord"), str(d / "val.tfrecord")
    write_synthetic_dataset(train, num_images=8, height=48, width=80, num_classes=7, seed=0)
    write_synthetic_dataset(val, num_images=4, height=48, width=80, num_classes=7, seed=1)
    return train, val


@pytest.fixture(scope="module")
def trained(records, tmp_path_factory):
    model_dir = str(tmp_path_factory.mktemp("model"))
    history = cli.main(["train", "--train_file_pattern", records[0], "--val_file_pattern",
                        records[1], "--model_dir", model_dir, "--batch_size", "2",
                        "--num_epochs", "2", "--steps_per_epoch", "2", "--eval_samples", "4",
                        "--hparams", HPARAMS, "--device", "cpu"])
    return model_dir, history


def test_cli_train_writes_checkpoints_config_and_an_ap(trained):
    model_dir, history = trained
    assert latest_checkpoint(model_dir) == 2
    assert len(history["loss"]) == len(history["val_loss"]) == len(history["AP"]) == 2
    assert all(0.0 <= ap <= 1.0 and math.isfinite(ap) for ap in history["AP"])
    assert 0.0 <= history["input_wait"]["wait_fraction"] <= 1.0
    saved = load_yaml(os.path.join(model_dir, "config.yaml"))
    assert saved == yaml.safe_load(open(os.path.join(model_dir, "config.yaml")))
    want = get_detection_config("efficientdet-d0").override(HPARAMS)
    assert saved["image_size"] == want.image_size and saved["map_freq"] == 1
    assert saved["batch_size"] == 2 and saved["num_epochs"] == 2
    logs = os.path.join(model_dir, "logs")
    rows = [json.loads(line) for line in open(os.path.join(logs, "metrics.jsonl"))]
    assert [r["AP"] for r in rows if "AP" in r] == history["AP"]
    for tag in ("ap_vs_iou", "confusion_matrix"):
        panel = json.load(open(os.path.join(logs, "panels", f"{tag}_epoch2.json")))
        assert panel
    assert len(json.load(open(os.path.join(logs, "panels", "ap_vs_iou_epoch1.json")))) == 19


def test_cli_train_writes_the_nms_grid_panel(trained):
    """Each evaluation's grid of detections over 3 x 3 (NMS IoU, score)
    thresholds on the first validation image, at the network's size."""
    from udal_tpu_torch.config import parse_image_size
    from udal_tpu_torch.data.image_codec import decode_image

    model_dir, _ = trained
    h, w = parse_image_size(get_detection_config("efficientdet-d0").override(HPARAMS).image_size)
    for epoch in (1, 2):
        path = os.path.join(model_dir, "logs", "panels", f"nms_grid_epoch{epoch}.png")
        grid = decode_image(open(path, "rb").read())
        assert grid.shape == (3 * h, 3 * w, 3)
        cells = grid.reshape(3, h, 3, w, 3).transpose(0, 2, 1, 3, 4).reshape(9, h, w, 3)
        assert all(c.std() > 0 for c in cells)


def test_inspect_validate_and_calibrate_from_the_checkpoint(trained, records, tmp_path):
    model_dir, _ = trained
    common = ["--model_dir", model_dir, "--val_file_pattern", records[1], "--batch_size", "2",
              "--hparams", HPARAMS, "--device", "cpu"]
    rows = cli.main(["inspect", "--mode", "validate", "--output_dir", str(tmp_path / "v"),
                     *common])
    assert isinstance(rows, list) and os.path.exists(tmp_path / "v" / "validate_results.txt")
    cli.main(["inspect", "--mode", "calibrate", "--output_dir", str(tmp_path / "c"),
              "--fast_input", *common])
    assert os.listdir(tmp_path / "c")


@pytest.mark.parametrize("reader", [[], ["--fast_input"], ["--fast_input", "--device_resize"]],
                         ids=["classic", "fast", "device_resize"])
def test_inspect_auto_label_saves_visualizations(trained, records, tmp_path, reader):
    """``inspect --mode auto-label --save_visualizations`` in each reader
    contract: three PNGs (the overlay, the aleatoric box σ and the entropy
    panels; the model has no MC dropout) for each image with detections,
    at the size of the pixels the batch carries (the network's, or the
    frame's with the device resize)."""
    from udal_tpu_torch.config import parse_image_size

    model_dir, _ = trained
    out = tmp_path / "auto"
    rows = cli.main(["inspect", "--mode", "auto-label", "--save_visualizations", "--output_dir",
                     str(out), "--model_dir", model_dir, "--val_file_pattern", records[1],
                     "--batch_size", "2", "--hparams", HPARAMS + ",enable_softmax=True",
                     "--device", "cpu", *reader])
    names = {os.path.splitext(r["image_name"])[0] for r in rows}
    pngs = sorted(p.name for p in (out / "visualizations").glob("*.png"))
    assert names and pngs == sorted(n + s + ".png" for n in names
                                    for s in ("", "_mean_albox", "_entropy"))
    h, w = (48, 80) if "--device_resize" in reader else parse_image_size(
        get_detection_config("efficientdet-d0").override(HPARAMS).image_size)
    shape = decode_image((out / "visualizations" / pngs[0]).read_bytes()).shape
    assert shape == (h, w, 3)


def _record_updates(monkeypatch, evaluator_cls):
    """Every (groundtruth, detections) batch that ``cli eval`` hands the
    COCO evaluator."""
    calls, update = [], evaluator_cls.update_state

    def recording(self, gt, det):
        calls.append((np.array(gt, np.float64), np.array(det, np.float64)))
        return update(self, gt, det)

    monkeypatch.setattr(evaluator_cls, "update_state", recording)
    return calls


def _plant_groundtruth(src: str, dst: str, detections, per_image: int = 3) -> None:
    """``src``'s images with each image's top detections (COCO rows in the
    image's own frame) as its groundtruth, so that the evaluation has hits."""
    rows = np.concatenate([d.reshape(-1, 7) for d in detections])
    with TFRecordWriter(dst) as writer:
        for i, record in enumerate(iterate_tfrecord(src)):
            image = decode_image(parse_example(record)["image/encoded"][0])
            h, w = image.shape[:2]
            mine = rows[(rows[:, 0] == i) & (rows[:, 5] > 0) & (rows[:, 6] > 0)]
            mine = mine[np.argsort(-mine[:, 5], kind="stable")][:per_image]
            x1, y1 = np.clip(mine[:, 1], 0, w - 2), np.clip(mine[:, 2], 0, h - 2)
            x2 = np.clip(mine[:, 1] + mine[:, 3], x1 + 1, w)
            y2 = np.clip(mine[:, 2] + mine[:, 4], y1 + 1, h)
            writer.write(make_example(image, np.stack([y1, x1, y2, x2], 1),
                                      mine[:, 6].astype(np.int64), str(i), f"{i}.png"))


def _coco_box_iou(a, b):
    """IoU of COCO [x, y, w, h] boxes a [N, 4] against b [M, 4]."""
    lo = np.maximum(a[:, None, :2], b[None, :, :2])
    hi = np.minimum(a[:, None, :2] + a[:, None, 2:], b[None, :, :2] + b[None, :, 2:])
    inter = np.prod(np.clip(hi - lo, 0, None), axis=-1)
    area = lambda x: x[:, 2] * x[:, 3]  # noqa: E731
    return inter / (area(a)[:, None] + area(b)[None, :] - inter)


# soft-NMS drops scores below 0.001: a detection whose score lies within
# the 1e-4 tolerance of that cut may be kept by one side only
_MATCHED_ABOVE = 0.001 + 1e-4


def _each_matched(a, b):
    """Each row of ``a`` (COCO rows of one image) scoring above
    ``_MATCHED_ABOVE`` pairs with its own row of ``b``: the same image and
    class, box IoU >= 0.99, score within 1e-4."""
    a = a[a[:, 5] > _MATCHED_ABOVE]
    assert len(a) > 0
    iou = _coco_box_iou(a[:, 1:5], b[:, 1:5])
    taken = np.zeros(len(b), bool)
    for i in range(len(a)):
        ok = ((iou[i] >= 0.99) & (np.abs(b[:, 5] - a[i, 5]) <= 1e-4)
              & (b[:, 6] == a[i, 6]) & (b[:, 0] == a[i, 0]) & ~taken)
        assert ok.any(), f"detection {a[i]} has no match"
        taken[np.argmax(ok)] = True


def _spread_class_logits(params, gain: float = 20.0):
    """The class predictor's kernel times ``gain`` and its bias 0. A fresh
    head puts every logit near the prior's -4.6 (scores near 0.01), where
    soft-NMS meets near-ties that either side may break its own way; spread
    over several units, the scores are far apart."""
    def spread(path, leaf):
        name = jax.tree_util.keystr(path)
        if "class-predict" not in name or "pointwise" not in name:
            return leaf
        return leaf * gain if name.endswith("['kernel']") else leaf * 0
    return jax.tree_util.tree_map_with_path(spread, params)


def test_cli_eval_equals_jax(records, tmp_path, monkeypatch):
    """The same weights (a JAX train state from PRNGKey(0), its class
    logits spread) evaluated by both CLIs over the same TFRecord, dropout
    off. The TFRecord's
    groundtruth is planted on each image's top detections, so that the
    COCO numbers are far from 0. Each batch's groundtruth, in the image's
    frame where ``cli eval`` scales it, within 1e-4; its detections as
    matched sets (each side's rows pair with the other's, ``_each_matched``);
    every number of the result within 1e-4, the AP at IoU 0.5 above 0.5."""
    jcfg = jax_config("efficientdet-d0").override(HPARAMS)
    _, state, _, _ = jax_create_state(jcfg, jax.random.PRNGKey(0), 1)
    state = state.replace(params=_spread_class_logits(state.params),
                          ema_params=_spread_class_logits(state.ema_params))
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_checkpoint.save_checkpoint(jax_dir, state, 1)
    pcfg = get_detection_config("efficientdet-d0").override(HPARAMS)
    pstate, _ = create_train_state(pcfg, 1, device="cpu",
                                   state_dict=flax_to_torch(state.params, state.batch_stats))
    save_checkpoint(port_dir, pstate, 1)
    args = ["--batch_size", "2", "--hparams", HPARAMS]
    port_calls = _record_updates(monkeypatch, COCOEvaluator)
    cli.main(["eval", "--model_dir", port_dir, "--device", "cpu",
              "--val_file_pattern", records[1], *args])
    planted = str(tmp_path / "planted.tfrecord")
    _plant_groundtruth(records[1], planted, [d for _, d in port_calls])
    port_calls.clear()
    jax_calls = _record_updates(monkeypatch, JaxCOCOEvaluator)
    args += ["--val_file_pattern", planted]
    want = jax_cli.main(["eval", "--model_dir", jax_dir, *args])
    got = cli.main(["eval", "--model_dir", port_dir, "--device", "cpu", *args])
    assert len(port_calls) == len(jax_calls) == 2
    for (g_gt, g_det), (w_gt, w_det) in zip(port_calls, jax_calls):
        np.testing.assert_allclose(g_gt, w_gt, rtol=0, atol=1e-4)
        for g, w in zip(g_det, w_det):
            _each_matched(w, g)
            _each_matched(g, w)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - float(want[k])) <= 1e-4, (k, got[k], want[k])
    assert float(want["AP50"]) > 0.5 and float(want["AP"]) > 0.1


def test_run_from_ini_dry_run_equals_jax():
    ini = str(ROOT / "configs/train/train_runner.ini")
    assert runner.run_from_ini(ini, dry_run=True) == jax_runner.run_from_ini(ini, dry_run=True)


@pytest.mark.parametrize("path", sorted(glob.glob(str(ROOT / "configs/**/*.yaml"),
                                             recursive=True)), ids=os.path.basename)
def test_yaml_reader_equals_safe_load(path):
    got, want = load_yaml(path), yaml.safe_load(open(path))
    assert got == want
    assert [type(v) for v in got.values()] == [type(v) for v in want.values()]


def test_parser_has_the_jax_flags_and_defaults():
    def options(parser):
        sub = next(a for a in parser._actions if a.dest == "command")
        return {name: {a.dest: a.default for a in sp._actions if a.dest != "help"}
                for name, sp in sub.choices.items()}

    got, want = options(cli.build_parser()), options(jax_cli.build_parser())
    assert got.keys() == want.keys()
    for name in want:
        extra = set(got[name]) - set(want[name])
        assert extra <= {"device", "fn"}, (name, extra)
        for dest, default in want[name].items():
            if dest != "fn":
                assert got[name][dest] == default, (name, dest)


@pytest.mark.parametrize("argv,match", [
    (["train", "--train_file_pattern", "x", "--tf_checkpoint", "ck"], "tf_checkpoint"),
    (["train", "--train_file_pattern", "x", "--compile_cache", "d"], "compile_cache"),
    # one process cannot hold a model group of two (torchrun launches more)
    (["train", "--train_file_pattern", "x", "--n_model", "2", "--device", "cpu"], "A11"),
    (["inspect", "--mode", "export"], "StableHLO"),
    (["inspect", "--mode", "video"], "cv2"),
    (["parity_kitti", "--val_tfrecord", "v", "--tf_checkpoint", "c"], "Not to port"),
])
def test_unported_commands_exit_naming_why(argv, match):
    with pytest.raises(SystemExit, match=match):
        cli.main(argv)


def test_stac_randaug_is_refused():
    """The name is kept from when the flag was refused: ``--stac_randaug``
    is ported (``tests/test_torch_ssl.py`` holds its batches to the JAX
    CLI's); a training reader with a policy it does not know still fails,
    naming the policy."""
    from udal_tpu_torch.data.augment import apply_policy

    args = cli.build_parser().parse_args(["train_ssl", "--train_file_pattern", "t",
                                          "--unlabeled_file_pattern", "u", "--stac_randaug"])
    assert args.stac_randaug and args.fn is cli.cmd_train_ssl
    with pytest.raises(ValueError, match="unknown policy 'v9'"):
        apply_policy("v9", np.zeros((4, 4, 3), np.uint8), np.zeros((0, 4)))
