"""The port's semi-supervised learning against ``udal_tpu.apps.ssl``,
``ssl_runner``, ``ssl_utils`` and the JAX CLI's ``train_ssl``, on the CPU.

* ``select_pseudo_labels`` for every strategy, the pseudo TFRecord (the
  same features; the images decode to the same pixels: the two PNG
  encoders differ in their bytes), ``split_labeled_unlabeled``, and the
  ``STAC`` / ``CSD`` orchestration with injected stages (the same calls,
  artifacts and retries).
* ROADMAP C11, second site: both runners give the student (and CSD's
  model) ``ssl_method`` in lower case, and ``compute_loss`` with it equals
  the plain detection loss on both sides (a stub network hands both
  packages the same outputs; the upper-case branch differs).
* ``train_ssl --stac_randaug``: the zipped batches (labelled + the
  RandAugmented unlabelled stream) equal the JAX CLI's.
* The ``ssl_utils`` helpers, and ``cli ssl`` end to end on the CPU.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import udal_tpu.apps.ssl as jax_ssl  # noqa: E402
import udal_tpu.apps.ssl_utils as jax_utils  # noqa: E402
from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from tests.test_torch_active_learning import rows_of  # noqa: E402
from udal_tpu.data.synthetic import write_synthetic_dataset as jax_write  # noqa: E402
from udal_tpu_torch import cli  # noqa: E402
from udal_tpu_torch.apps import ssl, ssl_utils  # noqa: E402
from udal_tpu_torch.apps.al_runner import PoolIndex  # noqa: E402
from udal_tpu_torch.data import example_codec as codec  # noqa: E402
from udal_tpu_torch.data import tfrecord as tfr  # noqa: E402
from udal_tpu_torch.data.image_codec import decode_image  # noqa: E402

TINY = "image_size=64x64,num_classes=3,fpn_cell_repeats=1,box_class_repeats=1"
STRATEGIES = ["score", "combo", "calib_combo", "alluncert", "calib_alluncert", "epuncert",
              "ental", "calib_ental"]


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("ssl")
    labeled, unlabeled = str(root / "labeled.tfrecord"), str(root / "unlabeled.tfrecord")
    jax_write(labeled, num_images=6, height=64, width=96, num_classes=3, seed=0)
    jax_write(unlabeled, num_images=6, height=64, width=96, num_classes=3, seed=1)
    return root, labeled, unlabeled


def records(path):
    """The parsed features of every record, images decoded."""
    out = []
    for rec in tfr.iterate_tfrecord(path):
        f = codec.parse_example(rec)
        f["image/encoded"] = decode_image(f["image/encoded"][0])
        out.append(f)
    return out


def assert_records_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if k == "image/encoded":
                np.testing.assert_array_equal(g[k], w[k])
            elif w[k] and isinstance(w[k][0], float):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-7, err_msg=k)
            else:
                assert g[k] == w[k], k


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_select_pseudo_labels_equal_jax(strategy):
    rows = rows_of(n_images=16, seed=7)
    for tau in (0.0, 0.3, 0.7):
        for thrs in (None, np.asarray([0.4, 0.6])):
            kw = dict(opt_thrs=thrs, opt_params=[0.3, 0.7], with_scores=True)
            got = ssl.select_pseudo_labels(rows, strategy, tau, **kw)
            want = jax_ssl.select_pseudo_labels(rows, strategy, tau, **kw)
            assert got[0] == want[0]
            for g, w in zip(got[1:], want[1:]):
                for a, b in zip(g, w):
                    np.testing.assert_array_equal(a, b)
    assert ssl.select_pseudo_labels([], "score", 0.5) == ([], [], [])


def _stages(log, rows, images):
    def train_fn(stage, pseudo_path, round_idx):
        log.append((stage, None if pseudo_path is None else os.path.basename(pseudo_path),
                    round_idx))

    def infer_fn(round_idx):
        return rows

    def images_fn(names):
        return {n: images[i % len(images)] for i, n in enumerate(names)}

    return train_fn, infer_fn, images_fn


@pytest.mark.parametrize("strategy,pseudoscore", [("score", True), ("combo", False),
                                                  ("alluncert", True)])
def test_stac_with_injected_stages_equals_jax(tmp_path, strategy, pseudoscore):
    rows = rows_of(n_images=8, seed=2)
    images = [np.random.RandomState(i).randint(0, 256, (40, 60, 3)).astype(np.uint8)
              for i in range(3)]
    out = {}
    for side, mod in (("port", ssl), ("jax", jax_ssl)):
        log = []
        train_fn, infer_fn, images_fn = _stages(log, rows, images)
        arts = mod.STAC(str(tmp_path / side), tau=0.2, selection_strategy=strategy,
                        activate_pseudoscore=pseudoscore, train_fn=train_fn,
                        infer_fn=infer_fn, images_fn=images_fn, opt_params=[0.5, 0.5],
                        selftrain_rounds=1).run()
        out[side] = ([os.path.basename(a) for a in arts], log, [records(a) for a in arts])
    assert out["port"][:2] == out["jax"][:2]
    for g, w in zip(out["port"][2], out["jax"][2]):
        assert_records_equal(g, w)
    for mod in (ssl, jax_ssl):
        stac = mod.STAC(str(tmp_path / "retry"), train_fn=lambda **kw: None,
                        train_done_fn=lambda stage, r: False, max_train_retries=2)
        with pytest.raises(RuntimeError, match="never produced a checkpoint"):
            stac.run()


def test_pseudo_tfrecord_and_splits_equal_jax(tmp_path, datasets):
    _, labeled, _ = datasets
    rng = np.random.RandomState(4)
    images = {f"u{i}.png": rng.randint(0, 256, (30, 50, 3)).astype(np.uint8) for i in range(3)}
    names = list(images)
    classes = [rng.randint(1, 4, 2) for _ in names]
    boxes = [rng.uniform(0, 30, (2, 4)).astype(np.float32) for _ in names]
    scores = [rng.uniform(0, 1, 2).astype(np.float32) for _ in names]
    for sc in (None, scores):
        got, want = str(tmp_path / "p.tfrecord"), str(tmp_path / "j.tfrecord")
        assert ssl.write_pseudo_tfrecord(got, images, names, classes, boxes, sc) == \
            jax_ssl.write_pseudo_tfrecord(want, images, names, classes, boxes, sc)
        assert_records_equal(records(got), records(want))
    recs = list(tfr.iterate_tfrecord(labeled))
    for ratio in (0.5, 0.34):
        p = [str(tmp_path / f"{s}_{ratio}.tfrecord") for s in ("pl", "pu", "jl", "ju")]
        assert ssl.split_labeled_unlabeled(recs, ratio, p[0], p[1], seed=3) == \
            jax_ssl.split_labeled_unlabeled(recs, ratio, p[2], p[3], seed=3)
        assert_records_equal(records(p[0]), records(p[2]))
        assert_records_equal(records(p[1]), records(p[3]))
    for side, mod in (("port", ssl), ("jax", jax_ssl)):
        calls = []
        mod.CSD(str(tmp_path / f"csd_{side}"), ratio=0.5, csd_ramp=True, csd_be=False,
                csd_be_thr=0.2, train_fn=lambda *a: calls.append(a)).run(recs)
        assert calls[0][2] == {"ssl_method": "CSD", "csd_ramp": True, "csd_BE": False,
                               "csd_BE_thr": 0.2}
    assert_records_equal(records(str(tmp_path / "csd_port" / "csd_unlabeled.tfrecord")),
                         records(str(tmp_path / "csd_jax" / "csd_unlabeled.tfrecord")))


class StubNet(torch.nn.Module):
    """Hands out fixed per-level outputs; one kernel for the L2 term."""

    def __init__(self, cls_out, box_out, kernel):
        super().__init__()
        self.kernel = torch.nn.Parameter(torch.from_numpy(kernel))
        self.outs = ([torch.from_numpy(c) for c in cls_out], [torch.from_numpy(b) for b in box_out])

    def forward(self, images, masks=None):
        return self.outs


class JaxStub:
    def __init__(self, cls_out, box_out):
        self.outs = ([jnp.asarray(c) for c in cls_out], [jnp.asarray(b) for b in box_out])

    def apply(self, variables, images, train, mutable, rngs):
        return self.outs, {"batch_stats": variables["batch_stats"]}


def test_c11_runners_train_the_student_with_the_plain_loss(tmp_path, datasets, monkeypatch):
    """Both runners hand the student (and CSD's model) a lower-case
    ``ssl_method``; with it ``compute_loss`` is the plain loss on both
    sides, and the upper-case STAC branch is not."""
    import udal_tpu.apps.ssl_runner as jax_runner
    import udal_tpu.train.loop as jax_loop
    import udal_tpu.train.train_lib as jax_lib
    import udal_tpu_torch.apps.ssl_runner as port_runner
    from udal_tpu.data.dataloader import InputReader as JaxReader
    from udal_tpu_torch.config import get_detection_config
    from udal_tpu_torch.train import train_lib

    _, labeled, unlabeled = datasets
    seen = {"port": [], "jax": []}

    def capture(side):
        def fake(config, it, steps, model_dir, **kw):
            seen[side].append(config.get("ssl_method"))
            os.makedirs(model_dir, exist_ok=True)
        return fake

    monkeypatch.setattr(port_runner, "_train_once",
                        lambda config, *a: capture("port")(config, None, 0, a[2]))
    monkeypatch.setattr(jax_loop, "train_and_evaluate", capture("jax"))
    monkeypatch.setattr(port_runner, "checkpoint_state_dict", _no_weights)
    import udal_tpu_torch.apps.infer as port_infer
    import udal_tpu.apps.infer as jax_infer
    monkeypatch.setattr(port_infer.InferImages, "run", lambda self, it: [])
    monkeypatch.setattr(jax_infer.InferImages, "run", lambda self, it: [])
    monkeypatch.setattr(jax_runner, "ServingDriver", _NoDriver, raising=False)
    import udal_tpu.apps.serving as jax_serving
    monkeypatch.setattr(jax_serving, "ServingDriver", _NoDriver)
    import udal_tpu_torch.apps.serving as port_serving
    monkeypatch.setattr(port_serving, "ServingDriver", _NoDriver)
    import udal_tpu.train.train_lib as jtl
    monkeypatch.setattr(jtl, "create_train_state", lambda *a, **k: (None, None, None, None))
    import udal_tpu.utils.checkpoint as jck
    monkeypatch.setattr(jck, "restore_checkpoint", lambda d, s: (s, 0))
    monkeypatch.setattr(jck, "swap_in_ema", lambda s: s)
    argv = ["ssl", "--train_file_pattern", labeled, "--unlabeled_file_pattern", unlabeled,
            "--batch_size", "2", "--num_epochs", "1", "--steps_per_epoch", "1",
            "--hparams", TINY]
    import udal_tpu.cli as jax_cli
    for method in ("stac", "csd"):
        cli.main(argv + ["--method", method, "--work_dir", str(tmp_path / f"p{method}"),
                         "--device", "cpu"])
        jax_cli.main(argv + ["--method", method, "--work_dir", str(tmp_path / f"j{method}")])
    assert seen["port"] == seen["jax"] == [None, "stac", "csd"]

    # the loss with the runners' lower-case method against the plain loss
    cfg = get_detection_config("efficientdet-d0")
    cfg.override(TINY + ",loss_attenuation=true")
    reader = JaxReader(labeled, is_training=False, seed=0)
    from udal_tpu.config import get_detection_config as jax_config
    jcfg = jax_config("efficientdet-d0").override(TINY + ",loss_attenuation=true")
    with jax.disable_jit():
        images, labels = next(iter(reader(jcfg, 2)))
    labels = {k: np.array(v) for k, v in labels.items() if not isinstance(v, list)}
    rng = np.random.RandomState(5)
    a = cfg.num_scales * len(cfg.aspect_ratios)
    sizes = [-(-64 // 2 ** level) for level in range(cfg.min_level, cfg.max_level + 1)]
    cls_out = [rng.randn(2, s, s, a * 3).astype(np.float32) for s in sizes]
    box_out = [rng.randn(2, s, s, a * 8).astype(np.float32) * 0.1 for s in sizes]
    kernel = rng.randn(3, 3).astype(np.float32)
    totals = {}
    for method in (None, "stac", "STAC"):
        extra = {"ssl_method": method, "unlabeled_start": 1, "stac_lambda": 0.5}
        pc, jc = cfg.copy(), jax_config("efficientdet-d0").override(TINY + ",loss_attenuation=true")
        pc.override(extra, allow_new_keys=True)
        jc.override(extra, allow_new_keys=True)
        port_total, _ = train_lib.compute_loss(
            pc, StubNet(cls_out, box_out, kernel), torch.from_numpy(np.asarray(images)),
            {k: torch.from_numpy(v) for k, v in labels.items()}, None, 0, 1)
        jax_total = jax.jit(lambda params, im, lab, jc=jc: jax_lib.compute_loss(
            jc, JaxStub(cls_out, box_out), params, {}, im, lab, jax.random.PRNGKey(0),
            jnp.asarray(0), 1)[0])({"kernel": jnp.asarray(kernel)}, jnp.asarray(images),
                                   {k: jnp.asarray(v) for k, v in labels.items()})
        totals[method] = (float(port_total.detach()), float(jax_total))
        np.testing.assert_allclose(totals[method][0], totals[method][1], rtol=1e-5)
    assert totals["stac"] == totals[None]
    assert totals["STAC"][0] != totals[None][0] and totals["STAC"][1] != totals[None][1]


class _NoDriver:
    def __init__(self, config, *a, **k):
        self.config = config


def _no_weights(config, model_dir):
    return {}


def test_train_ssl_stac_randaug_stream_equals_jax(datasets, tmp_path, monkeypatch):
    """The name is kept from when the flag was refused: ``--stac_randaug``
    now RandAugments the unlabelled stream, and the zipped batches equal
    the JAX CLI's (uint8 contract: bit for bit)."""
    import udal_tpu.cli as jax_cli
    import udal_tpu.train.loop as jax_loop
    import udal_tpu_torch.train.loop as port_loop

    _, labeled, unlabeled = datasets
    got = {}

    def capture(side):
        def fake(config, it, steps, model_dir, **kw):
            got[side] = (config, [next(it) for _ in range(3)])
            return {}
        return fake

    monkeypatch.setattr(port_loop, "train_and_evaluate", capture("port"))
    monkeypatch.setattr(jax_loop, "train_and_evaluate", capture("jax"))
    argv = ["train_ssl", "--train_file_pattern", labeled, "--unlabeled_file_pattern", unlabeled,
            "--batch_size", "4", "--ratio", "0.5", "--stac_randaug", "--fast_input",
            "--steps_per_epoch", "1", "--hparams", TINY]
    cli.main(argv + ["--model_dir", str(tmp_path / "p"), "--device", "cpu"])
    with jax.disable_jit():
        jax_cli.main(argv + ["--model_dir", str(tmp_path / "j")])
    assert got["port"][0].ssl_method == got["jax"][0].ssl_method == "stac"
    assert got["port"][0].unlabeled_start == got["jax"][0].unlabeled_start == 2
    for (pi, pl), (ji, jl) in zip(got["port"][1], got["jax"][1]):
        np.testing.assert_array_equal(pi, np.asarray(ji))
        for k in jl:
            if isinstance(jl[k], list):
                assert pl[k] == jl[k], k
            else:
                np.testing.assert_allclose(pl[k], np.asarray(jl[k]), rtol=0, atol=1e-5,
                                           err_msg=k)


def test_ssl_utils_equal_jax():
    rng = np.random.RandomState(3)
    counts = {1: 120, 2: 14, 3: 1, 4: 33}
    w = ssl_utils.class_distribution_weights(counts, 1.0, 10.0)
    assert w == jax_utils.class_distribution_weights(counts, 1.0, 10.0)
    per_image = [list(rng.randint(1, 5, rng.randint(1, 4))) for _ in range(12)]
    names = [f"i{k}" for k in range(12)]
    np.testing.assert_array_equal(ssl_utils.image_class_scores(per_image, w),
                                  jax_utils.image_class_scores(per_image, w))
    assert ssl_utils.rcf_curriculum_split(names, per_image, w, 0.3) == \
        jax_utils.rcf_curriculum_split(names, per_image, w, 0.3)
    det_scores = [list(rng.uniform(0, 1, len(c))) for c in per_image]
    s = ssl_utils.pls_image_scores(det_scores, per_image, w, 0.4)
    np.testing.assert_array_equal(s, jax_utils.pls_image_scores(det_scores, per_image, w, 0.4))
    for mode in ("top", "bottom", "random"):
        assert ssl_utils.pls_split(names, s, 0.25, mode, np.random.RandomState(1)) == \
            jax_utils.pls_split(names, s, 0.25, mode, np.random.RandomState(1))
    gt = np.asarray([[0, 0, 10, 10], [20, 20, 40, 40], [50, 50, 60, 70]], np.float64)
    gc = np.asarray([1, 2, 3])
    pb = np.asarray([[1, 1, 10, 10], [70, 70, 90, 90], [21, 20, 40, 41]], np.float64)
    pc, ps, pcons = np.asarray([1, 2, 2]), np.asarray([0.9, 0.8, 0.3]), np.asarray([0.95, 0.99, 0.9])
    for mode in ("md", "mistakes", "noisy"):
        for got, want in zip(ssl_utils.glc_clean_labels(gt, gc, pb, pc, ps, pcons, mode),
                             jax_utils.glc_clean_labels(gt, gc, pb, pc, ps, pcons, mode)):
            np.testing.assert_array_equal(got, want)
    for kw in (dict(drop_fraction=0.3), dict(box_noise_fraction=0.5),
               dict(class_mistake_fraction=0.5, drop_fraction=0.2)):
        for got, want in zip(
                ssl_utils.inject_label_faults(gt, gc, 3, rng=np.random.RandomState(2), **kw),
                jax_utils.inject_label_faults(gt, gc, 3, rng=np.random.RandomState(2), **kw)):
            np.testing.assert_array_equal(got, want)
    bg = rng.randint(0, 256, (80, 120, 3)).astype(np.uint8)
    crops = [(rng.randint(0, 256, (17, 23, 3)).astype(np.uint8), 2),
             (rng.randint(0, 256, (30, 12, 3)).astype(np.uint8), 3)]
    for got, want in zip(ssl_utils.rcc_collage(bg, crops, np.random.RandomState(6)),
                         jax_utils.rcc_collage(bg, crops, np.random.RandomState(6))):
        np.testing.assert_array_equal(got, want)
    for (g, gcls), (w_, wcls) in zip(
            ssl_utils.augment_collage_crops(crops, np.random.RandomState(8)),
            jax_utils.augment_collage_crops(crops, np.random.RandomState(8))):
        np.testing.assert_array_equal(g, w_)
        assert gcls == wcls
    gt_imgs = [(gt, gc), (gt[:1], gc[:1]), (np.zeros((0, 4)), np.zeros(0))]
    pseudo = [(pb, pc), (np.zeros((0, 4)), np.zeros(0)), (pb[:1], pc[:1])]
    got = ssl_utils.pseudo_vs_gt_analysis(gt_imgs, pseudo)
    want = jax_utils.pseudo_vs_gt_analysis(gt_imgs, pseudo)
    assert got.keys() == want.keys()
    np.testing.assert_allclose([got["md_rate"], got["fd_rate"]], [want["md_rate"], want["fd_rate"]])
    for c in want["per_class"]:
        for k, v in want["per_class"][c].items():
            np.testing.assert_allclose(got["per_class"][c][k], v, rtol=1e-6, err_msg=f"{c} {k}")


def test_cli_ssl_runs_on_the_cpu(tmp_path, datasets):
    """STAC (teacher, pseudo-labels through InferImages, student on zipped
    RandAugmented batches) and CSD through the port's CLI at 64x64."""
    _, labeled, unlabeled = datasets
    argv = ["ssl", "--train_file_pattern", labeled, "--unlabeled_file_pattern", unlabeled,
            "--batch_size", "2", "--num_epochs", "1", "--steps_per_epoch", "1", "--device",
            "cpu", "--hparams", TINY]
    work = tmp_path / "stac"
    arts = cli.main(argv + ["--method", "stac", "--work_dir", str(work), "--tau", "0.0",
                            "--pseudoscore", "--stac_randaug"])
    assert arts == [str(work / "pseudo_round0.tfrecord")]
    for d in ("teacher", "student_r0"):
        assert os.path.exists(work / d / "model" / "ckpt_1" / "state.pt")
    recs = records(arts[0])
    assert recs and all(r["image/object/pseudo_score"] for r in recs)
    assert not any(r["image/filename"][0].startswith(b"__pad") for r in recs)
    assert set(PoolIndex(arts[0]).names) <= set(PoolIndex(unlabeled).names)
    model_dir = cli.main(argv + ["--method", "csd", "--work_dir", str(tmp_path / "csd"),
                                 "--csd_ramp"])
    assert os.path.exists(os.path.join(model_dir, "ckpt_1", "state.pt"))
