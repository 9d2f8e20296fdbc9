"""The port's active learning against ``udal_tpu.apps.active_learning``,
``al_scoring`` and ``al_runner``, on the CPU.

* Scoring and selection on the same dict rows and their packed pool, for
  every strategy of the grammar (with and without ``calib``): scores to
  1e-12 relative, selections name for name; random selections from the
  same seed.
* ``collect_pool`` over the JAX and the port's drivers with the same
  weights (the test configuration of ``test_torch_fixtures.py``, f32,
  deterministic) on the same reader batches with ``__pad`` rows: the same
  images, detections as matched sets (each of the port's valid detections
  has one of JAX's with IoU ≥ 0.99 and its score within 1e-4), then the
  same selections for every strategy.
* pHash and wHash bit for bit on decoded pool images (the JAX package's
  cv2 INTER_AREA against the port's), ``prune_pool`` and ``PoolIndex``.
* ``cli al --strategy random`` with tiny budgets: the port's whole CLI
  (training on the CPU) against the JAX CLI, whose training is replaced by
  a stub: a random selection never reads the model, and compiling JAX's
  training step would cost a minute. The ``selected.txt`` files are equal
  name for name, and a rerun resumes with the same selection.
* The loop with injected stages on both sides: equal artifacts.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import udal_tpu.apps.active_learning as jax_al  # noqa: E402
import udal_tpu.apps.al_runner as jax_runner  # noqa: E402
import udal_tpu.apps.al_scoring as jax_als  # noqa: E402
import udal_tpu.apps.serving as jax_serving  # noqa: E402
from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from tests.test_torch_fixtures import configs, random_variables  # noqa: E402
from udal_tpu.data.synthetic import write_synthetic_dataset as jax_write  # noqa: E402
from udal_tpu_torch import cli  # noqa: E402
from udal_tpu_torch.apps import active_learning as al  # noqa: E402
from udal_tpu_torch.apps import al_runner  # noqa: E402
from udal_tpu_torch.apps import al_scoring as als  # noqa: E402
from udal_tpu_torch.apps.serving import ServingDriver  # noqa: E402
from udal_tpu_torch.convert import flax_to_torch  # noqa: E402
from udal_tpu_torch.ops.boxes import pairwise_iou  # noqa: E402

STRATEGIES = ["random", "entropy", "mean_entropy", "norm_mcbox", "norm_albox", "mcclass",
              "mean_mcbox", "combo", "mean_combo", "ental", "alluncert", "mean_epuncert",
              "sota", "alluncert_highep_lowal", "perc_entropy", "bottomk_entropy",
              "nee_entropy", "det_score"]
CALIB = ["calib_combo", "calib_ental", "calib_alluncert", "calib_mean_epuncert", "calib_sota",
         "calib_entropy", "calib_norm_albox"]


def rows_of(n_images=24, seed=0, n_classes=4):
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n_images):
        for _ in range(int(rng.randint(1, 7))):
            y1, x1 = rng.uniform(0, 100, 2)
            h, w = rng.uniform(10, 80, 2)
            logits = rng.randn(n_classes) * 2
            p = np.exp(logits - logits.max())
            p = p / p.sum()
            rows.append({
                "image_name": f"img{i:03d}.png", "det_score": float(rng.uniform(0.05, 1.0)),
                "bbox": [float(y1), float(x1), float(y1 + h), float(x1 + w)],
                "class": float(rng.randint(1, n_classes + 1)),
                "entropy": float(-np.sum(p * np.log(p))),
                "logits": [float(x) for x in logits], "probab": [float(x) for x in p],
                "uncalib_albox": list(rng.gamma(2, 0.5, 4)),
                "uncalib_mcbox": list(rng.gamma(2, 0.5, 4)),
                "uncalib_mcclass": list(rng.gamma(2, 0.2, n_classes)),
                "iso_perclscoo_albox": list(rng.gamma(2, 0.4, 4)),
                "iso_perclscoo_mcbox": list(rng.gamma(2, 0.4, 4)),
                "iso_percls_entropy": float(rng.gamma(2, 0.2)),
                "iso_percls_mcclass": list(rng.gamma(2, 0.2, n_classes)),
            })
    return rows


@pytest.mark.parametrize("strategy", STRATEGIES + CALIB)
def test_scoring_and_selection_equal_jax(strategy):
    rows = rows_of(seed=3)
    pool, jpool = als.pool_from_rows(rows), jax_als.pool_from_rows(rows)
    if strategy != "random":
        got = al.score_images(rows, strategy, opt_params=[0.4, 0.6])
        want = jax_al.score_images(rows, strategy, opt_params=[0.4, 0.6])
        assert got[2] == want[2]
        np.testing.assert_allclose(got[0], want[0], rtol=1e-12, atol=1e-15)
        got = als.score_pool(pool, strategy, opt_params=[0.4, 0.6])
        want = jax_als.score_pool(jpool, strategy, opt_params=[0.4, 0.6])
        np.testing.assert_allclose(got[0], want[0], rtol=1e-12, atol=1e-15)
    for k in (1, 7, 12):
        kw = dict(opt_params=[0.4, 0.6])
        assert al.select_images(rows, strategy, k, rng=np.random.RandomState(1), **kw) == \
            jax_al.select_images(rows, strategy, k, rng=np.random.RandomState(1), **kw)
        assert als.select_pool(pool, strategy, k, rng=np.random.RandomState(1), **kw) == \
            jax_als.select_pool(jpool, strategy, k, rng=np.random.RandomState(1), **kw)


def test_scalers_and_subset_pool_equal_jax():
    x = np.random.RandomState(0).randn(17)
    np.testing.assert_array_equal(al.min_max_scaler(x), jax_al.min_max_scaler(x))
    np.testing.assert_array_equal(al.z_score_normalization(x), jax_al.z_score_normalization(x))
    np.testing.assert_array_equal(al.min_max_scaler(np.ones(3)), np.zeros(3))
    rows = rows_of(seed=5)
    keep = [f"img{i:03d}.png" for i in range(0, 24, 3)]
    got = als.subset_pool(als.pool_from_rows(rows), keep)
    want = jax_als.subset_pool(jax_als.pool_from_rows(rows), keep)
    assert got.names == want.names
    for k in want.feats:
        np.testing.assert_array_equal(got.feats[k], want.feats[k])


@pytest.fixture(scope="module")
def pool_file(tmp_path_factory):
    root = tmp_path_factory.mktemp("al_pool")
    path = str(root / "pool.tfrecord")
    jax_write(path, num_images=10, height=64, width=96, num_classes=3, seed=0)
    return root, path


def test_collect_pool_matches_jax_driver(pool_file):
    """The two drivers over the same classic reader batches (10 images,
    batches of 4, the last padded with __pad rows): the same image names,
    the detections as matched sets, the same selections."""
    from udal_tpu.data.dataloader import InputReader as JaxReader
    from udal_tpu_torch.data.dataloader import InputReader

    root, path = pool_file
    jax_cfg, torch_cfg = configs(extra=dict(enable_softmax=True))
    variables = random_variables(jax_cfg, seed=2)
    jax_drv = jax_serving.ServingDriver(jax_cfg, variables, 4, use_pallas_nms=False)
    drv = ServingDriver(torch_cfg, flax_to_torch(variables["params"], variables["batch_stats"]),
                        4, device="cpu")
    padded = str(root / "padded.tfrecord")
    al_runner.PoolIndex(path).write_subset(al_runner.PoolIndex(path).names, padded,
                                           pad_multiple=4)

    def batches(reader_cls, cfg):
        it = reader_cls(padded, is_training=False, names=True, seed=0)(cfg, 4)
        return ((im, lab["image_names"], lab["image_scales"]) for im, lab in it)

    got = als.collect_pool(drv, batches(InputReader, torch_cfg), inflight=2)
    want = jax_als.collect_pool(jax_drv, batches(JaxReader, jax_cfg), inflight=2)
    assert got.names == want.names and len(got.names) > 0
    for i in range(got.n_images):
        gm, wm = got.mask[i], want.mask[i]
        assert gm.sum() == wm.sum()
        iou = pairwise_iou(torch.from_numpy(got.boxes[i][gm].astype(np.float32)),
                           torch.from_numpy(want.boxes[i][wm].astype(np.float32))).numpy()
        close = (iou >= 0.99) & \
            (np.abs(got.feats["det_score"][i][gm][:, None]
                    - want.feats["det_score"][i][wm][None]) <= 1e-4) & \
            (got.classes[i][gm][:, None] == want.classes[i][wm][None])
        taken = set()
        for row in close:                       # one to one, greedily
            j = next(j for j in np.flatnonzero(row) if j not in taken)
            taken.add(j)
    remaining = [n for n in got.names if not n.startswith("__pad")]
    for strategy in ("entropy", "norm_albox", "mean_entropy", "ental", "bottomk_entropy"):
        assert als.select_pool(als.subset_pool(got, remaining), strategy, 3) == \
            jax_als.select_pool(jax_als.subset_pool(want, remaining), strategy, 3), strategy


def test_hashes_prune_and_pool_index_equal_jax(pool_file):
    root, path = pool_file
    idx, jidx = al_runner.PoolIndex(path), jax_runner.PoolIndex(path)
    assert idx.names == jidx.names and idx.entries == jidx.entries
    images = idx.decoded_images(idx.names)
    for got, want in zip(images, jidx.decoded_images(jidx.names)):
        np.testing.assert_array_equal(got, want)
    big = np.random.RandomState(1).randint(0, 256, (375, 1242, 3)).astype(np.uint8)
    for im in images + [big, big[:100, :60]]:
        np.testing.assert_array_equal(al.phash(im), jax_al.phash(im))
        np.testing.assert_array_equal(al.whash(im), jax_al.whash(im))
    dupes = images + [images[0].copy(), images[3][:, ::-1].copy()]
    for method in ("phash", "whash"):
        for thr in (0, 5, 20, 40):
            assert al.prune_pool(dupes, thr, method) == jax_al.prune_pool(dupes, thr, method)
    for pad in (None, 3, 4):
        sub = str(root / f"sub_{pad}.tfrecord")
        jsub = str(root / f"jsub_{pad}.tfrecord")
        assert idx.write_subset(idx.names[2:7], sub, pad) == \
            jidx.write_subset(jidx.names[2:7], jsub, pad)
        assert al_runner.PoolIndex(sub).names == jax_runner.PoolIndex(jsub).names


def _stages(log):
    def train_fn(selected, it_dir):
        log.append(("train", os.path.basename(it_dir), tuple(selected)))

    def infer_fn(remaining, it_dir):
        return [r for r in rows_of(n_images=20, seed=9) if r["image_name"] in set(remaining)]

    return train_fn, infer_fn


@pytest.mark.parametrize("strategy", ["entropy", "random", "combo", "sota"])
def test_active_learning_loop_equals_jax(tmp_path, strategy):
    """The resumable loop with injected stages: the same selections a
    budget step, the same train calls and artifacts; a second run resumes."""
    names = [f"img{i:03d}.png" for i in range(20)]
    out = {}
    for side, mod in (("port", al), ("jax", jax_al)):
        log = []
        train_fn, infer_fn = _stages(log)
        loop = mod.ActiveLearning(names, str(tmp_path / side), strategy,
                                  budget_steps=[10, 20, 15], train_fn=train_fn,
                                  infer_fn=infer_fn, seed=4)
        sel = loop.run()
        again = mod.ActiveLearning(names, str(tmp_path / side), strategy,
                                   budget_steps=[10, 20, 15], train_fn=train_fn,
                                   infer_fn=infer_fn, seed=4).run()
        assert again == sel
        files = {d: (tmp_path / side / d / "selected.txt").read_text()
                 for d in sorted(os.listdir(tmp_path / side))}
        out[side] = (sel, log, files)
    assert out["port"] == out["jax"]


def test_cli_al_random_equals_jax_cli(pool_file, tmp_path, monkeypatch):
    root, path = pool_file
    tiny = "image_size=64x64,num_classes=3,fpn_cell_repeats=1,box_class_repeats=1"
    argv = ["al", "--pool_file_pattern", path, "--strategy", "random", "--budgets", "20,30",
            "--batch_size", "2", "--num_epochs", "1", "--steps_per_epoch", "1",
            "--seed", "3", "--hparams", tiny]
    port_dir = str(tmp_path / "port")
    got = cli.main(argv + ["--work_dir", port_dir, "--device", "cpu",
                           "--out_tfrecord", str(tmp_path / "sel.tfrecord")])
    assert os.path.exists(os.path.join(port_dir, "iter_1", "model", "ckpt_1", "state.pt"))
    assert al_runner.PoolIndex(str(tmp_path / "sel.tfrecord")).names == got

    import udal_tpu.cli as jax_cli
    import udal_tpu.train.loop as jax_loop

    def no_training(config, it, steps, model_dir, **kw):
        os.makedirs(model_dir, exist_ok=True)

    monkeypatch.setattr(jax_loop, "train_and_evaluate", no_training)
    jax_dir = str(tmp_path / "jax")
    jax_cli.main(argv + ["--work_dir", jax_dir])
    for d in ("", "iter_0", "iter_1"):
        assert open(os.path.join(port_dir, d, "selected.txt")).read() == \
            open(os.path.join(jax_dir, d, "selected.txt")).read()
    assert len(got) == 5 and len(set(got)) == 5
    assert cli.main(argv + ["--work_dir", port_dir, "--device", "cpu"]) == got


def test_cli_al_scores_the_pool_through_the_driver(pool_file, tmp_path):
    """``--strategy entropy`` with pruning: the second iteration serves
    the remaining 7 images through collect_pool (padded to whole batches
    of 2) and selects from them; no padding row is selected."""
    _, path = pool_file
    tiny = "image_size=64x64,num_classes=3,fpn_cell_repeats=1,box_class_repeats=1"
    sel = cli.main(["al", "--pool_file_pattern", path, "--work_dir", str(tmp_path / "w"),
                    "--strategy", "entropy", "--budgets", "30,20", "--batch_size", "2",
                    "--num_epochs", "1", "--steps_per_epoch", "1", "--device", "cpu",
                    "--prune_thr", "0", "--hash_method", "whash", "--hparams", tiny])
    assert len(sel) == 5 and len(set(sel)) == 5
    assert not any(s.startswith("__pad") for s in sel)
    assert os.path.exists(tmp_path / "w" / "iter_1" / "remaining.tfrecord")
    remaining = al_runner.PoolIndex(str(tmp_path / "w" / "iter_1" / "remaining.tfrecord")).names
    assert remaining[-1] == "__pad0__" and len(remaining) == 8


# -- a resumed `cli al` serves the model the previous iteration left ------------

RESUME_ARGV = ["--strategy", "entropy", "--budgets", "30,20", "--batch_size", "2",
               "--num_epochs", "1", "--steps_per_epoch", "1", "--device", "cpu", "--seed", "3",
               "--hparams", "image_size=64x64,num_classes=3,fpn_cell_repeats=1,box_class_repeats=1"]


@pytest.fixture(scope="module")
def finished_al(pool_file):
    """One uninterrupted two-iteration ``cli al --strategy entropy`` run:
    (its work directory, its selection)."""
    root, path = pool_file
    work = root / "al_finished"
    return work, cli.main(["al", "--pool_file_pattern", path, "--work_dir", str(work),
                           *RESUME_ARGV])


@pytest.mark.parametrize("how", ["killed", "warmup"])
def test_resumed_cli_al_serves_the_previous_iterations_model(pool_file, finished_al, tmp_path,
                                                              monkeypatch, how):
    """A run that never trains iteration 0 itself (resumed after iteration
    1 was killed before its training finished, or with ``--warmup_dir``
    copying iteration 0's model) serves iteration 1's pool from
    ``iter_0/model``: ``collect_pool``'s pool equals one served from
    ``checkpoint_state_dict(cfg, iter_0/model)`` array for array, and the
    selection equals the uninterrupted run's. (JAX's runner serves from
    ``last_model_dir[0]``, which only its training sets, and raises here.)"""
    import shutil

    from udal_tpu_torch.apps.serving import checkpoint_state_dict
    from udal_tpu_torch.config import config_from_args
    from udal_tpu_torch.data.dataloader import InputReader

    _, path = pool_file
    finished, want = finished_al
    work = tmp_path / "work"
    extra = []
    if how == "killed":
        shutil.copytree(finished, work)
        shutil.rmtree(work / "iter_1" / "model")
        os.remove(work / "iter_1" / "train_done")
    else:
        extra = ["--warmup_dir", str(finished / "iter_0")]
    pools = []
    real = als.collect_pool

    def recording(drv, batches, **kw):
        pools.append(real(drv, batches, **kw))
        return pools[-1]

    monkeypatch.setattr(als, "collect_pool", recording)
    argv = ["al", "--pool_file_pattern", path, "--work_dir", str(work), *RESUME_ARGV, *extra]
    got = cli.main(argv)
    assert got == want and len(pools) == 1
    assert os.path.exists(work / "iter_0" / "model") and os.path.exists(work / "iter_1" / "model")

    cfg = config_from_args(cli.build_parser().parse_args(argv))
    cfg.is_training_bn = False
    drv = ServingDriver(cfg, checkpoint_state_dict(cfg, str(work / "iter_0" / "model")),
                        batch_size=2, device="cpu")
    it = InputReader(str(work / "iter_1" / "remaining.tfrecord"), is_training=False, names=True,
                     seed=3)(drv.config, 2)
    try:
        ref = real(drv, ((im, lab["image_names"], lab["image_scales"]) for im, lab in it),
                   min_score=0.0)
    finally:
        it.close()
    pool = pools[0]
    assert pool.names == ref.names and pool.n_images == ref.n_images > 0
    for key in ("boxes", "classes", "mask"):
        np.testing.assert_array_equal(getattr(pool, key), getattr(ref, key))
    assert pool.feats.keys() == ref.feats.keys()
    for key in pool.feats:
        np.testing.assert_array_equal(pool.feats[key], ref.feats[key])


def test_selections_over_a_large_pool_equal_jax(tmp_path):
    """The loop's remaining list and row filter (one set each, built once)
    over 400 names and five budget steps: the same selections as JAX's,
    name for name, through the row route."""
    names = [f"img{i:03d}.png" for i in range(400)]
    rows = rows_of(n_images=400, seed=11)

    def infer_fn(remaining, it_dir):
        keep = set(remaining)
        return [r for r in rows if r["image_name"] in keep]

    out = {}
    for side, mod in (("port", al), ("jax", jax_al)):
        out[side] = mod.ActiveLearning(names, str(tmp_path / side), "mean_entropy",
                                       budget_steps=[5, 10, 10, 20, 15], infer_fn=infer_fn,
                                       seed=7).run()
    assert out["port"] == out["jax"] and len(set(out["port"])) == len(out["port"]) == 240
