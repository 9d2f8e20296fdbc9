"""The port's input reader against ``udal_tpu.data.dataloader``.

One TFRecord of PNG frames written by ``udal_tpu.data.synthetic`` (cv2's
encoder) is read by both ``InputReader``s at the same seed, eval batches
and training batches (flip and scale jitter), in the three contracts:

- classic (normalised f32 + per-level targets): images within 1e-6 (the
  f32 resize: cv2 sums in f32, the port in f64 rounded once; decode is
  exact), every label key within 1e-6. The JAX reader's targets are built
  with jit off: jitted, XLA rounds an IoU differently by an ulp and an
  anchor at a 0.5 tie flips (``tests/test_torch_target_assign.py``);
- ``fast_input`` and ``device_resize``: uint8 images equal, every label
  key equal to 1e-6.

Also: two worker processes give the single process's batches; a
producer's error reaches the consumer (thread and process; an unknown
``autoaugment_policy`` too); ``device_put`` puts tensors on the
reader's device; the port's synthetic writer, KITTI writer and batch
composition equal the JAX package's.
"""


import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from udal_tpu.config import get_detection_config as jax_config  # noqa: E402
from udal_tpu.data import composition as jax_comp  # noqa: E402
from udal_tpu.data import dataset_creators as jax_creators  # noqa: E402
from udal_tpu.data.dataloader import InputReader as JaxReader  # noqa: E402
from udal_tpu.data.synthetic import write_synthetic_dataset as jax_write  # noqa: E402
from udal_tpu_torch.config import get_detection_config as port_config  # noqa: E402
from udal_tpu_torch.data import composition, dataset_creators, synthetic  # noqa: E402
from udal_tpu_torch.data import tfrecord as tfr  # noqa: E402
from udal_tpu_torch.data.dataloader import InputReader, parse_detection_example  # noqa: E402

OVERRIDES = dict(image_size=128, num_classes=8)
BATCH, SEED = 4, 5


@pytest.fixture(scope="module")
def record(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("reader") / "s.tfrecord")
    jax_write(path, num_images=10, height=75, width=130, num_classes=7, seed=3,
              pseudo_scores=True)
    return path


def configs():
    return (jax_config("efficientdet-d0").override(OVERRIDES),
            port_config("efficientdet-d0").override(OVERRIDES))


def take(reader, config, n=3):
    it = reader(config, BATCH)
    out = [next(it) for _ in range(n)] if reader._is_training else list(it)
    it.close()
    return out


def assert_batches_close(got, want, image_tol, label_tol=1e-6):
    assert len(got) == len(want)
    for (pi, pl), (ji, jl) in zip(got, want):
        ji = np.asarray(ji)
        assert pi.dtype == ji.dtype and pi.shape == ji.shape
        np.testing.assert_allclose(pi, ji, rtol=0, atol=image_tol)
        assert set(pl) == set(jl)
        for k in jl:
            if isinstance(jl[k], list):
                assert pl[k] == jl[k], k
            else:
                np.testing.assert_allclose(np.asarray(pl[k], np.float64),
                                           np.asarray(jl[k], np.float64), rtol=0,
                                           atol=label_tol, err_msg=k)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("contract", ["classic", "fast_input", "device_resize"])
def test_reader_batches_equal_jax(record, contract, training):
    kw = {"classic": {}, "fast_input": dict(fast_input=True),
          "device_resize": dict(fast_input=True, device_resize=True)}[contract]
    jc, pc = configs()
    got = take(InputReader(record, training, prefetch=2, seed=SEED, names=True, **kw), pc)
    with jax.disable_jit():
        want = take(JaxReader(record, training, prefetch=0, seed=SEED, names=True, **kw), jc)
    assert_batches_close(got, want, image_tol=1e-6 if contract == "classic" else 0)


def test_two_worker_processes_equal_one(record):
    _, pc = configs()
    for kw in (dict(fast_input=True), {}):
        one = take(InputReader(record, True, prefetch=0, seed=SEED, **kw), pc, 4)
        two = take(InputReader(record, True, prefetch=1, seed=SEED, num_proc=2, **kw), pc, 4)
        assert_batches_close(two, one, image_tol=0, label_tol=0)


def test_producer_errors_reach_the_consumer(record, tmp_path):
    _, pc = configs()
    bad = str(tmp_path / "bad.tfrecord")
    with tfr.TFRecordWriter(bad) as w:
        for _ in range(BATCH):
            w.write(b"\x0a\x00")                   # an Example without an image
    with pytest.raises(KeyError, match="image/encoded"):
        next(InputReader(bad, False, prefetch=2)(pc, BATCH))
    with pytest.raises(RuntimeError, match="input worker failed: KeyError"):
        next(InputReader(bad, False, prefetch=1, num_proc=1)(pc, BATCH))
    pc.autoaugment_policy = "v9"
    with pytest.raises(ValueError, match="unknown policy"):
        next(InputReader(record, True, prefetch=0)(pc, BATCH))


def test_training_reader_refuses_fewer_records_than_a_batch(record):
    """The JAX reader drops the remainder and loops for ever on a file
    smaller than a batch; the port's training reader says so instead."""
    _, pc = configs()
    with pytest.raises(ValueError, match="10 records cannot fill one batch of 16"):
        next(InputReader(record, True, prefetch=0)(pc, 16))
    assert next(InputReader(record, True, prefetch=0)(pc, 10))[0].shape[0] == 10


def test_device_put_and_wait_stats(record):
    _, pc = configs()
    reader = InputReader(record, False, fast_input=True, device_put=True, device="cpu")
    images, labels = next(reader(pc, BATCH))
    assert isinstance(images, torch.Tensor) and images.dtype == torch.uint8
    assert isinstance(labels["gt_boxes"], torch.Tensor) and isinstance(labels["source_ids"], list)
    stats = reader.wait_stats()
    assert stats["total_s"] >= stats["wait_s"] >= 0 and 0 <= stats["wait_fraction"] <= 1


def test_synthetic_and_kitti_writers_equal_jax(tmp_path):
    port, jax_path = str(tmp_path / "port.tfrecord"), str(tmp_path / "jax.tfrecord")
    meta = synthetic.write_synthetic_dataset(port, num_images=3, height=40, width=56, seed=2)
    jax_meta = jax_write(jax_path, num_images=3, height=40, width=56, seed=2)
    for m, jm in zip(meta, jax_meta):
        assert m["source_id"] == jm["source_id"]
        np.testing.assert_array_equal(m["boxes"], jm["boxes"])
    for a, b in zip(tfr.iterate_tfrecord(port), tfr.iterate_tfrecord(jax_path)):
        pa, pb = parse_detection_example(a), parse_detection_example(b)
        assert np.array_equal(pa.image, pb.image)
        np.testing.assert_array_equal(pa.boxes, pb.boxes)
        assert (pa.source_id, pa.filename) == (pb.source_id, pb.filename)
    # a KITTI layout: the port's writer's records equal the JAX writer's
    image_dir, label_dir = tmp_path / "image_2", tmp_path / "label_2"
    image_dir.mkdir()
    label_dir.mkdir()
    rng = np.random.RandomState(0)
    for i in range(3):
        img = rng.randint(0, 256, (30 + i, 41, 3)).astype(np.uint8)
        (image_dir / f"{i:06d}.png").write_bytes(synthetic.encode_png(img))
        (label_dir / f"{i:06d}.txt").write_text(
            "Car 0.00 0 -1.5 10.0 5.0 30.5 20.0 1 1 1 1 1 1 1\n"
            "DontCare -1 -1 -10 1 1 2 2 -1 -1 -1 -1 -1 -1 -1\n"
            f"Cyclist 0.5 1 0.2 {i}.5 2.0 20.0 25.0 1 1 1 1 1 1 1\n")
    outs = []
    for creators, name in ((dataset_creators, "port"), (jax_creators, "jax")):
        out = str(tmp_path / f"kitti_{name}.tfrecord")
        assert creators.kitti_to_tfrecord(str(image_dir), str(label_dir), out) == 3
        outs.append(list(tfr.iterate_tfrecord(out)))
    assert outs[0] == outs[1]
    label = str(label_dir / "000001.txt")
    got, want = dataset_creators.parse_kitti_label_file(label), \
        jax_creators.parse_kitti_label_file(label)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def test_composition_equals_jax(record):
    jc, pc = configs()
    kw = dict(fast_input=True, prefetch=0, seed=SEED)
    got = next(composition.zip_readers(InputReader(record, True, **kw),
                                       InputReader(record, False, **kw), pc, 3, 1))
    want = next(jax_comp.zip_readers(JaxReader(record, True, **kw),
                                     JaxReader(record, False, **kw), jc, 3, 1))
    assert_batches_close([got], [want], image_tol=0, label_tol=0)
    assert composition.ssl_batch_split(pc, 8, 0.3) == jax_comp.ssl_batch_split(jc, 8, 0.3)


def test_default_shard_comes_from_torch_distributed(record, monkeypatch):
    """Without shard_id / num_shards the reader reads the strided subset of
    ``torch.distributed``'s rank of its world size (0 of 1 when no process
    group is initialised), as the JAX reader does with jax.process_index."""
    assert InputReader(record, False)._sharded_order().tolist() == list(range(10))
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 3)
    assert InputReader(record, False)._sharded_order().tolist() == [1, 4, 7]
    assert InputReader(record, False, shard_id=0, num_shards=2)._sharded_order().tolist() == \
        [0, 2, 4, 6, 8]
