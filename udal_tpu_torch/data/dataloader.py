"""Detection input pipeline: TFRecord → decoded, augmented, labelled batches.

Port of ``udal_tpu/data/dataloader.py`` with the same preprocessing
(aspect-preserving resize onto a top-left padded canvas, random scale
jitter, random horizontal flip, RGB normalisation), the same RNG stream
(a reader at a seed yields the JAX reader's batches) and the same three
batch contracts:

- classic: normalised f32 images at the network size and the per-level
  anchor targets (``data.labels.build_labels`` on the CPU, the JAX
  reader's keys, as numpy);
- ``fast_input``: resized uint8 images, compact groundtruth (``gt_boxes``,
  ``gt_classes``, ``valid_hw``); normalisation and target assignment run
  on the step's device (``train_lib.prepare_batch``);
- ``device_resize``: native-size uint8 images and each image's warp
  (``warp_scale`` / ``warp_offset``); the resize runs on the device too.

Decoding (``data.image_codec``, no cv2), the cv2-exact resize
(``ops.image_ops.resize_bilinear_uint8`` / ``resize_bilinear_float``)
and the labels run on the host in worker threads (``num_workers``) behind
a producer thread (``prefetch``), or in worker processes (``num_proc``,
``data.mp_loader``). ``device_put`` copies each batch from pinned host
memory to ``device`` with ``non_blocking`` copies on the producer thread.
The default shard is ``torch.distributed``'s rank of its world size when a
process group is initialised, else 0 of 1. A training reader applies
``config.autoaugment_policy`` (``data/augment.py``'s ``apply_policy``) and
then ``config.grid_mask`` to the decoded image, before the flip, with the
reader's own ``rng``, as the JAX reader does.
"""

from __future__ import annotations

import concurrent.futures as futures
import dataclasses
import queue as queuelib
import threading
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from udal_tpu_torch.config import parse_image_size
from udal_tpu_torch.data import example_codec as codec
from udal_tpu_torch.data import tfrecord as tfr
from udal_tpu_torch.data.augment import apply_policy, gridmask
from udal_tpu_torch.data.image_codec import decode_image
from udal_tpu_torch.data.labels import build_labels, groundtruth_data
from udal_tpu_torch.ops.image_ops import resize_bilinear_float, resize_bilinear_uint8


@dataclasses.dataclass
class ParsedExample:
    image: np.ndarray          # uint8 RGB
    boxes: np.ndarray          # [N, 4] absolute (y1, x1, y2, x2)
    classes: np.ndarray        # [N] int
    is_crowd: np.ndarray       # [N] bool
    area: np.ndarray           # [N] float
    source_id: str
    filename: str
    pseudo_scores: Optional[np.ndarray] = None


def parse_detection_example(record: bytes) -> ParsedExample:
    """A serialized tf.Example of the detection schema, its image decoded
    (the optional ``image/object/pseudo_score`` included)."""
    f = codec.parse_example(record)
    image = decode_image(f["image/encoded"][0])
    h, w = image.shape[:2]
    xmin = np.asarray(f.get("image/object/bbox/xmin", []), np.float32)
    xmax = np.asarray(f.get("image/object/bbox/xmax", []), np.float32)
    ymin = np.asarray(f.get("image/object/bbox/ymin", []), np.float32)
    ymax = np.asarray(f.get("image/object/bbox/ymax", []), np.float32)
    boxes = np.stack([ymin * h, xmin * w, ymax * h, xmax * w], axis=1) \
        if len(xmin) else np.zeros((0, 4), np.float32)
    classes = np.asarray(f.get("image/object/class/label", []), np.int64)
    n = len(classes)
    area = np.asarray(f.get("image/object/area", []), np.float32)
    if len(area) != n:
        area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    crowd = np.asarray(f.get("image/object/is_crowd", []), np.int64)
    if len(crowd) != n:
        crowd = np.zeros((n,), np.int64)
    pseudo = f.get("image/object/pseudo_score")
    source_id = (f.get("image/source_id", [b"0"])[0] or b"0").decode()
    filename = f.get("image/filename", [b""])[0].decode()
    return ParsedExample(image=image, boxes=boxes, classes=classes,
                         is_crowd=crowd.astype(bool), area=area,
                         source_id=source_id, filename=filename,
                         pseudo_scores=(np.asarray(pseudo, np.float32)
                                        if pseudo is not None else None))


# ---------------------------------------------------------------------------
# Preprocessing (numpy on the host)
# ---------------------------------------------------------------------------

def scale_factors_to_output(h: int, w: int, output_size: Tuple[int, int]
                            ) -> Tuple[float, int, int]:
    """The min-scale factor onto ``output_size`` and the scaled size."""
    scale = min(output_size[0] / h, output_size[1] / w)
    return scale, int(h * scale), int(w * scale)


def random_scale_factors(rng: np.random.RandomState, h: int, w: int,
                         output_size: Tuple[int, int], scale_min: float,
                         scale_max: float,
                         target_size: Optional[Tuple[int, int]] = None):
    """Multiscale jitter: (scale, scaled h, scaled w, crop offset y, x).
    The offsets are truncated with ``int()``, as the JAX reader does."""
    target = target_size or output_size
    factor = rng.uniform(scale_min, scale_max)
    scaled_y = int(factor * target[0])
    scaled_x = int(factor * target[1])
    image_scale = min(scaled_x / w, scaled_y / h)
    scaled_h, scaled_w = int(h * image_scale), int(w * image_scale)
    off_y = max(0.0, scaled_h - output_size[0]) * rng.uniform(0, 1)
    off_x = max(0.0, scaled_w - output_size[1]) * rng.uniform(0, 1)
    return image_scale, scaled_h, scaled_w, int(off_y), int(off_x)


def resize_and_crop(image: np.ndarray, scaled_h: int, scaled_w: int,
                    off_y: int, off_x: int, output_size: Tuple[int, int]
                    ) -> np.ndarray:
    """Bilinear resize (cv2's, uint8 or f32), crop at the offset, pad
    bottom / right to the output size."""
    if image.dtype == np.uint8:
        scaled = resize_bilinear_uint8(image, (scaled_h, scaled_w))
    else:
        scaled = resize_bilinear_float(image, (scaled_h, scaled_w))
    crop = scaled[off_y:off_y + output_size[0], off_x:off_x + output_size[1]]
    out = np.zeros((output_size[0], output_size[1], image.shape[2]), crop.dtype)
    out[:crop.shape[0], :crop.shape[1]] = crop
    return out


def resize_and_crop_boxes(boxes: np.ndarray, classes: np.ndarray,
                          h: int, w: int, scaled_h: int, scaled_w: int,
                          off_y: int, off_x: int,
                          output_size: Tuple[int, int],
                          **extra_columns) -> Tuple[np.ndarray, np.ndarray, Dict]:
    """Scale, offset and clip boxes; drop those of zero area (with their
    rows of ``extra_columns``)."""
    if len(boxes) == 0:
        return boxes, classes, {k: v for k, v in extra_columns.items()}
    scale_y = scaled_h / h
    scale_x = scaled_w / w
    out = boxes * np.asarray([scale_y, scale_x, scale_y, scale_x], np.float32)
    out -= np.asarray([off_y, off_x, off_y, off_x], np.float32)
    out[:, 0] = np.clip(out[:, 0], 0, output_size[0] - 1)
    out[:, 2] = np.clip(out[:, 2], 0, output_size[0] - 1)
    out[:, 1] = np.clip(out[:, 1], 0, output_size[1] - 1)
    out[:, 3] = np.clip(out[:, 3], 0, output_size[1] - 1)
    keep = (out[:, 2] - out[:, 0]) * (out[:, 3] - out[:, 1]) != 0
    extras = {k: (v[keep] if v is not None and len(v) == len(boxes) else v)
              for k, v in extra_columns.items()}
    return out[keep], classes[keep], extras


def horizontal_flip(image: np.ndarray, boxes: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    image = image[:, ::-1]
    if len(boxes):
        w = image.shape[1]
        boxes = boxes.copy()
        x1 = boxes[:, 1].copy()
        boxes[:, 1] = w - 1 - boxes[:, 3]
        boxes[:, 3] = w - 1 - x1
    return image, boxes


def normalize_image(image: np.ndarray, mean_rgb, stddev_rgb) -> np.ndarray:
    x = image.astype(np.float32)
    return (x - np.asarray(mean_rgb, np.float32)) / np.asarray(stddev_rgb, np.float32)


def denormalize_image(images: np.ndarray, mean_rgb, stddev_rgb) -> np.ndarray:
    """Inverse of ``normalize_image`` → clipped uint8 pixels."""
    x = np.asarray(images, np.float32) * np.asarray(stddev_rgb, np.float32) \
        + np.asarray(mean_rgb, np.float32)
    return np.clip(np.round(x), 0, 255).astype(np.uint8)


def default_shard(n_model: int = 1) -> Tuple[int, int]:
    """(data rank, data-axis size) of this process in the initialised
    ``torch.distributed`` process group laid out as a mesh of ``n_model``
    ranks to a model group (``parallel.mesh``: rank d·n_model + m), else
    (0, 1): the ranks of one model group read the same records."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return (torch.distributed.get_rank() // n_model,
                torch.distributed.get_world_size() // n_model)
    return 0, 1


def build_host_labels(config, gt_boxes: np.ndarray, gt_classes: np.ndarray,
                      pseudo: Optional[np.ndarray]) -> Dict[str, np.ndarray]:
    """The classic contract's per-level targets, built on the CPU, as numpy.

    The anchors are matched against the groundtruth columns up to the last
    valid one in the batch (the reader pads at the end, and a padded
    column never wins a match), so a batch of 1-10 boxes a frame costs a
    tenth of matching all ``max_instances_per_image`` columns; the
    ``groundtruth_data`` rows keep every column."""
    valid = np.flatnonzero((gt_classes > 0).any(axis=0))
    m = int(valid[-1]) + 1 if len(valid) else 1
    trim = None if pseudo is None else torch.from_numpy(pseudo[:, :m])
    built = build_labels(config, torch.from_numpy(gt_boxes[:, :m]),
                         torch.from_numpy(gt_classes[:, :m]), trim)
    built["groundtruth_data"] = groundtruth_data(
        torch.from_numpy(gt_boxes), torch.from_numpy(gt_classes),
        None if pseudo is None else torch.from_numpy(pseudo))
    return {k: v.numpy() for k, v in built.items()}


def to_device(batch, device: torch.device):
    """A batch's arrays as tensors on ``device``: from pinned host memory
    with ``non_blocking`` copies when it is a CUDA device."""
    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    images, labels = batch
    return put(images), {k: (put(v) if isinstance(v, np.ndarray) else v)
                         for k, v in labels.items()}


# ---------------------------------------------------------------------------
# InputReader
# ---------------------------------------------------------------------------

class InputReader:
    """Batched detection input over TFRecord shards:
    ``InputReader(file_pattern, is_training, ...)(config, batch_size)``
    yields (images, labels) batches; with ``names=True`` the labels carry
    the filenames as ``image_names``.

    prefetch: depth of the producer thread's queue (0: synchronous).
    device_put: copy each batch to ``device`` (default ``cuda``) on the
      producer thread, from pinned memory with ``non_blocking`` copies.
    shard_id / num_shards: read the strided subset
      ``records[shard_id::num_shards]``; default: ``default_shard`` of
      the config's ``n_model``.
    fast_input: resized uint8 images and compact groundtruth.
    num_proc: > 0 runs that many worker processes (``data.mp_loader``),
      each producing its round-robin share of the batches; every worker
      replays the same RNG stream, so the batches equal one process's.
    device_resize: (with fast_input) native-size uint8 images and each
      image's warp; the resize runs on the device. The native size is
      locked from the first record or passed as ``native_hw``; a larger
      image later raises.
    """

    def __init__(self, file_pattern: str, is_training: bool,
                 use_fake_data: bool = False, max_instances_per_image: int = 100,
                 names: bool = False, num_workers: int = 8, seed: int = 0,
                 prefetch: int = 2, device_put: bool = False,
                 shard_id: Optional[int] = None,
                 num_shards: Optional[int] = None,
                 fast_input: bool = False,
                 num_proc: int = 0,
                 device_resize: bool = False,
                 native_hw: Optional[Tuple[int, int]] = None,
                 device=None):
        if device_resize and not fast_input:
            raise ValueError("device_resize requires fast_input=True")
        self._file_pattern = file_pattern
        self._is_training = is_training
        self._use_fake_data = use_fake_data
        self._max_instances = max_instances_per_image
        self._names = names
        self._num_workers = num_workers
        self._seed = seed
        self._prefetch = prefetch
        self._device_put = device_put
        self._device = torch.device(device if device is not None else "cuda")
        self._shard_id = shard_id
        self._num_shards = num_shards
        self._n_model = 1
        self._fast_input = fast_input
        self._num_proc = num_proc
        self._device_resize = device_resize
        self._native_hw = tuple(native_hw) if native_hw else None
        self._index: Optional[tfr.TFRecordIndex] = None
        # the consumer's seconds blocked on the queue, and in all
        self._wait_s = 0.0
        self._total_s = 0.0

    def wait_stats(self) -> Dict[str, float]:
        """Seconds the consumer waited for input, the seconds of its
        iteration in all, and the share waited."""
        total = max(self._total_s, 1e-9)
        return {"wait_s": self._wait_s, "total_s": self._total_s,
                "wait_fraction": self._wait_s / total}

    def _get_index(self) -> tfr.TFRecordIndex:
        if self._index is None:
            self._index = tfr.TFRecordIndex.from_pattern(self._file_pattern)
        return self._index

    def __len__(self):
        return len(self._get_index())

    def _process(self, record: bytes, config, rng: np.random.RandomState):
        ex = parse_detection_example(record)
        output_size = parse_image_size(config.image_size)
        image = ex.image
        boxes, classes = ex.boxes.copy(), ex.classes.copy()
        h, w = image.shape[:2]

        if self._is_training and config.autoaugment_policy:
            image, boxes = apply_policy(config.autoaugment_policy, image, boxes, rng)
            if config.grid_mask:
                image = gridmask(image, rng=rng)

        if self._is_training and config.input_rand_hflip and rng.rand() < 0.5:
            image, boxes = horizontal_flip(image, boxes)

        if self._is_training:
            scale, sh, sw, oy, ox = random_scale_factors(
                rng, h, w, output_size, config.jitter_min, config.jitter_max,
                parse_image_size(config.target_size)
                if config.target_size else None)
        else:
            scale, sh, sw = scale_factors_to_output(h, w, output_size)
            oy = ox = 0

        warp = None
        if self._fast_input and self._device_resize:
            # the native image; the resize runs on the device with this warp
            if self._native_hw is None:
                self._native_hw = (h, w)
            nh, nw = self._native_hw
            if h > nh or w > nw:
                raise ValueError(
                    f"device_resize: image {h}x{w} exceeds the locked "
                    f"native canvas {nh}x{nw}; pass native_hw= or disable "
                    "device_resize for variable-size datasets")
            if (h, w) != (nh, nw):
                canvas = np.zeros((nh, nw, image.shape[2]), image.dtype)
                canvas[:h, :w] = image
                img_out = canvas
            else:
                img_out = np.ascontiguousarray(image)
            warp = np.asarray([sh / h, sw / w, oy, ox], np.float32)
            valid_hw = (min(sh - oy, output_size[0]),
                        min(sw - ox, output_size[1]))
        elif self._fast_input:
            # uint8 all the way: normalisation moves to the device
            img_out = resize_and_crop(image, sh, sw, oy, ox, output_size)
            valid_hw = (min(sh - oy, output_size[0]),
                        min(sw - ox, output_size[1]))
        else:
            img_norm = normalize_image(image, config.mean_rgb, config.stddev_rgb)
            img_out = resize_and_crop(img_norm, sh, sw, oy, ox, output_size)
            valid_hw = None
        boxes, classes, extras = resize_and_crop_boxes(
            boxes, classes, h, w, sh, sw, oy, ox, output_size,
            pseudo=ex.pseudo_scores)
        pseudo = extras.get("pseudo")

        m = self._max_instances
        boxes_p = np.zeros((m, 4), np.float32)
        classes_p = np.zeros((m,), np.int32)
        n = min(len(boxes), m)
        boxes_p[:n] = boxes[:n]
        classes_p[:n] = classes[:n]
        pseudo_p = None
        if pseudo is not None:
            pseudo_p = -np.ones((m,), np.float32)
            pseudo_p[:n] = pseudo[:n]
        return (img_out, boxes_p, classes_p, pseudo_p, 1.0 / scale,
                ex.source_id, ex.filename, valid_hw, warp)

    def __call__(self, config, batch_size: int) -> Iterator:
        """Yield (images, labels) batches; labels hold the contract's
        targets or compact groundtruth, ``image_scales`` and
        ``source_ids``.

        With ``prefetch > 0`` a producer thread fills a bounded queue (and
        copies to the device with ``device_put``); with ``num_proc > 0``
        the decoding runs in that many worker processes."""
        self._n_model = int(config.get("n_model", 1) or 1)
        if self._device_resize and self._native_hw is None:
            # lock the native canvas before any worker runs, from the first
            # sharded record, so every thread and process agrees on it
            first = parse_detection_example(
                self._get_index()[int(self._sharded_order()[0])])
            self._native_hw = tuple(first.image.shape[:2])
        source = None
        if self._num_proc > 0 and not self._use_fake_data:
            from udal_tpu_torch.data.mp_loader import MultiProcessProducer

            if self._shard_id is None and self._num_shards is None:
                # resolved in the parent: workers start with no process group
                self._shard_id, self._num_shards = default_shard(self._n_model)
            source = MultiProcessProducer(self, config, batch_size,
                                          num_proc=self._num_proc,
                                          prefetch=max(1, self._prefetch))
        if self._prefetch <= 0:
            if source is not None:
                try:
                    yield from source
                finally:
                    source.close()
                return
            yield from self._batches(config, batch_size)
            return

        q: queuelib.Queue = queuelib.Queue(maxsize=self._prefetch)
        stop = threading.Event()
        end = object()

        def stop_aware_put(item) -> None:
            # a full queue with a departed consumer must not block forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.25)
                    return
                except queuelib.Full:
                    continue

        def producer():
            src = None
            try:
                src = source if source is not None else self._batches(config, batch_size)
                for batch in src:
                    if self._device_put:
                        batch = to_device(batch, self._device)
                    stop_aware_put(batch)
                    if stop.is_set():
                        return
                stop_aware_put(end)
            except BaseException as e:  # noqa: BLE001 - raised again on the consumer
                stop_aware_put(e)
            finally:
                # close the inner generator on this thread: it owns the
                # decode pool, which must shut down before interpreter exit
                if src is not None and src is not source:
                    src.close()

        thread = threading.Thread(target=producer, daemon=True, name="input-reader-producer")
        thread.start()
        try:
            t_iter = time.perf_counter()
            while True:
                t0 = time.perf_counter()
                item = q.get()
                now = time.perf_counter()
                self._wait_s += now - t0
                self._total_s += now - t_iter
                t_iter = now
                if item is end:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join(timeout=10.0)
            if source is not None:
                source.close()

    def _sharded_order(self) -> np.ndarray:
        order = np.arange(len(self._get_index()))
        if self._shard_id is not None or self._num_shards is not None:
            shard_id, num_shards = self._shard_id or 0, self._num_shards or 1
        else:
            shard_id, num_shards = default_shard(self._n_model)
        if num_shards > 1:
            order = order[shard_id::num_shards]
        return order

    def _batches(self, config, batch_size: int, wid: int = 0,
                 nproc: int = 1, host_labels: Optional[bool] = None) -> Iterator:
        """The synchronous batch generator (the producer's body).

        With ``nproc > 1`` it is worker ``wid``'s view: every worker replays
        the same RNG stream (shuffles and per-batch seeds) and yields only
        the batches whose sequence number is ``wid`` modulo ``nproc``.
        ``host_labels=False`` yields compact groundtruth even in the
        classic contract (worker processes; the parent builds the targets).
        """
        if host_labels is None:
            host_labels = not self._fast_input and nproc == 1
        pool = futures.ThreadPoolExecutor(self._num_workers)
        try:
            yield from self._batches_body(config, batch_size, wid, nproc, host_labels, pool)
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

    def _batches_body(self, config, batch_size, wid, nproc, with_labels, pool) -> Iterator:
        index = self._get_index()
        order = self._sharded_order()
        rng = np.random.RandomState(self._seed)
        if self._is_training and len(order) < batch_size:
            # the JAX reader loops forever here: it drops the remainder, every epoch
            raise ValueError(f"a training reader of {len(order)} records cannot fill one "
                             f"batch of {batch_size}")
        fake_batch = None
        seq = 0
        while True:
            if self._is_training:
                rng.shuffle(order)
            for start in range(0, len(order) - batch_size + 1, batch_size):
                if self._use_fake_data and fake_batch is not None:
                    yield fake_batch
                    continue
                idxs = order[start:start + batch_size]
                seeds = [int(rng.randint(1 << 31)) for _ in idxs]
                mine = seq % nproc == wid
                seq += 1
                if not mine:
                    continue
                results = list(pool.map(
                    lambda iv: self._process(index[iv[0]], config, np.random.RandomState(iv[1])),
                    zip(idxs, seeds)))
                images = np.stack([r[0] for r in results])
                gt_boxes = np.stack([r[1] for r in results])
                gt_classes = np.stack([r[2] for r in results])
                pseudo = (np.stack([r[3] for r in results])
                          if results[0][3] is not None else None)
                if self._fast_input or not with_labels:
                    labels = {"gt_boxes": gt_boxes, "gt_classes": gt_classes}
                    if self._fast_input:
                        labels["valid_hw"] = np.asarray([r[7] for r in results], np.int32)
                        if results[0][8] is not None:
                            warp = np.stack([r[8] for r in results])
                            labels["warp_scale"] = warp[:, :2]
                            labels["warp_offset"] = warp[:, 2:]
                    if pseudo is not None:
                        labels["gt_pseudo"] = pseudo
                else:
                    labels = build_host_labels(config, gt_boxes, gt_classes, pseudo)
                labels["image_scales"] = np.asarray([r[4] for r in results], np.float32)
                labels["source_ids"] = [r[5] for r in results]
                if self._names:
                    labels["image_names"] = [r[6] for r in results]
                batch = (images, labels)
                if self._use_fake_data:
                    fake_batch = batch
                yield batch
            if not self._is_training:
                return
