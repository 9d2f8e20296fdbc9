"""Batch composition: zip two readers into one batch.

Port of ``udal_tpu/data/composition.py``: SSL zips the labelled reader
with the (pseudo-labelled or unlabelled) one and concatenates each batch,
``config.unlabeled_start`` marking where the train step splits them; the
rare-class curriculum zips the common and rare splits alike. Label keys
one side lacks are filled with -1 (no pseudo score), and groundtruth
tensors of different widths are padded with -1.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np


def _concat_batches(a: Tuple[np.ndarray, Dict], b: Tuple[np.ndarray, Dict]
                    ) -> Tuple[np.ndarray, Dict]:
    images = np.concatenate([a[0], b[0]], axis=0)
    na, nb = a[0].shape[0], b[0].shape[0]
    labels = {}
    # union of keys: e.g. with fast_input STAC only the pseudo stream
    # carries gt_pseudo — the labeled side is filled with -1 (= no pseudo
    # score), mirroring the classic groundtruth_data column padding below
    for k in sorted(set(a[1]) | set(b[1])):
        va, vb = a[1].get(k), b[1].get(k)
        if isinstance(va if va is not None else vb, list):
            labels[k] = list(va or []) + list(vb or [])
        elif va is None or vb is None:
            present = np.asarray(va if va is not None else vb)
            fill = -np.ones((na if va is None else nb,) + present.shape[1:],
                            present.dtype)
            parts = [fill, present] if va is None else [present, fill]
            labels[k] = np.concatenate(parts, axis=0)
        else:
            va = np.asarray(va)
            vb = np.asarray(vb)
            if va.ndim >= 3 and vb.ndim >= 3 and va.shape[-1] != vb.shape[-1]:
                # groundtruth_data column mismatch (the pseudo_score
                # column): pad the narrower tensor with -1
                width = max(va.shape[-1], vb.shape[-1])

                def pad(t):
                    if t.shape[-1] == width:
                        return t
                    padding = -np.ones(t.shape[:-1] + (width - t.shape[-1],),
                                       t.dtype)
                    return np.concatenate([t, padding], axis=-1)

                va, vb = pad(va), pad(vb)
            labels[k] = np.concatenate([va, vb], axis=0)
    return images, labels


def zip_readers(reader_a, reader_b, config, batch_a: int, batch_b: int
                ) -> Iterator[Tuple[np.ndarray, Dict]]:
    """Yield concatenated batches [A-part | B-part].

    For SSL: A = labeled, B = pseudo/unlabeled; set
    ``config.unlabeled_start = batch_a`` so the train step splits correctly.
    For RCF: A = common, B = rare.
    """
    it_a = reader_a(config, batch_a)
    it_b = reader_b(config, batch_b)
    while True:
        try:
            a = next(it_a)
            b = next(it_b)
        except StopIteration:
            return
        yield _concat_batches(a, b)


def ssl_batch_split(config, total_batch: int, labeled_fraction: float) -> int:
    """Labelled examples a batch (the ``unlabeled_start`` boundary)."""
    n = int(round(total_batch * labeled_fraction))
    return max(1, min(total_batch - 1, n))
