"""Dataset → TFRecord writers: KITTI, BDD100K, CODA.

Port of ``udal_tpu/data/dataset_creators.py``: the same tf.Example schema
(the optional ``image/object/pseudo_score`` included) and the same full /
active-learning subset / CSD labelled-unlabelled / custom split variants,
as arguments of one writer. Image sizes come from the port's image codec
(``data.image_codec.image_size``, the PNG or JPEG header) where the JAX
package decodes with cv2.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from udal_tpu_torch.data import example_codec as codec
from udal_tpu_torch.data import tfrecord as tfr
from udal_tpu_torch.data.image_codec import image_size
from udal_tpu_torch.data.label_maps import BDD, KITTI


def build_example(image_path: str, boxes: np.ndarray, classes: Sequence[int],
                  class_texts: Sequence[str],
                  pseudo_scores: Optional[Sequence[float]] = None,
                  source_id: Optional[str] = None,
                  drop_annotations: bool = False) -> bytes:
    """One tf.Example with the reference detection schema.

    boxes are absolute [y1, x1, y2, x2]; stored normalized.
    """
    with open(image_path, "rb") as f:
        encoded = f.read()
    height, width = image_size(encoded)
    fname = os.path.basename(image_path)
    sid = source_id if source_id is not None else \
        (os.path.splitext(fname)[0].lstrip("0") or "0")
    feats = {
        "image/height": codec.int64_feature(height),
        "image/width": codec.int64_feature(width),
        "image/filename": codec.bytes_feature(fname),
        "image/source_id": codec.bytes_feature(sid),
        "image/key/sha256": codec.bytes_feature(
            hashlib.sha256(encoded).hexdigest()),
        "image/encoded": codec.bytes_feature(encoded),
        "image/format": codec.bytes_feature(
            os.path.splitext(fname)[1].lstrip(".") or "png"),
    }
    if not drop_annotations and len(boxes):
        boxes = np.asarray(boxes, np.float64)
        feats.update({
            "image/object/bbox/ymin": codec.float_list_feature(
                boxes[:, 0] / height),
            "image/object/bbox/xmin": codec.float_list_feature(
                boxes[:, 1] / width),
            "image/object/bbox/ymax": codec.float_list_feature(
                boxes[:, 2] / height),
            "image/object/bbox/xmax": codec.float_list_feature(
                boxes[:, 3] / width),
            "image/object/class/label": codec.int64_list_feature(classes),
            "image/object/class/text": codec.bytes_list_feature(class_texts),
            "image/object/difficult": codec.int64_list_feature(
                [0] * len(classes)),
        })
        if pseudo_scores is not None:
            feats["image/object/pseudo_score"] = codec.float_list_feature(
                pseudo_scores)
    return codec.serialize_example(feats)


# ---------------------------------------------------------------------------
# KITTI
# ---------------------------------------------------------------------------

def parse_kitti_label_file(path: str, label_map: Dict[int, str] = KITTI,
                           with_scores: bool = False):
    """Parse a KITTI label txt: type trunc occl alpha x1 y1 x2 y2 ... [score].

    Returns (boxes [N,4] y1x1y2x2, class ids, class texts[, scores]).
    """
    name_to_id = {v.lower(): k for k, v in label_map.items()}
    boxes, ids, texts, scores = [], [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            name = parts[0].lower()
            if name not in name_to_id:
                continue
            x1, y1, x2, y2 = map(float, parts[4:8])
            boxes.append([y1, x1, y2, x2])
            ids.append(name_to_id[name])
            texts.append(name)
            if with_scores and len(parts) >= 16:
                scores.append(float(parts[15]))
    out = (np.asarray(boxes, np.float64).reshape(-1, 4), ids, texts)
    if with_scores:
        return out + (scores if len(scores) == len(ids) else None,)
    return out


def kitti_to_tfrecord(image_dir: str, label_dir: str, output_path: str,
                      indices: Optional[Sequence[str]] = None,
                      label_map: Dict[int, str] = KITTI,
                      with_pseudo_scores: bool = False,
                      drop_annotations: bool = False) -> int:
    """Write KITTI images+labels to a TFRecord.

    indices: optional list of image stems (AL subsets / CSD splits); None →
    every label file in label_dir.
    """
    if indices is None:
        indices = sorted(os.path.splitext(f)[0]
                         for f in os.listdir(label_dir)
                         if f.endswith(".txt"))
    n = 0
    with tfr.TFRecordWriter(output_path) as w:
        for stem in indices:
            label_path = os.path.join(label_dir, stem + ".txt")
            image_path = None
            for ext in (".png", ".jpg", ".jpeg"):
                cand = os.path.join(image_dir, stem + ext)
                if os.path.exists(cand):
                    image_path = cand
                    break
            if image_path is None or not os.path.exists(label_path):
                continue
            parsed = parse_kitti_label_file(label_path, label_map,
                                            with_scores=with_pseudo_scores)
            boxes, ids, texts = parsed[:3]
            scores = parsed[3] if with_pseudo_scores else None
            w.write(build_example(image_path, boxes, ids, texts, scores,
                                  drop_annotations=drop_annotations))
            n += 1
    return n


# ---------------------------------------------------------------------------
# BDD100K
# ---------------------------------------------------------------------------

def bdd_to_tfrecord(json_path: str, image_dir: str, output_path: str,
                    indices: Optional[Sequence[str]] = None,
                    label_map: Dict[int, str] = BDD,
                    with_pseudo_scores: bool = False) -> int:
    """Write BDD100K json annotations to a TFRecord —
    parity `bdd_tf_creator.py:191-446`."""
    name_to_id = {v: k for k, v in label_map.items()}
    with open(json_path) as f:
        data = json.load(f)
    wanted = set(indices) if indices is not None else None
    n = 0
    with tfr.TFRecordWriter(output_path) as w:
        for entry in data:
            name = entry["name"]
            if wanted is not None and os.path.splitext(name)[0] not in wanted:
                continue
            image_path = os.path.join(image_dir, name)
            if not os.path.exists(image_path):
                continue
            boxes, ids, texts, scores = [], [], [], []
            for lab in entry.get("labels", []):
                cat = lab.get("category")
                if cat not in name_to_id or "box2d" not in lab:
                    continue
                b = lab["box2d"]
                boxes.append([b["y1"], b["x1"], b["y2"], b["x2"]])
                ids.append(name_to_id[cat])
                texts.append(cat)
                if with_pseudo_scores:
                    scores.append(float(lab.get("score", 1.0)))
            w.write(build_example(
                image_path, np.asarray(boxes).reshape(-1, 4), ids, texts,
                scores if with_pseudo_scores else None))
            n += 1
    return n


# ---------------------------------------------------------------------------
# CODA (COCO-format corner cases)
# ---------------------------------------------------------------------------

def coda_to_tfrecord(annotation_json: str, image_dir: str, output_path: str,
                     label_map: Dict[int, str] = BDD) -> int:
    """Write CODA (COCO-format) annotations — parity
    `coda_tf_creator.py:54-124`; CODA evaluates with the BDD label space."""
    with open(annotation_json) as f:
        data = json.load(f)
    per_image: Dict[int, List] = {}
    for ann in data.get("annotations", []):
        per_image.setdefault(ann["image_id"], []).append(ann)
    id_to_name = {img["id"]: img["file_name"] for img in data.get("images",
                                                                  [])}
    n = 0
    with tfr.TFRecordWriter(output_path) as w:
        for img_id, anns in per_image.items():
            image_path = os.path.join(image_dir, id_to_name[img_id])
            if not os.path.exists(image_path):
                continue
            boxes, ids, texts = [], [], []
            for a in anns:
                x, y, bw, bh = a["bbox"]
                cid = int(a["category_id"])
                if cid not in label_map:
                    continue
                boxes.append([y, x, y + bh, x + bw])
                ids.append(cid)
                texts.append(label_map[cid])
            w.write(build_example(image_path, np.asarray(boxes).reshape(-1, 4),
                                  ids, texts, source_id=str(img_id)))
            n += 1
    return n


# ---------------------------------------------------------------------------
# Orchestrated variants (AL subsets / CSD splits / custom splits)
# ---------------------------------------------------------------------------

def _stems_at(image_dir: str, indices) -> List[str]:
    """Positional image selection — the reference indexes
    sorted(listdir(image_dir)) (`kitti_tf_creator.py:124,212`)."""
    names = sorted(os.listdir(image_dir))
    return [os.path.splitext(names[int(i)])[0] for i in indices]


def kitti_active_tfrecords(image_dir: str, label_dir: str, output_path: str,
                           train_indices, current_iteration: int,
                           train: bool = True,
                           pseudo: Optional[str] = None,
                           label_map: Dict[int, str] = KITTI) -> int:
    """AL-subset TFRecord writer — parity `kitti_tf_creator.py:171-233`:
    writes ``<output_path>/_{train|val}_<iteration>.tfrecord`` from the
    selected image indices; `pseudo` points at a pseudo-label directory
    (per-detection scores become `image/object/pseudo_score`)."""
    os.makedirs(output_path, exist_ok=True)
    tag = "_train_" if train else "_val_"
    out = os.path.join(output_path,
                       f"{tag}{current_iteration}.tfrecord")
    return kitti_to_tfrecord(image_dir, pseudo or label_dir, out,
                             indices=_stems_at(image_dir, train_indices),
                             label_map=label_map,
                             with_pseudo_scores=pseudo is not None)


def kitti_csd_tfrecords(image_dir: str, label_dir: str, output_path: str,
                        num_labeled: int, train_indices,
                        saving_name: str = "",
                        label_map: Dict[int, str] = KITTI
                        ) -> Tuple[int, int]:
    """CSD labeled/unlabeled split — parity `kitti_tf_creator.py:84-170`:
    the first `num_labeled` selected images keep annotations
    (``_train_labeled<name>.tfrecord``); the rest are written without
    boxes (``_train_unlabeled<name>.tfrecord``)."""
    os.makedirs(output_path, exist_ok=True)
    stems = _stems_at(image_dir, train_indices)
    n_lab = kitti_to_tfrecord(
        image_dir, label_dir,
        os.path.join(output_path, f"_train_labeled{saving_name}.tfrecord"),
        indices=stems[:num_labeled], label_map=label_map)
    n_unl = kitti_to_tfrecord(
        image_dir, label_dir,
        os.path.join(output_path, f"_train_unlabeled{saving_name}.tfrecord"),
        indices=stems[num_labeled:], label_map=label_map,
        drop_annotations=True)
    return n_lab, n_unl


def kitti_custom_to_tfrecords(image_dir: str, label_dir: str,
                              output_path: str,
                              train_indices=None,
                              validation_indices=None,
                              label_map: Dict[int, str] = KITTI
                              ) -> Tuple[int, int]:
    """Custom train/val index split — parity `kitti_tf_creator.py:233-320`:
    writes ``<output_path>_train.tfrecord`` / ``<output_path>_val.tfrecord``."""
    n_train = n_val = 0
    if train_indices is not None:
        n_train = kitti_to_tfrecord(
            image_dir, label_dir, output_path + "_train.tfrecord",
            indices=_stems_at(image_dir, train_indices),
            label_map=label_map)
    if validation_indices is not None:
        n_val = kitti_to_tfrecord(
            image_dir, label_dir, output_path + "_val.tfrecord",
            indices=_stems_at(image_dir, validation_indices),
            label_map=label_map)
    return n_train, n_val


def bdd_active_tfrecords(json_path: str, image_dir: str, output_path: str,
                         train_indices, current_iteration: int,
                         train: bool = True,
                         pseudo_json: Optional[str] = None,
                         label_map: Dict[int, str] = BDD) -> int:
    """BDD AL-subset writer — parity `bdd_tf_creator.py:331-445`."""
    os.makedirs(output_path, exist_ok=True)
    tag = "_train_" if train else "_val_"
    out = os.path.join(output_path,
                       f"{tag}{current_iteration}.tfrecord")
    with open(json_path) as f:
        names = sorted(e["name"] for e in json.load(f))
    stems = [os.path.splitext(names[int(i)])[0] for i in train_indices]
    return bdd_to_tfrecord(pseudo_json or json_path, image_dir, out,
                           indices=stems, label_map=label_map,
                           with_pseudo_scores=pseudo_json is not None)


def bdd_csd_tfrecords(json_path: str, image_dir: str, output_path: str,
                      num_labeled: int, train_indices,
                      saving_name: str = "",
                      label_map: Dict[int, str] = BDD) -> Tuple[int, int]:
    """BDD CSD labeled/unlabeled split — parity `bdd_tf_creator.py:191-330`.

    Unlabeled entries keep their images but drop every annotation (the
    pipeline pads GT to zeros, matching the reference's empty-feature
    examples)."""
    os.makedirs(output_path, exist_ok=True)
    with open(json_path) as f:
        data = json.load(f)
    by_name = sorted(data, key=lambda e: e["name"])
    chosen = [by_name[int(i)] for i in train_indices]
    labeled = chosen[:num_labeled]
    unlabeled = []
    for e in chosen[num_labeled:]:
        e = dict(e)
        e["labels"] = []
        unlabeled.append(e)
    tmp_lab = os.path.join(output_path, f"_lab{saving_name}.json")
    tmp_unl = os.path.join(output_path, f"_unl{saving_name}.json")
    with open(tmp_lab, "w") as f:
        json.dump(labeled, f)
    with open(tmp_unl, "w") as f:
        json.dump(unlabeled, f)
    n_lab = bdd_to_tfrecord(
        tmp_lab, image_dir,
        os.path.join(output_path, f"_train_labeled{saving_name}.tfrecord"),
        label_map=label_map)
    n_unl = bdd_to_tfrecord(
        tmp_unl, image_dir,
        os.path.join(output_path, f"_train_unlabeled{saving_name}.tfrecord"),
        label_map=label_map)
    return n_lab, n_unl
