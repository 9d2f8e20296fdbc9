"""Dataset label maps and per-image occlusion/truncation metadata.

Port of ``udal_tpu/data/label_maps.py``: the class-id maps (background =
0, real classes from 1), the datasets' shorthand codes and metadata
(``available_datasets``, ``get_dataset_data``) and ``get_ocl_trc``.
A label map comes as None, a dict, a registry name or a ``.yaml`` path,
read by the port's own YAML reader (``config.load_yaml``: the machine with
the card has no ``yaml``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple, Union

from udal_tpu_torch.config import load_yaml

KITTI = {1: "car", 2: "van", 3: "truck", 4: "pedestrian",
         5: "person_sitting", 6: "cyclist", 7: "tram"}

BDD = {1: "pedestrian", 2: "rider", 3: "car", 4: "truck", 5: "bus",
       6: "train", 7: "motorcycle", 8: "bicycle", 9: "traffic light",
       10: "traffic sign"}

# COCO (91-slot) and VOC maps for config parity with the reference registry.
VOC = {1: "aeroplane", 2: "bicycle", 3: "bird", 4: "boat", 5: "bottle",
       6: "bus", 7: "car", 8: "cat", 9: "chair", 10: "cow",
       11: "diningtable", 12: "dog", 13: "horse", 14: "motorbike",
       15: "person", 16: "pottedplant", 17: "sheep", 18: "sofa",
       19: "train", 20: "tvmonitor"}

WAYMO = {1: "vehicle", 2: "pedestrian", 3: "cyclist"}

_COCO_NAMES = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", None, "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", None, "backpack", "umbrella",
    None, None, "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", None, "wine glass", "cup",
    "fork", "knife", "spoon", "bowl", "banana", "apple", "sandwich",
    "orange", "broccoli", "carrot", "hot dog", "pizza", "donut", "cake",
    "chair", "couch", "potted plant", "bed", None, "dining table", None,
    None, "toilet", None, "tv", "laptop", "mouse", "remote", "keyboard",
    "cell phone", "microwave", "oven", "toaster", "sink", "refrigerator",
    None, "book", "clock", "vase", "scissors", "teddy bear", "hair drier",
    "toothbrush"]

COCO = {i + 1: n for i, n in enumerate(_COCO_NAMES) if n is not None}

_REGISTRY = {"kitti": KITTI, "bdd": BDD, "coco": COCO, "voc": VOC,
             "waymo": WAYMO}


def get_label_map(mapping: Union[None, str, Dict]) -> Optional[Dict[int, str]]:
    """A label map from None, a dict, a Config (``as_dict``), a yaml path or
    a registry name (kitti, bdd, coco, voc, waymo)."""
    if not mapping or isinstance(mapping, dict):
        return mapping
    if hasattr(mapping, "as_dict"):
        return mapping.as_dict()
    if not isinstance(mapping, str):
        raise TypeError(f"a label map is a dict or a str, got {type(mapping).__name__}")
    if mapping.endswith((".yaml", ".yml")):
        return load_yaml(mapping)
    return _REGISTRY[mapping]


def available_datasets(val: bool = False) -> List[str]:
    """The datasets' shorthand codes: the validation sets' with ``val``."""
    if val:
        return ["k", "b", "kc", "bc", "ks", "bs", "cbs", "cks"]
    return ["k", "b", "c"]


def get_dataset_data(path: str, im_name: Optional[str] = None
                     ) -> Tuple[Dict[int, str], Optional[str], List[str], List[int], Optional[str]]:
    """Metadata of the dataset whose name (KITTI, BDD, CODA) ``path``
    contains: (label map, image directory, capitalised class names, image
    shape [H, W], the image's path when ``im_name`` is given). An unknown
    path gives an empty map, no directory and shape [0, 0]."""
    label_map: Dict[int, str] = {}
    img_source_path = None
    img_shape = [0, 0]
    if "KITTI" in path:
        label_map, img_source_path, img_shape = KITTI, "/KITTI/training/image_2/", [375, 1220]
    elif "BDD" in path:
        label_map, img_source_path = BDD, "/BDD100K/bdd100k/images/100k/val/"
        img_shape = [720, 1280]
    elif "CODA" in path:
        label_map, img_source_path, img_shape = BDD, "/CODA/images/", [1000, 1500]
    class_names = [label_map[i].capitalize() for i in sorted(label_map)]
    img_file = (img_source_path + im_name) if (im_name and img_source_path) else None
    return label_map, img_source_path, class_names, img_shape, img_file


def get_ocl_trc(dataset_root: str, img_names: List[str]
                ) -> Tuple[List[List[float]], List[List[float]]]:
    """Per-image occlusion/truncation ground-truth metadata.

    KITTI reads the label_2 txt columns (1 = truncated, 2 = occluded);
    BDD reads the val-labels json attributes. Images without metadata get
    [-1]*100 placeholders.
    """
    occlusions: List[List[float]] = []
    truncations: List[List[float]] = []
    if "KITTI" in dataset_root:
        for im_name in img_names:
            stem = os.path.splitext(os.path.basename(im_name))[0]
            path = os.path.join(dataset_root, "training", "label_2",
                                stem + ".txt")
            occl: List[float] = []
            trcs: List[float] = []
            if os.path.exists(path):
                with open(path) as f:
                    for line in f:
                        parts = line.split(" ")
                        if len(parts) > 2 and parts[0] != "DontCare":
                            trcs.append(float(parts[1]))
                            occl.append(float(parts[2]))
            occlusions.append(occl or [-1.0] * 100)
            truncations.append(trcs or [-1.0] * 100)
        return occlusions, truncations
    if "BDD" in dataset_root:
        label_names = set(BDD.values())
        path = os.path.join(dataset_root, "bdd100k", "labels",
                            "bdd100k_labels_images_val.json")
        by_name = {}
        if os.path.exists(path):
            with open(path) as f:
                for entry in json.load(f):
                    occl = [float(l["attributes"].get("occluded", -1))
                            for l in entry.get("labels", [])
                            if l.get("category") in label_names]
                    trcs = [float(l["attributes"].get("truncated", -1))
                            for l in entry.get("labels", [])
                            if l.get("category") in label_names]
                    by_name[entry["name"]] = (occl, trcs)
        for im_name in img_names:
            occl, trcs = by_name.get(os.path.basename(im_name), ([], []))
            occlusions.append(occl or [-1.0] * 100)
            truncations.append(trcs or [-1.0] * 100)
        return occlusions, truncations
    for _ in img_names:
        occlusions.append([-1.0] * 100)
        truncations.append([-1.0] * 100)
    return occlusions, truncations
