"""Hierarchical dot-dict config, the detection defaults and the model tables.

Port of ``udal_tpu/config.py``. ``Config``, ``default_detection_configs``,
the d0-d7x / lite tables, ``get_detection_config``, ``parse_image_size``
and ``get_feat_sizes`` give the same values as the JAX package (held by
``tests/test_torch_config.py``).

The machine with the card has no ``yaml``, so the port reads the YAML the
repo's files use with its own reader (``load_yaml`` / ``parse_yaml``): a
flat mapping of ``key: scalar`` lines with comments, a leading ``---``,
quoted strings (no escapes), decimal numbers, booleans and null, each
resolved as ``yaml.safe_load`` resolves it (YAML 1.1), or a JSON object (what
``Config.save_to_yaml`` writes: JSON is YAML, so ``yaml.safe_load`` reads
it too). Anything else raises ``ValueError``.
"""

from __future__ import annotations

import ast
import copy
import json
import math
import re
from typing import Any, Dict, Optional, Sequence, Tuple, Union


def _maybe_parse(value: str) -> Any:
    """Parse a ``k=v`` override value into a Python literal when possible."""
    if not isinstance(value, str):
        return value
    low = value.strip()
    if low == "None":
        return None
    if low == "True":
        return True
    if low == "False":
        return False
    try:
        return ast.literal_eval(low)
    except (ValueError, SyntaxError):
        pass
    # simple arithmetic like 2*3 or 1e-3*2
    try:
        node = ast.parse(low, mode="eval")
        allowed = (ast.Expression, ast.BinOp, ast.UnaryOp, ast.Constant,
                   ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Pow, ast.USub, ast.UAdd,
                   ast.Tuple, ast.List)
        if all(isinstance(n, allowed) for n in ast.walk(node)):
            return eval(compile(node, "<cfg>", "eval"))  # noqa: S307 - sanitized
    except (ValueError, SyntaxError):
        pass
    return value


class Config:
    """A recursive dot-dict configuration object."""

    def __init__(self, config_dict: Optional[Dict[str, Any]] = None):
        self.update(config_dict)

    def __repr__(self) -> str:
        return repr(self.as_dict())

    def __setattr__(self, k: str, v: Any) -> None:
        self.__dict__[k] = Config(v) if isinstance(v, dict) else copy.deepcopy(v)

    def __getattr__(self, k: str) -> Any:
        # Only called when normal lookup fails.
        raise AttributeError(f"Config has no attribute {k!r}")

    def __getitem__(self, k: str) -> Any:
        return self.__dict__[k]

    def __setitem__(self, k: str, v: Any) -> None:
        self.__setattr__(k, v)

    def __contains__(self, k: str) -> bool:
        return k in self.__dict__

    def __iter__(self):
        return iter(self.__dict__)

    def get(self, k: str, default: Any = None) -> Any:
        return self.__dict__.get(k, default)

    def keys(self):
        return self.__dict__.keys()

    def items(self):
        return self.__dict__.items()

    def update(self, config_dict: Optional[Dict[str, Any]]) -> None:
        """Recursively set keys (creating new ones as needed)."""
        if not config_dict:
            return
        for k, v in config_dict.items():
            if isinstance(v, dict) and isinstance(self.__dict__.get(k), Config):
                self.__dict__[k].update(v)
            else:
                self.__setattr__(k, v)

    def override(self, value: Union[None, str, Dict[str, Any], "Config"],
                 allow_new_keys: bool = False) -> "Config":
        """Override existing keys from a dict, Config or ``k=v`` string.

        Unknown keys raise ``KeyError`` unless ``allow_new_keys``.
        """
        if value is None:
            return self
        if isinstance(value, Config):
            value = value.as_dict()
        if isinstance(value, str):
            if value.endswith((".yaml", ".yml")):
                value = load_yaml(value) or {}
            else:
                value = self._parse_kv_string(value)
        if not isinstance(value, dict):
            raise ValueError(f"Cannot override config from {value!r}")
        self._override_dict(value, allow_new_keys)
        return self

    def _parse_kv_string(self, s: str) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for item in filter(None, (p.strip() for p in s.split(","))):
            if "=" not in item:
                raise ValueError(f"Invalid override segment {item!r}")
            k, v = item.split("=", 1)
            d = out
            parts = k.strip().split(".")
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = _maybe_parse(v)
        return out

    def _override_dict(self, d: Dict[str, Any], allow_new_keys: bool) -> None:
        for k, v in d.items():
            if k not in self.__dict__ and not allow_new_keys:
                raise KeyError(f"Unknown config key: {k!r}")
            existing = self.__dict__.get(k)
            if isinstance(existing, Config) and isinstance(v, dict):
                existing._override_dict(v, allow_new_keys)
            elif isinstance(existing, dict) and isinstance(v, dict):
                existing.update(v)
            else:
                self.__setattr__(k, v)

    def as_dict(self) -> Dict[str, Any]:
        out = {}
        for k, v in self.__dict__.items():
            out[k] = v.as_dict() if isinstance(v, Config) else copy.deepcopy(v)
        return out

    def save_to_yaml(self, path: str) -> None:
        """Write the config as JSON text, which is YAML: ``load_yaml`` and
        ``yaml.safe_load`` both read it back. Floats are written with a
        point and a signed exponent (``1.0e-05``), as YAML 1.1 needs to
        read them as floats; a value that is not finite raises."""
        write_yaml(path, self.as_dict())

    def copy(self) -> "Config":
        return Config(self.as_dict())


def write_yaml(path: str, data: Dict[str, Any]) -> None:
    """Write ``data`` as JSON text, which is YAML (``save_to_yaml``'s
    format)."""
    with open(path, "w") as f:
        f.write(_to_json(data) + "\n")


def _to_json(value: Any, indent: int = 0) -> str:
    pad, inner = " " * indent, " " * (indent + 2)
    if isinstance(value, dict):
        if not value:
            return "{}"
        items = [f"{inner}{json.dumps(str(k))}: {_to_json(v, indent + 2)}"
                 for k, v in value.items()]
        return "{\n" + ",\n".join(items) + "\n" + pad + "}"
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_to_json(v, indent + 2) for v in value) + "]"
    if isinstance(value, float):
        if not math.isfinite(value):
            raise ValueError(f"save_to_yaml cannot write the non-finite float {value}")
        text = repr(value)
        if "e" in text and "." not in text.split("e")[0]:
            text = text.replace("e", ".0e")
        return text
    if value is None or isinstance(value, (bool, int, str)):
        return json.dumps(value)
    raise ValueError(f"save_to_yaml cannot write {type(value).__name__} values")


# the implicit scalars of the repo's files as ``yaml.safe_load`` (YAML 1.1)
# resolves them: null, booleans, decimal ints and floats
_YAML_NULL = ("", "~", "null", "Null", "NULL")
_YAML_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_YAML_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE", "off",
                                      "Off", "OFF")})
_YAML_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9]*)$")
_YAML_FLOAT = re.compile(r"^[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?$")
# what YAML 1.1 reads as another number, a timestamp or a non-finite float
_YAML_OTHER_NUMBER = re.compile(r"^(?:[-+]?\.?[0-9]|[-+]?\.(?:inf|Inf|INF)$|\.(?:nan|NaN|NAN)$)")


def _outside(where: str, text: str) -> ValueError:
    return ValueError(f"{where}: {text!r} is outside the YAML subset the port reads "
                      "(flat key: scalar mappings of null, booleans, decimal numbers "
                      "and strings)")


def _yaml_plain(text: str, where: str) -> Any:
    """A plain (unquoted) scalar resolved as YAML 1.1 resolves it."""
    if (text and text[0] in "[]{}&*!|>%@`\"',") or text.startswith(("- ", "? ", "<<")) or \
            text == "-" or ": " in text or text.endswith(":"):
        raise _outside(where, text)
    if text in _YAML_NULL:
        return None
    if text in _YAML_BOOL:
        return _YAML_BOOL[text]
    if _YAML_INT.match(text):
        return int(text)
    if _YAML_FLOAT.match(text):
        return float(text)
    if _YAML_OTHER_NUMBER.match(text):
        raise _outside(where, text)
    return text


def _yaml_scalar(text: str, where: str) -> Any:
    """A scalar with its trailing comment: quoted (a double-quoted string
    without escapes) or plain."""
    text = text.strip()
    if text[:1] in ("'", '"'):
        quote = text[0]
        end = text.find(quote, 1)
        while end > 0 and quote == "'" and text[end + 1:end + 2] == "'":   # '' is a quote
            end = text.find(quote, end + 2)
        if end < 0:
            raise ValueError(f"{where}: unterminated quoted string")
        body, rest = text[1:end], text[end + 1:].strip()
        if quote == '"' and "\\" in body:
            raise _outside(where, text)
        if rest and not rest.startswith("#"):
            raise ValueError(f"{where}: text after a quoted string: {rest!r}")
        return body.replace("''", "'") if quote == "'" else body
    comment = re.search(r"\s#", text)
    if comment:
        text = text[:comment.start()].rstrip()
    return _yaml_plain(text, where)


def parse_yaml(text: str, name: str = "<yaml>") -> Any:
    """The document of ``text``: None when it holds no content, else a
    dict. Raises ValueError outside the subset the module docstring names."""
    body = "\n".join(line for line in text.splitlines()
                     if line.strip() and not line.lstrip().startswith("#"))
    if body.lstrip().startswith("{"):
        return json.loads(body)
    out: Dict[Any, Any] = {}
    started = False
    for n, line in enumerate(text.splitlines(), 1):
        where = f"{name}:{n}"
        stripped = line.rstrip()
        if not stripped.strip() or stripped.lstrip().startswith("#"):
            continue
        if stripped.startswith("---"):
            rest = stripped[3:].strip()
            if started or (rest and not rest.startswith("#")):
                raise ValueError(f"{where}: one document with a leading '---' only")
            started = True
            continue
        started = True
        if line[:1] in (" ", "\t"):
            raise ValueError(f"{where}: indented (nested) YAML is outside the subset the "
                             "port reads")
        m = re.match(r"^([^:#'\"]+?):(?:\s+(.*))?$", stripped)
        if m is None:
            raise ValueError(f"{where}: {stripped!r} is not a 'key: value' line")
        key = _yaml_plain(m.group(1).strip(), where)
        out[key] = _yaml_scalar(m.group(2) or "", where)
    return out if out else None


def load_yaml(path: str) -> Any:
    """``parse_yaml`` of a file."""
    with open(path) as f:
        return parse_yaml(f.read(), path)


def default_detection_configs() -> Config:
    """Default hyperparameters, the same keys and values as ``udal_tpu``."""
    h = Config()

    # -- uncertainty / auto-labeling knobs -----------------------------------
    h.early_stopping_patience = 0
    h.infer_draw_uncert = True
    h.loss_attenuation = False          # aleatoric box uncertainty head
    h.strict_loss_parity = False
    h.la_beta_nll = 0.0
    h.clip_min_uncert = 0.01
    h.clip_max_uncert = 1024
    h.uncert_adjust_method = "l-norm"   # [l-norm, n-flow, falsedec, sample]
    h.decode_nsamples = 100

    h.mc_dropout = False
    h.mc_dropoutrate = 0.0
    h.mc_classheadrate = 0.0
    h.mc_boxheadrate = 0.0
    h.mc_dropoutsamp = 10

    h.assign_gt_box = "IoU"             # ["MSE", "IoU", False]

    h.enable_softmax = False
    h.calibrate_classification = True
    h.calib_method_class = "iso_percls"
    h.calibrate_regression = True
    h.calib_method_box = "iso_perclscoo"

    h.count_classes = False
    h.boxloss_type = "huber"            # ["MSE", "huber"]
    h.save_freq = 1
    h.sample_images = None
    h.sample_images_freq = None
    h.save_train_images = False
    h.autoaugment_policy = None         # None | 'v0' | 'randaug' | 'albu'
    h.albumentations_mode = "optimal"
    h.albumentations_path = "configs/augmentation/"
    h.albumentations_ops = ["rain", "snow", "fog", "sat"]
    h.consistency_ssl = False
    h.infer_augment = False

    h.thr_fpr_tpr = 0.95
    h.thr_cd = True
    h.thr_iou_thrs = [0.5, 0.55, 0.6, 0.65, 0.7, 0.75]
    h.thr_sel_uncert = "ENTALBOX"

    # -- core model ----------------------------------------------------------
    h.name = "efficientdet-d1"
    h.act_type = "swish"
    h.image_size = 640                  # int or 'WxH' string
    h.target_size = None
    h.input_rand_hflip = True
    h.jitter_min = 0.1
    h.jitter_max = 2.0
    h.grid_mask = False
    h.map_freq = 5

    h.num_classes = 90                  # includes background slot 0
    h.seg_num_classes = 3
    h.heads = ["object_detection"]

    h.skip_crowd_during_training = True
    h.label_map = None
    h.max_instances_per_image = 100
    h.regenerate_source_id = False

    h.min_level = 3
    h.max_level = 7
    h.num_scales = 3
    h.aspect_ratios = [1.0, 2.0, 0.5]
    h.anchor_scale = 4.0
    h.is_training_bn = True

    # -- optimization ----------------------------------------------------------
    h.momentum = 0.9
    h.optimizer = "sgd"
    h.learning_rate = 0.08
    h.lr_warmup_init = 0.008
    h.lr_warmup_epoch = 1.0
    h.first_lr_drop_epoch = 200.0
    h.second_lr_drop_epoch = 250.0
    h.poly_lr_power = 0.9
    h.clip_gradients_norm = 10.0
    h.num_epochs = 300
    h.data_format = "channels_last"
    h.mean_rgb = [0.485 * 255, 0.456 * 255, 0.406 * 255]
    h.stddev_rgb = [0.229 * 255, 0.224 * 255, 0.225 * 255]
    h.scale_range = False

    h.label_smoothing = 0.0
    h.alpha = 0.25
    h.gamma = 1.5
    h.delta = 0.1
    h.box_loss_weight = 50.0
    h.iou_loss_type = None
    h.iou_loss_weight = 1.0
    h.weight_decay = 4e-5
    h.strategy = None
    h.mixed_precision = False
    h.loss_scale = None
    h.train_matmul_precision = "highest"

    # -- detection head layout -------------------------------------------------
    h.box_class_repeats = 3
    h.fpn_cell_repeats = 3
    h.fpn_num_filters = 88
    h.separable_conv = True
    h.fused_sepconv = False
    h.apply_bn_for_resampling = True
    h.conv_after_downsample = False
    h.conv_bn_act_pattern = False
    h.drop_remainder = True

    h.nms_configs = {
        "method": "gaussian",
        "iou_thresh": None,
        "score_thresh": 0.0,
        "sigma": None,
        "pyfunc": False,
        "max_nms_inputs": 0,
        "max_output_size": 100,
    }
    h.tflite_max_detections = 100

    h.fpn_name = None
    h.fpn_weight_method = None
    h.fpn_config = None
    h.survival_prob = None

    h.lr_decay_method = "cosine"
    h.moving_average_decay = 0.9998
    h.ckpt_var_scope = None
    h.skip_mismatch = True

    h.backbone_name = "efficientnet-b1"
    h.backbone_config = None
    h.var_freeze_expr = None

    h.use_keras_model = True            # kept for config-string compat
    h.dataset_type = None
    h.positives_momentum = None
    h.grad_checkpoint = False
    h.verbose = 1
    return h


# (name -> backbone, image_size, fpn_filters, fpn_repeats, box_class_repeats,
#  extras), as in udal_tpu/config.py.
EFFICIENTDET_MODEL_PARAMS: Dict[str, Dict[str, Any]] = {
    "efficientdet-d0": dict(backbone_name="efficientnet-b0", image_size=512,
                            fpn_num_filters=64, fpn_cell_repeats=3, box_class_repeats=3),
    "efficientdet-d1": dict(backbone_name="efficientnet-b1", image_size=640,
                            fpn_num_filters=88, fpn_cell_repeats=4, box_class_repeats=3),
    "efficientdet-d2": dict(backbone_name="efficientnet-b2", image_size=768,
                            fpn_num_filters=112, fpn_cell_repeats=5, box_class_repeats=3),
    "efficientdet-d3": dict(backbone_name="efficientnet-b3", image_size=896,
                            fpn_num_filters=160, fpn_cell_repeats=6, box_class_repeats=4),
    "efficientdet-d4": dict(backbone_name="efficientnet-b4", image_size=1024,
                            fpn_num_filters=224, fpn_cell_repeats=7, box_class_repeats=4),
    "efficientdet-d5": dict(backbone_name="efficientnet-b5", image_size=1280,
                            fpn_num_filters=288, fpn_cell_repeats=7, box_class_repeats=4),
    "efficientdet-d6": dict(backbone_name="efficientnet-b6", image_size=1280,
                            fpn_num_filters=384, fpn_cell_repeats=8, box_class_repeats=5,
                            fpn_weight_method="sum"),
    "efficientdet-d7": dict(backbone_name="efficientnet-b6", image_size=1536,
                            fpn_num_filters=384, fpn_cell_repeats=8, box_class_repeats=5,
                            anchor_scale=5.0, fpn_weight_method="sum"),
    "efficientdet-d7x": dict(backbone_name="efficientnet-b7", image_size=1536,
                             fpn_num_filters=384, fpn_cell_repeats=8, box_class_repeats=5,
                             anchor_scale=4.0, max_level=8, fpn_weight_method="sum"),
}

_LITE_COMMON = dict(mean_rgb=127.0, stddev_rgb=128.0, act_type="relu6",
                    fpn_weight_method="sum")

EFFICIENTDET_LITE_MODEL_PARAMS: Dict[str, Dict[str, Any]] = {
    "efficientdet-lite0": dict(backbone_name="efficientnet-lite0", image_size=320,
                               fpn_num_filters=64, fpn_cell_repeats=3,
                               box_class_repeats=3, anchor_scale=3.0, **_LITE_COMMON),
    "efficientdet-lite1": dict(backbone_name="efficientnet-lite1", image_size=384,
                               fpn_num_filters=88, fpn_cell_repeats=4,
                               box_class_repeats=3, anchor_scale=3.0, **_LITE_COMMON),
    "efficientdet-lite2": dict(backbone_name="efficientnet-lite2", image_size=448,
                               fpn_num_filters=112, fpn_cell_repeats=5,
                               box_class_repeats=3, anchor_scale=3.0, **_LITE_COMMON),
    "efficientdet-lite3": dict(backbone_name="efficientnet-lite3", image_size=512,
                               fpn_num_filters=160, fpn_cell_repeats=6,
                               box_class_repeats=4, **_LITE_COMMON),
    "efficientdet-lite3x": dict(backbone_name="efficientnet-lite3", image_size=640,
                                fpn_num_filters=200, fpn_cell_repeats=6,
                                box_class_repeats=4, anchor_scale=3.0, **_LITE_COMMON),
    "efficientdet-lite4": dict(backbone_name="efficientnet-lite4", image_size=640,
                               fpn_num_filters=224, fpn_cell_repeats=7,
                               box_class_repeats=4, **_LITE_COMMON),
}


def get_efficientdet_config(model_name: str = "efficientdet-d1") -> Config:
    h = default_detection_configs()
    if model_name in EFFICIENTDET_MODEL_PARAMS:
        h.override(dict(name=model_name, **EFFICIENTDET_MODEL_PARAMS[model_name]))
    elif model_name in EFFICIENTDET_LITE_MODEL_PARAMS:
        h.override(dict(name=model_name, **EFFICIENTDET_LITE_MODEL_PARAMS[model_name]))
    else:
        raise ValueError(f"Unknown model name: {model_name}")
    return h


def get_detection_config(model_name: str) -> Config:
    if model_name.startswith("efficientdet"):
        return get_efficientdet_config(model_name)
    raise ValueError("model name must start with efficientdet.")


def config_from_args(args) -> Config:
    """The command line's config: ``--model_name``'s, then ``--hparams``
    (a yaml path or ``k=v`` string), the batch size and the epochs."""
    config = get_detection_config(args.model_name)
    if args.hparams:
        config.override(args.hparams, allow_new_keys=True)
    config.override({"batch_size": args.batch_size}, allow_new_keys=True)
    if args.num_epochs:
        config.num_epochs = args.num_epochs
    return config


ImageSize = Union[int, str, Tuple[int, int]]


def parse_image_size(image_size: ImageSize) -> Tuple[int, int]:
    """Return (height, width). Strings are 'WxH'."""
    if isinstance(image_size, int):
        return (image_size, image_size)
    if isinstance(image_size, str):
        width, height = image_size.lower().split("x")
        return (int(height), int(width))
    if isinstance(image_size, (tuple, list)):
        return tuple(image_size)  # type: ignore[return-value]
    raise ValueError(f"image_size must be int, 'WxH' str or (h, w): {image_size!r}")


def get_feat_sizes(image_size: ImageSize, max_level: int) -> Sequence[Dict[str, int]]:
    """Stride-2 pyramid sizes with ceil division, level 0 first."""
    size = parse_image_size(image_size)
    feat_sizes = [{"height": size[0], "width": size[1]}]
    for _ in range(1, max_level + 1):
        size = ((size[0] - 1) // 2 + 1, (size[1] - 1) // 2 + 1)
        feat_sizes.append({"height": size[0], "width": size[1]})
    return feat_sizes
