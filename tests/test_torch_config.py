"""The PyTorch port's config module against ``udal_tpu.config``."""

import pytest

pytest.importorskip("torch")

from udal_tpu import config as jax_config  # noqa: E402
from udal_tpu_torch import config as torch_config  # noqa: E402

MODEL_NAMES = sorted(jax_config.EFFICIENTDET_MODEL_PARAMS) + \
    sorted(jax_config.EFFICIENTDET_LITE_MODEL_PARAMS)


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_detection_config_equals_jax(name):
    assert torch_config.get_detection_config(name).as_dict() == \
        jax_config.get_detection_config(name).as_dict()


def test_model_tables_equal():
    assert torch_config.EFFICIENTDET_MODEL_PARAMS == jax_config.EFFICIENTDET_MODEL_PARAMS
    assert torch_config.EFFICIENTDET_LITE_MODEL_PARAMS == \
        jax_config.EFFICIENTDET_LITE_MODEL_PARAMS


@pytest.mark.parametrize("override", [
    "image_size=1024x512,num_classes=8,mc_dropoutrate=0.05",
    "nms_configs.max_output_size=50,learning_rate=1e-3*2,heads=['object_detection']",
    {"nms_configs": {"method": "hard"}, "loss_attenuation": True},
])
def test_override_equals_jax(override):
    got = torch_config.get_detection_config("efficientdet-d0").override(override)
    want = jax_config.get_detection_config("efficientdet-d0").override(override)
    assert got.as_dict() == want.as_dict()


def test_unknown_key_and_yaml_path_raise():
    cfg = torch_config.get_detection_config("efficientdet-d0")
    with pytest.raises(KeyError):
        cfg.override("no_such_key=1")
    with pytest.raises(ValueError, match="yaml"):
        cfg.override("configs/whatever.yaml")


@pytest.mark.parametrize("size,level", [(512, 7), ("1024x512", 7), ("640x384", 8),
                                        ((300, 500), 5), (127, 6)])
def test_geometry_helpers_equal(size, level):
    assert torch_config.parse_image_size(size) == jax_config.parse_image_size(size)
    assert torch_config.get_feat_sizes(size, level) == jax_config.get_feat_sizes(size, level)


@pytest.mark.parametrize("name", ["KITTI_HEAD", "BDD", "KITTI_TRAIN"])
def test_chip_smoke_inference_configs_equal_their_yaml(name):
    """``chip_smoke.py`` carries the overrides of three config files in code
    (the card has no yaml): the same keys as the file, and the port's d0
    config overridden with them equals ``udal_tpu.config``'s overridden
    with the file, at every key the file sets."""
    import pathlib

    import yaml

    import chip_smoke

    path, overrides = getattr(chip_smoke, name)
    path = pathlib.Path(__file__).resolve().parents[1] / path
    keys = yaml.safe_load(path.read_text())
    assert set(overrides) == set(keys)
    want = jax_config.get_detection_config("efficientdet-d0").override(str(path))
    got = torch_config.get_detection_config("efficientdet-d0").override(overrides)
    for key in keys:
        assert got[key] == want[key], key
        assert type(got[key]) is type(want[key]), key


def test_chip_smoke_training_batch_equals_the_runner():
    """Phase 8's batch is the KITTI runner's, whose model is d0 and whose
    hparams file is the one phase 8 carries."""
    import configparser
    import pathlib

    import chip_smoke

    root = pathlib.Path(__file__).resolve().parents[1]
    path, runner = chip_smoke.KITTI_RUNNER
    ini = configparser.ConfigParser()
    ini.read(root / path)
    assert runner == {"batch_size": ini.getint("Hyperparameters", "batch_size")} == \
        {"batch_size": 8}
    assert ini["Hyperparameters"]["hparams"] == chip_smoke.KITTI_TRAIN[0]
    assert ini["Paths"]["model_name"] == "efficientdet-d0"
