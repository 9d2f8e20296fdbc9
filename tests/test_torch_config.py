"""The PyTorch port's config module against ``udal_tpu.config``."""

import pathlib

import pytest

pytest.importorskip("torch")

from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
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


def test_unknown_key_and_yaml_path_raise(tmp_path):
    """An unknown key raises; a yaml path is read by the port's own YAML
    reader (equal to the JAX package's override with the same file), and
    yaml outside the reader's flat subset raises."""
    cfg = torch_config.get_detection_config("efficientdet-d0")
    with pytest.raises(KeyError):
        cfg.override("no_such_key=1")
    path = str(pathlib.Path(__file__).resolve().parents[1] /
               "configs/train/allclasses_mcdropout_lossatt.yaml")
    assert cfg.override(path).as_dict() == \
        jax_config.get_detection_config("efficientdet-d0").override(path).as_dict()
    nested = tmp_path / "nested.yaml"
    nested.write_text("nms_configs:\n  method: hard\n")
    with pytest.raises(ValueError, match="YAML"):
        cfg.override(str(nested))


@pytest.mark.parametrize("text", ["a: 0x10", "a: 0o7", "a: 07", "a: 1_000", "a: 1e5",
                                  "a: .5", "a: .inf", "a: -.Inf", "a: .nan", "a: 2020-01-01",
                                  "a: 1:30", 'a: "tab\\t"', "a: [1, 2]", "a: &x 1",
                                  "a:\n  b: 1"])
def test_yaml_outside_the_subset_raises(text):
    """YAML that ``yaml.safe_load`` reads as another number, a timestamp, an
    escape, a collection or an anchor raises rather than reading as a string."""
    with pytest.raises(ValueError, match="YAML|yaml|outside"):
        torch_config.parse_yaml(text)


@pytest.mark.parametrize("text,want", [
    ("a: 1\nb: -2.5\nc: 1.0e-05\nd: yes\ne: ~\nf: 'it''s'\ng: \"x y\"\nh: p/q # c\n",
     {"a": 1, "b": -2.5, "c": 1e-05, "d": True, "e": None, "f": "it's", "g": "x y",
      "h": "p/q"}),
    ("---\n# only a comment\n", None)])
def test_yaml_subset_reads_as_safe_load(text, want):
    yaml = pytest.importorskip("yaml")
    assert torch_config.parse_yaml(text) == want == yaml.safe_load(text)


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
