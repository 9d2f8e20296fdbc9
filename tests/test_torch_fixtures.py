"""Shared inputs for the PyTorch-port parity tests (``tests/test_torch_*.py``),
and their one CPU thread.

The test configuration is EfficientDet-d0 at its published widths, cut to
128x128 input, 8 classes, one BiFPN cell and one head repeat, with loss
attenuation. Weights are numpy draws from a seed laid out as the flax
variable tree (shapes from ``jax.eval_shape`` of the flax init, so no
flax init runs); both packages get the same numbers, the port through
``convert.py``. The tests here hold the port's own layout of that tree
against flax's.

Every port test file imports ``one_cpu_thread`` from here, by the file's
own name (``from test_torch_fixtures import one_cpu_thread``: pytest puts
``tests/`` on the path, and the card's machine has an installed package
named ``tests``); a test below checks it. This module imports JAX only
inside the functions that use it, so the card's test files, which run
where there is no JAX, import it too.
"""

import ast
import os
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from udal_tpu_torch import config as torch_config  # noqa: E402
from udal_tpu_torch.convert import load_flax, torch_to_flax  # noqa: E402
from udal_tpu_torch.models.efficientdet import EfficientDetNet  # noqa: E402


def one_cpu_thread() -> None:
    """One CPU thread for torch in this process, and for the processes it
    starts (``OMP_NUM_THREADS``: the ranks of ``parallel.dryrun.spawn_world``,
    the reader's workers, subprocesses). The tests run in several worker
    processes on a few cores, where torch's default of a thread per core
    makes the workers spin against each other; and some tests compare CPU
    convolutions bit for bit, which round by thread count. Run once in a
    process, when this module is first imported, and never undone."""
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)


one_cpu_thread()

IMAGE = 128


def small_overrides(mc: bool = False, samples: int = 3) -> dict:
    return dict(image_size=f"{IMAGE}x{IMAGE}", num_classes=8, loss_attenuation=True,
                fpn_cell_repeats=1, box_class_repeats=1, is_training_bn=False,
                mc_dropout=mc, mc_dropoutrate=0.05 if mc else 0.0,
                mc_dropoutsamp=samples)


def configs(mc: bool = False, samples: int = 3, extra: dict = None):
    """(JAX config, port config) with the same overrides, then ``extra``."""
    from udal_tpu import config as jax_config

    out = []
    for api in (jax_config, torch_config):
        cfg = api.get_detection_config("efficientdet-d0")
        cfg.override(small_overrides(mc, samples))
        cfg.override(extra or {})
        out.append(cfg)
    return tuple(out)


HEAD_ONLY = dict(mc_dropoutrate=0.0, mc_classheadrate=0.05, mc_boxheadrate=0.05,
                 enable_softmax=True)
SEGMENTATION = dict(heads=["object_detection", "segmentation"])


_SHAPES = {}


def flax_shapes(jax_cfg, image: int = IMAGE):
    """The flax variable tree's shapes, traced once per configuration, on
    an ``image`` x ``image`` input (the configuration's canvas)."""
    import jax
    import jax.numpy as jnp

    from udal_tpu.models.efficientdet import EfficientDetNet as JaxNet

    key = repr(sorted(jax_cfg.as_dict().items()))
    if key not in _SHAPES:
        model = JaxNet(jax_cfg)
        _SHAPES[key] = jax.eval_shape(lambda: model.init(
            {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, image, image, 3)),
            train=False))
    return _SHAPES[key]


def random_variables(jax_cfg, seed: int = 0, image: int = IMAGE) -> dict:
    """{'params', 'batch_stats'} as nested dicts of float32 numpy arrays,
    drawn from ``seed``. Kernels at lecun-normal scale keep the activations
    of the random network O(1) (He scale lets some seeds grow them to 1e3,
    where float32 parity is a matter of conditioning, not of the port)."""
    import jax

    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.normal(0.0, np.sqrt(1.0 / fan_in), shape)
        elif name in ("scale", "var", "edge_weights"):
            v = rng.uniform(0.5, 1.5, shape)
        else:                                   # bias, mean
            v = rng.normal(0.0, 0.1, shape)
        return np.asarray(v, np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, flax_shapes(jax_cfg, image))
    return jax.tree_util.tree_map(np.asarray, {k: dict(v) for k, v in tree.items()})


def torch_model(torch_cfg, variables) -> "EfficientDetNet":
    """The port's model in f32 on the CPU with ``variables`` loaded."""
    model = EfficientDetNet(torch_cfg)
    load_flax(model, variables["params"], variables["batch_stats"])
    return model.eval()


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + "/")
        else:
            yield prefix + k, tuple(v.shape)


@pytest.mark.parametrize("mc,extra", [(False, None), (True, None), (False, SEGMENTATION)],
                         ids=["False", "True", "segmentation"])
def test_port_layout_equals_flax_tree(mc, extra):
    """Every flax leaf has a torch parameter or buffer of the same size, and
    the reverse: ``torch_to_flax`` of a fresh port model reproduces the
    flax variable tree's paths and shapes (with the segmentation head: its
    transposed convs' kernels too)."""
    import jax

    jax_cfg, torch_cfg = configs(mc, extra=extra)
    want = flax_shapes(jax_cfg)
    params, stats = torch_to_flax(EfficientDetNet(torch_cfg))
    assert dict(_flat(params)) == dict(_flat(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape), dict(want["params"]))))
    assert dict(_flat(stats)) == dict(_flat(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape), dict(want["batch_stats"]))))


def test_every_port_test_file_takes_one_cpu_thread():
    """Every other ``tests/test_torch_*.py`` imports ``one_cpu_thread`` from
    this module at its top level and sets no thread count of its own, so a
    new port test file cannot bring back torch's thread per core."""
    here = pathlib.Path(__file__).resolve()
    missing, own = [], []
    for path in sorted(here.parent.glob("test_torch_*.py")):
        if path == here:
            continue
        source = path.read_text()
        if not any(isinstance(node, ast.ImportFrom) and node.module == "test_torch_fixtures"
                   and any(a.name == "one_cpu_thread" for a in node.names)
                   for node in ast.parse(source).body):
            missing.append(path.name)
        if "set_num_threads" in source:
            own.append(path.name)
    assert (missing, own) == ([], [])
    assert torch.get_num_threads() == 1 and os.environ["OMP_NUM_THREADS"] == "1"
