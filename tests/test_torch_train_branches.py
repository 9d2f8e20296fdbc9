"""The train step's other branches against the JAX package's: STAC's
labelled / pseudo-labelled split with the segmentation head's loss, and
CSD's flipped second forward, on the CPU.

The harness of ``tests/test_torch_train_step.py`` (the same reduced d0,
numpy weights, JAX's step jitted with its dropout sites fed from inputs,
the keep bits replayed on the port's side, the same tolerances): one step
with MC dropout, then the loss dict, the clipped gradients, the weights,
the batch statistics (CSD updates them with both forwards, in order), the
momentum and the EMA.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from tests.test_torch_fixtures import random_variables  # noqa: E402
from tests.test_torch_train_step import (B, IMAGE, assert_grads_close,  # noqa: E402
                                         assert_state_close, assert_values_close, jax_state,
                                         jax_stepper, keep_bits, make_batch, multipliers,
                                         port_state, run_port, site_shapes, train_configs)

BRANCHES = {
    # the segmentation head doubles each level into the next finer one, which at 64x64
    # holds down to level 6 (levels 6 and 7 are both 1x1)
    "stac_segmentation": dict(ssl_method="STAC", unlabeled_start=1, stac_lambda=0.5,
                              heads=["object_detection", "segmentation"], max_level=6),
    "csd": dict(ssl_method="CSD", unlabeled_start=1, csd_ramp=True, csd_BE=True,
                csd_BE_thr=0.01, num_epochs=2),
}


def branch_batch(name):
    """The step's batch: segmentation masks at the head's 2x-of-level-3 size
    for the segmentation branch."""
    images, labels = make_batch(50)
    if "segmentation" in BRANCHES[name].get("heads", []):
        size = 2 * -(-IMAGE // 8)
        labels["image_masks"] = np.random.RandomState(51).randint(0, 3, (B, size, size)) \
            .astype(np.int32)
    return images, labels


@pytest.mark.parametrize("name", sorted(BRANCHES))
def test_branch_step_matches_jax(name, monkeypatch):
    jax_cfg, torch_cfg = train_configs(**BRANCHES[name])
    variables = random_variables(jax_cfg, seed=12)
    state, tx, schedule = jax_state(jax_cfg, variables)
    images, labels = branch_batch(name)
    shapes = site_shapes(torch_cfg, images, labels)
    forwards = 2 if name == "csd" else 1
    levels = torch_cfg.max_level - torch_cfg.min_level + 1
    assert len(shapes) == forwards * (1 + 2 * 15 + 2 * levels)
    bits = keep_bits(np.random.RandomState(52), shapes)
    state, vals, grads = jax_stepper(jax_cfg, tx, schedule)(state, images, labels,
                                                            multipliers(bits))
    pstate, pschedule = port_state(torch_cfg, variables)
    (got_vals, got_grads), = run_port(torch_cfg, pstate, pschedule, [(images, labels)], [bits],
                                      monkeypatch)
    want_keys = {"stac_segmentation": {"pseudo_det_loss", "seg_loss"},
                 "csd": {"unsup_cls_loss", "unsup_box_loss", "ramp_w"}}[name]
    assert want_keys <= set(got_vals)
    assert_values_close(got_vals, vals, name)
    assert_grads_close(got_grads, grads, True, f"{name} gradients")
    assert_state_close(pstate, state, name)
    if name == "stac_segmentation":
        assert "seg_head" in got_grads
    assert jax.tree_util.tree_structure(got_grads) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, grads))
