"""Deep ensembles of the port against ``udal_tpu/models/ensemble.py``.

Random members (numpy from seeds, in the flax variable layout) go to both
packages: the JAX side stacks the trees and ``vmap``s one forward over
them; the port converts the stacked tree (``flax_to_torch_stacked``), runs
each member in turn and stacks the outputs. Then ``ServingDriver(ensemble=
True)`` of both packages, whose post-processing fuses the members as MC
samples: mean boxes, the members' spread as the epistemic σ.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import udal_tpu.apps.serving as jax_serving  # noqa: E402
from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from tests.test_torch_fixtures import IMAGE, configs, random_variables, torch_model  # noqa: E402
from tests.test_torch_head_mc import sigma_check  # noqa: E402
from tests.test_torch_mc import match_detections  # noqa: E402
from udal_tpu.models import ensemble as jax_ensemble  # noqa: E402
from udal_tpu.models.efficientdet import EfficientDetNet as JaxNet  # noqa: E402
from udal_tpu_torch.apps.serving import ServingDriver  # noqa: E402
from udal_tpu_torch.convert import flax_to_torch, flax_to_torch_stacked  # noqa: E402
from udal_tpu_torch.models import ensemble  # noqa: E402

B = 2
ATOL, RTOL = 1e-4, 1e-3


def random_members(jax_cfg, n):
    members = [random_variables(jax_cfg, seed=40 + i) for i in range(n)]
    return members, jax_ensemble.stack_variables(members)


@pytest.fixture(scope="module")
def case():
    """Two members through the JAX package's vmapped forward."""
    n = 2
    jax_cfg, torch_cfg = configs()
    members, stacked = random_members(jax_cfg, n)
    images = np.random.RandomState(41).uniform(-2, 2, (B, IMAGE, IMAGE, 3)).astype(np.float32)
    model = JaxNet(jax_cfg)
    cls, box = jax.jit(lambda v, x: jax_ensemble.ensemble_forward(model, v, x))(
        stacked, jnp.asarray(images))
    return dict(n=n, jax_cfg=jax_cfg, torch_cfg=torch_cfg, members=members, stacked=stacked,
                images=images, cls=list(cls), box=list(box))


@pytest.mark.parametrize("n", [2, 3])
def test_stack_variables_matches_the_stacked_flax_tree(n):
    """The port's stack of converted members equals the converted stack."""
    members, stacked = random_members(configs()[0], n)
    port = ensemble.stack_variables([flax_to_torch(m["params"], m["batch_stats"])
                                     for m in members])
    converted = flax_to_torch_stacked(stacked["params"], stacked["batch_stats"])
    assert sorted(port) == sorted(converted)
    for k, v in port.items():
        assert v.shape[0] == n
        assert torch.equal(v, converted[k]), k
    for i, sd in enumerate(ensemble.unstack_variables(converted)):
        one = flax_to_torch(members[i]["params"], members[i]["batch_stats"])
        assert all(torch.equal(sd[k], one[k]) for k in one)


def test_ensemble_forward_matches(case):
    members = [torch_model(case["torch_cfg"], m) for m in case["members"]]
    with torch.inference_mode():
        cls, box = ensemble.ensemble_forward(members, torch.from_numpy(case["images"]))
    for g, w in zip(cls + box, case["cls"] + case["box"]):
        assert tuple(g.shape) == w.shape and w.shape[:2] == (case["n"], B)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)


def test_ensemble_serving_driver_matches_as_matched_sets(case):
    scales = np.asarray([1.0, 1.5], np.float32)
    want = jax_serving.ServingDriver(case["jax_cfg"], case["stacked"], B, use_pallas_nms=False,
                                     ensemble=True).serve_preprocessed(case["images"], scales)
    s = case["stacked"]
    driver = ServingDriver(case["torch_cfg"], flax_to_torch_stacked(s["params"], s["batch_stats"]),
                           B, device="cpu", ensemble=True)
    assert driver.num_members == case["n"] and len(driver.members) == case["n"]
    got = driver.serve_preprocessed(case["images"], scales)
    # the members' spread gives σ_mc (boxes 12 wide) and σ_cls
    assert [tuple(g.shape) for g in got] == [(B, 100, 12), (B, 100), (B, 100, 9), (B,)]
    match_detections(got, want, sigma_check(case["jax_cfg"], case["cls"], case["box"], scales))


def test_init_ensemble_draws_distinct_seeded_members():
    _, torch_cfg = configs()
    model, stacked = ensemble.init_ensemble(torch_cfg, 2, seed=5)
    _, again = ensemble.init_ensemble(torch_cfg, 2, seed=5)
    _, given = ensemble.init_ensemble(
        torch_cfg, 2, generators=[torch.Generator().manual_seed(5 + i) for i in range(2)])
    assert sorted(stacked) == sorted(model.state_dict())
    key = "box_net.box-predict.pointwise.weight"
    assert stacked[key].shape[0] == 2
    assert not torch.equal(stacked[key][0], stacked[key][1])
    assert all(torch.equal(stacked[k], again[k]) and torch.equal(stacked[k], given[k])
               for k in stacked)
    with pytest.raises(ValueError, match="generators"):
        ensemble.init_ensemble(torch_cfg, 3, generators=[torch.Generator()])
    # the JAX package's stacked tree has the same leaves, with the member axis
    jax_cfg, _ = configs()
    jax_stacked = jax.eval_shape(lambda k: jax_ensemble.init_ensemble(
        jax_cfg, 2, k, (IMAGE, IMAGE))[1], jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), dict(jax_stacked))
    shapes = flax_to_torch_stacked(zeros["params"], zeros["batch_stats"])
    assert {k: tuple(v.shape) for k, v in shapes.items()} == \
        {k: tuple(v.shape) for k, v in stacked.items()}
