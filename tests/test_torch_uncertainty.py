"""The port's uncertainty decodes and helpers against the JAX package.

``sample`` draws its noise from its own generator in each package, so the
parity test injects JAX's own draw (``jax.random.normal(PRNGKey(0),
(S, 4) + shape)``, what the JAX package draws without a key) as the port's
``eps``. ``pre_nms`` with the ``sample`` method gets the same injection
through a patched ``decode_uncert``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from tests.test_torch_fixtures import configs  # noqa: E402
from tests.test_torch_postprocess import ATOL, assert_std_close, level_maps  # noqa: E402
from udal_tpu.ops import postprocess as jax_post  # noqa: E402
from udal_tpu.ops import uncertainty as jax_unc  # noqa: E402
from udal_tpu_torch.ops import postprocess, uncertainty  # noqa: E402

S = 16


def boxes_case(seed, lead=(2,)):
    """(mean, std, anchors) as numpy: anchors of 1-3 px centred within 2 px
    of the origin, offsets and log-sizes O(0.3), stds in [0.2, 0.5]. The
    sampled σ are sqrt(E[x²] - E[x]²) in f32, whose cancellation grows with
    |x|² against the variance (one ulp of a sample's exp moves E[x²] by
    ulps of x²): near the origin both packages agree to rtol 1e-5."""
    rng = np.random.RandomState(seed)
    n = 60
    yx = rng.uniform(-2, 2, (n, 2))
    hw = rng.uniform(1, 3, (n, 2))
    grid = np.concatenate([yx - hw / 2, yx + hw / 2], -1).astype(np.float32)
    mu = rng.normal(0, 0.3, lead + (n, 4)).astype(np.float32)
    sd = rng.uniform(0.2, 0.5, mu.shape).astype(np.float32)
    return mu, sd, grid


def jax_eps(shape, n_samples=S):
    """The JAX package's default draw for a 'sample' decode of [..., 4]
    boxes of leading ``shape``."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n_samples, 4) + shape,
                                        dtype=jnp.float32))


@pytest.mark.parametrize("lead", [(2,), (3, 2)])
def test_sample_decode_matches_with_jax_noise(lead):
    mu, sd, grid = boxes_case(1, lead)
    eps = jax_eps(mu.shape[:-1])
    got = uncertainty.decode_uncert(torch.from_numpy(mu), torch.from_numpy(sd),
                                    torch.from_numpy(grid), "sample", n_samples=S,
                                    eps=torch.from_numpy(eps.copy()))
    want = jax_unc.decode_uncert(jnp.asarray(mu), jnp.asarray(sd), jnp.asarray(grid),
                                 "sample", n_samples=S)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_sample_decode_default_generator_is_seeded():
    """Without ``eps`` the noise comes from a generator seeded 0: the same
    call twice gives the same result; another generator another one; and
    with many samples the moments approach the closed form."""
    mu, sd, grid = (torch.from_numpy(a) for a in boxes_case(2))
    first = uncertainty.decode_uncert(mu, sd, grid, "sample", n_samples=S)
    again = uncertainty.decode_uncert(mu, sd, grid, "sample", n_samples=S)
    other = uncertainty.decode_uncert(mu, sd, grid, "sample", n_samples=S,
                                      generator=torch.Generator().manual_seed(1))
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert not torch.equal(first[1], other[1])
    many = uncertainty.decode_uncert(mu, sd, grid, "sample", n_samples=20000)
    exact = uncertainty.decode_uncert(mu, sd, grid, "l-norm")
    np.testing.assert_allclose(many[0].numpy(), exact[0].numpy(), rtol=0, atol=0.05)
    np.testing.assert_allclose(many[1].numpy(), exact[1].numpy(), rtol=0.05, atol=0.01)


def test_falsedec_matches():
    mu, sd, grid = boxes_case(3, (3, 2))
    got = uncertainty.decode_uncert(torch.from_numpy(mu), torch.from_numpy(sd),
                                    torch.from_numpy(grid), "falsedec")
    want = jax_unc.decode_uncert(jnp.asarray(mu), jnp.asarray(sd), jnp.asarray(grid),
                                 "falsedec")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_relativize_uncert_matches():
    rng = np.random.RandomState(4)
    y1x1 = rng.uniform(0, 100, (2, 50, 2))
    boxes = np.concatenate([y1x1, y1x1 + rng.uniform(5, 60, (2, 50, 2))], -1).astype(np.float32)
    sig = rng.uniform(0.1, 5, (2, 50, 4)).astype(np.float32)
    got = uncertainty.relativize_uncert(torch.from_numpy(boxes), torch.from_numpy(sig))
    want = jax_unc.relativize_uncert(jnp.asarray(boxes), jnp.asarray(sig))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_clip_uncert_matches():
    x = np.linspace(-12, 16, 113, dtype=np.float32).reshape(1, -1)
    got = uncertainty.clip_uncert(torch.from_numpy(x), 0.01, 1024)
    want = jax_unc.clip_uncert(jnp.asarray(x), 0.01, 1024)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert float(got.min()) == pytest.approx(2 * np.log(0.01), rel=1e-5)


@pytest.mark.parametrize("dim", [-1, 0])
def test_entropy_from_logits_matches(dim):
    x = np.random.RandomState(5).normal(0, 3, (7, 9)).astype(np.float32)
    got = uncertainty.entropy_from_logits(torch.from_numpy(x), dim)
    want = jax_unc.entropy_from_logits(jnp.asarray(x), dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("samples", [0, 3])
def test_pre_nms_sample_method_matches(samples, monkeypatch):
    """``pre_nms`` passes ``decode_nsamples`` to the decode as the JAX one
    does: JAX's own 8 draws, injected, give the same boxes and σ (the
    aleatoric σ, sampled, to a few ulps of E[x²] at the largest box, as
    the MC σ are compared in test_torch_postprocess.py)."""
    extra = dict(uncert_adjust_method="sample", decode_nsamples=8)
    jax_cfg, torch_cfg = configs(mc=bool(samples), extra=extra)
    cls, box = level_maps(torch_cfg, seed=11 + samples, samples=samples)
    topk = 700
    shape = ((samples,) if samples else ()) + (2, topk)
    calls = []

    def injected(*args, **kwargs):
        calls.append(kwargs["n_samples"])
        return uncertainty.decode_uncert(*args, eps=torch.from_numpy(jax_eps(shape, 8).copy()),
                                         **kwargs)

    monkeypatch.setattr(postprocess, "decode_uncert", injected)
    got = postprocess.pre_nms(torch_cfg, [torch.from_numpy(c) for c in cls],
                              [torch.from_numpy(b) for b in box], topk)
    want = jax_post.pre_nms(jax_cfg, [jnp.asarray(c) for c in cls],
                            [jnp.asarray(b) for b in box], topk)
    assert calls == [8]
    np.testing.assert_array_equal(got["indices"].numpy(), np.asarray(want["indices"]))
    want_boxes = np.asarray(want["boxes"])
    np.testing.assert_allclose(got["boxes"].numpy(), want_boxes, atol=ATOL, rtol=1e-5)
    assert_std_close(got["sigma_al"].numpy(), np.asarray(want["sigma_al"]),
                     np.abs(want_boxes).max())

