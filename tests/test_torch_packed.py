"""The port's packed-layout probes (``udal_tpu_torch/ops/packed.py`` and
``udal_tpu_torch/tools/perf_packed.py``) against the five Pallas kernels of
``tools/perf_packed.py``, run in interpret mode on the CPU.

The JAX script is imported from ``tools/`` and its ``pl`` replaced by a
namespace whose ``pallas_call`` adds ``interpret=True`` and records each
call's operands and output; the recorded operands go to the port's plain
versions, so both sides see the same bf16 values.
"""

import functools
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from udal_tpu_torch.ops import packed  # noqa: E402
from udal_tpu_torch.tools import perf_packed as port_tool  # noqa: E402

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
G = 8


def to_torch(a) -> torch.Tensor:
    """A JAX or numpy array as a torch tensor of the same values (bf16
    arrays come back as bf16 tensors)."""
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t.bfloat16() if a.dtype == jnp.bfloat16 else t


@pytest.fixture
def jax_probe(monkeypatch):
    """``tools/perf_packed.py`` with every ``pallas_call`` in interpret mode;
    yields the module and the list of (operands, output) it records."""
    monkeypatch.syspath_prepend(TOOLS)
    import perf_packed

    calls = []

    def pallas_call(kernel, **kwargs):
        run = pl.pallas_call(kernel, interpret=True, **kwargs)

        def call(*args):
            out = run(*args)
            calls.append(([to_torch(a) for a in args], to_torch(out)))
            return out
        return call

    monkeypatch.setattr(perf_packed, "pl",
                        types.SimpleNamespace(pallas_call=pallas_call, BlockSpec=pl.BlockSpec))
    yield perf_packed, calls


@pytest.mark.parametrize("dense", [False, True], ids=["block_diag", "dense"])
def test_pointwise_plain_matches_the_tpu_kernel(jax_probe, dense):
    """[1024, 192] @ [192, 1152]: both sum bf16 products in f32 in another
    order and round once, so within one bf16 ulp of each value, plus 1% of
    an ulp of the largest for results near zero, where the sum cancels and
    its f32 error scales with the terms (about 1e-7 here)."""
    jp, calls = jax_probe
    rng = np.random.RandomState(1)
    xp = jnp.asarray(rng.randn(1024, G * 24), jnp.bfloat16)
    w = (rng.randn(G * 24, G * 144) * 0.1 if dense else
         jp.block_diag_weight((rng.randn(24, 144) * 0.1).astype(np.float32), G))
    jp.packed_pointwise(xp, jnp.asarray(w, jnp.bfloat16))
    (x_t, w_t), want = calls[0]
    got = packed.packed_pointwise(x_t, w_t)
    assert got.dtype == torch.bfloat16 and got.shape == (1024, G * 144)
    err = (got.float() - want.float()).abs()
    bound = port_tool.bf16_ulp(want) + 0.01 * port_tool.bf16_ulp(want.float().abs().max())
    assert bool((err <= bound).all()), float((err - bound).max())


def jax_wshift(jp, x, cexp, direction):
    """``case_a1_roll.shift`` (tools/perf_packed.py:176-190) at any C."""
    n, h, wp, ge = x.shape
    f = functools.partial(jp.packed_wshift_kernel, cexp=cexp, g=G, direction=direction)
    spec = pl.BlockSpec((1, 8, wp, ge), lambda i, j: (i, j, 0, 0), memory_space=jp.pltpu.VMEM)
    return jp.pl.pallas_call(f, grid=(n, h // 8), in_specs=[spec], out_specs=spec,
                             out_shape=jp.jax.ShapeDtypeStruct(x.shape, x.dtype))(x)


@pytest.mark.parametrize("cexp", [16, 144])
@pytest.mark.parametrize("direction", [1, -1])
def test_wshift_plain_matches_the_tpu_kernel(jax_probe, cexp, direction):
    """Exact: a shift moves values and zeros, nothing is rounded."""
    jp, calls = jax_probe
    x = np.random.RandomState(cexp).randn(2, 16, 4, G * cexp)
    jax_wshift(jp, jnp.asarray(x, jnp.bfloat16), cexp, direction)
    (x_t,), want = calls[0]
    assert torch.equal(packed.packed_wshift(x_t, cexp, G, direction), want)


def test_wshift_plain_matches_the_scripts_own_check(jax_probe):
    """``case_a1_roll(check=True)``: the script's shape (C = 144, n = 2),
    both directions, through its own calls."""
    jp, calls = jax_probe
    jp.case_a1_roll(check=True)
    assert len(calls) == 2
    for ((x_t,), want), direction in zip(calls, (1, -1)):
        assert torch.equal(packed.packed_wshift(x_t, 144, G, direction), want)


@pytest.mark.parametrize("kernel,port", [(0, "add_one_natural"), (1, "add_one_packed")],
                         ids=["B6_run", "B7_fn_copy"])
def test_add_one_plain_matches_the_tpu_kernels(jax_probe, monkeypatch, kernel, port):
    """``case_p1`` at N = 8 (Mp = 4096) with ``timed`` calling once: the
    only way to reach B7's closure. Exact on the input's rows."""
    jp, calls = jax_probe
    monkeypatch.setattr(jp, "N", 8)
    monkeypatch.setattr(jp, "timed", lambda fn, args, label: fn(*args))
    jp.case_p1()
    assert len(calls) == 2
    (x_t,), want = calls[kernel]
    got = getattr(packed, port)(x_t, 24)
    assert got.shape == (4096, G * 24) and torch.equal(got, want)


def test_dw_w3_plain_matches_the_tpu_kernel(jax_probe):
    """``case_p2(check=True)`` (n = 2, the script's H, W, C): the same f32
    products and sums in the same order, rounded once: exact."""
    jp, calls = jax_probe
    jp.case_p2(check=True)
    (x_t, taps), want = calls[0]
    assert taps.shape == (3, G * 144)
    assert torch.equal(packed.packed_dw_w3(x_t, taps, 144), want)


def test_dw_w3_plain_on_odd_shapes():
    """f32, C = 5 and g = 3: each output is the three-term sum of its
    neighbours along the unpacked W, with the tap of its lane."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, 4, 15).astype(np.float32)
    taps = rng.randn(3, 15).astype(np.float32)
    got = packed.packed_dw_w3(torch.from_numpy(x), torch.from_numpy(taps), 5).numpy()
    u, t = x.reshape(2, 8, 12, 5), taps.reshape(3, 3, 5)
    want = np.zeros_like(u)
    for w in range(12):
        lane = t[:, w % 3]
        left = u[:, :, w - 1] if w > 0 else 0 * u[:, :, w]
        right = u[:, :, w + 1] if w < 11 else 0 * u[:, :, w]
        want[:, :, w] = (left * lane[0] + u[:, :, w] * lane[1]) + right * lane[2]
    np.testing.assert_array_equal(got.reshape(want.shape), want)


def test_the_functions_refuse_ragged_tiles():
    """Where the JAX grid would leave rows unwritten (ROADMAP C4)."""
    with pytest.raises(ValueError, match="C4"):
        packed.packed_pointwise(torch.zeros(1000, 16), torch.zeros(16, 8), m_tile=512)
    with pytest.raises(ValueError, match="C4"):
        packed.packed_wshift(torch.zeros(1, 12, 2, 16), 8, 2, 1)
    with pytest.raises(ValueError, match="C4"):
        packed.packed_dw_w3(torch.zeros(1, 12, 2, 16), torch.zeros(3, 16), 8)
    for fn in (packed.add_one_natural, packed.add_one_packed):
        with pytest.raises(ValueError, match="C4"):
            fn(torch.zeros(1000, 16), 2)


@pytest.mark.parametrize("name,args", [
    ("packed_pointwise_cuda", (torch.zeros(16, 8).bfloat16(), torch.zeros(8, 8).bfloat16(), 16)),
    ("packed_wshift_cuda", (torch.zeros(1, 8, 2, 16).bfloat16(), 8, 2, 1)),
    ("add_one_natural_cuda", (torch.zeros(16, 16).bfloat16(), 2, 16)),
    ("add_one_packed_cuda", (torch.zeros(16, 16).bfloat16(), 2, 16)),
    ("packed_dw_w3_cuda", (torch.zeros(1, 8, 2, 16).bfloat16(), torch.zeros(3, 16), 8)),
])
def test_cuda_launchers_refuse_cpu_tensors(name, args):
    """No fallback: a launcher given CPU tensors raises."""
    before = dict(packed.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(packed, name)(*args)
    assert packed.launches == before


def test_the_functions_check_their_operands():
    with pytest.raises(ValueError, match="do not chain"):
        packed.packed_pointwise(torch.zeros(16, 8), torch.zeros(9, 8), 16)
    with pytest.raises(ValueError, match="direction"):
        packed.packed_wshift(torch.zeros(1, 8, 2, 16), 8, 2, 2)
    with pytest.raises(ValueError, match="g·C"):
        packed.packed_wshift(torch.zeros(1, 8, 2, 16), 8, 3, 1)
    with pytest.raises(ValueError, match=r"\[3, g·C\]"):
        packed.packed_dw_w3(torch.zeros(1, 8, 2, 16), torch.zeros(3, 8), 8)
    with pytest.raises(TypeError, match="floating"):
        packed.add_one_packed(torch.zeros(16, 16, dtype=torch.int32), 2, 16)
    with pytest.raises(ValueError, match="contiguous"):
        packed.packed_pointwise(torch.zeros(8, 16).t(), torch.zeros(8, 8), 16)


def test_tool_block_diag_weight_is_the_scripts(jax_probe):
    jp, _ = jax_probe
    w = np.random.RandomState(3).randn(5, 7).astype(np.float32)
    np.testing.assert_array_equal(port_tool.block_diag_weight(w, 3), jp.block_diag_weight(w, 3))


def test_tool_check_passes_on_the_cpu(monkeypatch, capsys):
    """``check --cpu`` at N = 8 holds the plain versions against the
    script's references and asserts (ROADMAP C6), and the library calls
    timed beside B5 and B8 against their plain versions; B6 and B7 return
    the input's rows (C5). No kernel runs on the CPU."""
    monkeypatch.setattr(port_tool, "N", 8)
    before = dict(packed.launches)
    assert port_tool.main(["check", "--cpu"]) == {}
    assert packed.launches == before
    lines = capsys.readouterr().out.splitlines()
    cases = [line.split('"case": "')[1].split('"')[0] for line in lines]
    assert cases == ["a1_pw_check", "a1_roll_check", "a1_roll_check_neg", "p1_check",
                     "p1_copy_check", "p2_check", "library_check"]
    assert '"rows": 1024' in lines[3]


def test_tool_timed_cases_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        port_tool.main(["a1_pw"])
    with pytest.raises(SystemExit, match="unknown"):
        port_tool.main(["a3"])


def test_tool_check_runs_on_the_card_unless_asked(monkeypatch):
    """``check`` without ``--cpu`` needs a card and raises without one;
    ``--cpu`` goes with ``check`` alone."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        port_tool.main(["check"])
    with pytest.raises(SystemExit, match="--cpu"):
        port_tool.main(["a1_pw", "--cpu"])
