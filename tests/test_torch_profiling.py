"""The port's ``utils/profiling.py`` against the JAX package's, on the CPU.

``device_memory_stats`` is a dict (empty here: no card, as JAX's on a
backend without statistics); ``trace`` writes a Chrome trace JSON under
its directory naming the ops it saw (its spans: test_torch_tracing.py).
``MetricsWriter.write_image`` writes nothing, as JAX's does without
TensorBoard.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from udal_tpu.utils import profiling as jax_profiling  # noqa: E402
from udal_tpu_torch.utils import profiling  # noqa: E402


def test_device_memory_stats_without_a_card():
    stats = profiling.device_memory_stats()
    assert isinstance(stats, dict) and isinstance(jax_profiling.device_memory_stats(), dict)
    if not torch.cuda.is_available():
        assert stats == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.ones(64, 64)
    with profiling.trace(str(tmp_path / "logs")) as prof:
        (x @ x).sum()
    assert prof is not None
    files = list((tmp_path / "logs").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)


def test_metrics_writer_write_image_writes_nothing(tmp_path):
    from udal_tpu.utils.metrics_writer import MetricsWriter as JaxWriter
    from udal_tpu_torch.utils.metrics_writer import MetricsWriter

    image = np.zeros((8, 8, 3), np.uint8)
    for cls, kw, d in ((MetricsWriter, {}, tmp_path / "port"),
                       (JaxWriter, {"use_tensorboard": False}, tmp_path / "jax")):
        w = cls(str(d), **kw)
        assert w.write_image(1, "nms_grid", image) is None
        w.write(1, {"AP": 0.5})
        w.close()
        assert sorted(p.name for p in d.iterdir()) == ["metrics.jsonl"]
