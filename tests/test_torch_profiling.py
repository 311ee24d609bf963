"""The port's tracing and stage timers (``nellie_tpu_torch.utils.profiling``),
as ``tests/test_profiling.py`` holds the JAX package's."""
import json
import os
import time

import torch

from nellie_tpu_torch.utils.profiling import StageTimer, trace


def test_stage_timer():
    t = StageTimer()
    with t.span("a"):
        time.sleep(0.01)
    with t.span("b"):
        pass
    assert t.spans["a"] >= 0.01
    assert t.total >= t.spans["a"]
    data = json.loads(t.to_json())
    assert set(data) == {"a", "b", "total"}
    assert "a:" in t.report()


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with trace(str(log_dir)) as prof:
        x = torch.ones(64, 64)
        (x @ x).sum()
    path = os.path.join(log_dir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert any("mm" in row.key for row in prof.key_averages())
