"""``utils/profiling.py`` against the JAX package's on the CPU:
``time_block``'s result dict and printed line, and ``profile_trace``'s
trace file."""

import json
import re

import pytest
import torch

from moleculardiffusion_mivit_tpu.utils import profiling as jprofiling
from moleculardiffusion_mivit_tpu_torch import utils
from moleculardiffusion_mivit_tpu_torch.utils import profiling

LINE = re.compile(r"^\[time\] (\w+): (\d+\.\d{3})s$")


@pytest.mark.parametrize("module", [jprofiling, profiling], ids=["jax", "port"])
def test_time_block_stores_or_prints_the_seconds(module, capsys):
    """With a dict the block's seconds go under its name and nothing is
    printed; without one a line ``[time] name: S.SSSs``: the same on both
    sides."""
    results = {}
    with module.time_block("work", results):
        torch.ones(64, 64).sum()
    assert list(results) == ["work"] and isinstance(results["work"], float) and 0 <= results["work"] < 5
    assert capsys.readouterr().out == ""
    with module.time_block("step"):
        pass
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and LINE.match(lines[0]) and LINE.match(lines[0]).group(1) == "step"


def test_profile_trace_writes_a_trace_tensorboard_reads(tmp_path):
    """``profile_trace(log_dir)`` leaves one ``*.pt.trace.json`` (the
    TensorBoard profiler plugin's and chrome://tracing's format) holding the
    block's operators; both names are exported from ``utils`` as the JAX
    package's are."""
    assert utils.profile_trace is profiling.profile_trace and utils.time_block is profiling.time_block
    with profiling.profile_trace(str(tmp_path)):
        torch.ones(32, 32) @ torch.ones(32, 32)
    (trace,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name") == "aten::matmul" for e in events)
