"""A run on the CPU at a tiny size prints the contract's result, and the
command refuses to run without a card."""

import json
import subprocess
import sys

import pytest

from portbench.run import ROOT
from portbench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", [tiny.SERVE, tiny.TRAIN])
def test_dry_run_result_keys(cell):
    spec = tiny.spec(cell)
    result = tiny.run(spec)
    line = json.loads(json.dumps(result))
    assert list(line) == KEYS
    assert set(line["metrics"]) == set(spec["end_to_end"])
    for v in line["metrics"].values():
        assert set(v) == {"value", "unit"}
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line["checks"]) == sorted(spec["limits"])
    assert line["correct"] is True, line["checks"]


def test_traced_dry_run_has_breakdown():
    result = tiny.run(tiny.spec(tiny.SERVE), trace=True)
    assert list(result) == KEYS[:5] + ["breakdown", "checks"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "serve.idle_share" in result["metrics"] and "serve.mfu" in result["metrics"]
    assert {"busy_s", "window_s"} <= set(result["device"])


def test_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the refusal is for machines without one")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", tiny.SERVE,
                          "--seed", "1", "--seconds", "1"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
