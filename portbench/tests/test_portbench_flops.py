"""Each configuration's frozen operations a frame equal FlopCounterMode's
count over the reference at its shapes."""

import json

import pytest

from portbench.flops import per_frame
from portbench.run import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_frozen_flops_match_the_counter(entry):
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["flops_per_frame"] == per_frame(cfg)


def test_flagship_forward_count():
    cfg = json.loads((ROOT / "portbench/configs/flagship_512x640.json").read_text())
    # 684.7 GFLOP of convolutions a frame, plus the blur-pools' depthwise convs.
    assert 684.7e9 < cfg["flops_per_frame"]["serve"] < 690e9
    assert 2.6e12 < cfg["flops_per_frame"]["train"] < 2.75e12
