"""The benchmark finds every cell, configuration, traffic mix, limit and
metric by name, and BENCHMARK.json keeps to the contract's shapes."""

import json
import re
from pathlib import Path

import pytest

from portbench.run import ROOT, load_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for p in BENCH["paths"]:
        assert (ROOT / p).is_dir() and not p.startswith("/") and ".." not in p


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    spec = load_cell(cell)
    assert spec["config"]["name"] == spec["cell"]["config"]
    assert spec["traffic"]["kind"] in ("serve", "train")
    assert set(spec["limits"]) and all(v >= 0 for v in spec["limits"].values())
    e2e = set(spec["end_to_end"])
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec["per_layer"]
    for m, _ in spec["per_layer"].values():
        assert m["moves"] in e2e, (cell, m["name"])
    assert spec["cell"]["chips"] in (1, 4) and len(spec["cell"]["why"]) <= 200


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metric_readers_exist(group):
    folder = "end_to_end" if group == "end_to_end" else "metrics"
    for m in BENCH[group]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        path = ROOT / "portbench" / folder / f"{m['name']}.py"
        assert path.is_file(), path
        assert "def read(" in path.read_text()
        if group == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
            assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
            if "roofline" in m["name"]:
                assert m["name"].endswith("_roofline") and m["unit"] == "%"


def test_names_unique_and_configs_used():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[key]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}, c["name"]
        assert all(1 <= len(c[k]) <= 200 and "\n" not in c[k] for k in ("source", "why"))
        assert Path(ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(pairs) // 4)
