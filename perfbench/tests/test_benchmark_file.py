"""BENCHMARK.json keeps the shape the harness reads: every name a file
under perfbench/ holds, every metric a reader, every cell its limits."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "perfbench")
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and BENCH["command"][1] == "perfbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_files():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(HERE, "metrics", f"{m['name']}.py")), m["name"]
    for c in BENCH["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert os.path.exists(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
        with open(os.path.join(HERE, "limits", f"{w['name']}.json")) as f:
            assert set(json.load(f)["limits"]) == {"pose_gap_median"}
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_reports_its_metrics(w):
    def mine(m):
        return "workloads" not in m or w["name"] in m["workloads"]

    e2e = [m["name"] for m in BENCH["end_to_end"] if mine(m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(mine(m) for m in BENCH["per_layer"])
    moved = {m["moves"] for m in BENCH["per_layer"]}
    assert moved <= {m["name"] for m in BENCH["end_to_end"]}
