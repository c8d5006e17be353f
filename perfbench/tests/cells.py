"""The cells the tests run: every workload of BENCHMARK.json, and those
whose files are under perfbench/ but which BENCHMARK.json does not hold yet
(PERF.md, Open questions): a later benchmark change adds them by adding
their entries."""

import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PENDING = [{"name": "batch64-replay", "config": "std", "traffic": "lanes64-replay", "chips": 1}]

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
ALL = dict(BENCH, workloads=BENCH["workloads"] + [w for w in PENDING
                                                 if w["name"] not in {v["name"] for v in BENCH["workloads"]}])
CELLS = [w["name"] for w in ALL["workloads"]]
