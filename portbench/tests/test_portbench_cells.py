"""BENCHMARK.json against the benchmark's contract, every piece found by
name, and each cell rehearsed on the CPU at a small size."""

import json
import re
import subprocess
import sys
import time

import pytest

from portbench import cell, data, harness
from portbench.tests.small import SMALL

BENCH = cell.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    cells = len(BENCH["workloads"])
    assert 2 + 14 * cells > 0 and sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, cells // 4)


def test_names_units_and_keys():
    names = [c["name"] for c in BENCH["configs"]] + CELLS
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(CELLS)) == len(CELLS) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["file"].startswith("portbench/")
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        for w in m.get("workloads", CELLS):
            assert m["moves"] in [e["name"] for e in cell.metrics_of(BENCH, w, traced=False)]


@pytest.mark.parametrize("workload", CELLS)
def test_every_piece_found_by_name(workload):
    w = cell.workload(BENCH, workload)
    cfg = cell.config(BENCH, w["config"])
    mix = cell.traffic(w["traffic"])
    entry = cell.entry(mix["entry"])
    assert callable(cell.loop(mix["loop"]).run)
    for fn in ("make_inputs", "prepare", "call", "keep", "window_checks", "answers", "release"):
        assert callable(getattr(entry, fn))
    assert callable(cell.reference(cfg["reference"]).check)
    assert cfg["reduced"] == next(c["reduced"] for c in BENCH["configs"] if c["name"] == w["config"])
    for traced in (False, True):
        metrics = cell.metrics_of(BENCH, workload, traced)
        assert metrics
        for m in metrics:
            assert callable(cell.metric_reader(m["name"]).read)
    assert "setup_s" in [m["name"] for m in cell.metrics_of(BENCH, workload, False)]


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_rehearsal_on_cpu(workload, traced):
    r = harness.run_cell(workload, 2**31 + 977, 0.3, traced, "cpu", time.perf_counter(), SMALL[workload])
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks" and r["checks"]
    expected = {m["name"] for m in cell.metrics_of(BENCH, workload, traced)}
    # device metrics have nothing to read on the CPU (no device events)
    host_only = {n for n in expected if not n.startswith(("device_idle_share", "b5_roofline"))}
    assert host_only <= set(r["metrics"]) <= expected
    if traced:
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        # the per-layer metrics the host's clock gives, read without the profiler
        host_layer = {m["name"] for m in cell.metrics_of(BENCH, workload, True) if m["source"] == "host_clock"}
        assert set(r["untraced_per_layer"]) == host_layer


def test_same_seed_same_inputs():
    w = cell.workload(BENCH, "knn-exact-online")
    cfg = cell.merged(cell.config(BENCH, w["config"]), SMALL["knn-exact-online"]["config"])
    mix = cell.merged(cell.traffic(w["traffic"]), SMALL["knn-exact-online"]["traffic"])
    entry = cell.entry(mix["entry"])
    a, b, c = (entry.make_inputs(cfg, mix, s, "cpu") for s in (2**33 + 5, 2**33 + 5, 7))
    assert (a["items"] == b["items"]).all() and (a["queries"] == b["queries"]).all()
    assert not (a["items"] == c["items"]).all()


REHEARSE = """
import sys, time
sys.path.insert(0, {root!r})
from portbench import harness
from portbench.tests.small import SMALL
for w in SMALL:
    harness.run_cell(w, 3, 0.2, True, "cpu", time.perf_counter(), SMALL[w])
print(",".join(harness.forbidden_modules()) or "none")
"""


def test_no_jax_after_a_rehearsal():
    out = subprocess.run([sys.executable, "-c", REHEARSE.format(root=str(cell.ROOT))], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "none"
    names = ["jax", "jaxlib.x", "flax", "spark_rapids_ml_tpu.core", "spark_rapids_ml_tpu_torch", "jaxy"]
    assert [n for n in names if n.split(".")[0] in harness.FORBIDDEN] == names[:4]


def test_fit_rows_and_estimator_seed_follow_the_run_seed():
    w = cell.workload(BENCH, "kmeans-fit")
    cfg = cell.merged(cell.config(BENCH, w["config"]), SMALL["kmeans-fit"]["config"])
    mix = cell.traffic(w["traffic"])
    entry = cell.entry(mix["entry"])
    a, b, c = (entry.make_inputs(cfg, mix, s, "cpu")["X"] for s in (2**33 + 5, 2**33 + 5, 17))
    assert (a == b).all() and not (a == c).all()
    seeds = [data.estimator_seed(s) for s in (2**33 + 5, 2**33 + 5, 17, 2**31 + 977)]
    assert seeds[0] == seeds[1] and len(set(seeds)) == 3 and all(0 <= s < 2**31 for s in seeds)
    assert "seed" not in cfg["params"]
