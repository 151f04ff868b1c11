#
# Finding a cell's pieces by name.
#
# BENCHMARK.json (at the checkout's root) lists the cells; each names a
# configuration, found at portbench/configs/<config>.json, and a traffic
# mix, found at portbench/traffic/<traffic>.json.  The mix names its
# loop, which owns the window: how calls arrive, from how many callers,
# and what counts as attempted and failed (portbench/loops/<loop>.py),
# and the entry whose calls the loop makes (portbench/entries/<entry>.py); the configuration names its plain
# reference (portbench/reference/<name>.py).
# Every metric, end to end or per layer, is read by its own reader,
# portbench/metrics/<metric>.py, whose read(run) returns a number or None
# (nothing to read: the metric is left out of the line).  Adding a cell, a
# configuration, a mix or a metric adds files; no file here changes.
#

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"BENCHMARK.json has no workload {name!r}")


def _json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def config(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    """The configuration `name` as BENCHMARK.json files it."""
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(ROOT / c["file"])
    raise KeyError(f"BENCHMARK.json has no config {name!r}")


def traffic(name: str) -> Dict[str, Any]:
    return _json(HERE / "traffic" / f"{name}.json")


def entry(name: str) -> ModuleType:
    return importlib.import_module(f"portbench.entries.{name}")


def reference(name: str) -> ModuleType:
    return importlib.import_module(f"portbench.reference.{name}")


def _by_path(folder: str, name: str) -> ModuleType:
    """portbench/<folder>/<name>.py, loaded by path: a name may hold dots
    and dashes."""
    path = HERE / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.{folder}._{re.sub(r'[.-]', '_', name)}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str) -> ModuleType:
    return _by_path("metrics", name)


def loop(name: str) -> ModuleType:
    return _by_path("loops", name)


def metrics_of(bench: Dict[str, Any], cell: str, traced: bool) -> List[Dict[str, Any]]:
    """The metrics a run of `cell` reports: the end-to-end ones untraced,
    the per-layer ones traced; a metric with a "workloads" list only in
    those cells."""
    group = bench["per_layer" if traced else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def merged(base: Dict[str, Any], overrides: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """`base` with `overrides` merged in, nested groups key by key (the
    tests' small sizes)."""
    out = dict(base)
    for k, v in (overrides or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out
