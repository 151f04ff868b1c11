#
# One run of one cell: set-up, the window, the check, the result line.
#
# run_cell() is the whole run behind run.py's look for a chip, so the
# tests can drive it on the CPU at a small size (`overrides` merge into the
# configuration and the mix; `device` "cpu" takes the port's plain kernels).
#
#   set-up   the entry makes the inputs from the seed, builds the frames and
#            the estimator or model, and warms the cell's own shapes (the
#            kernel libraries build or load at their first call);
#   window   the mix's loop (portbench/loops/) makes the entry's calls
#            until `seconds` have passed and returns a record a call; the
#            window closes when it returns.  Traced runs wrap the window in
#            torch.profiler;
#   check    the window's answers against the configuration's plain
#            reference, after the peak memory is read and the program's
#            state is freed.
#
# An untraced run also reads the cell's per-layer metrics that need no
# trace (the host clock's: call latencies, shares of peak over the window)
# and puts them under the line's key "untraced_per_layer", which the
# traced run's readings, made under the profiler, can be set beside.
#

from __future__ import annotations

import gc
import sys
import time
from types import SimpleNamespace
from typing import Any, Dict, Optional

from torch.profiler import record_function

from . import cell, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "spark_rapids_ml_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot, whole) is
    JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def _readings(bench: Dict[str, Any], workload: str, traced: bool, run) -> Dict[str, Any]:
    """The cell's end-to-end (untraced) or per-layer (traced) metrics that
    have something to read in `run`."""
    out: Dict[str, Any] = {}
    for m in cell.metrics_of(bench, workload, traced):
        value = cell.metric_reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(workload: str, seed: int, seconds: float, traced: bool, device: str, t_start: float,
             overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The result line's object (and its checks last) of one run."""
    import torch

    import spark_rapids_ml_tpu_torch as port
    from spark_rapids_ml_tpu_torch import profiling

    overrides = overrides or {}
    bench = cell.load_benchmark()
    w = cell.workload(bench, workload)
    cfg = cell.merged(cell.config(bench, w["config"]), overrides.get("config"))
    mix = cell.merged(cell.traffic(w["traffic"]), overrides.get("traffic"))
    entry = cell.entry(mix["entry"])
    on_cuda = device.startswith("cuda")
    port.device.use_device(device)

    inputs = entry.make_inputs(cfg, mix, seed, device)
    state = entry.prepare(port, cfg, mix, inputs, seed)
    if on_cuda:
        torch.cuda.synchronize()
    if traced:
        with trace.profiled(on_cuda):  # the profiler's own first start, outside the window
            torch.ones(1, device=device).add_(1)
    # what set-up left alive is never collected: a collection in the window
    # walks only the window's own objects
    gc.collect()
    gc.freeze()

    counters0, launches0 = profiling.counters(), trace.launches()
    window_loop = cell.loop(mix["loop"]).run
    holder: list = []
    profiler = trace.profiled(on_cuda) if traced else None
    if profiler is not None:
        holder = profiler.__enter__()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    with record_function(trace.WINDOW_RANGE):
        calls = window_loop(entry, state, mix, seconds, t0, seed)
        if on_cuda:
            torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    if profiler is not None:
        profiler.__exit__(None, None, None)

    run = SimpleNamespace(
        cell=workload, config=cfg, mix=mix, calls=calls, window_s=window_s, setup_s=setup_s,
        counters=_delta(profiling.counters(), counters0), launches=_delta(trace.launches(), launches0), trace=None,
    )
    if traced:
        run.trace = trace.reduce(holder[0], sum(run.launches.values()))
        del holder[:]
    device_rec: Dict[str, Any] = {
        "platform": "gpu" if on_cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0)) if on_cuda else 0,
    }
    if traced:
        device_rec["busy_s"] = run.trace.busy_us / 1e6
        device_rec["window_s"] = run.trace.window_us / 1e6

    metrics = _readings(bench, workload, traced, run)

    checks = dict(entry.window_checks(state, run))
    answers = entry.answers(state)
    entry.release(state)
    del state
    gc.unfreeze()
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    checks.update(cell.reference(cfg["reference"]).check(cfg, mix, inputs, answers, seed, device))

    failed = sum(not c["ok"] for c in calls)
    result: Dict[str, Any] = {
        "correct": failed == 0 and all(v <= lim for v, lim in checks.values()),
        "attempted": len(calls),
        "failed": failed,
        "metrics": metrics,
        "device": device_rec,
    }
    if traced:
        result["breakdown"] = {"device_ops": run.trace.device_ops(), "idle_gaps": run.trace.idle_gaps()}
    else:
        result["untraced_per_layer"] = _readings(bench, workload, True, run)
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    return result
