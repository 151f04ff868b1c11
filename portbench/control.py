#!/usr/bin/env python3
#
# The controls of the check that decides `correct`, at a cell's own size:
#
#   python3 portbench/control.py --workload <cell> --seeds 11 12 13
#
# For each seed it makes the cell's inputs as a run does and computes the
# configuration's plain reference, then puts in the program's place:
#   control  the reference in the next lower precision (TF32 products for
#            the configuration's float32): the check must refuse it;
#   sibling  a sound float32 computation arranged otherwise (KMeans: Lloyd
#            over blocks of 65,536 rows, not 32,768; kNN: float32 search in
#            item blocks): what a sound reordering of the program reads;
#   fault_*  the reference with a fault planted (KMeans: Lloyd's state
#            unchanged, half the rows; kNN: half the items left out).
# and prints one JSON line a seed with the numbers each gives, beside the
# configuration's limits.  The program itself is not run; its readings
# come from the benchmark's own runs.
#

import argparse
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):  # run as a script: import the harness as the package portbench
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from portbench import cell  # noqa: E402


def kmeans_readings(cfg, mix, inputs, seed, device):
    import torch

    from portbench.data import estimator_seed
    from portbench.reference import kmeans

    est_seed = estimator_seed(seed)
    params = cfg["params"]
    X = kmeans.upload(inputs["X"], device)
    ref = kmeans.fit(X, params, est_seed)
    out = {"reference_n_iter": ref["n_iter"]}
    for name, kw in (("control", {"tf32": True}), ("sibling", {"block_rows": 65536})):
        t0 = time.perf_counter()
        other = kmeans.fit(X, params, est_seed, **kw)
        out[name] = {**kmeans.compare(other, ref), "n_iter": other["n_iter"], "s": time.perf_counter() - t0}
    # faults with the reference in the program's place: Lloyd returns its
    # state unchanged (the init's centers); Lloyd over the first half of
    # each partition's rows, the means taken over them
    centers0 = X[kmeans.init_rows(X.shape[0], int(params["k"]), est_seed, device)]
    halves = torch.cat([p[: p.shape[0] // 2] for p in torch.tensor_split(X, int(cfg["data"]["partitions"]))])
    for name, (rows, max_iter) in (("fault_state_unchanged", (X, 0)), ("fault_half_the_rows", (halves, None))):
        c, n_iter, inertia = kmeans.lloyd(rows, centers0, int(params["maxIter"]) if max_iter is None else max_iter,
                                          float(params["tol"]))
        out[name] = kmeans.compare({"centers": c.double().cpu().numpy(), "n_iter": n_iter, "inertia": inertia}, ref)
    return out


def knn_readings(cfg, mix, inputs, seed, device):
    import numpy as np
    import torch

    from portbench.entries.kneighbors import sample_rows
    from portbench.reference import knn

    rows = int(mix["rows_per_call"])
    sample = sample_rows(mix, seed)
    frames = range(min(2, int(mix["frames"])))
    queries = np.concatenate([inputs["queries"][f * rows + sample] for f in frames])
    k = int(cfg["params"]["k"])
    truth = knn.Truth(inputs["items"], queries, k, device)
    all_rows = torch.arange(len(queries), device=truth.d.device)
    out = {}
    for name, tf32 in (("control", True), ("sibling", False)):
        ans = knn.search(inputs["items"], queries, k, device, tf32)
        out[name] = truth.judge(all_rows, ans["indices"], ans["distances"], cfg["tie_rtol"])
    # fault: half of the items left out of the search
    half = inputs["items"][: len(inputs["items"]) // 2]
    ans = knn.search(half, queries, k, device, False)
    out["fault_half_the_items"] = truth.judge(all_rows, ans["indices"], ans["distances"], cfg["tie_rtol"])
    return out


READINGS = {"fit": kmeans_readings, "kneighbors": knn_readings}


def readings(workload, seed, device="cuda", overrides=None):
    overrides = overrides or {}
    bench = cell.load_benchmark()
    w = cell.workload(bench, workload)
    cfg = cell.merged(cell.config(bench, w["config"]), overrides.get("config"))
    mix = cell.merged(cell.traffic(w["traffic"]), overrides.get("traffic"))
    entry = cell.entry(mix["entry"])
    inputs = entry.make_inputs(cfg, mix, seed, device)
    return {"workload": workload, "seed": seed, "limits": cfg["limits"],
            **READINGS[mix["entry"]](cfg, mix, inputs, seed, device)}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
