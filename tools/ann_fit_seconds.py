#!/usr/bin/env python3
#
# Seconds of the three ANN arms' index builds (ApproximateNearestNeighbors
# .fit) at chip_smoke.py's flagship shape, for one copy of the PyTorch port,
# with each k-means training inside a build:
#
#     python3 tools/ann_fit_seconds.py --root DIR [--reps 2] [--profile ARM]
#
# DIR is a checkout (or an unpacked `git archive`) whose
# spark_rapids_ml_tpu_torch package is imported, so two versions of the port
# can be timed on one card in one call (run them in the order A, B, B, A).
# The items and the arms are chip_smoke.py's (ann_data, ANN_ARMS) of this
# checkout: 400,000 x 256 float32 clustered rows around 632 centres; the
# arms path_ann (IVF-Flat), path_ann_pq (IVF-PQ, 32 subspaces, 8 bits) and
# path_ann_pq4 (4 bits, OPQ).  One untimed fit of a small index first
# builds the kernels.  Every call of train_coarse_quantizer's init and Lloyd
# loop (the coarse quantizer and each PQ / OPQ codebook) is timed
# (synchronised) and its Lloyd iterations counted.
# Prints one JSON line: the card's name and power limit (nvidia-smi), the
# root, and each arm's fit seconds, one a repeat, with the repeat's
# trainings summed by centre count: calls, init seconds, Lloyd seconds and
# Lloyd iterations.  With --profile ARM, one more fit of that arm runs
# under torch.profiler and a second line gives its 25 operators of most
# host time (self CPU ms and calls) and its 10 device kernels of most
# device time.
# Needs a CUDA card; exits 2 without one.

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the ANN arms' items and parameters)


def timed_trainings(torch, ivfflat):
    """Wrap ivfflat's init and Lloyd loop to log each training; returns the
    log (a list, one dict a call, emptied by the caller)."""
    log = []
    init, lloyd = ivfflat.scalable_kmeans_pp_init, ivfflat.lloyd_iterations

    def timed_init(X, w, k, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = init(X, w, k, *args, **kw)
        torch.cuda.synchronize()
        log.append({"k": int(k), "init_s": time.perf_counter() - t0})
        return out

    def timed_lloyd(*args, **kw):
        t0 = time.perf_counter()
        centers, n_iter, inertia = lloyd(*args, **kw)
        torch.cuda.synchronize()
        log[-1].update(lloyd_s=time.perf_counter() - t0, n_iter=int(n_iter))
        return centers, n_iter, inertia

    ivfflat.scalable_kmeans_pp_init, ivfflat.lloyd_iterations = timed_init, timed_lloyd
    return log


def by_k(log):
    out = {}
    for rec in log:
        agg = out.setdefault(str(rec["k"]), {"calls": 0, "init_s": 0.0, "lloyd_s": 0.0, "n_iter": 0})
        agg["calls"] += 1
        for name in ("init_s", "lloyd_s", "n_iter"):
            agg[name] += rec[name]
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--root", required=True, help="directory holding the spark_rapids_ml_tpu_torch package")
    parser.add_argument("--reps", type=int, default=2)
    parser.add_argument("--profile", choices=sorted(chip_smoke.ANN_ARMS), default=None)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ann_fit_seconds.py: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import spark_rapids_ml_tpu_torch as port
    from spark_rapids_ml_tpu_torch.ann import ivfflat

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    X, _ = chip_smoke.ann_data()
    df = port.DataFrame.from_numpy(X, num_partitions=chip_smoke.ANN_ITEM_PARTS)
    warm = port.DataFrame.from_numpy(X[:4096])
    for algorithm, params, _ in chip_smoke.ANN_ARMS.values():
        port.ApproximateNearestNeighbors(k=10, algorithm=algorithm, algoParams=dict(params, nlist=16)).fit(warm)
    log = timed_trainings(torch, ivfflat)
    out = {"nvidia_smi": smi, "root": root, "items": int(X.shape[0]), "cols": int(X.shape[1])}
    for name, (algorithm, params, _) in chip_smoke.ANN_ARMS.items():
        runs, trainings = [], []
        for _ in range(args.reps):
            log.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            port.ApproximateNearestNeighbors(k=chip_smoke.ANN_K, algorithm=algorithm, algoParams=params).fit(df)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
            trainings.append(by_k(log))
        out[name] = {"fit_s": runs, "trainings": trainings}
    print(json.dumps(out), flush=True)
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        algorithm, params, _ = chip_smoke.ANN_ARMS[args.profile]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            port.ApproximateNearestNeighbors(k=chip_smoke.ANN_K, algorithm=algorithm, algoParams=params).fit(df)
            torch.cuda.synchronize()
        ops = prof.key_averages()
        host = sorted(ops, key=lambda e: e.self_cpu_time_total, reverse=True)[:25]
        device = sorted(ops, key=lambda e: e.self_device_time_total, reverse=True)[:10]
        print(json.dumps({
            "profile": args.profile, "root": root,
            "host_ms": [[e.key[:60], e.self_cpu_time_total / 1e3, e.count] for e in host],
            "device_ms": [[e.key[:60], e.self_device_time_total / 1e3, e.count] for e in device],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
