#!/usr/bin/env python3
#
# Smoke run of the PyTorch/CUDA port (spark_rapids_ml_tpu_torch) on one
# NVIDIA GPU.  From the root of the repository:
#
#     python3 chip_smoke.py
#
# Phases, one JSON line each; any failure raises and exits non-zero:
#   env      torch/CUDA versions and the card (nvidia-smi name, power limit)
#   build    nvcc of every kernel of the port, all started together
#   kernels  each kernel's wrapper against its plain PyTorch version on the
#            card, at the shapes below: exact agreement on data whose sums are
#            exact in fp32, min_d2 within 1e-4 on continuous data (argmin may
#            differ there only on rows whose two best distances are within
#            1e-5 relative); median times of the kernel, the plain version,
#            the unfused PyTorch composition (library_ms, a yardstick only),
#            and the least time the card could take (bound_ms)
#   path     the KMeans flagship configuration through the public API:
#            1,000,000 x 3000 float32 Gaussian blobs around 1000 centers,
#            KMeans(k=1000, maxIter=30, initMode="random").fit -> transform ->
#            save -> load -> transform, with the kernel's launch counter reset
#            just before and read just after
# It ends with the card's nvidia-smi line, a {"kernels": [...]} summary line
# and {"ok": true, "device": {...}}.
#
# Imports neither jax, nor pandas, nor the JAX package.
#

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# The flagship KMeans configuration of the reference benchmark
# (k=1000, maxIter=30, initMode=random on 1M x 3000 float32).
ROWS, COLS, K, MAX_ITER, PARTITIONS, SEED = 1_000_000, 3000, 1000, 30, 8, 1
# Shapes of the kernel check: the JAX package's kernel-test shapes, its
# low-d/large-k shape, a slice of the flagship, and the flagship's
# per-partition shape (what transform hands the kernel).
SHAPES = [
    (300, 70, 33),
    (512, 256, 128),
    (129, 1, 2),
    (64, 515, 700),
    (131072, 32, 16384),
    (262144, COLS, K),
    (ROWS // PARTITIONS, COLS, K),
]
# H100 SXM peaks (NVIDIA data sheet, 700 W): fp32 on the CUDA cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
TIE_RTOL = 1e-5
MIN_D2_TOL = 1e-4


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, message):
    if not cond:
        raise RuntimeError(message)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(torch, fn, reps):
    """Median over `reps` timed runs (CUDA events) after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n, d, k, itemsize):
    """The larger of operations over the fp32 peak and bytes (each input read
    once, each output written once) over the memory rate."""
    ops = 2.0 * n * k * d
    nbytes = itemsize * (n * d + k * d + n + k) + n * (itemsize + 4)
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def plain_top2(torch, X, C, x_norm, c_norm, block_bytes=1 << 28):
    """Plain PyTorch (best d2, argmin, second-best d2) of every row."""
    n, k = X.shape[0], C.shape[0]
    rows = max(1, block_bytes // (4 * k))
    best = torch.empty(n, dtype=X.dtype, device=X.device)
    second = torch.empty(n, dtype=X.dtype, device=X.device)
    arg = torch.empty(n, dtype=torch.int64, device=X.device)
    for lo in range(0, n, rows):
        sl = slice(lo, min(lo + rows, n))
        d2 = x_norm[sl, None] - 2.0 * (X[sl] @ C.T) + c_norm[None, :]
        best[sl], arg[sl] = torch.min(d2, dim=1)  # the first index on ties
        second[sl] = (
            torch.topk(d2, 2, dim=1, largest=False).values[:, 1] if k > 1 else math.inf
        )
    return best, arg, second


def near_ties(best, second):
    return (second - best) <= TIE_RTOL * second.abs()


def check_kernel_shape(torch, nc, n, d, k, gen, dev):
    """One shape: exact and continuous-data agreement, then timings."""
    # exact: values on a 1/4 grid keep every product and partial sum exact
    # in fp32, so any summation order gives the same d2, and a duplicated
    # center makes exact ties that must resolve to the lower index
    X = (torch.randn(n, d, generator=gen) * 4).round().div(4).to(dev)
    C = (torch.randn(k, d, generator=gen) * 4).round().div(4).to(dev)
    if k > 1:
        C[k - 1] = C[0]
    m, a = nc.min_dist_argmin(X, C)
    pm, pa = nc.min_dist_argmin_plain(X, C)
    torch.cuda.synchronize()
    exact_mismatch = int((a != pa).sum())
    exact_err = float((m - pm).abs().max())
    check(exact_mismatch == 0 and exact_err == 0.0,
          f"({n},{d},{k}) exact data: {exact_mismatch} argmin mismatches, max err {exact_err}")
    # continuous: standard normal
    X = torch.randn(n, d, generator=gen).to(dev)
    C = torch.randn(k, d, generator=gen).to(dev)
    x_norm, c_norm = nc.squared_norms(X), nc.squared_norms(C)
    m, a = nc.min_dist_argmin(X, C, x_norm, c_norm)
    best, parg, second = plain_top2(torch, X, C, x_norm, c_norm)
    torch.cuda.synchronize()
    differ = a.long() != parg
    ties = near_ties(best, second)
    err = float((m - best).abs().max())
    check(bool(torch.allclose(m, best, rtol=MIN_D2_TOL, atol=MIN_D2_TOL)),
          f"({n},{d},{k}) min_d2 off by up to {err}")
    check(not bool((differ & ~ties).any()),
          f"({n},{d},{k}) {int((differ & ~ties).sum())} argmin mismatches off near-ties")
    reps = 5 if n * k * d > 1e11 else 20
    kernel = median_ms(torch, lambda: nc.min_dist_argmin(X, C, x_norm, c_norm), reps)
    plain = median_ms(torch, lambda: nc.min_dist_argmin_plain(X, C, x_norm, c_norm), reps)
    library = median_ms(
        torch, lambda: torch.min(x_norm[:, None] - 2.0 * (X @ C.T) + c_norm[None, :], dim=1), reps
    )
    bound, bound_by = bound_ms(n, d, k, 4)
    del X, C
    torch.cuda.empty_cache()
    return {
        "n": n, "d": d, "k": k,
        "exact_mismatches": exact_mismatch,
        "mismatches": int(differ.sum()),
        "near_tie_rows": int(ties.sum()),
        "max_abs_err": err,
        "kernel_ms": kernel, "plain_ms": plain, "library_ms": library,
        "bound_ms": bound, "bound_by": bound_by,
        "tflops": 2.0 * n * k * d / kernel / 1e9,
    }


def blobs(rows, cols, k, seed, workers=8):
    """Gaussian blobs (cluster_std 1, centers uniform in [-10, 10]) as in the
    benchmark's BlobsDataGen, filled by `workers` threads with independent
    seeded streams."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10.0, 10.0, size=(k, cols)).astype(np.float32)
    assign = rng.integers(0, k, size=rows)
    X = np.empty((rows, cols), np.float32)
    streams = np.random.SeedSequence(seed).spawn(workers)
    bounds = np.linspace(0, rows, workers + 1, dtype=int)

    def fill(i):
        rng_i = np.random.default_rng(streams[i])
        for lo in range(bounds[i], bounds[i + 1], 16384):
            hi = min(lo + 16384, bounds[i + 1])
            rng_i.standard_normal(out=X[lo:hi], dtype=np.float32)
            X[lo:hi] += centers[assign[lo:hi]]

    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(fill, range(workers)))
    return X


def run_path(torch, port, nc):
    """The flagship configuration through the public API.  Returns the
    path's record; raises on any failed check."""
    t0 = time.perf_counter()
    X = blobs(ROWS, COLS, K, SEED)
    gen_s = time.perf_counter() - t0
    df = port.DataFrame.from_numpy(X, num_partitions=PARTITIONS)
    model_dir = os.path.join(REPO, "build", "chip_smoke_model")
    shutil.rmtree(model_dir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()

    nc.min_dist_argmin.launches = 0
    t0 = time.perf_counter()
    model = port.KMeans(k=K, maxIter=MAX_ITER, initMode="random", seed=SEED).fit(df)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches_fit = nc.min_dist_argmin.launches
    t0 = time.perf_counter()
    labels = np.concatenate([p["prediction"] for p in model.transform(df).partitions])
    transform_s = time.perf_counter() - t0
    launches_transform = nc.min_dist_argmin.launches - launches_fit
    model.save(model_dir)
    loaded = port.load(model_dir)
    t0 = time.perf_counter()
    labels_loaded = np.concatenate([p["prediction"] for p in loaded.transform(df).partitions])
    transform2_s = time.perf_counter() - t0
    launches = nc.min_dist_argmin.launches
    peak_bytes = torch.cuda.max_memory_allocated()

    check(launches_transform > 0, "transform did not launch the min_dist_argmin kernel")
    check(model.n_iter_ <= MAX_ITER and math.isfinite(model.inertia_),
          f"n_iter {model.n_iter_}, inertia {model.inertia_}")
    check(labels.shape == (ROWS,) and labels.dtype == np.int32
          and int(labels.min()) >= 0 and int(labels.max()) < K, "labels out of range")
    check(np.array_equal(labels, labels_loaded), "reloaded model gives other labels")

    # the kernel's labels against the plain version on the card
    centers = torch.as_tensor(model.cluster_centers_.astype(np.float32)).cuda()
    c_norm = (centers * centers).sum(dim=1)
    mismatches = near_tie_rows = tie_mismatches = 0
    upload_s = 0.0  # the host-to-device copy that transform makes per partition
    for part, lo in zip(df.partitions, np.cumsum([0] + [len(p) for p in df.partitions])):
        t0 = time.perf_counter()
        Xp = torch.from_numpy(part["features"]).cuda()
        torch.cuda.synchronize()
        upload_s += time.perf_counter() - t0
        best, parg, second = plain_top2(torch, Xp, centers, nc.squared_norms(Xp), c_norm)
        differ = torch.from_numpy(labels[lo : lo + len(part)]).cuda().long() != parg
        ties = near_ties(best, second)
        mismatches += int(differ.sum())
        near_tie_rows += int(ties.sum())
        tie_mismatches += int((differ & ties).sum())
        del Xp
    check(mismatches == tie_mismatches,
          f"{mismatches - tie_mismatches} labels differ from the plain version off near-ties")
    return {
        "phase": "path",
        "rows": ROWS, "cols": COLS, "k": K, "max_iter": MAX_ITER,
        "init_mode": "random", "partitions": PARTITIONS, "rows_cut": False,
        "data_gen_s": gen_s,
        "fit_s": fit_s, "n_iter": model.n_iter_, "inertia": model.inertia_,
        "transform_s": transform_s, "transform_rows_per_s": ROWS / transform_s,
        "reloaded_transform_s": transform2_s,
        "host_to_device_s": upload_s,
        "host_to_device_bytes_per_s": X.nbytes / upload_s,
        "launches_fit": launches_fit,
        "launches_per_transform": launches_transform,
        "launches": launches,
        "label_mismatches_vs_plain": mismatches,
        "near_tie_rows": near_tie_rows,
        "max_memory_allocated_bytes": peak_bytes,
    }


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script runs on a GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "spark_rapids_ml_tpu_torch")):
        print("chip_smoke.py: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import spark_rapids_ml_tpu_torch as port
    from spark_rapids_ml_tpu_torch.ops import _build
    from spark_rapids_ml_tpu_torch.ops import nearest_center as nc

    t_start = time.perf_counter()
    smi = smi_line()
    print(smi, flush=True)
    emit({
        "phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
        "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
        "device_count": torch.cuda.device_count(), "nvidia_smi": smi,
    })

    seconds = _build.build(["min_dist_argmin"])
    ptxas = [line.strip() for line in _build.build_log("min_dist_argmin").splitlines()
             if "registers" in line or "spill" in line]
    emit({"phase": "build", "nvcc_s": seconds, "ptxas": ptxas})

    gen = torch.Generator().manual_seed(SEED)
    dev = port.device.resolve()  # cuda:0, with TF32 off for the plain versions
    rows = [check_kernel_shape(torch, nc, n, d, k, gen, dev) for n, d, k in SHAPES]
    emit({"phase": "kernels", "kernel": "min_dist_argmin", "dtype": "float32",
          "peak_fp32_flops": PEAK_FP32_FLOPS, "peak_bytes_per_s": PEAK_BYTES_PER_S,
          "shapes": rows})
    # the float64 instantiation: exact agreement at the JAX package's shapes
    for n, d, k in SHAPES[:4]:
        X = (torch.randn(n, d, generator=gen, dtype=torch.float64) * 4).round().div(4).to(dev)
        C = (torch.randn(k, d, generator=gen, dtype=torch.float64) * 4).round().div(4).to(dev)
        m, a = nc.min_dist_argmin(X, C)
        pm, pa = nc.min_dist_argmin_plain(X, C)
        check(m.dtype == torch.float64 and bool((a == pa).all()) and bool((m == pm).all()),
              f"float64 ({n},{d},{k}) disagrees with the plain version")
    emit({"phase": "kernels_f64", "shapes": [list(s) for s in SHAPES[:4]], "exact": True})

    path = run_path(torch, port, nc)
    emit(path)

    main_shape = rows[-1]
    summary = {"kernels": [{
        "name": "min_dist_argmin",
        "route": "cuda",
        "source": "spark_rapids_ml_tpu_torch/csrc/min_dist_argmin.cu",
        "replaces": "spark_rapids_ml_tpu/ops/pallas_tpu.py:102",
        "launches": path["launches"],
        "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["kernel_ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "shape": [main_shape["n"], main_shape["d"], main_shape["k"]],
    }], "seconds": time.perf_counter() - t_start}
    print(smi, flush=True)
    emit(summary)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
