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
#            save -> load -> transform
#   kernels_forest
#            the RandomForest kernels against their plain versions: binning
#            (B2) exact at the path's shape (1,000,000 x 3000, 127 edges),
#            ragged shapes and NaN / +-inf / on-edge values; node histograms
#            (B3) at shallow levels 0 and 6 and bucketed histograms (B4) at
#            one deep window, exact on integer stats and within
#            HIST_FLOAT_RTOL / HIST_FLOAT_ATOL on float stats; timings as above
#            (library_ms: torch.searchsorted, one index_add_)
#   path_rf_clf
#            RandomForestClassifier(numTrees=50, maxDepth=13, maxBins=128,
#            featureSubsetStrategy="sqrt") on 1,000,000 x 3000 float32 rows
#            (make_classification semantics, 2 classes): fit -> transform ->
#            save -> load -> transform, identical predictions, every forest
#            kernel launched by the fit, held-out accuracy (100k rows) above
#            the majority share
#   path_rf_reg
#            RandomForestRegressor(numTrees=30, maxDepth=6, maxBins=128,
#            featureSubsetStrategy="onethird") on the same rows with a linear
#            target: fit -> transform, finite predictions, held-out R^2 > 0
#   forest_card_vs_cpu
#            one reduced fit (65,536 x 256, 4 trees, depth 13, no bootstrap)
#            on the card and under use_device("cpu"): identical trees
# Every path runs with all kernel launch counters reset just before it and
# read just after.  It ends with the card's nvidia-smi line, a
# {"kernels": [...]} summary line and {"ok": true, "device": {...}}.
# `--phases a,b` runs a subset (the summary then lists only what ran).
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


def run_path(torch, port, nc, wrappers):
    """The flagship configuration through the public API.  Returns the
    path's record; raises on any failed check."""
    t0 = time.perf_counter()
    X = blobs(ROWS, COLS, K, SEED)
    gen_s = time.perf_counter() - t0
    df = port.DataFrame.from_numpy(X, num_partitions=PARTITIONS)
    model_dir = os.path.join(REPO, "build", "chip_smoke_model")
    shutil.rmtree(model_dir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()

    reset_launches(wrappers)
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
    launches_all = read_launches(wrappers)
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
        "launches_all": launches_all,
        "label_mismatches_vs_plain": mismatches,
        "near_tie_rows": near_tie_rows,
        "max_memory_allocated_bytes": peak_bytes,
    }


# ---------------------------------------------------------------------------
# RandomForest: kernels B2-B4 and the two flagship configurations
# ---------------------------------------------------------------------------

# The reference benchmark's RandomForest configurations (run_benchmark.sh
# 101-122): 1M x 3000 float32, 2 classes, make_classification semantics
# (10 informative, 2 redundant, class_sep 1); 100k more rows held out.
RF_ROWS, RF_HOLDOUT, RF_PARTITIONS = 1_000_000, 100_000, 8
RF_CLF = dict(numTrees=50, maxDepth=13, maxBins=128, featureSubsetStrategy="sqrt", seed=1)
RF_REG = dict(numTrees=30, maxDepth=6, maxBins=128, featureSubsetStrategy="onethird", seed=1)
N_INF, N_RED = 10, 2
RF_N_PAD = -(-RF_ROWS // 2048) * 2048  # rows padded to the histogram row tile
RF_F_PAD = 64                           # sqrt(3000) = 54 subset features, padded to 32s
# float stats (regression w*y): the kernel and the plain version add the
# same bf16-rounded terms in fp32, in other orders
HIST_FLOAT_RTOL, HIST_FLOAT_ATOL = 1e-4, 1e-3


def classification_data(rows, cols, seed, workers=8):
    """make_classification semantics as in the benchmark's
    ClassificationDataGen: hypercube-vertex centroids (class_sep 1), a random
    rotation of the informative columns, redundant linear combinations, the
    rest Gaussian noise; filled by `workers` threads with independent seeded
    streams.  Returns (X float32, y float64 in {0, 1})."""
    crng = np.random.default_rng(seed)
    centroids = crng.choice([-1.0, 1.0], size=(2, N_INF))
    rotate = crng.standard_normal((N_INF, N_INF))
    redundant = crng.standard_normal((N_INF, N_RED))
    y = np.random.default_rng(seed + 1).integers(0, 2, size=rows)
    X = np.empty((rows, cols), np.float32)
    streams = np.random.SeedSequence(seed).spawn(workers)
    bounds = np.linspace(0, rows, workers + 1, dtype=int)

    def fill(i):
        rng_i = np.random.default_rng(streams[i])
        for lo in range(bounds[i], bounds[i + 1], 16384):
            hi = min(lo + 16384, bounds[i + 1])
            rng_i.standard_normal(out=X[lo:hi], dtype=np.float32)
            inf = (centroids[y[lo:hi]] + X[lo:hi, :N_INF]) @ rotate
            X[lo:hi, :N_INF] = inf
            X[lo:hi, N_INF : N_INF + N_RED] = inf @ redundant

    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(fill, range(workers)))
    return X, y.astype(np.float64)


def regression_target(X, seed):
    """y = X . coef + 0.1 noise, coef with 10 informative entries in
    [0, 100) (the benchmark's RegressionDataGen)."""
    crng = np.random.default_rng(seed)
    coef = 100.0 * crng.uniform(size=N_INF)
    noise = np.random.default_rng(seed + 1).standard_normal(X.shape[0])
    return X[:, :N_INF].astype(np.float64) @ coef + 0.1 * noise


def reset_launches(wrappers):
    for fn in wrappers.values():
        fn.launches = 0


def read_launches(wrappers):
    return {name: fn.launches for name, fn in wrappers.items()}


def timings(torch, kernel, plain, library, reps):
    return {
        "kernel_ms": median_ms(torch, kernel, reps),
        "plain_ms": median_ms(torch, plain, max(1, reps // 2)),
        "library_ms": None if library is None else median_ms(torch, library, max(1, reps // 2)),
    }


def bound(nbytes, ops):
    """Least time for `nbytes` moved and `ops` fp32 operations."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_binning(torch, binning, X, edges, n_pad, reps, library=True):
    """B2 on one input: exact agreement with the plain version (and with
    torch.searchsorted, the library yardstick), then timings."""
    n, d = X.shape
    got = binning.bin_features_fm(X, edges, n_pad)
    want = binning.bin_features_fm_plain(X, edges, n_pad)
    torch.cuda.synchronize()
    mismatches = int((got != want).sum())
    check(mismatches == 0, f"bin_features_fm ({n}, {d}, {edges.shape[1]}): {mismatches} bins differ")
    del want
    lib = None
    if library:
        XT = X.T.contiguous()
        lib_fn = lambda: torch.searchsorted(edges, XT, out_int32=True)  # noqa: E731
        # searchsorted puts NaN after every edge; the kernel gives it bin 0
        lib_bins = lib_fn()
        lib_bins[torch.isnan(XT)] = 0
        check(bool((lib_bins.to(torch.int8) == got[:, :n]).all()), "bin_features_fm disagrees with searchsorted")
        del lib_bins
        lib = lib_fn
    row = timings(
        torch,
        lambda: binning.bin_features_fm(X, edges, n_pad),
        lambda: binning.bin_features_fm_plain(X, edges, n_pad),
        lib,
        reps,
    )
    if library:
        del XT
    # X read once, the bins written once; ~log2(E+1) compares per value
    b, by = bound(4.0 * n * d + 4.0 * edges.numel() + d * n_pad, n * d * math.ceil(math.log2(edges.shape[1] + 1)))
    torch.cuda.empty_cache()
    return {"n": n, "d": d, "edges": edges.shape[1], "n_pad": n_pad, "mismatches": mismatches,
            "max_abs_err": 0.0, **row, "bound_ms": b, "bound_by": by}


def hist_case(torch, dev, gen, f_pad, n, t_pack, nodes, s_dim, n_bins, integer, stray=False):
    """Random inputs at one histogram shape: bins in [0, n_bins), node ids in
    [0, nodes] (== nodes is masked), stats Poisson(1) counts x one-hot
    classes (integer) or uniform [0, 1) (float)."""
    bins = torch.randint(0, n_bins, (f_pad, n), generator=gen, device=dev, dtype=torch.int8)
    node = torch.randint(0, nodes + 1, (t_pack, n), generator=gen, device=dev, dtype=torch.int32)
    if stray:
        node[torch.rand((t_pack, n), generator=gen, device=dev) < 0.05] = 1 << 18
    if integer:
        counts = torch.poisson(torch.ones((t_pack, n), device=dev), generator=gen)
        y = torch.randint(0, s_dim, (n,), generator=gen, device=dev)
        onehot = (y[None, :] == torch.arange(s_dim, device=dev)[:, None]).float()
        stats = (counts[:, None, :] * onehot[None]).reshape(t_pack * s_dim, n)
    else:
        stats = torch.rand((t_pack * s_dim, n), generator=gen, device=dev)
    return bins, node, stats.contiguous()


def hist_terms(torch, node, stats, t_pack, nodes, s_dim, f_pad):
    """Adds the data needs: (row, feature, tree, stat) with a node in range
    and a non-zero stat."""
    valid = ((node >= 0) & (node < nodes)).repeat_interleave(s_dim, dim=0)
    return int((valid & (stats != 0)).sum()) * f_pad


def check_hist(torch, fh, dev, gen, name, f_pad, n, t_pack, nodes, s_dim, n_bins, reps, bucketed=False,
               library=True):
    """B3 (node_histograms) or B4 (node_histograms_bucketed) at one shape:
    exact on integer stats, HIST_FLOAT_* on float stats; timings on the
    integer inputs."""
    if bucketed:
        n_buckets = t_pack
        kernel = lambda b, c, s: fh.node_histograms_bucketed(b, c, s, n_buckets, nodes, s_dim, n_bins)  # noqa: E731
        plain = lambda b, c, s: fh.node_histograms_bucketed_plain(b, c, s, n_buckets, nodes, s_dim, n_bins)  # noqa: E731
        rows = 1
    else:
        kernel = lambda b, c, s: fh.node_histograms(b, c, s, t_pack, nodes, s_dim, n_bins)  # noqa: E731
        plain = lambda b, c, s: fh.node_histograms_plain(b, c, s, t_pack, nodes, s_dim, n_bins)  # noqa: E731
        rows = t_pack
    errs = {}
    for integer in (False, True):
        bins, node, stats = hist_case(torch, dev, gen, f_pad, n, rows, nodes, s_dim, n_bins, integer, stray=bucketed)
        got, want = kernel(bins, node, stats), plain(bins, node, stats)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if integer:
            check(err == 0.0, f"{name} integer stats: max abs err {err}")
        else:
            check(bool(torch.allclose(got, want, rtol=HIST_FLOAT_RTOL, atol=HIST_FLOAT_ATOL)),
                  f"{name} float stats: max abs err {err}")
        errs["integer" if integer else "float"] = err
        del got, want
    lib = None
    if library:
        # the library yardstick: one index_add_ of the bf16-rounded stats
        # over the flat output index, built beforehand
        out_shape = tuple(kernel(bins, node, stats).shape)
        if bucketed:
            cap = n // n_buckets
            bucket = torch.arange(n, device=dev) // cap
            slots_pad = out_shape[2]
        feat = torch.arange(f_pad, device=dev)[:, None]
        idx_parts, val_parts = [], []
        for t in range(rows):
            c = node[t].long()
            ok = (c >= 0) & (c < nodes)
            for s in range(s_dim):
                slot = (t * nodes + c.clamp(0, nodes - 1)) * s_dim + s
                if bucketed:
                    flat = ((bucket[None, :] * f_pad + feat) * slots_pad + slot[None, :]) * n_bins + bins.long()
                else:
                    flat = (feat * 128 + slot[None, :]) * n_bins + bins.long()
                v = stats[t * s_dim + s].to(torch.bfloat16).float()
                keep = (ok & (v != 0))[None, :].expand(f_pad, n)
                idx_parts.append(flat[keep])
                val_parts.append(v[None, :].expand(f_pad, n)[keep])
        idx, vals = torch.cat(idx_parts), torch.cat(val_parts)
        del idx_parts, val_parts
        numel = math.prod(out_shape)
        lib = lambda: torch.zeros(numel, device=dev).index_add_(0, idx, vals)  # noqa: E731
        check(bool((lib().reshape(out_shape) == kernel(bins, node, stats)).all()), f"{name} disagrees with index_add_")
    row = timings(torch, lambda: kernel(bins, node, stats), lambda: plain(bins, node, stats), lib, reps)
    out_bytes = 4 * math.prod(kernel(bins, node, stats).shape)
    b, by = bound(bins.numel() + 4 * node.numel() + 4 * stats.numel() + out_bytes,
                  hist_terms(torch, node, stats, rows, nodes, s_dim, f_pad))
    del bins, node, stats, lib
    torch.cuda.empty_cache()
    return {"kernel": name, "f_pad": f_pad, "n": n, "t_pack_or_buckets": t_pack, "nodes": nodes,
            "s_dim": s_dim, "n_bins": n_bins, "max_abs_err": errs["float"], "max_abs_err_integer": errs["integer"],
            **row, "bound_ms": b, "bound_by": by}


def check_forest_kernels(torch, port, binning, fh, X_host, dev):
    """Phase kernels_forest: B2, B3 and B4 against their plain versions on
    the card, at the shapes the RandomForest path gives them."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {"phase": "kernels_forest", "hist_float_rtol": HIST_FLOAT_RTOL, "hist_float_atol": HIST_FLOAT_ATOL}
    # B2 at the path's shape: the classifier's rows and its 127 edges
    X = torch.from_numpy(X_host[:RF_ROWS]).to(dev)
    step = -(-RF_ROWS // 2796)
    edges = torch.from_numpy(port.ops.forest.compute_bin_edges(X_host[:RF_ROWS:step], 128)).to(dev)
    binning_rows = [check_binning(torch, binning, X, edges, RF_N_PAD, reps=5)]
    del X
    torch.cuda.empty_cache()
    # ragged, degenerate, and NaN / +-inf / values equal to an edge
    for n, d, e in ((300, 70, 31), (129, 1, 1), (2000, 5, 127)):
        Xs = torch.randn((n, d), generator=gen, device=dev)
        es = torch.sort(torch.randn((d, e), generator=gen, device=dev), dim=1).values
        if e == 127:
            Xs[0], Xs[1], Xs[2] = float("nan"), float("inf"), float("-inf")
            Xs[3], Xs[4] = es[:, 0], es[:, -1]
            es[0, 60:70] = es[0, 60]  # repeated edges
        binning_rows.append(check_binning(torch, binning, Xs, es.contiguous(), -(-n // 2048) * 2048, reps=5,
                                          library=False))
    out["bin_features_fm"] = binning_rows
    # B3 at the classifier's shallow levels 0 and 6, B4 at one deep window
    # (128 buckets of 8192 rows at level 12: 32 local nodes)
    out["node_histograms"] = [
        check_hist(torch, fh, dev, gen, "node_histograms", RF_F_PAD, RF_N_PAD, 1, 64, 2, 128, reps=10),
        check_hist(torch, fh, dev, gen, "node_histograms", RF_F_PAD, RF_N_PAD, 50, 1, 2, 128, reps=5,
                   library=False),
    ]
    out["node_histograms_bucketed"] = [
        check_hist(torch, fh, dev, gen, "node_histograms_bucketed", RF_F_PAD, 128 * 8192, 128, 32, 2, 128,
                   reps=10, bucketed=True),
    ]
    return out


def run_rf_path(torch, port, wrappers, phase, est, X, y, classification):
    """One RandomForest flagship configuration through the public API on
    the first RF_ROWS rows; held-out quality on the rest."""
    df = port.DataFrame.from_numpy(X[:RF_ROWS], y[:RF_ROWS], num_partitions=RF_PARTITIONS)
    hold = port.DataFrame.from_numpy(X[RF_ROWS:], num_partitions=1)
    model_dir = os.path.join(REPO, "build", f"chip_smoke_{phase}")
    shutil.rmtree(model_dir, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(wrappers)
    t0 = time.perf_counter()
    model = est.fit(df)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches_fit = read_launches(wrappers)
    t0 = time.perf_counter()
    out = model.transform(df)
    transform_s = time.perf_counter() - t0
    pred = np.concatenate([p["prediction"] for p in out.partitions])
    rec = {}
    if classification:
        model.save(model_dir)
        loaded = port.load(model_dir)
        out2 = loaded.transform(df)
        check(np.array_equal(pred, np.concatenate([p["prediction"] for p in out2.partitions])),
              "reloaded forest gives other predictions")
        check(np.array_equal(np.concatenate([p["probability"] for p in out.partitions]),
                             np.concatenate([p["probability"] for p in out2.partitions])),
              "reloaded forest gives other probabilities")
        rec["reloaded_identical"] = True
    launches = read_launches(wrappers)
    peak_bytes = torch.cuda.max_memory_allocated()
    rec["profile"] = profile_fit(torch, est, df)
    hold_pred = np.concatenate([p["prediction"] for p in model.transform(hold).partitions])
    y_hold = y[RF_ROWS:]
    check(np.isfinite(pred).all() and np.isfinite(hold_pred).all(), "non-finite predictions")
    if classification:
        acc = float((hold_pred == y_hold).mean())
        majority = float(max(y_hold.mean(), 1 - y_hold.mean()))
        for name in ("bin_features_fm", "node_histograms", "node_histograms_bucketed"):
            check(launches_fit[name] > 0, f"the fit launched {name} no time")
        check(acc > majority, f"held-out accuracy {acc} <= majority share {majority}")
        rec.update(holdout_accuracy=acc, majority_share=majority)
    else:
        r2 = float(1.0 - ((hold_pred - y_hold) ** 2).mean() / y_hold.var())
        check(r2 > 0.0, f"held-out R^2 {r2} <= 0")
        rec["holdout_r2"] = r2
    return {
        "phase": phase, "rows": RF_ROWS, "cols": X.shape[1], "holdout_rows": len(y_hold),
        "params": {k.name: v for k, v in est.extractParamMap().items() if k.name in RF_CLF},
        "fit_s": fit_s, "transform_s": transform_s, "transform_rows_per_s": RF_ROWS / transform_s,
        "launches_fit": launches_fit, "launches": launches,
        "max_memory_allocated_bytes": peak_bytes, **rec,
    }


PROFILE_RANGES = ("core.ingest", "forest.bin", "forest.shallow", "forest.deep_layout", "forest.deep")


def profile_fit(torch, est, df):
    """One more fit of `est` under torch.profiler: the host milliseconds
    inside each of the port's ranges, the device's busy milliseconds (the
    union of the intervals of every kernel and copy on the card), the
    device's idle share of the fit's wall time, and the device time of the
    kernels that took the most.  The profiler slows the fit; fit_s comes
    from the fit before it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        est.fit(df)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)  # not the profiler's own start and stop
    events = prof.events()
    host = {k: 0.0 for k in PROFILE_RANGES}
    spans, per_kernel = [], {}
    for e in events:
        if e.device_type == DeviceType.CPU:
            if e.name in host:
                host[e.name] += (e.time_range.end - e.time_range.start) / 1e3
        elif e.name not in host and not e.name.startswith("Activity Buffer"):
            # a kernel or a copy on the card (not a range's device-side
            # annotation, nor the profiler's own buffer requests)
            spans.append((e.time_range.start, e.time_range.end))
            ms, count = per_kernel.get(e.name, (0.0, 0))
            per_kernel[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, count + 1)
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    top = sorted(per_kernel.items(), key=lambda kv: kv[1][0], reverse=True)[:10]
    return {
        "profiled_fit_ms": wall_ms,
        "range_host_ms": host,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
        "top_device_ms": [[name[:90], ms, count] for name, (ms, count) in top],
    }


def forest_card_vs_cpu(torch, port):
    """The same reduced fit (bootstrap off) on the card and under
    use_device("cpu"): the trees must be identical, which holds the whole
    tree growth on the card against the kernels' plain versions."""
    X, y = classification_data(65536, 256, SEED + 7)
    df = port.DataFrame.from_numpy(X, y, num_partitions=2)
    est = port.RandomForestClassifier(numTrees=4, maxDepth=13, maxBins=128, featureSubsetStrategy="sqrt",
                                      bootstrap=False, seed=1)
    t0 = time.perf_counter()
    card = est.fit(df)
    card_s = time.perf_counter() - t0
    with port.device.use_device("cpu"):
        t0 = time.perf_counter()
        cpu = est.fit(df)
        cpu_s = time.perf_counter() - t0
    for name in ("features_", "thresholds_", "node_counts_"):
        a, b = getattr(card, name), getattr(cpu, name)
        check(np.array_equal(a, b), f"card and CPU trees differ in {name} at {int((a != b).sum())} nodes")
    return {"phase": "forest_card_vs_cpu", "rows": 65536, "cols": 256, "trees": 4, "max_depth": 13,
            "split_nodes": int((card.features_ >= 0).sum()), "identical": True,
            "card_fit_s": card_s, "cpu_fit_s": cpu_s}




def main():
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of the phases to run (default: all)")
    phases = parser.parse_args().phases.split(",")
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        parser.error(f"unknown phases {unknown}; choose from {PHASES}")
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script runs on a GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "spark_rapids_ml_tpu_torch")):
        print("chip_smoke.py: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import spark_rapids_ml_tpu_torch as port
    import spark_rapids_ml_tpu_torch.ops.forest  # noqa: F401  (port.ops.forest)
    from spark_rapids_ml_tpu_torch.ops import _build, binning
    from spark_rapids_ml_tpu_torch.ops import forest_hist as fh
    from spark_rapids_ml_tpu_torch.ops import nearest_center as nc

    wrappers = {
        "min_dist_argmin": nc.min_dist_argmin,
        "bin_features_fm": binning.bin_features_fm,
        "node_histograms": fh.node_histograms,
        "node_histograms_bucketed": fh.node_histograms_bucketed,
    }
    t_start = time.perf_counter()
    smi = smi_line()
    print(smi, flush=True)
    emit({
        "phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
        "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
        "device_count": torch.cuda.device_count(), "nvidia_smi": smi,
    })

    libraries = sorted({os.path.basename(src)[: -len(".cu")] for src in KERNEL_SOURCES.values()})
    seconds = _build.build(libraries)  # one nvcc per source, all started together
    ptxas = {name: [line.strip() for line in _build.build_log(name).splitlines()
                    if "registers" in line or "spill" in line or "smem" in line]
             for name in libraries}
    emit({"phase": "build", "nvcc_s": seconds, "ptxas": ptxas})
    dev = port.device.resolve()  # cuda:0, with TF32 off for the plain versions
    results = {}

    if "kernels" in phases:
        gen = torch.Generator().manual_seed(SEED)
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
        results["kernels"] = rows[-1]

    if "path" in phases:
        results["path"] = run_path(torch, port, nc, wrappers)
        emit(results["path"])

    rf_phases = {"kernels_forest", "path_rf_clf", "path_rf_reg"} & set(phases)
    if rf_phases:
        t0 = time.perf_counter()
        X_rf, y_rf = classification_data(RF_ROWS + RF_HOLDOUT, COLS, SEED)
        emit({"phase": "rf_data", "rows": RF_ROWS + RF_HOLDOUT, "cols": COLS, "seconds": time.perf_counter() - t0})
    if "kernels_forest" in phases:
        results["kernels_forest"] = check_forest_kernels(torch, port, binning, fh, X_rf, dev)
        emit(results["kernels_forest"])
    if "path_rf_clf" in phases:
        results["path_rf_clf"] = run_rf_path(torch, port, wrappers, "path_rf_clf",
                                             port.RandomForestClassifier(**RF_CLF), X_rf, y_rf, True)
        emit(results["path_rf_clf"])
    if "path_rf_reg" in phases:
        y_reg = regression_target(X_rf, SEED + 3)
        results["path_rf_reg"] = run_rf_path(torch, port, wrappers, "path_rf_reg",
                                             port.RandomForestRegressor(**RF_REG), X_rf, y_reg, False)
        emit(results["path_rf_reg"])
    if rf_phases:
        del X_rf
    if "forest_card_vs_cpu" in phases:
        emit(forest_card_vs_cpu(torch, port))

    print(smi, flush=True)
    emit(summary(results, time.perf_counter() - t_start))
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def summary(results, seconds):
    """The {"kernels": [...]} line: each kernel at the shape the main path
    gives it most often, with the launches of the path that runs it."""
    rows = []
    km, kf = results.get("kernels"), results.get("kernels_forest")
    if km is not None:
        rows.append({
            "name": "min_dist_argmin", "route": "cuda", "source": KERNEL_SOURCES["min_dist_argmin"],
            "replaces": "spark_rapids_ml_tpu/ops/pallas_tpu.py:102",
            "launches": results.get("path", {}).get("launches_all", {}).get("min_dist_argmin"),
            "max_abs_err": km["max_abs_err"], "ms": km["kernel_ms"], "plain_ms": km["plain_ms"],
            "bound_ms": km["bound_ms"], "bound_by": km["bound_by"], "library_ms": km["library_ms"],
            "shape": [km["n"], km["d"], km["k"]],
        })
    if kf is not None:
        clf = results.get("path_rf_clf", {}).get("launches", {})
        picks = (
            ("bin_features_fm", kf["bin_features_fm"][0], "spark_rapids_ml_tpu/ops/pallas_tpu.py:219",
             ["n", "d", "edges", "n_pad"]),
            ("node_histograms", kf["node_histograms"][0], "spark_rapids_ml_tpu/ops/forest_hist.py:73",
             ["f_pad", "n", "t_pack_or_buckets", "nodes", "s_dim", "n_bins"]),
            ("node_histograms_bucketed", kf["node_histograms_bucketed"][0],
             "spark_rapids_ml_tpu/ops/forest_hist.py:182",
             ["f_pad", "n", "t_pack_or_buckets", "nodes", "s_dim", "n_bins"]),
        )
        for name, r, replaces, keys in picks:
            rows.append({
                "name": name, "route": "cuda", "source": KERNEL_SOURCES[name], "replaces": replaces,
                "launches": clf.get(name), "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], "shape": [r[k] for k in keys],
            })
    return {"kernels": rows, "seconds": seconds}


PHASES = ["kernels", "path", "kernels_forest", "path_rf_clf", "path_rf_reg", "forest_card_vs_cpu"]
KERNEL_SOURCES = {
    "min_dist_argmin": "spark_rapids_ml_tpu_torch/csrc/min_dist_argmin.cu",
    "bin_features_fm": "spark_rapids_ml_tpu_torch/csrc/bin_features_fm.cu",
    "node_histograms": "spark_rapids_ml_tpu_torch/csrc/forest_hist.cu",
    "node_histograms_bucketed": "spark_rapids_ml_tpu_torch/csrc/forest_hist.cu",
}


if __name__ == "__main__":
    sys.exit(main())
