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
#            and the least time the card could take (bound_ms).  B1 (float32,
#            the pipelined loop of csrc/fp32_dist_tile.cuh) also at two
#            large shapes of its 4-byte copies (SHAPES_UNALIGNED: X one
#            element off a 16-byte boundary, and d % 4 != 0), each record
#            naming its copy width; float64 exact at the first four shapes
#   path     the KMeans flagship configuration through the public API:
#            1,000,000 x 3000 float32 Gaussian blobs around 1000 centers,
#            KMeans(k=1000, maxIter=30, initMode="random").fit -> transform ->
#            save -> load -> transform
#   kernels_forest
#            the RandomForest kernels against their plain versions: binning
#            (B2) exact at the path's shape (1,000,000 x 3000, 127 edges),
#            ragged shapes and NaN / +-inf / on-edge values; node histograms
#            (B3) through both routes, the tensor-core kernel and the atomic
#            kernel, at ragged shapes and at the first launch of every
#            shallow split level of both flagship fits (classifier F_pad 64,
#            levels 0-6; regressor F_pad 1024, levels 0-5), and bucketed
#            histograms (B4) at one deep window (each block writes its own
#            output slice), at its level 7, with the fit's zero-padded
#            feature rows, and at a launch too small to fill the card (rows
#            split across blocks, atomic flush), with stray node ids and
#            bins, every output on a block of NaNs; the atomic kernel also
#            through the int32 cells of declared integer stats (the
#            classifier's): exact on integer stats,
#            within HIST_FLOAT_RTOL / HIST_FLOAT_ATOL on float stats, the
#            tensor-core route bit for bit across two calls on float stats;
#            timings as above (library_ms: torch.searchsorted, index_add_;
#            B3's plain version and index_add_ timed at every classifier
#            level and at the regressor's level 0 only, its plain version
#            taking seconds a call at F_pad 1024)
#   path_rf_clf
#            RandomForestClassifier(numTrees=50, maxDepth=13, maxBins=128,
#            featureSubsetStrategy="sqrt") on 1,000,000 x 3000 float32 rows
#            (make_classification semantics, 2 classes): fit -> transform ->
#            save -> load -> transform, identical predictions, every forest
#            kernel launched by the fit (B3's launches by route as the
#            route function sends them), held-out accuracy (100k rows) above
#            the majority share
#   path_rf_reg
#            RandomForestRegressor(numTrees=30, maxDepth=6, maxBins=128,
#            featureSubsetStrategy="onethird") on the same rows with a linear
#            target: fit -> transform, finite predictions, held-out R^2 > 0
#   forest_card_vs_cpu
#            one reduced fit (65,536 x 256, 4 trees, depth 13, no bootstrap)
#            on the card and under use_device("cpu"): identical trees
#   kernels_knn
#            the exact-kNN kernels against their plain versions: candidate
#            pool (B5, and B6, the same kernel on the audit route), fused
#            merge (B7), audit count (B8).  On integer-valued data (ragged
#            shapes, one flagship block, the mesh's shard shape, m = 32)
#            pools (-inf slots included), merges and counts are exact, a
#            pool wider than 16,384, 65,537 groups, groups ending inside
#            an item tile, and B5's and B8's 4-byte copies (d % 4 != 0, and
#            misaligned views at d % 4 == 0) included; the pool kernel's
#            ptxas registers and spills and its resident blocks an SM;
#            given one pool, B7 is bit-exact on Gaussian data too, and on
#            tied pools with k past one 4,096-rank window and past the pool;
#            the flagship block's merged distances agree with the plain
#            route within KNN_DIST_RTOL, and the count equals the merged
#            lists on every unflagged row; timings as above, B5 also at the
#            mesh's shard shape and at m = 32 (library_ms: matmul + a
#            per-group topk, topk over the pool, matmul + a compare-sum);
#            B7's route at each launch shape, its radix kernel bit for bit
#            on a wide tied pool at each (CTAs a row, threads a CTA) the
#            route can pick, its ptxas registers and spills, resident
#            clusters, and the windowed kernel (the first design) timed
#            beside it
#   path_knn the JAX package's kNN arm: NearestNeighbors(k=200).fit on
#            400,000 x 3000 float32 items (standard normal, seed 0, 8
#            partitions), kneighbors of 16,384 queries (seed 7, 2
#            partitions) twice (staging + search, then the cached call), one
#            profiled call, 1,024 sampled queries against float64 brute force
#            on the card, exactNearestNeighborsJoin of 1,000 queries
#   knn_audit
#            one 8,192-query block through the audit route (B6 + B7 + B8):
#            every row the count check fails is flagged too, and the results
#            equal the main path's
#   knn_streamed
#            the same items under an item budget of KNN_STREAM_BUDGET bytes:
#            kneighbors of 2,048 queries streams them through in 3 blocks;
#            the device never holds two blocks (peak memory of the call under
#            two blocks' bytes), and the results pass the float64 check
#   kernels_exchange
#            the ring shift (B11) against its plain version on 4 shards of
#            the card, bit for bit: the ring hop's blocks (2,048 x 3000 f32
#            queries, 2,048 x 200 f32 and i32 candidates) at shifts 1, -1, 3,
#            misaligned blocks, two gateway cycles, the typed rejections;
#            device times from a trace (library_ms: torch.roll of the
#            stacked blocks).  kernels_exchange_peer runs the same cases over
#            cuda:0 .. n-1 through peer pointers, or says it was skipped on a
#            host with one card
#   path_knn_mesh
#            path_knn's arm on a 4-shard mesh of the card
#            (use_device(["cuda:0"] * 4), NearestNeighbors(k=200,
#            num_workers=4)): fit, kneighbors twice, one profiled call, B5
#            once per shard per block and B7 once per block, the float64
#            check, ids equal to path_knn's off near-ties
#   knn_ring one 8,192-query block through the exact exchange on that mesh,
#            ring and gather (equal bit for bit; 12 B11 launches on the ring,
#            none on the gather; the section bytes of the per-hop model), and
#            through the one-shard exchange (distances within 1e-6, ids equal
#            off near-ties); a ragged 37-row block, padded onto the ring (12
#            B11 launches), against the block's rows; one profiled ring call
#            gives B11's share
#   kernels_ann
#            B7 at the ANN arms' pool (414 query rows x 158 lists x 2048
#            slots, ~69% -inf) at k = 200 / 800 / 1600: bit for bit against
#            its plain version on tied integer values, through its route and
#            the windowed kernel, and timed on continuous values beside
#            torch.topk; the IVF-PQ lookup-table kernels against their plain
#            versions, bit for bit: B9 (one-byte codes; the contiguous form
#            and lut_accumulate_probed, which reads the probed lists in
#            place) and B10 (fast-scan) at the JAX package's test shapes,
#            ragged R, ksub < 256 / < 16 with codes past it, tables staged in
#            parts, misaligned codes, 65,537 queries, ragged counts and slots
#            outside the plane; lut_accumulate_probed at the 8-bit arm's
#            launch (150 queries x 158 lists of 2048 rows, m_sub 32), resident
#            and through a tier's pool planes, timed there (library_ms:
#            index_select + gather + sum over j) with its blocks a query and
#            the blocks an SM holds; fastscan_lut_accumulate_probed the same
#            way at the 4-bit arm's launch (237 queries x 158 lists of 2048
#            rows, 16 packed bytes a row; library_ms: index_select + unpack +
#            gather + sum) and B10's contiguous form at 237 x 323,584 rows;
#            their ptxas registers; B10's typed rejections on both entries; B1 at the ANN fit's shapes (400,000 x 256 vs 632
#            centroids, 400,000 x 8 vs 256 codewords)
#   path_ann / path_ann_pq / path_ann_pq4
#            the JAX package's ANN arms (bench.py:379-442): 400,000 x 256
#            clustered float32 items (8 partitions), 16,384 queries (their
#            first rows, 2 partitions), k = 200, nlist 632, nprobe 158;
#            IVF-Flat, IVF-PQ (M 32, 8 bits, refine_ratio 4) and IVF-PQ
#            fast-scan (M 32, 4 bits, opq, refine_ratio 8): fit, kneighbors
#            twice (staging, then the cached call), one profiled call;
#            B1 in every fit, B7 in every search, B9 (lut_accumulate_probed)
#            only in the 8-bit and B10 only in the 4-bit search; then, on 2,048 queries, recall@10
#            and @200 against exactSearch=True (gates 0.95 flat, 0.9
#            refined PQ), the ADC-only recall of the PQ arms, save -> load
#            identical, B7 against lex_topk on one probed block, and (4-bit)
#            hot_fraction 0.5 bitwise the resident search
#   path_pca the reference benchmark's PCA (k = 3) on 1,000,000 x 3000
#            float32 low-rank rows (rank 32 plus 0.1 noise, bench.py's):
#            fit -> transform -> save -> load -> transform (identical), the
#            fitted mean, components (signs equal), variance ratio and
#            singular values against the float64 covariance and float64 eigh
#            of the same rows on the card (PCA_* gates), projections against
#            float64, TF32 off (the settings and an X^T X probe against
#            float64), stage times (ingest, moments, covariance, float64
#            eigh), a profiled fit
#   path_linreg
#            LinearRegression OLS, ridge (regParam 1e-5) and elastic net
#            (regParam 1e-5, elasticNetParam 0.5, maxIter 10) from one frame
#            of 1,000,000 x 3000 Gaussian rows, y = X . coef + 0.1 noise:
#            each fit -> transform -> save -> load -> transform (identical)
#            and held-out R^2 > 0.99 (100,000 rows); OLS and ridge against a
#            float64 solve of the float64 normal equations (LINREG_RTOL) and
#            the port's solve on the float64 statistics against it
#            (LINREG_F64_RTOL); elastic net against the port's CD on the CPU
#            from the card's statistics (ENET_RTOL, sweeps equal); one CD
#            sweep eager and as its CUDA graph's replay; a profiled ridge fit
#   path_logreg
#            binary LogisticRegression(regParam 1e-5, maxIter 200) on the
#            same rows, y > 0: fit -> transform -> save -> load -> transform
#            (identical), held-out accuracy > 0.9, L-BFGS iterations,
#            evaluations and convergence, one objective evaluation (X read
#            twice) against its bound, a profiled fit
#   path_logreg_sparse
#            multinomial LogisticRegression(regParam 1e-5, maxIter 100, tol
#            1e-6) on 4,000,000 x 100 CSR rows (one nonzero a row, 4 classes;
#            bench.py's sparse arm): two fits bit for bit, peak device memory
#            under the dense features' 1.6 GB, accuracy above the majority
#            share, transform, one evaluation timed, a profiled fit
#   glm_card_vs_cpu
#            PCA, the three linear fits and four logistic fits (binary and 4
#            classes, dense and CSR) at 65,536 x 256 on the card and under
#            use_device("cpu"), within the CVC_* tolerances
# Every path runs with all kernel launch counters reset just before it and
# read just after (the PCA and GLM paths run no kernel of the port's own:
# their launches stay 0).  It ends with the card's nvidia-smi line, a
# {"kernels": [...]} summary line and {"ok": true, "device": {...}}.
# `--phases a,b` runs a subset (the summary then lists only what ran;
# knn_audit, knn_streamed and path_knn_mesh need path_knn, knn_ring needs
# path_knn_mesh; the ANN, PCA and GLM phases need nothing else).
#
# Imports neither jax, nor pandas, nor the JAX package.
#

import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import types
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
# B1's 4-byte-copy instantiation at large n: the flagship's per-partition
# shape with X one element past a 16-byte boundary, and d % 4 != 0
SHAPES_UNALIGNED = [(ROWS // PARTITIONS, COLS, K, True), (131072, 515, K, False)]
# H100 SXM peaks (NVIDIA data sheet, 700 W): fp32 on the CUDA cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12  # dense, on the tensor cores
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


def b1_input(torch, X, dev, misaligned):
    """X on the card; misaligned: its first element one float past a
    16-byte boundary (a view into a buffer one element longer), so every
    row start is misaligned at any d."""
    if not misaligned:
        return X.to(dev)
    buf = torch.empty(X.numel() + 1, dtype=X.dtype, device=dev)
    buf[1:].copy_(X.reshape(-1))
    return buf[1:].view(X.shape)


def check_kernel_shape(torch, nc, n, d, k, gen, dev, misaligned=False):
    """One shape: exact and continuous-data agreement, then timings."""
    # exact: values on a 1/4 grid keep every product and partial sum exact
    # in fp32, so any summation order gives the same d2, and a duplicated
    # center makes exact ties that must resolve to the lower index
    X = b1_input(torch, (torch.randn(n, d, generator=gen) * 4).round().div(4), dev, misaligned)
    C = (torch.randn(k, d, generator=gen) * 4).round().div(4).to(dev)
    if k > 1:
        C[k - 1] = C[0]
    copy = nc.copy_bytes(X, C)
    check((copy == 4) == (misaligned or d % 4 != 0), f"({n},{d},{k}) takes {copy}-byte copies")
    m, a = nc.min_dist_argmin(X, C)
    pm, pa = nc.min_dist_argmin_plain(X, C)
    torch.cuda.synchronize()
    exact_mismatch = int((a != pa).sum())
    exact_err = float((m - pm).abs().max())
    check(exact_mismatch == 0 and exact_err == 0.0,
          f"({n},{d},{k}) exact data: {exact_mismatch} argmin mismatches, max err {exact_err}")
    # continuous: standard normal
    X = b1_input(torch, torch.randn(n, d, generator=gen), dev, misaligned)
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
        "n": n, "d": d, "k": k, "misaligned": misaligned, "copy_bytes": copy,
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
RF_FEATURES = 54                        # sqrt(3000): the classifier's feature subset
RF_F_PAD = 64                           # ... padded to 32s
# float stats (regression w*y): the kernel and the plain version add the
# same bf16-rounded terms in fp32, in other orders
HIST_FLOAT_RTOL, HIST_FLOAT_ATOL = 1e-4, 1e-3
# B3's index_add_ yardstick builds one index of every term up to this many
# (feature, row, tree, stat) terms, else one per chunk of rows of this many
HIST_LIBRARY_FULL = 1 << 30
# B3's shapes: the regressor's feature subset (onethird of 3000 = 1000,
# padded to 32s), the paths' (F_pad, parameters), the timing repeats, and
# ragged shapes (rows not a multiple of 16, bins not of 16, odd n-tiles,
# features not filling a block)
RF_F_PAD_REG = 1024
RF_HIST_PATHS = {"clf": (RF_F_PAD, RF_CLF), "reg": (RF_F_PAD_REG, RF_REG)}
HIST_REPS = {"clf": 5, "reg": 3}
HIST_RAGGED = [(7, 3001, 3, 4, 2, 16), (5, 1000, 2, 3, 2, 100), (3, 77, 1, 1, 1, 7), (64, 40960, 5, 1, 2, 128)]


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


def hist_case(torch, dev, gen, f_pad, n, t_pack, nodes, s_dim, n_bins, integer, stray=False, features=None):
    """Random inputs at one histogram shape: bins in [0, n_bins), node ids in
    [0, nodes] (== nodes is masked), stats Poisson(1) counts x one-hot
    classes (integer) or uniform [0, 1) (float); stray: 5% of the node ids
    1 << 18 (the deep phase's pad rows) and 2% of the bins -1; features:
    the bin rows past it 0, as the fit's zero-padded feature subsets."""
    bins = torch.randint(0, n_bins, (f_pad, n), generator=gen, device=dev, dtype=torch.int8)
    if features is not None:
        bins[features:] = 0
    node = torch.randint(0, nodes + 1, (t_pack, n), generator=gen, device=dev, dtype=torch.int32)
    if stray:
        node[torch.rand((t_pack, n), generator=gen, device=dev) < 0.05] = 1 << 18
        bins[torch.rand((f_pad, n), generator=gen, device=dev) < 0.02] = -1
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


def hist_flat_index(torch, dev, bins, node, stats, rows, nodes, s_dim, n_bins, f_pad, out_shape, bucketed, sl):
    """The index_add_ yardstick's (flat output index, bf16-rounded value) of
    every non-zero term of the rows in `sl`."""
    n = bins.shape[1]
    feat = torch.arange(f_pad, device=dev)[:, None]
    b = bins[:, sl].long()
    width = b.shape[1]
    if bucketed:
        bucket = (torch.arange(n, device=dev) // (n // out_shape[0]))[sl]
    idx_parts, val_parts = [], []
    for t in range(rows):
        c = node[t, sl].long()
        ok = (c >= 0) & (c < nodes)
        for s in range(s_dim):
            slot = (t * nodes + c.clamp(0, nodes - 1)) * s_dim + s
            if bucketed:
                flat = ((bucket[None, :] * f_pad + feat) * out_shape[2] + slot[None, :]) * n_bins + b
            else:
                flat = (feat * 128 + slot[None, :]) * n_bins + b
            v = stats[t * s_dim + s, sl].to(torch.bfloat16).float()
            keep = (ok & (v != 0))[None, :] & (b >= 0) & (b < n_bins)
            idx_parts.append(flat[keep])
            val_parts.append(v[None, :].expand(f_pad, width)[keep])
    return torch.cat(idx_parts), torch.cat(val_parts)


def poison(torch, shape, dev):
    """Leave a freed block of NaNs of `shape` in the caching allocator, so a
    torch.empty of that shape that follows likely gets it: a kernel that
    skips a cell of its output then shows."""
    t = torch.full(shape, float("nan"), device=dev)
    del t


def rows_first_geometry(fh):
    """The atomic kernel's geometry with rows cut before features, for
    comparison with ops/forest_hist._atomic_geometry: as many features a
    block as fit its shared memory, the rows split across blocks until the
    card is full."""
    def geometry(f_pad, n_buckets, seg_len, slots, n_bins):
        fb = max(1, min(f_pad, fh.ATOMIC_SMEM_BUDGET // (4 * slots * n_bins)))
        per_split = -(-f_pad // fb) * n_buckets
        splits = max(1, min(-(-fh.ATOMIC_TARGET_BLOCKS // per_split), -(-seg_len // fh.ATOMIC_MIN_ROWS)))
        rows = -(-seg_len // (4 * splits)) * 4
        return fb, -(-seg_len // rows), rows
    return geometry


def check_hist_bucketed(torch, fh, dev, gen, f_pad, n, n_buckets, nodes, s_dim, n_bins, reps, compare=False,
                        features=None):
    """B4 (node_histograms_bucketed) at one shape, on a poisoned output
    block: exact on integer stats, through fp32 cells and through the int32
    cells of a caller that declares them integers, HIST_FLOAT_* on float
    stats; timings on the integer inputs, declared (the classifier's main
    path) and not (compare: also under rows_first_geometry, checked
    equal)."""
    name = "node_histograms_bucketed"

    def kernel(b, c, s, integer_stats=False):
        return fh.node_histograms_bucketed(b, c, s, n_buckets, nodes, s_dim, n_bins, integer_stats=integer_stats)

    plain = lambda b, c, s: fh.node_histograms_bucketed_plain(b, c, s, n_buckets, nodes, s_dim, n_bins)  # noqa: E731
    fb, splits, rows = fh._atomic_geometry(f_pad, n_buckets, n // n_buckets, nodes * s_dim, n_bins)
    out_shape = (n_buckets, f_pad, fh.slots_pad_of(nodes, s_dim), n_bins)
    errs = {}
    for integer in (False, True):
        bins, node, stats = hist_case(torch, dev, gen, f_pad, n, 1, nodes, s_dim, n_bins, integer, stray=True,
                                      features=features)
        want = plain(bins, node, stats)
        for declared in (False, True) if integer else (False,):
            poison(torch, out_shape, dev)
            got = kernel(bins, node, stats, integer_stats=declared)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if integer:
                check(err == 0.0, f"{name} integer stats (declared: {declared}): max abs err {err}")
            else:
                check(bool(torch.allclose(got, want, rtol=HIST_FLOAT_RTOL, atol=HIST_FLOAT_ATOL)),
                      f"{name} float stats: max abs err {err}")
            errs["integer" if integer else "float"] = err
            del got
        del want
    # the library yardstick: index_add_ of the bf16-rounded stats over the
    # flat output index, built beforehand
    numel = math.prod(out_shape)
    idx, vals = hist_flat_index(torch, dev, bins, node, stats, 1, nodes, s_dim, n_bins, f_pad, out_shape, True,
                                slice(0, n))
    lib = lambda: torch.zeros(numel, device=dev).index_add_(0, idx, vals)  # noqa: E731
    check(bool((lib().reshape(out_shape) == kernel(bins, node, stats)).all()), f"{name} disagrees with index_add_")
    row = timings(torch, lambda: kernel(bins, node, stats, integer_stats=True), lambda: plain(bins, node, stats),
                  lib, reps)
    row["fp32_cells_kernel_ms"] = median_ms(torch, lambda: kernel(bins, node, stats), reps)
    if compare:
        real = fh._atomic_geometry
        fh._atomic_geometry = rows_first_geometry(fh)
        try:
            row["rows_first_geometry"] = fh._atomic_geometry(f_pad, n_buckets, n // n_buckets, nodes * s_dim, n_bins)
            check(bool(torch.equal(kernel(bins, node, stats, integer_stats=True), lib().reshape(out_shape))),
                  f"{name} under the rows-first geometry differs")
            row["rows_first_kernel_ms"] = median_ms(torch, lambda: kernel(bins, node, stats, integer_stats=True),
                                                    reps)
        finally:
            fh._atomic_geometry = real
    b, by = bound(bins.numel() + 4 * node.numel() + 4 * stats.numel() + 4 * numel,
                  hist_terms(torch, node, stats, 1, nodes, s_dim, f_pad))
    del bins, node, stats, lib, idx, vals
    torch.cuda.empty_cache()
    return {"kernel": name, "f_pad": f_pad, "n": n, "t_pack_or_buckets": n_buckets, "nodes": nodes,
            "s_dim": s_dim, "n_bins": n_bins, "features": features, "fb": fb, "splits": splits, "rows_per_block": rows,
            "owner_flush": splits == 1, "max_abs_err": errs["float"], "max_abs_err_integer": errs["integer"],
            **row, "bound_ms": b, "bound_by": by}


def check_forest_kernels(torch, port, binning, fh, _build, X_host, dev):
    """Phase kernels_forest: B2, B3 (both routes) and B4 against their plain
    versions on the card, at the shapes the RandomForest path gives them."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {"phase": "kernels_forest", "hist_float_rtol": HIST_FLOAT_RTOL, "hist_float_atol": HIST_FLOAT_ATOL}
    # B2 at the path's shape: the classifier's rows and its 127 edges
    X = torch.from_numpy(X_host[:RF_ROWS]).to(dev)
    step = -(-RF_ROWS // 2796)
    edges = torch.from_numpy(port.ops.forest.compute_bin_edges(X_host[:RF_ROWS:step], 128)).to(dev)
    binning_rows = [check_binning(torch, binning, X, edges, RF_N_PAD, reps=5)]
    del X
    torch.cuda.empty_cache()
    # ragged, degenerate, NaN / +-inf / values equal to an edge, trailing
    # NaN edges, an n_pad that is not a multiple of 4 (byte stores), and
    # unaligned rows with a ragged strip (d 3001) at 100,000 rows
    for n, d, e, n_pad, nan_edges in ((300, 70, 31, 2048, False), (129, 1, 1, 2048, False),
                                      (2000, 5, 127, 2048, False), (2000, 9, 127, 2048, True),
                                      (301, 40, 31, 303, False), (100_000, 3001, 127, 100_352, False)):
        Xs = torch.randn((n, d), generator=gen, device=dev)
        es = torch.sort(torch.randn((d, e), generator=gen, device=dev), dim=1).values
        if e == 127 and n <= 2000:
            Xs[0], Xs[1], Xs[2] = float("nan"), float("inf"), float("-inf")
            Xs[3], Xs[4] = es[:, 0], es[:, -1]
            es[0, 60:70] = es[0, 60]  # repeated edges
        if nan_edges:  # features with 1, 27, 126 and all 127 edges NaN at the end
            for f, k in ((1, 1), (2, 27), (3, 127), (4, 126)):
                es[f, e - k:] = float("nan")
            Xs[5, :] = es[:, 0]
        row = check_binning(torch, binning, Xs, es.contiguous(), n_pad, reps=5, library=n > 2000)
        binning_rows.append({**row, "nan_edges": nan_edges})
        del Xs, es
    torch.cuda.empty_cache()
    out["bin_features_fm"] = binning_rows
    out["bin_build"] = ptxas_record(_build, "bin_features_fm", ("bin_features_fm_kernel",))
    # B3, both routes, at ragged shapes and at the first launch of every
    # shallow split level of the two flagship fits
    out["node_histograms_ragged"] = [check_hist_routes(torch, fh, dev, gen, None, None, *shape, reps=0)
                                     for shape in HIST_RAGGED]
    levels = []
    for path, (f_pad, params) in RF_HIST_PATHS.items():
        launches = port.ops.forest_grow.shallow_launches(params["numTrees"], 2, params["maxDepth"])
        for level in sorted({lv for lv, _, _ in launches}):
            nodes, t_pack = next((nd, tp) for lv, nd, tp in launches if lv == level)
            timed = path == "clf" or level == 0
            row = check_hist_routes(torch, fh, dev, gen, path, level, f_pad, RF_N_PAD, t_pack, nodes, 2, 128,
                                    reps=HIST_REPS[path], library=timed, plain_timed=timed)
            row["launches_at_level"] = sum(1 for lv, _, _ in launches if lv == level)
            levels.append(row)
            emit({"phase": "kernels_forest_level", **row})
    out["node_histograms_levels"] = levels
    # B4 at one deep window (128 buckets of 8192 rows at level 12: 32 local
    # nodes; each block owns its output slice), where the buckets are too
    # few to fill the card (2 buckets of 16,384 rows: rows split across
    # blocks, atomic flush) with 5 x 3 slots padded to 16, at the same
    # window's level 7 (1 local node), and at level 12 with the fit's 54
    # features and 10 zero-padded bin rows
    out["node_histograms_bucketed"] = [
        check_hist_bucketed(torch, fh, dev, gen, RF_F_PAD, 128 * 8192, 128, 32, 2, 128, reps=10),
        check_hist_bucketed(torch, fh, dev, gen, RF_F_PAD, 2 * 16384, 2, 5, 3, 128, reps=10),
        check_hist_bucketed(torch, fh, dev, gen, RF_F_PAD, 128 * 8192, 128, 1, 2, 128, reps=10, compare=True),
        check_hist_bucketed(torch, fh, dev, gen, RF_F_PAD, 128 * 8192, 128, 32, 2, 128, reps=10,
                            features=RF_FEATURES),
    ]
    check(out["node_histograms_bucketed"][0]["owner_flush"] and not out["node_histograms_bucketed"][1]["owner_flush"],
          "the B4 cases miss one of the two flushes")
    return out


def check_hist_routes(torch, fh, dev, gen, path, level, f_pad, n, t_pack, nodes, s_dim, n_bins, reps,
                      library=False, plain_timed=False):
    """B3 at one shape through both routes: each equal to the plain version
    bit for bit on integer stats and within HIST_FLOAT_* on float stats, the
    tensor-core route bit for bit across two calls on float stats, the
    atomic route also through the int32 cells of declared integer stats;
    timings of both routes (reps > 0; the atomic one declared and not), of
    the plain version and of the index_add_ yardstick (where asked), on the
    integer inputs."""
    routes = {"mma": fh.node_histograms_mma, "atomic": fh.node_histograms_atomic}
    args = (t_pack, nodes, s_dim, n_bins)
    row = {"path": path, "level": level, "f_pad": f_pad, "n": n, "t_pack": t_pack, "nodes": nodes,
           "s_dim": s_dim, "n_bins": n_bins,
           # the classifier declares its stats integers, the regressor's are not
           "route": fh._hist_route(*args, integer_stats=path == "clf")}
    for integer in (False, True):
        bins, node, stats = hist_case(torch, dev, gen, f_pad, n, t_pack, nodes, s_dim, n_bins, integer)
        want = fh.node_histograms_plain(bins, node, stats, *args)
        for name, fn in routes.items():
            poison(torch, want.shape, dev)
            got = fn(bins, node, stats, *args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            where = f"node_histograms_{name} {[f_pad, n, *args]}"
            if integer:
                check(err == 0.0, f"{where} integer stats: max abs err {err}")
                row[f"max_abs_err_integer_{name}"] = err
            else:
                check(bool(torch.allclose(got, want, rtol=HIST_FLOAT_RTOL, atol=HIST_FLOAT_ATOL)),
                      f"{where} float stats: max abs err {err}")
                row[f"max_abs_err_{name}"] = err
                if name == "mma":
                    again = fn(bins, node, stats, *args)
                    check(bool(torch.equal(got, again)), f"{where}: two calls on float stats differ")
                    row["mma_repeat_bitwise"] = True
                    del again
            del got
        if integer:
            poison(torch, want.shape, dev)
            got = fh.node_histograms_atomic(bins, node, stats, *args, integer_stats=True)
            err = float((got - want).abs().max())
            check(err == 0.0, f"node_histograms_atomic {[f_pad, n, *args]} declared integer stats: max abs err {err}")
            row["max_abs_err_integer_atomic_declared"] = err
            del got
        del want
    if reps:
        for name, fn in routes.items():
            row[f"{name}_ms"] = median_ms(torch, lambda: fn(bins, node, stats, *args), reps)  # noqa: B023
        row["atomic_int_ms"] = median_ms(
            torch, lambda: fh.node_histograms_atomic(bins, node, stats, *args, integer_stats=True), reps)
        row["plain_ms"] = (median_ms(torch, lambda: fh.node_histograms_plain(bins, node, stats, *args), 1)
                           if plain_timed else None)
        row["library_ms"] = hist_library_ms(torch, fh, dev, bins, node, stats, *args) if library else None
        out_bytes = 4 * f_pad * fh.M_SLOTS * n_bins
        row["bound_ms"], row["bound_by"] = bound(
            bins.numel() + 4 * node.numel() + 4 * stats.numel() + out_bytes,
            hist_terms(torch, node, stats, t_pack, nodes, s_dim, f_pad))
        # the tensor-core route's multiply-adds at the dense bf16 peak
        macs = f_pad * n * (-(-(t_pack * nodes * s_dim) // 16) * 16) * (-(-n_bins // 16) * 16)
        row["mma_peak_ms"] = 1e3 * 2 * macs / PEAK_BF16_FLOPS
    del bins, node, stats
    torch.cuda.empty_cache()
    return row


def hist_library_ms(torch, fh, dev, bins, node, stats, t_pack, nodes, s_dim, n_bins):
    """The index_add_ yardstick of B3: the bf16-rounded non-zero terms added
    over the flat output index, built beforehand; built and applied in row
    chunks where one index of every term would not fit the card, only the
    index_add_ calls timed.  Checked against the tensor-core route."""
    f_pad, n = bins.shape
    out_shape = (f_pad, 128, n_bins)
    numel = math.prod(out_shape)
    want = fh.node_histograms_mma(bins, node, stats, t_pack, nodes, s_dim, n_bins)
    if f_pad * n * t_pack * s_dim <= HIST_LIBRARY_FULL:
        idx, vals = hist_flat_index(torch, dev, bins, node, stats, t_pack, nodes, s_dim, n_bins, f_pad,
                                    out_shape, False, slice(0, n))
        lib = lambda: torch.zeros(numel, device=dev).index_add_(0, idx, vals)  # noqa: E731
        check(bool((lib().reshape(out_shape) == want).all()), "node_histograms disagrees with index_add_")
        return median_ms(torch, lib, 3)
    chunk = max(2048, HIST_LIBRARY_FULL // (f_pad * t_pack * s_dim))
    lib_ms, acc = [], torch.zeros(numel, device=dev)
    for _ in range(2):
        acc.zero_()
        total = 0.0
        for lo in range(0, n, chunk):
            idx, vals = hist_flat_index(torch, dev, bins, node, stats, t_pack, nodes, s_dim, n_bins, f_pad,
                                        out_shape, False, slice(lo, min(lo + chunk, n)))
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            acc.index_add_(0, idx, vals)
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
            del idx, vals
        lib_ms.append(total)
    check(bool(torch.equal(acc.reshape(out_shape), want)), "node_histograms disagrees with index_add_")
    return statistics.median(lib_ms)


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
    # B3's launches by route: as _hist_route sends the shallow phase's launches
    params = {k.name: v for k, v in est.extractParamMap().items()}
    shapes = port.ops.forest_grow.shallow_launches(params["numTrees"], 2, params["maxDepth"])
    routes = [port.ops.forest_hist._hist_route(tp, nodes, 2, params["maxBins"], integer_stats=classification)
              for _, nodes, tp in shapes]
    hist_expected = {f"node_histograms_{r}": routes.count(r) for r in ("mma", "atomic")}
    for name, want in hist_expected.items():
        check(launches_fit[name] == want, f"the fit launched {name} {launches_fit[name]} times, not {want}")
    check(launches_fit["node_histograms_mma"] > 0, "the fit launched the tensor-core route no time")
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
    with deep_launch_shapes(port) as deep:
        rec["profile"] = profile_run(torch, lambda: est.fit(df), PROFILE_RANGES, wrappers)
    if deep:
        rec["deep_launches"] = deep
    hold_pred = np.concatenate([p["prediction"] for p in model.transform(hold).partitions])
    y_hold = y[RF_ROWS:]
    check(np.isfinite(pred).all() and np.isfinite(hold_pred).all(), "non-finite predictions")
    if classification:
        acc = float((hold_pred == y_hold).mean())
        majority = float(max(y_hold.mean(), 1 - y_hold.mean()))
        for name in ("bin_features_fm", "node_histograms_bucketed"):
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
        "launches_fit": launches_fit, "launches": launches, "hist_launches_expected": hist_expected,
        "max_memory_allocated_bytes": peak_bytes, **rec,
    }


class deep_launch_shapes:
    """Within the block, the B4 launches of the deep phase by local node
    count: launches, rows, and launches whose rows the atomic kernel splits
    across blocks (ops/forest_hist._atomic_geometry), as a list of records
    (empty if the fit has no deep phase).  Every call goes on to the
    wrapper unchanged."""

    def __init__(self, port):
        self.grow, self.fh, self.rows = port.ops.forest_grow, port.ops.forest_hist, {}

    def __enter__(self):
        self.real = self.grow.node_histograms_bucketed

        def record(bins_sub, node_rel, stats_s, n_buckets, nodes, s_dim, n_bins, **kw):
            f_pad, n = bins_sub.shape
            splits = self.fh._atomic_geometry(f_pad, n_buckets, n // n_buckets, nodes * s_dim, n_bins)[1]
            r = self.rows.setdefault(nodes, {"nodes": nodes, "launches": 0, "rows": 0, "split_launches": 0})
            r["launches"] += 1
            r["rows"] += n
            r["split_launches"] += splits > 1
            return self.real(bins_sub, node_rel, stats_s, n_buckets=n_buckets, nodes=nodes, s_dim=s_dim,
                             n_bins=n_bins, **kw)

        self.grow.node_histograms_bucketed = record
        self.out = []
        return self.out

    def __exit__(self, *exc):
        self.grow.node_histograms_bucketed = self.real
        self.out.extend(self.rows[k] for k in sorted(self.rows))
        return False


PROFILE_RANGES = ("core.ingest", "forest.bin", "forest.shallow", "forest.deep_layout", "forest.deep")
# the port's kernels as the trace names them (all in anonymous namespaces)
PORT_KERNEL_SYMBOLS = ("min_dist_argmin_kernel", "min_dist_tile_kernel", "bin_features_fm_kernel", "hist_kernel",
                       "hist_mma_kernel", "knn_topm_tile_kernel", "knn_count_tile_kernel", "radix_merge_kernel",
                       "window_merge_kernel", "probed_lut_kernel", "fastscan_probed_kernel", "ring_shift_kernel")
# launched beside hist_mma_kernel by the same wrapper call (the masked-stat
# operand, the split sum): timed with the port's kernels, not counted
PORT_AUX_SYMBOLS = ("hist_mask_stats_kernel", "hist_split_sum_kernel")


def port_kernel(name):
    """The port's kernel symbol a trace event names, or None."""
    if "at::" in name:
        return None
    return next((s for s in PORT_KERNEL_SYMBOLS + PORT_AUX_SYMBOLS if f"(anonymous namespace)::{s}" in name), None)


def profile_run(torch, run, ranges, wrappers):
    """One more call of `run` under torch.profiler: the host milliseconds
    inside each of the port's `ranges`, the device's busy milliseconds (the
    union of the intervals of every kernel and copy on the card), the
    device's idle share of the call's wall time, and the device time of the
    kernels that took the most.  The trace is complete when it holds one
    event for each launch the port's wrappers counted during the call (a
    trace of the kNN path once lost one of two 0.7-s kernels, halving the
    busy time); the busy time and idle share of an incomplete trace are
    null, not measured.  The profiler slows the call; the path's own timings
    come from the calls before it."""
    before = sum(read_launches(wrappers).values())
    rec = profile_once(torch, run, ranges)
    rec["launches"] = sum(read_launches(wrappers).values()) - before
    rec["trace_complete"] = rec["traced_launches"] == rec["launches"]
    if not rec["trace_complete"]:
        rec["device_busy_ms"] = rec["device_idle_share"] = None
    return rec


def profile_once(torch, run, ranges):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)  # not the profiler's own start and stop
    events = prof.events()
    host = {k: 0.0 for k in ranges}
    spans, per_kernel, traced, port_ms, port_n = [], {}, 0, {}, {}
    for e in events:
        if e.device_type == DeviceType.CPU:
            if e.name in host:
                host[e.name] += (e.time_range.end - e.time_range.start) / 1e3
        elif e.name not in host and not e.name.startswith("Activity Buffer"):
            # a kernel or a copy on the card (not a range's device-side
            # annotation, nor the profiler's own buffer requests)
            spans.append((e.time_range.start, e.time_range.end))
            symbol = port_kernel(e.name)
            if symbol is not None:
                traced += symbol not in PORT_AUX_SYMBOLS
                port_ms[symbol] = port_ms.get(symbol, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
                port_n[symbol] = port_n.get(symbol, 0) + 1
            ms, count = per_kernel.get(e.name, (0.0, 0))
            per_kernel[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, count + 1)
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    top = sorted(per_kernel.items(), key=lambda kv: kv[1][0], reverse=True)[:10]
    return {
        "profiled_ms": wall_ms,
        "range_host_ms": host,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
        "top_device_ms": [[name[:90], ms, count] for name, (ms, count) in top],
        "port_kernel_ms": port_ms,
        "port_launches": port_n,
        "traced_launches": traced,
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


# ---------------------------------------------------------------------------
# Exact kNN: kernels B5-B8 and the JAX package's kNN arm
# ---------------------------------------------------------------------------

# The JAX package's kNN arm (bench.py:303-339, k from
# benchmark/bench_nearest_neighbors.py:21): 400,000 x 3000 float32 items,
# standard normal from seed 0; 16,384 queries from seed 7; k = 200; 8 item
# and 2 query partitions.  Not cut.
KNN_ITEMS, KNN_QUERIES, KNN_K = 400_000, 16_384, 200
KNN_ITEM_PARTS, KNN_QUERY_PARTS, KNN_ITEM_SEED, KNN_QUERY_SEED = 8, 2, 0, 7
KNN_BLOCK = 8192       # queries per block (knn_search_prepared's default)
KNN_SAMPLE = 1024      # queries held against float64 brute force
KNN_JOIN_QUERIES = 1000
# distances against float64 (fp32 sums of 3000 products; ~1e-7 relative
# expected); index sets may differ only in items within KNN_TIE_RTOL of the
# k-th distance
KNN_DIST_RTOL, KNN_TIE_RTOL = 1e-4, 1e-5
# ragged kernel shapes (n, d, Q, m, k, invalid trailing items, misaligned):
# n not a multiple of 1024 nor of the 128-item tile, d not a multiple of the
# 8-feature slice, Q not a multiple of the 128-query tile, k past the valid
# items or past the pool; a pool of 3,418 groups x 5 = 17,090 candidates a
# query, 65,537 groups, B5's and B8's 4-byte copies (d % 4 != 0) on 1,563 x
# 5 item and query tiles; the last three on misaligned views of the items
# and queries (each one float past a 16-byte boundary: 4-byte copies at
# d % 4 == 0) and at m = 32, groups ending 1, 129 and 1023 items in
KNN_RAGGED = [
    (2100, 300, 250, 5, 10, 30, False),
    (700, 37, 33, 32, 40, 0, False),
    (20, 5, 7, 32, 25, 0, False),
    (3000, 515, 384, 20, 33, 0, False),
    (1076, 37, 33, 32, 40, 36, False),
    (3_500_000, 32, 64, 5, 200, 0, False),
    (67_109_000, 3, 33, 2, 5, 0, False),
    (200_003, 515, 517, 9, 200, 3, False),
    (1025, 256, 300, 9, 50, 0, True),
    (9345, 3000, 130, 32, 200, 17, True),
    (50_175, 64, 1000, 32, 100, 0, True),
]
# B5 at the main path's other shapes, exact on integer data and timed on
# Gaussian data, (n, Q, m): one shard of path_knn_mesh, and the pool's
# widest m at the flagship's items
KNN_POOL_SHAPES = [(KNN_ITEMS // 4, KNN_BLOCK, 15), (KNN_ITEMS, KNN_BLOCK, 32)]
# B7 alone on wide tied pools: (Q, ng, m) and the k of each merge, one
# 4,096-rank window, several, all of the pool and past it
KNN_WIDE_POOL, KNN_WIDE_KS = (256, 4000, 5), (200, 9000, 20000, 25000)
# B7's routes forced on that pool at k = 200, (CTAs a row, threads a CTA):
# each the route picks for some pool width (the radix kernel on 1-16 CTAs
# a row), and the windowed kernel (0)
MERGE_CONFIGS = ((1, 256), (2, 512), (4, 512), (8, 512), (16, 512), (0, 256))
# knn_streamed: the item budget (bytes), so 400,000 x 3000 items make 3
# blocks, and its queries
KNN_STREAM_BUDGET, KNN_STREAM_QUERIES = 2_000_000_000, 2048
KNN_PROFILE_RANGES = ("knn.dispatch", "knn.collect", "knn.fallback")


def normal_data(rows, cols, seed, workers=8):
    """Standard normal float32 (rows, cols), filled by `workers` threads
    with independent streams spawned from `seed`."""
    X = np.empty((rows, cols), np.float32)
    streams = np.random.SeedSequence(seed).spawn(workers)
    bounds = np.linspace(0, rows, workers + 1, dtype=int)

    def fill(i):
        rng_i = np.random.default_rng(streams[i])
        for lo in range(bounds[i], bounds[i + 1], 16384):
            rng_i.standard_normal(out=X[lo : min(lo + 16384, bounds[i + 1])], dtype=np.float32)

    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(fill, range(workers)))
    return X


def knn_exact_case(torch, kk, nc, dev, gen, n, d, q, m, k, invalid, misaligned=False):
    """B5, B7 and B8 against their plain versions on integer-valued data
    (every sum exact in fp32): equal pools (values and positions, -inf
    slots included), equal merges, equal counts."""
    X = torch.randint(-3, 4, (n, d), generator=gen, device=dev).float()
    Q = torch.randint(-3, 4, (q, d), generator=gen, device=dev).float()
    X, Q = b1_input(torch, X, dev, misaligned), b1_input(torch, Q, dev, misaligned)
    copy = nc.copy_bytes(X, Q)
    check((copy == 4) == (misaligned or d % 4 != 0), f"kNN ({n},{d},{q}) takes {copy}-byte copies")
    norm = (X * X).sum(dim=1)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    if invalid:
        valid[n - invalid :] = False
    inorm, qn = kk._masked_norms(norm, valid), (Q * Q).sum(dim=1)
    v, p = kk.knn_candidates(X, norm, valid, Q, m)
    pv, pp = kk.knn_candidates_plain(X, inorm, Q, qn, m)
    out = kk.knn_fused_merge(v, p, k)
    ref = kk.knn_fused_merge_plain(v, p, k)
    cnt = kk.knn_count(X, norm, valid, Q, out[3])
    pcnt = kk.knn_count_plain(X, inorm, Q, qn, out[3])
    torch.cuda.synchronize()
    ng = v.shape[1]
    neg = ~torch.isfinite(v)
    first = (torch.arange(ng, device=dev, dtype=torch.int32) * kk.GROUP)[None, :, None].expand_as(p)
    rec = {
        "n": n, "d": d, "q": q, "m": m, "k": k, "invalid": invalid, "misaligned": misaligned,
        "pool_value_mismatches": int((v.view(torch.int32) != pv.view(torch.int32)).sum()),
        "pool_position_mismatches": int((p != pp).sum()),
        "neg_inf_slots": int(neg.sum()), "neg_inf_slots_off_group_start": int((p != first)[neg].sum()),
        "merge_mismatches": [int((a != b).sum()) for a, b in zip(out, ref)],
        "count_mismatches": int((cnt != pcnt).sum()), "count_max_abs_err": int((cnt - pcnt).abs().max()),
        "copy_bytes": copy,
        "invalid_in_pool": int(((p >= n - invalid) & torch.isfinite(v)).sum()) if invalid else 0,
    }
    check(rec["pool_value_mismatches"] == 0 and rec["pool_position_mismatches"] == 0,
          f"knn_candidates ({n},{d},{q},m={m}) integer data: pool differs from the plain version: {rec}")
    check(rec["neg_inf_slots_off_group_start"] == 0, f"a -inf slot holds another position than its group's first: {rec}")
    check(sum(rec["merge_mismatches"]) == 0, f"knn_fused_merge ({n},{d},{q},k={k}) differs: {rec}")
    check(rec["count_mismatches"] == 0, f"knn_count ({n},{d},{q}) differs: {rec}")
    check(rec["invalid_in_pool"] == 0, f"an invalid item entered the pool: {rec}")
    del X, Q
    return rec


def merge_mismatches(torch, out, ref):
    """Values differing between two merges' five outputs (dist and
    thresholds compared as bits)."""
    return [int((a.view(torch.int32) != b.view(torch.int32)).sum()) if a.dtype == torch.float32
            else int((a != b).sum()) for a, b in zip(out, ref)]


def knn_wide_merge(torch, kk, dev, gen):
    """B7 against its plain version on one wide pool of tied values (a
    quarter of each row's values -inf), at every k of KNN_WIDE_KS through
    the route the wrapper takes, and at k = 200 on each configuration of
    MERGE_CONFIGS: bit for bit."""
    q, ng, m = KNN_WIDE_POOL
    v = torch.randint(-40, 0, (q, ng, m), generator=gen, device=dev).float()
    v[torch.rand(q, ng, m, generator=gen, device=dev) < 0.25] = float("-inf")
    p = torch.randint(0, 2**31 - 1, (q, ng, m), generator=gen, device=dev, dtype=torch.int32)
    mismatches, routes = {}, {}
    for k in KNN_WIDE_KS:
        out, ref = kk.knn_fused_merge(v, p, k), kk.knn_fused_merge_plain(v, p, k)
        mismatches[k] = merge_mismatches(torch, out, ref)
        routes[k] = list(kk._merge_route(ng * m, k))
        check(sum(mismatches[k]) == 0, f"knn_fused_merge on a ({q}, {ng}, {m}) pool, k={k}, differs: {mismatches[k]}")
    ref = kk.knn_fused_merge_plain(v, p, KNN_K)
    by_config = {}
    for cluster, threads in MERGE_CONFIGS:
        name = f"{cluster}x{threads}"
        by_config[name] = merge_mismatches(torch, kk._merge_cuda(v, p, KNN_K, cluster, threads), ref)
        check(sum(by_config[name]) == 0, f"B7 on {cluster} CTAs a row of {threads} threads (0: windowed) differs: "
                                         f"{by_config[name]}")
    ms = median_ms(torch, lambda: kk.knn_fused_merge(v, p, KNN_K), 5)
    return {"q": q, "ng": ng, "m": m, "pool": ng * m, "ks": list(KNN_WIDE_KS), "mismatches": mismatches,
            "routes": routes, "k200_by_config": by_config, "kernel_ms_k200": ms}


def ptxas_record(_build, library, symbols):
    """ptxas registers and spills of each kernel of `library` whose mangled
    name holds one of `symbols`, from its build log, by mangled name."""
    out, current = {}, None
    for line in _build.build_log(library).splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if line.count("'") >= 2 else line
            current = name if any(sym in name for sym in symbols) else None
            if current:
                out[current] = {}
        elif current and "spill stores" in line:
            words = line.replace(",", "").split()
            out[current]["spill_store_bytes"] = int(words[words.index("spill") - 2])
            out[current]["spill_load_bytes"] = int(words[words.index("loads") - 3])
        elif current and "Used" in line and "registers" in line:
            words = line.replace(",", "").split()
            out[current]["registers"] = int(words[words.index("registers") - 1])
    check(all(any(sym in name for name in out) for sym in symbols), f"the {library} build log lacks a kernel: {out}")
    return out


def merge_occupancy(_build, p, k, cluster, threads):
    """Clusters of B7's radix kernel resident on the card at once, and its
    dynamic shared memory a CTA, for one launch shape."""
    import ctypes

    fn = _build.load("knn_merge").srml_knn_merge_occupancy
    fn.argtypes = [ctypes.c_longlong] * 4 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    clusters, smem = ctypes.c_int(0), ctypes.c_int(0)
    err = fn(p, k, cluster, threads, ctypes.byref(clusters), ctypes.byref(smem))
    check(err == 0 and clusters.value >= 1, f"B7 radix kernel (p={p}, k={k}, cluster={cluster}, threads={threads}): "
                                            f"error {err}, {clusters.value} clusters")
    return {"p": p, "k": k, "cluster": cluster, "threads": threads, "resident_clusters": clusters.value,
            "dynamic_smem_bytes": smem.value}


def merge_routes(kk, m):
    """B7's route (CTAs a row of the radix kernel, 0 = windowed) at each
    launch shape of the main path and of the checks."""
    shapes = {"flagship": (-(-KNN_ITEMS // kk.GROUP), m, KNN_K),
              "mesh": (MESH_SHARDS * -(-KNN_ITEMS // MESH_SHARDS // kk.GROUP), 15, KNN_K),
              **{f"ann_k{k}": (ANN_NPROBE, ANN_L_PAD, k) for k in ANN_MERGE_KS},
              **{f"wide_k{k}": (KNN_WIDE_POOL[1], KNN_WIDE_POOL[2], k) for k in KNN_WIDE_KS}}
    return {name: {"pool": ng * mm, "k": k, "route": list(kk._merge_route(ng * mm, k))}
            for name, (ng, mm, k) in shapes.items()}


def pool_library(torch, kk, X, Q, inorm, qn, m):
    """The pool as one PyTorch composition: matmul + a per-group topk."""
    q_n, n = Q.shape[0], X.shape[0]
    ng = -(-n // kk.GROUP)
    neg = -((qn[:, None] - 2.0 * (Q @ X.T)) + inorm[None, :])
    neg = torch.nn.functional.pad(neg, (0, ng * kk.GROUP - n), value=float("-inf"))
    return torch.topk(neg.view(q_n, ng, kk.GROUP), m, dim=2)


def merge_bound(q_n, p, k):
    """B7's least time: the bytes the function needs.  Each pool value read
    once (4 bytes a slot), the positions of the k kept only (4 bytes each),
    k distances and positions and three scalars a row written."""
    return bound(4.0 * q_n * p + 4.0 * q_n * k + 8.0 * q_n * k + 12.0 * q_n, float(q_n * p))


def pool_bound(q_n, n, d, m):
    """B5's least time: 2 * Q * n * d fp32 operations against its inputs
    read once and its (Q, ng, m) values and positions written once."""
    ng = -(-n // 1024)
    return bound(4.0 * (q_n * d + n * d + q_n + n) + 8.0 * q_n * ng * m, 2.0 * q_n * n * d)


def time_pool(torch, kk, dev, gen, n, q_n, m):
    """B5 at (Q, n, d = COLS, m) on Gaussian data: kernel, plain and library
    times and the bound."""
    X = torch.randn(n, COLS, generator=gen, device=dev)
    Q = torch.randn(q_n, COLS, generator=gen, device=dev)
    norm = (X * X).sum(dim=1)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    inorm, qn = kk._masked_norms(norm, valid), (Q * Q).sum(dim=1)
    row = timings(torch, lambda: kk.knn_candidates(X, norm, valid, Q, m),
                  lambda: kk.knn_candidates_plain(X, inorm, Q, qn, m),
                  lambda: pool_library(torch, kk, X, Q, inorm, qn, m), 3)
    row["bound_ms"], row["bound_by"] = pool_bound(q_n, n, COLS, m)
    del X, Q
    torch.cuda.empty_cache()
    return {"n": n, "d": COLS, "q": q_n, "m": m, **row}


def pool_build_record(_build):
    """ptxas registers and spills of the pool kernel's two copy widths
    (VEC 4: 16-byte copies, VEC 1: 4-byte), from its build log."""
    out, current = {}, None
    for line in _build.build_log("knn_topm").splitlines():
        if "Compiling entry function" in line:
            current = None
            if "knn_topm_tile_kernel" in line:
                current = "copy_16_bytes" if "ILi4E" in line else "copy_4_bytes"
                out[current] = {}
        elif current and "spill stores" in line:
            words = line.replace(",", "").split()
            out[current]["spill_store_bytes"] = int(words[words.index("spill") - 2])
            out[current]["spill_load_bytes"] = int(words[words.index("loads") - 3])
        elif current and "Used" in line and "registers" in line:
            words = line.replace(",", "").split()
            out[current]["registers"] = int(words[words.index("registers") - 1])
    check(set(out) == {"copy_16_bytes", "copy_4_bytes"}, f"the build log lacks a pool kernel: {out}")
    return out


def pool_occupancy(_build, kk):
    """Resident pool blocks an SM and their dynamic shared memory, at every
    m the checks use, for both copy widths."""
    import ctypes

    fn = _build.load("knn_topm").srml_knn_topm_occupancy
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rows = []
    for m in (1, 5, 9, 15, 20, 32):
        for vec in (4, 1):
            blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
            err = fn(m, vec, ctypes.byref(blocks), ctypes.byref(smem))
            check(err == 0 and blocks.value >= 1, f"pool kernel m={m} vec={vec}: error {err}, {blocks.value} blocks")
            rows.append({"m": m, "copy_bytes": 4 * vec, "blocks_per_sm": blocks.value,
                         "dynamic_smem_bytes": smem.value})
    return rows


def check_knn_kernels(torch, kk, nc, knn_ops, _build, dev):
    """Phase kernels_knn: B5-B8 against their plain versions at ragged shapes
    (one with a pool wider than 16,384, misaligned views, m = 32), B7 on
    wide tied pools, B5 at the mesh's shard shape and at m = 32, and all at
    one flagship block, with timings at the flagship block."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    m = knn_ops._scan_geometry(KNN_K, KNN_ITEMS)[1]
    build = pool_build_record(_build)
    occupancy = pool_occupancy(_build, kk)
    routes = merge_routes(kk, m)
    merge_build = ptxas_record(_build, "knn_merge", ("radix_merge_kernel", "window_merge_kernel"))
    merge_occ = [merge_occupancy(_build, r["pool"], r["k"], *r["route"]) for r in routes.values() if r["route"][0]]
    ragged = [knn_exact_case(torch, kk, nc, dev, gen, *shape) for shape in KNN_RAGGED]
    check(any(r["copy_bytes"] == 4 and r["misaligned"] and r["d"] % 4 == 0 for r in ragged)
          and any(r["copy_bytes"] == 4 and r["d"] % 4 for r in ragged)
          and any(r["copy_bytes"] == 16 for r in ragged),
          "the ragged cases miss one of B5's and B8's copy widths")
    torch.cuda.empty_cache()
    pool_shapes = []
    for n, q_n, pm in KNN_POOL_SHAPES:
        exact = knn_exact_case(torch, kk, nc, dev, gen, n, COLS, q_n, pm, KNN_K, 0)
        torch.cuda.empty_cache()
        pool_shapes.append({**time_pool(torch, kk, dev, gen, n, q_n, pm), "integer": exact})
        emit({"phase": "kernels_knn_pool", **pool_shapes[-1]})
    wide_merge = knn_wide_merge(torch, kk, dev, gen)
    flagship_int = knn_exact_case(torch, kk, nc, dev, gen, KNN_ITEMS, COLS, KNN_BLOCK, m, KNN_K, 0)
    torch.cuda.empty_cache()

    X = torch.randn(KNN_ITEMS, COLS, generator=gen, device=dev)
    Q = torch.randn(KNN_BLOCK, COLS, generator=gen, device=dev)
    norm = (X * X).sum(dim=1)
    valid = torch.ones(KNN_ITEMS, dtype=torch.bool, device=dev)
    inorm, qn = kk._masked_norms(norm, valid), (Q * Q).sum(dim=1)
    v, p = kk.knn_candidates(X, norm, valid, Q, m)
    pv, pp = kk.knn_candidates_plain(X, inorm, Q, qn, m)
    out = kk.knn_fused_merge(v, p, KNN_K)
    ref = kk.knn_fused_merge_plain(v, p, KNN_K)
    plain_route = kk.knn_fused_merge_plain(pv, pp, KNN_K)
    torch.cuda.synchronize()
    flagship_mismatches = merge_mismatches(torch, out, ref)
    check(sum(flagship_mismatches) == 0,
          f"knn_fused_merge differs from its plain version on one pool: {flagship_mismatches}")
    merge_err = float((out[0] - ref[0]).abs().max())
    pool_err = float((v - pv).abs().max())
    dist_err = float((out[0] - plain_route[0]).abs().max())
    check(bool(torch.allclose(out[0], plain_route[0], rtol=KNN_DIST_RTOL, atol=0.0)),
          f"kernel route distances off the plain route's by up to {dist_err}")
    rows_differ = int((out[1] != plain_route[1]).any(dim=1).sum())
    thresh, unflagged = out[3], out[2] == 0
    cnt = kk.knn_count(X, norm, valid, Q, thresh)
    torch.cuda.synchronize()
    # an unflagged row is complete: every item above its threshold is in
    # its list, and the count (bitwise the pool's d2) must say so
    check(bool((cnt == out[4])[unflagged].all()), "count kernel disagrees with the merged lists on unflagged rows")
    del pv, pp, plain_route, ref

    q_n, n, d, P = KNN_BLOCK, KNN_ITEMS, COLS, v.shape[1] * v.shape[2]
    ng = v.shape[1]

    def library_count():
        return (-((qn[:, None] - 2.0 * (Q @ X.T)) + inorm[None, :]) > thresh[:, None]).sum(dim=1)

    dot_ops = 2.0 * q_n * n * d
    in_bytes = 4.0 * (q_n * d + n * d + q_n + n)
    b5 = timings(torch, lambda: kk.knn_candidates(X, norm, valid, Q, m),
                 lambda: kk.knn_candidates_plain(X, inorm, Q, qn, m),
                 lambda: pool_library(torch, kk, X, Q, inorm, qn, m), 3)
    b5["bound_ms"], b5["bound_by"] = pool_bound(q_n, n, d, m)
    b6 = {"kernel_ms": median_ms(torch, lambda: kk.knn_candidates_audit(X, norm, valid, Q, m), 2),
          "plain_ms": b5["plain_ms"], "library_ms": b5["library_ms"],
          "bound_ms": b5["bound_ms"], "bound_by": b5["bound_by"]}
    window = kk._merge_cuda(v, p, KNN_K, 0)
    window_mismatches = merge_mismatches(torch, window, out)
    check(sum(window_mismatches) == 0, f"the windowed B7 differs from the radix one: {window_mismatches}")
    b7 = timings(torch, lambda: kk.knn_fused_merge(v, p, KNN_K), lambda: kk.knn_fused_merge_plain(v, p, KNN_K),
                 lambda: torch.topk(v.view(q_n, P), KNN_K, dim=1), 20)
    # the first design (the windowed kernel) in the same run
    b7["window_ms"] = median_ms(torch, lambda: kk._merge_cuda(v, p, KNN_K, 0), 20)
    b7["route"] = list(kk._merge_route(P, KNN_K))
    b7["bound_ms"], b7["bound_by"] = merge_bound(q_n, P, KNN_K)
    b8 = timings(torch, lambda: kk.knn_count(X, norm, valid, Q, thresh),
                 lambda: kk.knn_count_plain(X, inorm, Q, qn, thresh), library_count, 3)
    b8["bound_ms"], b8["bound_by"] = bound(in_bytes + 8.0 * q_n, dot_ops + q_n * n)
    del X, Q, v, p
    torch.cuda.empty_cache()
    shape = {"n": n, "d": d, "q": q_n, "m": m, "k": KNN_K, "ng": ng, "pool": P}
    return {
        "phase": "kernels_knn", "pool_build": build, "pool_occupancy": occupancy, "merge_routes": routes,
        "merge_build": merge_build, "merge_occupancy": merge_occ, "ragged": ragged,
        "pool_shapes": pool_shapes, "wide_merge": wide_merge, "flagship_integer": flagship_int,
        "flagship": {**shape, "pool_max_abs_err": pool_err, "dist_max_abs_err_vs_plain_route": dist_err,
                     "flagged_rows": int((~unflagged).sum()),
                     "rows_with_other_positions_vs_plain_route": rows_differ, "dist_rtol": KNN_DIST_RTOL},
        "knn_candidates": {**shape, **b5, "max_abs_err": pool_err},
        "knn_candidates_audit": {**shape, **b6, "max_abs_err": pool_err},
        "knn_fused_merge": {**shape, **b7, "max_abs_err": merge_err},
        # the count is held against its plain version where both are exact:
        # the flagship block on integer data
        "knn_count": {**shape, **b8, "max_abs_err": float(flagship_int["count_max_abs_err"])},
    }


def check_against_float64(torch, prepared, Qh, idx, dist, dev):
    """KNN_SAMPLE queries against float64 brute force over the staged items:
    distances within KNN_DIST_RTOL, and the returned set differs from the
    true top k only in items within KNN_TIE_RTOL of the k-th distance."""
    rng = np.random.default_rng(SEED)
    sample = np.sort(rng.choice(len(Qh), KNN_SAMPLE, replace=False))
    q64 = torch.from_numpy(Qh[sample]).to(dev, torch.float64)
    items, n = prepared.items, prepared.items.shape[0]
    d2 = torch.empty((KNN_SAMPLE, n), dtype=torch.float64, device=dev)
    qn = (q64 * q64).sum(dim=1)
    for lo in range(0, n, 50_000):
        x = items[lo : lo + 50_000].double()
        d2[:, lo : lo + 50_000] = (qn[:, None] - 2.0 * (q64 @ x.T)) + (x * x).sum(dim=1)[None, :]
    d64 = d2.clamp_(min=0.0).sqrt_()
    true_d = torch.topk(d64, KNN_K, dim=1, largest=False, sorted=True).values
    kth = true_d[:, -1:]
    pos_of_id = np.empty(n, np.int64)
    pos_of_id[prepared.ids] = np.arange(n)
    got_pos = torch.from_numpy(pos_of_id[idx[sample]]).to(dev)
    got_d = torch.from_numpy(dist[sample]).to(dev, torch.float64)
    got_d64 = d64.gather(1, got_pos)
    dist_err = float(((got_d - true_d).abs() / true_d).max())
    below = (d64 < kth * (1 - KNN_TIE_RTOL)).sum(dim=1)
    got_below = (got_d64 < kth * (1 - KNN_TIE_RTOL)).sum(dim=1)
    unique = bool((torch.sort(got_pos, dim=1).values.diff(dim=1) > 0).all())
    worst_out = float((got_d64 / kth - 1).max())
    check(dist_err <= KNN_DIST_RTOL, f"distances off float64 by up to {dist_err} relative")
    check(unique, "a query got the same item twice")
    check(worst_out <= KNN_TIE_RTOL, f"a returned item lies {worst_out} relative beyond the k-th distance")
    check(bool((below == got_below).all()), f"{int((below != got_below).sum())} rows miss an item off the tie band")
    swapped = int((got_d64 > kth * (1 - KNN_TIE_RTOL)).sum())
    del d2, d64
    torch.cuda.empty_cache()
    return {"sample": KNN_SAMPLE, "dist_max_rel_err": dist_err, "returned_in_tie_band": swapped,
            "dist_rtol": KNN_DIST_RTOL, "tie_rtol": KNN_TIE_RTOL}


def run_knn_path(torch, port, knn_ops, wrappers, X, Qh, dev):
    """The kNN arm through the public API.  Returns (record, model, indices,
    distances)."""
    item_df = port.DataFrame.from_numpy(X, num_partitions=KNN_ITEM_PARTS)
    query_df = port.DataFrame.from_numpy(Qh, num_partitions=KNN_QUERY_PARTS)
    search = knn_ops.knn_search_prepared
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(wrappers)
    search.flagged_rows = search.rerun_rows = 0
    model = port.NearestNeighbors(k=KNN_K).fit(item_df)
    t0 = time.perf_counter()
    _, qdf, knn_df = model.kneighbors(query_df)
    first_s = time.perf_counter() - t0
    launches_first = read_launches(wrappers)
    t0 = time.perf_counter()
    knn_df2 = model.kneighbors(query_df)[2]
    kneighbors_s = time.perf_counter() - t0
    launches = read_launches(wrappers)
    flagged, rerun = search.flagged_rows, search.rerun_rows
    peak_bytes = torch.cuda.max_memory_allocated()
    for name in ("knn_candidates", "knn_fused_merge"):
        check(launches_first[name] > 0 and launches[name] > launches_first[name],
              f"kneighbors launched {name} no time in a call")
    idx = np.concatenate([p["indices"] for p in knn_df.partitions])
    dist = np.concatenate([p["distances"] for p in knn_df.partitions])
    check(idx.shape == (KNN_QUERIES, KNN_K) and idx.dtype == np.int64 and dist.dtype == np.float32,
          f"kneighbors gave {idx.shape} {idx.dtype} / {dist.dtype}")
    check(bool(np.isfinite(dist).all()) and bool((np.diff(dist, axis=1) >= 0).all()), "distances not finite ascending")
    check(np.array_equal(idx, np.concatenate([p["indices"] for p in knn_df2.partitions]))
          and np.array_equal(dist, np.concatenate([p["distances"] for p in knn_df2.partitions])),
          "the cached kneighbors call gave other results")
    prepared = model._staged_items[1]
    f64 = check_against_float64(torch, prepared, Qh, idx, dist, dev)
    profile = profile_run(torch, lambda: model.kneighbors(query_df), KNN_PROFILE_RANGES, wrappers)
    t0 = time.perf_counter()
    join = model.exactNearestNeighborsJoin(port.DataFrame.from_numpy(Qh[:KNN_JOIN_QUERIES]))
    join_s = time.perf_counter() - t0
    join_rows = join.count()
    check(join_rows == KNN_JOIN_QUERIES * KNN_K, f"the join has {join_rows} rows")
    rec = {
        "phase": "path_knn", "items": KNN_ITEMS, "cols": X.shape[1], "queries": KNN_QUERIES, "k": KNN_K,
        "item_partitions": KNN_ITEM_PARTS, "query_partitions": KNN_QUERY_PARTS, "rows_cut": False,
        "m": knn_ops._scan_geometry(KNN_K, KNN_ITEMS)[1], "kernel_route": knn_ops._kernel_route(KNN_K, KNN_ITEMS)[0],
        "first_kneighbors_s": first_s, "kneighbors_s": kneighbors_s,
        "stage_s": first_s - kneighbors_s,  # staging: the first call less the cached one
        "kneighbors_rows_per_s": KNN_QUERIES / kneighbors_s,
        "launches_first_call": launches_first, "launches": launches,
        "flagged_rows": flagged, "rerun_rows": rerun,
        "max_memory_allocated_bytes": peak_bytes, "float64_check": f64, "profile": profile,
        "join_queries": KNN_JOIN_QUERIES, "join_rows": join_rows, "join_s": join_s,
    }
    return rec, model, idx, dist


def knn_audit(torch, knn_ops, wrappers, model, Qh, idx, dist, dev):
    """Phase knn_audit: one block through the audit route on the staged
    items."""
    search = knn_ops.knn_search_prepared
    qb = torch.from_numpy(Qh[:KNN_BLOCK]).to(dev)
    reset_launches(wrappers)
    search.flagged_rows = search.rerun_rows = 0
    search.count_failed_rows = search.count_failed_unflagged_rows = 0
    t0 = time.perf_counter()
    d_a, i_a = search(model._staged_items[1], qb, KNN_K, audit=True)
    audit_s = time.perf_counter() - t0
    launches = read_launches(wrappers)
    for name in ("knn_candidates_audit", "knn_fused_merge", "knn_count"):
        check(launches[name] > 0, f"the audit route launched {name} no time")
    check(launches["knn_candidates"] == 0, "the audit route launched the main path's pool wrapper")
    check(search.count_failed_unflagged_rows == 0,
          f"{search.count_failed_unflagged_rows} rows failed the count check without a flag")
    check(np.array_equal(i_a, idx[:KNN_BLOCK]) and np.array_equal(d_a, dist[:KNN_BLOCK]),
          "the audit route's results differ from the main path's")
    return {"phase": "knn_audit", "queries": KNN_BLOCK, "audit_s": audit_s, "launches": launches,
            "flagged_rows": search.flagged_rows, "count_failed_rows": search.count_failed_rows,
            "count_failed_unflagged_rows": search.count_failed_unflagged_rows, "rerun_rows": search.rerun_rows,
            "equal_to_main_path": True}




def knn_streamed(torch, port, knn_ops, wrappers, X, Qh, main_prepared, main_dist, dev):
    """Phase knn_streamed: the kNN items under an item budget of
    KNN_STREAM_BUDGET bytes, so kneighbors streams them in blocks.  The
    device must hold one block at a time, and the results must pass the
    float64 check."""
    real_budget = knn_ops._item_budget_bytes
    knn_ops._item_budget_bytes = lambda d: KNN_STREAM_BUDGET
    try:
        block_rows = knn_ops._item_block_rows(X.shape[1], dev)
        n_blocks = -(-len(X) // block_rows)
        Qs = Qh[:KNN_STREAM_QUERIES]
        model = port.NearestNeighbors(k=KNN_K).fit(port.DataFrame.from_numpy(X, num_partitions=KNN_ITEM_PARTS))
        query_df = port.DataFrame.from_numpy(Qs, num_partitions=KNN_QUERY_PARTS)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(wrappers)
        t0 = time.perf_counter()
        knn_df = model.kneighbors(query_df)[2]
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        launches = read_launches(wrappers)
    finally:
        knn_ops._item_budget_bytes = real_budget
    block_bytes = block_rows * X.shape[1] * 4
    check(model._staged_items is None and n_blocks >= 2, f"the items were not streamed ({n_blocks} blocks)")
    for name in ("knn_candidates", "knn_fused_merge"):
        check(launches[name] == n_blocks * KNN_QUERY_PARTS, f"streamed kneighbors launched {name} {launches[name]} times")
    check(peak < 2 * block_bytes, f"streaming peaked at {peak} bytes: two {block_bytes}-byte blocks were resident")
    idx = np.concatenate([p["indices"] for p in knn_df.partitions])
    dist = np.concatenate([p["distances"] for p in knn_df.partitions])
    check(idx.shape == (len(Qs), KNN_K), f"streamed kneighbors gave {idx.shape}")
    f64 = check_against_float64(torch, main_prepared, Qs, idx, dist, dev)
    dist_err = float(np.abs(dist - main_dist[: len(Qs)]).max())
    check(bool(np.allclose(dist, main_dist[: len(Qs)], rtol=KNN_DIST_RTOL, atol=0.0)),
          f"streamed distances off the in-core ones by up to {dist_err}")
    return {"phase": "knn_streamed", "items": len(X), "queries": len(Qs), "k": KNN_K,
            "item_budget_bytes": KNN_STREAM_BUDGET, "block_rows": block_rows, "blocks": n_blocks,
            "block_bytes": block_bytes, "peak_bytes_over_base": peak, "kneighbors_s": seconds,
            "launches": launches, "dist_max_abs_err_vs_in_core": dist_err, "float64_check": f64}


# ---------------------------------------------------------------------------
# The mesh: kernel B11 and exact kNN on 4 shards of one card
# ---------------------------------------------------------------------------

# Four shards of one card: the script needs one card, and 4 shards of the
# kNN arm's 400,000 items are 100,000 rows each, with no padding; a mesh that
# repeats a device is the port's counterpart of the JAX package's forced host
# device count.  The ring hop's blocks: 8,192 queries / 4 shards.
MESH_SHARDS = 4
RING_ROWS = KNN_BLOCK // MESH_SHARDS
EXCHANGE_SHIFTS = (1, -1, 3)
EXCHANGE_REPS = 50  # calls a B11 timing traces
# the ring against the one-shard exchange: distances within this relative
# error, ids equal off near-ties (KNN_TIE_RTOL)
RING_DIST_RTOL = 1e-6
# a ragged exchange block, as flagged rows come: padded to 64 rows, it runs
# the ring with (16, 3000) sub-tiles
RAGGED_ROWS = 37
KNN_MESH_DIST_RTOL = 1e-5  # the mesh kernel route against path_knn's


def bits_differ(torch, a, b):
    """Count of bytes whose bits differ between two tensors of one shape."""
    return int((a.reshape(-1).view(torch.uint8) != b.reshape(-1).view(torch.uint8).to(a.device)).sum())


def ring_permutation(n, shift):
    from spark_rapids_ml_tpu_torch.parallel.mesh import ring_permutation as port_ring_permutation

    return port_ring_permutation(n, shift)


def exchange_case(torch, ek, name, srcs, perm):
    """B11 against its plain version on one case: bit for bit, every block
    on its destination's device."""
    out, ref = ek.ring_shift(srcs, perm), ek.ring_shift_plain(srcs, perm)
    torch.cuda.synchronize()
    differ = sum(bits_differ(torch, a, b) for a, b in zip(out, ref))
    for d, t in enumerate(out):
        check(t.device == srcs[d].device, f"ring_shift {name}: block {d} landed on {t.device}")
    check(differ == 0, f"ring_shift {name} differs from its plain version in {differ} bytes")
    return {"case": name, "perm": [list(p) for p in perm], "shape": list(srcs[0].shape),
            "dtype": str(srcs[0].dtype), "bytes_differ": differ}


def exchange_rejections(torch, ek, blocks):
    """The typed rejections: each raises ValueError and launches nothing."""
    q, cd, cp = blocks
    n = len(q)
    rot = [(i, (i + 1) % n) for i in range(n)]
    cases = {
        "unequal_shape": (q[:-1] + [q[-1][:-1]], rot),
        "unequal_dtype": ([cd[0]] + cp[1:], rot),
        "more_than_64_pairs": ([cd[0]] * (ek.MAX_PAIRS + 1), [(i, (i + 1) % (ek.MAX_PAIRS + 1))
                                                               for i in range(ek.MAX_PAIRS + 1)]),
        "not_a_permutation": (cd, [(i, 0) for i in range(n)]),
        "not_contiguous": ([t.t() for t in cd], rot),
    }
    before = ek.ring_shift.launches
    for case, (srcs, perm) in cases.items():
        try:
            ek.ring_shift(srcs, perm)
        except ValueError:
            continue
        raise RuntimeError(f"ring_shift accepted the {case} case")
    check(ek.ring_shift.launches == before, "a rejected ring_shift launched its kernel")
    return sorted(cases)


def exchange_cases(torch, ek, topology, devices, gen):
    """B11 on the given shard devices: the ring hop's blocks (2,048 x 3000
    f32 queries, 2,048 x 200 f32 distances and i32 positions) at every shift
    of EXCHANGE_SHIFTS, misaligned blocks, the gateway cycles, the
    rejections.  Returns (records, the hop's blocks)."""
    n = len(devices)
    home = devices[0]
    q = [torch.randn(RING_ROWS, COLS, generator=gen, device=home).to(d) for d in devices]
    cd = [torch.randn(RING_ROWS, KNN_K, generator=gen, device=home).to(d) for d in devices]
    cp = [torch.randint(0, 2**31 - 1, (RING_ROWS, KNN_K), generator=gen, device=home, dtype=torch.int32).to(d)
          for d in devices]
    rows = []
    for name, blocks in (("query", q), ("cand_dist", cd), ("cand_pos", cp)):
        for shift in EXCHANGE_SHIFTS:
            rows.append(exchange_case(torch, ek, f"{name}_shift{shift}", blocks, ring_permutation(n, shift)))
    # one float past a 16-byte boundary (4-byte words), one byte past with a
    # ragged length (bytes)
    f = torch.randn(n, 1 + 7001, generator=gen, device=home)
    rows.append(exchange_case(torch, ek, "misaligned_f32", [f[i, 1:].to(d) if d != home else f[i, 1:]
                                                             for i, d in enumerate(devices)], ring_permutation(n, 1)))
    b = torch.randint(0, 256, (n, 1 + 1001), generator=gen, device=home, dtype=torch.uint8)
    rows.append(exchange_case(torch, ek, "misaligned_u8", [b[i, 1:] if d == home else b[i, 1:].to(d)
                                                            for i, d in enumerate(devices)], ring_permutation(n, 1)))
    maps = [("gateway_devs_per_host_2", topology.topology_map(devices=devices, devs_per_host=2))]
    if n == 4:
        maps.append(("gateway_interleaved", topology.TopologyMap(groups=((0, 2), (1, 3)), source="override")))
    for name, topo in maps:
        check(topo.is_hierarchical, f"{name}: {topo.describe()} is not hierarchical")
        for shift in (1, -1):
            rows.append(exchange_case(torch, ek, f"{name}_shift{shift}", q, topology.ring_cycle(topo, shift)))
    rejections = exchange_rejections(torch, ek, (q, cd, cp))
    return rows, rejections, (q, cd, cp)


def device_ms(torch, fn, reps, symbol=None):
    """(device ms per call of `fn`, traced launches) from one trace of `reps`
    calls after a warm-up call: the mean time of the traced launches of the
    port's kernel `symbol`, or the card's busy time (every kernel and copy)
    over the calls."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()

    rec = profile_once(torch, run, ())
    if symbol is None:
        return rec["device_busy_ms"] / reps, None
    traced = rec["port_launches"].get(symbol, 0)
    check(traced > 0, f"the trace holds no launch of {symbol}")
    return rec["port_kernel_ms"][symbol] / traced, traced


def check_exchange_kernel(torch, ek, topology, dev):
    """Phase kernels_exchange: B11 against its plain version on 4 shards of
    one card, bit for bit, then its times at the ring hop's shapes (library:
    torch.roll of the stacked blocks along the shard axis)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    devices = [dev] * MESH_SHARDS
    rows, rejections, blocks = exchange_cases(torch, ek, topology, devices, gen)
    timed = {}
    for name, srcs in zip(("query", "cand_dist", "cand_pos"), blocks):
        perm = ring_permutation(MESH_SHARDS, 1)
        stacked = torch.stack(srcs)
        rolled = torch.roll(stacked, 1, 0)
        check(all(torch.equal(a, b) for a, b in zip(ek.ring_shift(srcs, perm), rolled)),
              f"ring_shift {name} disagrees with torch.roll")
        kernel = lambda: ek.ring_shift(srcs, perm)  # noqa: E731
        plain = lambda: ek.ring_shift_plain(srcs, perm)  # noqa: E731
        library = lambda: torch.roll(stacked, 1, 0)  # noqa: E731
        # a shift takes tens of microseconds on the card, less than the
        # wrapper's host work, so CUDA events around a call time the host:
        # ms, plain_ms and library_ms are device times from a trace of
        # EXCHANGE_REPS calls, the event times are kept beside them
        r = {key[: -len("_ms")] + "_call_ms": ms
             for key, ms in timings(torch, kernel, plain, library, EXCHANGE_REPS).items()}
        r["kernel_ms"], r["traced_launches"] = device_ms(torch, kernel, EXCHANGE_REPS, "ring_shift_kernel")
        r["plain_ms"], _ = device_ms(torch, plain, EXCHANGE_REPS)
        r["library_ms"], _ = device_ms(torch, library, EXCHANGE_REPS)
        nbytes = MESH_SHARDS * srcs[0].numel() * srcs[0].element_size()
        r["bound_ms"], r["bound_by"] = bound(2.0 * nbytes, 0.0)
        timed[name] = {"shards": MESH_SHARDS, "shape": list(srcs[0].shape), "dtype": str(srcs[0].dtype),
                       "block_bytes": nbytes // MESH_SHARDS, **r, "max_abs_err": 0.0}
        del stacked, rolled
    del blocks
    torch.cuda.empty_cache()
    return {"phase": "kernels_exchange", "shards": MESH_SHARDS, "device": str(dev), "cases": rows,
            "rejections": rejections, "bit_exact": True, "ring_shift": timed["query"],
            "ring_shift_cand_dist": timed["cand_dist"], "ring_shift_cand_pos": timed["cand_pos"]}


def check_exchange_peer(torch, ek, topology):
    """Phase kernels_exchange_peer: the same cases over cuda:0 .. n-1 (at
    most 4), through peer pointers; skipped on a host with one card."""
    count = torch.cuda.device_count()
    if count < 2:
        return {"phase": "kernels_exchange_peer", "skipped": f"{count} CUDA device"}
    devices = [torch.device("cuda", i) for i in range(min(count, MESH_SHARDS))]
    gen = torch.Generator(device=devices[0]).manual_seed(SEED + 1)
    rows, rejections, blocks = exchange_cases(torch, ek, topology, devices, gen)
    q = blocks[0]
    perm = ring_permutation(len(devices), 1)
    ms, _ = device_ms(torch, lambda: ek.ring_shift(q, perm), EXCHANGE_REPS, "ring_shift_kernel")
    del blocks, q
    torch.cuda.empty_cache()
    return {"phase": "kernels_exchange_peer", "devices": [str(d) for d in devices], "cases": rows,
            "rejections": rejections, "bit_exact": True, "query_kernel_ms": ms,
            "knn_across_cards": knn_across_cards(torch, ek, devices)}


def knn_across_cards(torch, ek, devices):
    """The exact kNN search with its shards on several cards against the
    same shards on one card: the kernel route and one block through the
    ring and the gather, bit for bit (one launch of B11 per source card and
    call on the ring)."""
    from spark_rapids_ml_tpu_torch.ops import knn as knn_ops
    from spark_rapids_ml_tpu_torch.parallel.mesh import Mesh

    n, rows, cols, queries = len(devices), 100_000, 256, 2048
    X = normal_data(n * rows, cols, KNN_ITEM_SEED)
    Q = normal_data(queries, cols, KNN_QUERY_SEED)
    ids = np.arange(n * rows)
    one = knn_ops.prepare_items(X, ids, Mesh([devices[0]] * n))
    cards = knn_ops.prepare_items(X, ids, Mesh(devices))
    qb = torch.from_numpy(Q).to(devices[0])
    rec = {"items": n * rows, "cols": cols, "queries": queries, "k": KNN_K}
    for route in ("ring", "gather"):
        before = ek.ring_shift.launches
        want = knn_ops._exact_block_search(one, qb, KNN_K, exchange=route)
        mid = ek.ring_shift.launches
        got = knn_ops._exact_block_search(cards, qb, KNN_K, exchange=route)
        torch.cuda.synchronize()
        differ = sum(bits_differ(torch, a, b) for a, b in zip(got, want))
        check(differ == 0, f"the {route} across {n} cards differs from one card in {differ} bytes")
        rec[f"{route}_launches_one_card"] = mid - before
        rec[f"{route}_launches_cards"] = ek.ring_shift.launches - mid
    check(rec["ring_launches_cards"] == 3 * n * n, f"the ring across cards launched B11 {rec['ring_launches_cards']}")
    want = knn_ops.knn_search_prepared(one, Q, KNN_K)
    got = knn_ops.knn_search_prepared(cards, Q, KNN_K)
    check(all(np.array_equal(a, b) for a, b in zip(got, want)), "the kernel route across cards differs from one card")
    rec["bit_exact"] = True
    del one, cards, qb
    torch.cuda.empty_cache()
    return rec


def near_tie_mismatches(torch, prepared, Qh, rows, pos_a, pos_b, dev):
    """(entries whose positions differ, of them those off near-ties): a
    differing pair of items must lie within KNN_TIE_RTOL of each other in
    float64 distance to the query."""
    differ = np.argwhere(pos_a != pos_b)
    if differ.size == 0:
        return 0, 0
    r, c = differ[:, 0], differ[:, 1]
    q = torch.from_numpy(Qh[rows[r]]).to(dev, torch.float64)
    items = prepared.items
    da = (items[torch.from_numpy(pos_a[r, c]).to(dev)].double() - q).norm(dim=1)
    db = (items[torch.from_numpy(pos_b[r, c]).to(dev)].double() - q).norm(dim=1)
    return len(r), int(((da - db).abs() > KNN_TIE_RTOL * db).sum())


def run_knn_mesh_path(torch, port, knn_ops, wrappers, X, Qh, single, single_idx, single_dist, dev):
    """Phase path_knn_mesh: the kNN arm through the public API on a 4-shard
    mesh of one card: fit -> kneighbors twice, the float64 check, one
    profiled call; the results against path_knn's."""
    item_df = port.DataFrame.from_numpy(X, num_partitions=KNN_ITEM_PARTS)
    query_df = port.DataFrame.from_numpy(Qh, num_partitions=KNN_QUERY_PARTS)
    search = knn_ops.knn_search_prepared
    with port.device.use_device([dev] * MESH_SHARDS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(wrappers)
        search.flagged_rows = search.rerun_rows = 0
        port.profiling.reset_counters()
        model = port.NearestNeighbors(k=KNN_K, num_workers=MESH_SHARDS).fit(item_df)
        t0 = time.perf_counter()
        knn_df = model.kneighbors(query_df)[2]
        first_s = time.perf_counter() - t0
        launches_first = read_launches(wrappers)
        t0 = time.perf_counter()
        knn_df2 = model.kneighbors(query_df)[2]
        kneighbors_s = time.perf_counter() - t0
        launches = read_launches(wrappers)
        counters = port.profiling.counters()
        flagged, rerun = search.flagged_rows, search.rerun_rows
        peak_bytes = torch.cuda.max_memory_allocated()
        prepared = model._staged_items[1]
        profile = profile_run(torch, lambda: model.kneighbors(query_df), KNN_PROFILE_RANGES, wrappers)
    n_loc = KNN_ITEMS // MESH_SHARDS
    check(len(prepared.shards) == MESH_SHARDS and all(sh.items.shape[0] == n_loc for sh in prepared.shards),
          "the items were not sharded 4 ways of 100,000 rows")
    blocks = -(-KNN_QUERIES // KNN_BLOCK)
    m = knn_ops._scan_geometry(KNN_K, n_loc)[1]
    check(launches_first["knn_candidates"] == MESH_SHARDS * blocks and launches_first["knn_fused_merge"] == blocks,
          f"a mesh kneighbors call launched B5 / B7 {launches_first['knn_candidates']} / "
          f"{launches_first['knn_fused_merge']} times")
    check(launches["knn_candidates"] == 2 * MESH_SHARDS * blocks, "the cached mesh call launched B5 otherwise")
    check(counters.get("exchange.knn.cand_pool.calls") == 2 * 2 * blocks, f"cand_pool gathers: {counters}")
    idx = np.concatenate([p["indices"] for p in knn_df.partitions])
    dist = np.concatenate([p["distances"] for p in knn_df.partitions])
    check(idx.shape == (KNN_QUERIES, KNN_K) and bool(np.isfinite(dist).all()), f"mesh kneighbors gave {idx.shape}")
    check(np.array_equal(idx, np.concatenate([p["indices"] for p in knn_df2.partitions]))
          and np.array_equal(dist, np.concatenate([p["distances"] for p in knn_df2.partitions])),
          "the cached mesh kneighbors call gave other results")
    dist_err = float((np.abs(dist - single_dist) / single_dist).max())
    check(dist_err <= KNN_MESH_DIST_RTOL, f"mesh distances off path_knn's by {dist_err} relative")
    pos_of_id = np.empty(KNN_ITEMS, np.int64)
    pos_of_id[single.ids] = np.arange(KNN_ITEMS)
    differ, off_tie = near_tie_mismatches(torch, single, Qh, np.arange(KNN_QUERIES), pos_of_id[idx],
                                          pos_of_id[single_idx], dev)
    check(off_tie == 0, f"{off_tie} mesh ids differ from path_knn's off near-ties")
    f64 = check_against_float64(torch, single, Qh, idx, dist, dev)
    return {
        "phase": "path_knn_mesh", "shards": MESH_SHARDS, "mesh": [str(dev)] * MESH_SHARDS,
        "items": KNN_ITEMS, "cols": X.shape[1], "queries": KNN_QUERIES, "k": KNN_K, "rows_cut": False,
        "rows_per_shard": n_loc, "m": m, "groups_per_shard": -(-n_loc // 1024),
        "pool_per_query": MESH_SHARDS * -(-n_loc // 1024) * m,
        "first_kneighbors_s": first_s, "kneighbors_s": kneighbors_s, "stage_s": first_s - kneighbors_s,
        "kneighbors_rows_per_s": KNN_QUERIES / kneighbors_s,
        "launches_first_call": launches_first, "launches": launches,
        "exchange_counters": {k: v for k, v in counters.items() if not k.endswith("time_ns")},
        "flagged_rows": flagged, "rerun_rows": rerun, "max_memory_allocated_bytes": peak_bytes,
        "ids_differ_vs_path_knn": differ, "ids_differ_off_near_ties": off_tie,
        "dist_max_rel_err_vs_path_knn": dist_err, "float64_check": f64, "profile": profile,
    }, prepared


def knn_ring(torch, port, knn_ops, ek, wrappers, mesh_prepared, single, Qh, dev):
    """Phase knn_ring: one 8,192-query block through the exact exchange on
    the 4-shard mesh, ring and gather, and through the one-shard exchange:
    ring == gather bit for bit, 12 B11 launches on the ring and none on the
    gather, the section bytes of the per-hop model, and the one-shard result
    within RING_DIST_RTOL (ids equal off near-ties)."""
    qb = torch.from_numpy(Qh[:KNN_BLOCK]).to(dev)
    out, rec = {}, {"phase": "knn_ring", "shards": MESH_SHARDS, "queries": KNN_BLOCK, "k": KNN_K}
    for route in ("ring", "gather"):
        torch.cuda.synchronize()
        reset_launches(wrappers)
        port.profiling.reset_counters()
        t0 = time.perf_counter()
        out[route] = knn_ops._exact_block_search(mesh_prepared, qb, KNN_K, exchange=route)
        torch.cuda.synchronize()
        rec[f"{route}_s"] = time.perf_counter() - t0
        rec[f"launches_{route}"] = read_launches(wrappers)
        rec[f"counters_{route}"] = {k: v for k, v in port.profiling.counters().items() if not k.endswith("time_ns")}
    (rd, rp), (gd, gp) = out["ring"], out["gather"]
    differ = bits_differ(torch, rd, gd) + bits_differ(torch, rp, gp)
    check(differ == 0, f"ring and gather differ in {differ} bytes")
    check(rec["launches_ring"]["ring_shift"] == 3 * MESH_SHARDS, f"the ring launched B11 {rec['launches_ring']}")
    check(rec["launches_gather"]["ring_shift"] == 0, "the gather launched B11")
    ctr = rec["counters_ring"]
    want_q = MESH_SHARDS * RING_ROWS * COLS * 4
    want_c = MESH_SHARDS * 2 * RING_ROWS * KNN_K * 4
    check(ctr.get("exchange.knn.ring_q.bytes") == want_q and ctr.get("exchange.knn.ring_cand.bytes") == want_c,
          f"ring section bytes {ctr} against the model {want_q} / {want_c}")
    check(rec["counters_ring"].get("knn.exchange_route.ring") == 1
          and rec["counters_gather"].get("knn.exchange_route.gather") == 1, "the route counters")
    n1 = single.items.shape[0]
    chunk, qt = knn_ops._exchange_geometry(n1, KNN_BLOCK, 1, "ring")
    ring_geometry = knn_ops._exchange_geometry(n1 // MESH_SHARDS, KNN_BLOCK, MESH_SHARDS, "ring")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    od, op = knn_ops.knn_block_kernel_exchange(single, qb, KNN_K, "ring", chunk, qt)
    torch.cuda.synchronize()
    rec["one_shard_s"] = time.perf_counter() - t0
    rec["geometry_one_shard"], rec["geometry_ring"] = [chunk, qt], list(ring_geometry)
    rec["bytes_differ_vs_one_shard"] = bits_differ(torch, rd, od) + bits_differ(torch, rp, op)
    dist_err = float(((rd.double() - od.double()).abs() / od.double()).max())
    check(dist_err <= RING_DIST_RTOL, f"ring distances off the one-shard exchange by {dist_err} relative")
    pa, pb = rp.cpu().numpy(), op.cpu().numpy()
    rec["ids_differ_vs_one_shard"], off_tie = near_tie_mismatches(torch, single, Qh, np.arange(KNN_BLOCK), pa, pb, dev)
    check(off_tie == 0, f"{off_tie} ring ids differ from the one-shard exchange off near-ties")
    rec["dist_max_rel_err_vs_one_shard"] = dist_err
    # a ragged block pads onto the ring: 12 B11 launches, rows as the block's
    torch.cuda.synchronize()
    reset_launches(wrappers)
    port.profiling.reset_counters()
    t0 = time.perf_counter()
    xd, xp = knn_ops._exact_block_search(mesh_prepared, qb[:RAGGED_ROWS], KNN_K)
    torch.cuda.synchronize()
    rec["ragged_s"] = time.perf_counter() - t0
    rec["ragged_rows"], rec["ragged_padded_rows"] = RAGGED_ROWS, knn_ops._exchange_rows(RAGGED_ROWS, MESH_SHARDS)
    rec["launches_ragged"] = read_launches(wrappers)
    check(port.profiling.counters("knn.exchange_route.") == {"knn.exchange_route.ring": 1}
          and rec["launches_ragged"]["ring_shift"] == 3 * MESH_SHARDS,
          f"the ragged block: routes {port.profiling.counters('knn.exchange_route.')}, "
          f"launches {rec['launches_ragged']}")
    rec["ragged_bytes_differ_vs_block"] = bits_differ(torch, xd, rd[:RAGGED_ROWS]) + bits_differ(
        torch, xp, rp[:RAGGED_ROWS])
    ragged_err = float(((xd.double() - rd[:RAGGED_ROWS].double()).abs() / rd[:RAGGED_ROWS].double()).max())
    check(ragged_err <= RING_DIST_RTOL, f"the ragged block's distances off the block's by {ragged_err} relative")
    rec["ragged_ids_differ_vs_block"], off_tie = near_tie_mismatches(
        torch, single, Qh, np.arange(RAGGED_ROWS), xp.cpu().numpy(), pa[:RAGGED_ROWS], dev)
    check(off_tie == 0, f"{off_tie} ragged-block ids differ from the block's off near-ties")
    rec["ragged_dist_max_rel_err_vs_block"] = ragged_err
    # the share of the ring's time in B11: one profiled ring call
    prof = profile_run(torch, lambda: knn_ops._exact_block_search(mesh_prepared, qb, KNN_K, exchange="ring"),
                       (), wrappers)
    b11_ms = prof["port_kernel_ms"].get("ring_shift_kernel", 0.0)
    rec["profile"] = prof
    rec["ring_shift_device_ms"] = b11_ms
    rec["ring_shift_share"] = b11_ms / prof["profiled_ms"]
    rec["equal_ring_gather"] = True
    del out, od, op, xd, xp
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# ANN: kernels B9-B10 (B1 and B7 at the ANN shapes) and the JAX package's
# three ANN operating points
# ---------------------------------------------------------------------------

# The JAX package's ANN arms (bench.py:379-442, its generator bench.py:150):
# 400,000 x 256 float32 items around 632 blob centres drawn as 10 * N(0, 1),
# labels uniform over the blobs, N(0, 1) noise, all from
# np.random.default_rng(42); the queries are the first 16,384 rows; k = 200,
# nlist = default_nlist(400,000) = 632, nprobe = default_nprobe(632) = 158,
# M = default_m_sub(256) = 32.  The 4-bit arm is the fast-scan operating
# point of ci/test.sh:711-714 (n_bits 4, opq, refine_ratio 8).  Not cut.
ANN_ITEMS, ANN_COLS, ANN_QUERIES, ANN_K, ANN_SEED = 400_000, 256, 16_384, 200, 42
ANN_NLIST, ANN_NPROBE, ANN_M = 632, 158, 32
ANN_ITEM_PARTS, ANN_QUERY_PARTS = 8, 2
ANN_CHECK_QUERIES = 2048   # the recall, reload and tiered checks
_ANN_BASE = {"nlist": ANN_NLIST, "nprobe": ANN_NPROBE}
# phase: (algorithm, algoParams, recall@10 gate of the JAX package's tests)
ANN_ARMS = {
    "path_ann": ("ivfflat", dict(_ANN_BASE), 0.95),                    # tests/test_ann_engine.py:107
    "path_ann_pq": ("ivfpq", dict(_ANN_BASE, M=ANN_M, n_bits=8, refine_ratio=4), 0.9),  # test_pq_engine.py:176
    "path_ann_pq4": ("ivfpq", dict(_ANN_BASE, M=ANN_M, n_bits=4, opq=True, refine_ratio=8), 0.9),  # :468
}
ANN_HOT_FRACTION = 0.5
ANN_PROFILE_RANGES = ("ann.select", "ann.scan", "ann.merge")
# B9 / B10 checks, (B, R, m_sub, ksub, codes drawn below): the JAX test
# shapes, a ragged R with ksub < 256 and codes past it, tables of two
# stages, misaligned codes (byte loads), more than 65,535 queries
LUT_CASES = [
    (3, 700, 4, 16, 16), (1, 512, 2, 256, 256), (2, 33, 8, 5, 5), (2, 1001, 32, 200, 256),
    (2, 1000, 48, 256, 256), (3, 517, 64, 256, 256), (65537, 3, 2, 16, 16),
]
FASTSCAN_CASES = [
    (3, 700, 4, 16, 16), (1, 512, 2, 16, 16), (2, 33, 8, 5, 16), (2, 1001, 32, 16, 16),
    (3, 517, 64, 9, 16), (65537, 3, 2, 16, 16),
]
# the padded list length the port's fit gives on these items (each path
# records its own); the path-sized calls of B7, B9 and B10 take the query
# rows of one launch from ivfflat.sweep_geometry at this length
ANN_L_PAD = 2048
# B7 at the ANN pool: the k of each arm's merge (flat, 8-bit refine x4,
# 4-bit refine x8)
ANN_MERGE_KS = (200, 800, 1600)
# lut_accumulate_probed at ragged shapes, (B, nprobe, n_planes, L_pad,
# m_sub, ksub, code range, misaligned): counts from below 0 to past L_pad,
# slots outside the plane, codes past ksub, byte loads (m_sub 20), a table
# staged in parts (64 x 256), a misaligned plane, more than 65,535 queries
PROBED_CASES = [
    (3, 5, 9, 700, 32, 256, 256, False), (4, 7, 6, 333, 20, 16, 32, False), (2, 3, 5, 517, 64, 256, 256, False),
    (3, 4, 8, 256, 32, 200, 256, True), (65537, 2, 4, 3, 16, 16, 16, False),
]
# fastscan_lut_accumulate_probed at ragged shapes, the same fields (codes
# drawn below the range, then packed two a byte): the 4-bit arm's m_sub,
# nibbles past ksub, byte loads (m_sub 20), two register-table chunks (m_sub
# 64), a misaligned plane, L_pad not a multiple of the 128-row warp unit,
# more than 65,535 queries
FASTSCAN_PROBED_CASES = [
    (3, 5, 9, 700, 32, 16, 16, False), (4, 7, 6, 333, 20, 9, 16, False), (2, 3, 5, 517, 64, 16, 16, False),
    (3, 4, 8, 256, 32, 5, 16, True), (65537, 2, 4, 3, 2, 16, 16, False),
]


def ann_data():
    """The ANN arms' items, made as bench.py makes them, and the queries."""
    rng = np.random.default_rng(ANN_SEED)
    centers = 10.0 * rng.standard_normal((max(32, ANN_NLIST), ANN_COLS), dtype=np.float32)
    lab = rng.integers(0, centers.shape[0], size=ANN_ITEMS)
    X = centers[lab] + rng.standard_normal((ANN_ITEMS, ANN_COLS), dtype=np.float32)
    return X, X[:ANN_QUERIES].copy()


def lut_case(torch, pk, dev, gen, b, r, m_sub, ksub, hi, packed, misaligned=False):
    """B9 (or B10 when packed) against its plain version at one shape: bit
    for bit.  Returns (tables, codes, record)."""
    T = torch.randn((b, m_sub, ksub), generator=gen, device=dev)
    C = torch.randint(0, hi, (b, r, m_sub), generator=gen, device=dev, dtype=torch.uint8)
    if packed:
        C = (C[:, :, 0::2] | (C[:, :, 1::2] << 4)).contiguous()
    if misaligned:  # the same bytes one byte past a 16-byte boundary
        buf = torch.empty(C.numel() + 1, dtype=torch.uint8, device=dev)
        buf[1:].copy_(C.view(-1))
        C = buf[1:].view(C.shape)
    kernel, plain = ((pk.fastscan_lut_accumulate, pk.fastscan_lut_accumulate_plain) if packed
                     else (pk.lut_accumulate, pk.lut_accumulate_plain))
    got, want = kernel(T, C), plain(T, C)
    torch.cuda.synchronize()
    mismatches = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    check(mismatches == 0, f"{'fastscan' if packed else 'lut'} ({b}, {r}, {m_sub}, {ksub}) differs from its plain "
                           f"version at {mismatches} values")
    return T, C, {"b": b, "r": r, "m_sub": m_sub, "ksub": ksub, "code_range": hi, "misaligned": misaligned,
                  "bit_mismatches": mismatches}


def lut_timing(torch, pk, T, C, packed):
    """B9 / B10 at one shape: kernel, plain and library times (gather + sum
    over j, a yardstick only), and the least time (codes, tables and
    output moved once)."""
    b, r = C.shape[0], C.shape[1]
    kernel, plain = ((pk.fastscan_lut_accumulate, pk.fastscan_lut_accumulate_plain) if packed
                     else (pk.lut_accumulate, pk.lut_accumulate_plain))

    def library():
        codes = pk.unpack_codes4(C) if packed else C
        return T.gather(2, codes.long().transpose(1, 2)).sum(dim=1)

    lib = library()
    check(bool(torch.allclose(lib, kernel(T, C), rtol=1e-5, atol=1e-4)), "the gather + sum yardstick disagrees")
    del lib
    row = timings(torch, lambda: kernel(T, C), lambda: plain(T, C), library, 20)
    row["bound_ms"], row["bound_by"] = bound(C.numel() + 4.0 * b * r + 4.0 * T.numel(), float(b * r * T.shape[1]))
    return {"b": b, "r": r, "m_sub": T.shape[1], "ksub": T.shape[2], "max_abs_err": 0.0, **row}


def scan_rows(ivf, pq_mod, n_bits):
    """Query rows of one B9 / B10 launch on the PQ arms: the sweep's
    sub-block at ANN_L_PAD."""
    index = types.SimpleNamespace(m_sub=ANN_M, fastscan=n_bits == 4, l_pad=ANN_L_PAD)
    return ivf.sweep_geometry(ANN_QUERIES, ANN_NPROBE * ANN_L_PAD, pq_mod.pq_tile_bytes(index, ANN_NPROBE))[1]


def ann_pool(torch, dev, gen, rows, tied):
    """A probe pool of the ANN arms' shape: rows x ANN_NPROBE distinct lists
    of ANN_L_PAD slots, each list holding Binomial(ANN_ITEMS, 1 / ANN_NLIST)
    items (mean 633: ~69% of the slots -inf), -d2 as tied integers in
    [-4096, -1] or continuous, positions list * L_pad + slot, the sentinel
    where invalid (ivfflat.probe_pool's layout)."""
    counts = torch.from_numpy(np.random.default_rng(SEED).binomial(ANN_ITEMS, 1.0 / ANN_NLIST, (rows, ANN_NPROBE)))
    counts = counts.to(device=dev, dtype=torch.int32)
    lists = torch.rand(rows, ANN_NLIST, generator=gen, device=dev).argsort(dim=1)[:, :ANN_NPROBE].sort(dim=1).values
    slot = torch.arange(ANN_L_PAD, device=dev, dtype=torch.int32)
    valid = slot[None, None, :] < counts[:, :, None]
    shape = (rows, ANN_NPROBE, ANN_L_PAD)
    if tied:
        v = -torch.randint(1, 4097, shape, generator=gen, device=dev).float()
    else:
        v = -(torch.rand(shape, generator=gen, device=dev) * 2000.0 + 100.0)
    v = torch.where(valid, v, torch.full_like(v, float("-inf")))
    p = torch.where(valid, lists.to(torch.int32)[:, :, None] * ANN_L_PAD + slot, torch.full_like(slot, 2**31 - 1))
    return v.contiguous(), p.contiguous(), float((~valid).float().mean())


def check_ann_merge(torch, kk, ivf, dev, gen):
    """B7 at the ANN arms' pool (one sweep block of query rows x 158 x 2048)
    at k = 200 / 800 / 1600: bit for bit against its plain version on tied
    integer values, through the route the wrapper takes and through the
    windowed kernel (the first design); timed (the route, the windowed
    kernel, the plain version, torch.topk over the pool) on continuous
    values."""
    rows = ivf.sweep_geometry(ANN_QUERIES, ANN_NPROBE * ANN_L_PAD, 1)[0]
    out_rows = []
    for tied in (True, False):
        v, p, neg_share = ann_pool(torch, dev, gen, rows, tied)
        P = ANN_NPROBE * ANN_L_PAD
        for k in ANN_MERGE_KS:
            rec = {"q": rows, "nprobe": ANN_NPROBE, "l_pad": ANN_L_PAD, "pool": P, "k": k, "tied": tied,
                   "neg_inf_share": neg_share, "route": list(kk._merge_route(P, k))}
            if tied:
                ref = kk.knn_fused_merge_plain(v, p, k)
                rec["mismatches"] = merge_mismatches(torch, kk.knn_fused_merge(v, p, k), ref)
                rec["window_mismatches"] = merge_mismatches(torch, kk._merge_cuda(v, p, k, 0), ref)
                check(sum(rec["mismatches"]) + sum(rec["window_mismatches"]) == 0,
                      f"B7 at the ANN pool differs from its plain version: {rec}")
                del ref
            else:
                rec.update(timings(torch, lambda: kk.knn_fused_merge(v, p, k),
                                   lambda: kk.knn_fused_merge_plain(v, p, k),
                                   (lambda: torch.topk(v.view(rows, P), k, dim=1)) if k <= P else None, 10))
                rec["window_ms"] = median_ms(torch, lambda: kk._merge_cuda(v, p, k, 0), 5)
                rec["bound_ms"], rec["bound_by"] = merge_bound(rows, P, k)
                rec["max_abs_err"] = 0.0
            out_rows.append(rec)
            emit({"phase": "kernels_ann_merge", **rec})
        del v, p
        torch.cuda.empty_cache()
    return out_rows


def probed_inputs(torch, dev, gen, b, nprobe, n_planes, l_pad, m_sub, ksub, hi, misaligned, packed=False):
    """Tables, a code plane (packed: two 4-bit codes a byte), slots and
    counts for the probed entries: ragged counts (below 0, 0, past L_pad)
    and slots (some outside the plane)."""
    T = torch.randn((b, m_sub, ksub), generator=gen, device=dev)
    plane = torch.randint(0, hi, (n_planes, l_pad, m_sub), generator=gen, device=dev, dtype=torch.uint8)
    if packed:
        plane = (plane[:, :, 0::2] | (plane[:, :, 1::2] << 4)).contiguous()
    if misaligned:  # the same bytes one byte past a 16-byte boundary
        buf = torch.empty(plane.numel() + 1, dtype=torch.uint8, device=dev)
        buf[1:].copy_(plane.view(-1))
        plane = buf[1:].view(plane.shape)
    slots = torch.randint(-1, n_planes + 1, (b, nprobe), generator=gen, device=dev, dtype=torch.int32)
    counts = torch.randint(-2, l_pad + 3, (b, nprobe), generator=gen, device=dev, dtype=torch.int32)
    counts[:, 0] = 0
    return T, plane, slots, counts


def probed_pair(pk, packed):
    """(kernel wrapper, plain version) of the probed entry: B10's when
    packed, else B9's."""
    return ((pk.fastscan_lut_accumulate_probed, pk.fastscan_lut_accumulate_probed_plain) if packed
            else (pk.lut_accumulate_probed, pk.lut_accumulate_probed_plain))


def probed_bits(torch, pk, T, plane, slots, counts, packed=False):
    kernel, plain = probed_pair(pk, packed)
    got = kernel(T, plane, slots, counts)
    want = plain(T, plane, slots, counts)
    torch.cuda.synchronize()
    return got, int((got.view(torch.int32) != want.view(torch.int32)).sum())


def check_probed_path(torch, pk, dev, gen, b, packed=False):
    """A probed entry at its arm's launch: b queries x 158 probed lists of
    an index plane (nlist_pad 640 x 2048) with Binomial(400,000, 1/632)
    items a list (8 lists empty), resident and through a tiered index's pool
    planes (ann/tier.TieredListPlanes, hot fraction 0.5): bit for bit
    against the plain version, the tiered rows bit for bit the resident
    ones; timed resident.  B9 (8-bit arm: m_sub 32 bytes a row, ksub 256)
    or, packed, B10 (4-bit arm: 16 packed bytes a row, ksub 16).  Library: index_select + (unpack +) gather +
    sum over j, masked."""
    from spark_rapids_ml_tpu_torch.ann.tier import TieredListPlanes

    name = "fastscan_lut_accumulate_probed" if packed else "lut_accumulate_probed"
    kernel, plain = probed_pair(pk, packed)
    ksub, m_bytes = (16, ANN_M // 2) if packed else (256, ANN_M)
    n_lists = 640
    rng = np.random.default_rng(SEED)
    list_counts = rng.binomial(ANN_ITEMS, 1.0 / ANN_NLIST, n_lists).astype(np.int32)
    list_counts[ANN_NLIST:] = 0
    list_counts[rng.choice(ANN_NLIST, 8, replace=False)] = 0
    host_plane = rng.integers(0, 256, (n_lists, ANN_L_PAD, m_bytes), dtype=np.uint8)
    plane = torch.from_numpy(host_plane).to(dev)
    counts_dev = torch.from_numpy(list_counts).to(dev)
    probes = torch.rand(b, ANN_NLIST, generator=gen, device=dev).argsort(dim=1)[:, :ANN_NPROBE].sort(dim=1).values
    counts = counts_dev[probes]
    T = torch.randn((b, ANN_M, ksub), generator=gen, device=dev)
    got, bad = probed_bits(torch, pk, T, plane, probes, counts, packed)
    check(bad == 0, f"{name} at the path's launch differs from its plain version at {bad} values")
    valid_rows = int(counts.clamp(0, ANN_L_PAD).sum())

    tier = TieredListPlanes(planes=[host_plane], sentinels=[None], counts=list_counts, device=dev,
                            hot_fraction=ANN_HOT_FRACTION)
    host_probes = probes.cpu().numpy()
    groups, tier_bad, tier_vs_resident = tier.plan_groups(host_probes), 0, 0
    for s0, e0 in groups:
        planes, slot_map = tier.acquire(host_probes[s0:e0].ravel())
        slots = slot_map[probes]
        t_got, t_bad = probed_bits(torch, pk, T, planes[0], slots, counts, packed)
        tier_bad += t_bad
        tier_vs_resident += int((t_got[s0:e0].view(torch.int32) != got[s0:e0].view(torch.int32)).sum())
    check(tier_bad == 0 and tier_vs_resident == 0,
          f"{name} on the tier's planes: {tier_bad} values off the plain version, "
          f"{tier_vs_resident} off the resident result")

    def library():
        tile = plane.index_select(0, probes.reshape(-1)).view(b, ANN_NPROBE * ANN_L_PAD, m_bytes)
        codes = pk.unpack_codes4(tile) if packed else tile
        acc = T.gather(2, codes.long().transpose(1, 2)).sum(dim=1).view(b, ANN_NPROBE, ANN_L_PAD)
        valid = torch.arange(ANN_L_PAD, device=dev)[None, None, :] < counts[:, :, None]
        return torch.where(valid, acc, torch.full_like(acc, float("inf")))

    lib = library()
    finite = torch.isfinite(got)
    check(bool(torch.allclose(lib[finite], got[finite], rtol=1e-5, atol=1e-4)), "the gather + sum yardstick disagrees")
    del lib
    torch.cuda.empty_cache()
    row = timings(torch, lambda: kernel(T, plane, probes, counts), lambda: plain(T, plane, probes, counts),
                  library, 20)
    all_rows = b * ANN_NPROBE * ANN_L_PAD
    # codes of the valid rows read, every output row written, the tables
    # and the slots and counts read once
    row["bound_ms"], row["bound_by"] = bound(
        valid_rows * m_bytes + 4.0 * all_rows + 4.0 * T.numel() + 12.0 * b * ANN_NPROBE, float(valid_rows * ANN_M))
    rec = {"b": b, "nprobe": ANN_NPROBE, "l_pad": ANN_L_PAD, "m_sub": ANN_M, "ksub": ksub,
           "r": ANN_NPROBE * ANN_L_PAD, "valid_rows": valid_rows, "valid_share": valid_rows / all_rows,
           "bit_mismatches": bad, "tier_groups": len(groups), "tier_bit_mismatches": tier_bad,
           "tier_vs_resident": tier_vs_resident, "tier": tier.stats(), "max_abs_err": 0.0, **row}
    vec = pk._vec(plane)
    if packed:
        rec["blocks_per_query"] = pk.fastscan_splits(T, ANN_NPROBE, ANN_L_PAD, vec)
        rec["resident_blocks_per_sm"] = pk.fastscan_resident_blocks(vec)
    else:
        rec["blocks_per_query"] = pk.probed_splits(T, ANN_NPROBE, ANN_L_PAD, vec)
        rec["resident_blocks_per_sm"] = pk.resident_blocks(ANN_M, 256, vec)
    return rec


def check_ann_kernels(torch, pk, kk, nc, ivf, pq_mod, _build, dev):
    """Phase kernels_ann: B9 and B10 against their plain versions on the
    card, bit for bit: the contiguous forms at the cases above, the probed
    entries at ragged cases and at their arms' launches (resident and
    tiered, timed there); B10's typed
    rejections; B7 at the ANN pool (check_ann_merge); B1 at the ANN fit's
    two shapes (list assignment, PQ encoding); ptxas registers and spills of
    the two kernels of csrc/pq_lut.cu."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    merge = check_ann_merge(torch, kk, ivf, dev, gen)
    build = ptxas_record(_build, "pq_lut", ("probed_lut_kernel", "fastscan_probed_kernel"))
    lut = [lut_case(torch, pk, dev, gen, *c, packed=False)[2] for c in LUT_CASES]
    lut.append(lut_case(torch, pk, dev, gen, 2, 999, 32, 256, 256, packed=False, misaligned=True)[2])
    fast = [lut_case(torch, pk, dev, gen, *c, packed=True)[2] for c in FASTSCAN_CASES]
    fast.append(lut_case(torch, pk, dev, gen, 2, 999, 64, 16, 16, packed=True, misaligned=True)[2])
    probed = []
    for packed, cases in ((False, PROBED_CASES), (True, FASTSCAN_PROBED_CASES)):
        for case in cases:
            inputs = probed_inputs(torch, dev, gen, *case, packed=packed)
            bad = probed_bits(torch, pk, *inputs, packed=packed)[1]
            check(bad == 0, f"{probed_pair(pk, packed)[0].__name__} {case} differs from its plain version at "
                            f"{bad} values")
            probed.append({"packed": packed, "case": list(case), "bit_mismatches": bad})
    rejections = {}
    for name, t_shape, p_shape, match in (
        ("odd_m_sub", (1, 3, 16), (1, 5, 1), "even"),
        ("ksub_over_16", (1, 4, 17), (1, 5, 2), "16"),
        ("packed_width", (1, 4, 16), (1, 5, 3), "bytes/item"),
    ):
        for entry in ("contiguous", "probed"):
            T0 = torch.zeros(t_shape, device=dev)
            C0 = torch.zeros(p_shape, dtype=torch.uint8, device=dev)
            try:
                if entry == "contiguous":
                    pk.fastscan_lut_accumulate(T0, C0)
                else:
                    zeros = torch.zeros((1, 2), dtype=torch.int32, device=dev)
                    pk.fastscan_lut_accumulate_probed(T0, C0, zeros, zeros)
            except ValueError as e:
                check(match in str(e), f"fast-scan {entry} {name}: {e}")
                rejections[f"{entry}_{name}"] = str(e)
            else:
                raise RuntimeError(f"fast-scan {entry} accepted {name}")
    torch.cuda.empty_cache()
    probed_row = check_probed_path(torch, pk, dev, gen, scan_rows(ivf, pq_mod, 8))
    emit({"phase": "kernels_ann_probed", **probed_row})
    torch.cuda.empty_cache()
    fast_probed_row = check_probed_path(torch, pk, dev, gen, scan_rows(ivf, pq_mod, 4), packed=True)
    emit({"phase": "kernels_ann_fastscan_probed", **fast_probed_row})
    torch.cuda.empty_cache()
    r_path = ANN_NPROBE * ANN_L_PAD
    T, C, fast_path = lut_case(torch, pk, dev, gen, scan_rows(ivf, pq_mod, 4), r_path, ANN_M, 16, 16, packed=True)
    fast_row = {**fast_path, **lut_timing(torch, pk, T, C, True)}
    del T, C
    torch.cuda.empty_cache()
    cpu_gen = torch.Generator().manual_seed(SEED)
    b1 = [check_kernel_shape(torch, nc, ANN_ITEMS, d, k, cpu_gen, dev) for d, k in ((ANN_COLS, ANN_NLIST), (8, 256))]
    return {"phase": "kernels_ann", "lut_build": build, "lut_cases": lut, "fastscan_cases": fast,
            "probed_cases": probed, "fastscan_rejections": rejections, "lut_accumulate_probed": probed_row,
            "fastscan_lut_accumulate_probed": fast_probed_row, "fastscan_lut_accumulate": fast_row,
            "knn_fused_merge_ann": merge, "min_dist_argmin_ann": b1}


def ann_rows(model, df):
    """(ids, distances) of kneighbors over `df`, partitions concatenated."""
    knn_df = model.kneighbors(df)[2]
    return (np.concatenate([p["indices"] for p in knn_df.partitions]),
            np.concatenate([p["distances"] for p in knn_df.partitions]))


def ann_merge_check(torch, ivf, pq_mod, knn_ops, kk, index, Q, k, pq, dev):
    """One probed block of 64 queries: B7 (the search's merge) against
    ops/knn.lex_topk on the same pool, bit for bit."""
    qb = torch.from_numpy(Q[:64]).to(dev)
    if pq:
        qb = torch.nn.functional.pad(qb, (0, index.d_pad - qb.shape[1]))
        if index.rotation is not None:
            qb = qb @ torch.from_numpy(index.rotation).to(dev).T
        scorer, tile = pq_mod.pq_block_scorer(index), pq_mod.pq_tile_bytes(index, ANN_NPROBE)
    else:
        scorer, tile = ivf._flat_block_scorer, ivf.flat_tile_bytes(index, ANN_NPROBE)
    _, sub_rows = ivf.sweep_geometry(64, ANN_NPROBE * index.l_pad, tile)
    vals, pos = ivf.probe_pool(index, qb, ANN_NPROBE, scorer, sub_rows)
    dist, fpos = kk.knn_fused_merge(vals, pos, k)[:2]
    fpos = torch.where(torch.isinf(dist), knn_ops.LEX_POS_SENTINEL, fpos)
    d2, lpos = knn_ops.lex_topk(-vals.view(64, -1), pos.view(64, -1), k)
    ldist = kk.sqrt_clamped(d2)
    torch.cuda.synchronize()
    bad = int((dist.view(torch.int32) != ldist.view(torch.int32)).sum() + (fpos != lpos).sum())
    check(bad == 0, f"the probe merge differs from lex_topk at {bad} values")
    return {"queries": 64, "pool": vals.shape[1] * vals.shape[2], "k": k, "mismatches": bad}


def run_ann_arm(torch, port, ivf, pq_mod, knn_ops, kk, wrappers, phase, X, Q, dev):
    """One ANN arm through the public API: fit, kneighbors twice (staging,
    then the cached call) and one profiled call with the launch counters
    read around them; then recall@10 / @200 against exactSearch, save ->
    load, B7 against lex_topk on one block and, for the 4-bit arm, the
    tiered search against the resident one, on ANN_CHECK_QUERIES queries."""
    algorithm, params, gate = ANN_ARMS[phase]
    pq, fast = algorithm == "ivfpq", params.get("n_bits") == 4
    item_df = port.DataFrame.from_numpy(X, num_partitions=ANN_ITEM_PARTS)
    query_df = port.DataFrame.from_numpy(Q, num_partitions=ANN_QUERY_PARTS)
    check_df = port.DataFrame.from_numpy(Q[:ANN_CHECK_QUERIES])
    model_dir = os.path.join(REPO, "build", f"chip_smoke_{phase}")
    shutil.rmtree(model_dir, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(wrappers)
    t0 = time.perf_counter()
    model = port.ApproximateNearestNeighbors(k=ANN_K, algorithm=algorithm, algoParams=params).fit(item_df)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches_fit = read_launches(wrappers)
    t0 = time.perf_counter()
    idx, dist = ann_rows(model, query_df)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx2, dist2 = ann_rows(model, query_df)
    kneighbors_s = time.perf_counter() - t0
    launches = read_launches(wrappers)
    peak_bytes = torch.cuda.max_memory_allocated()
    search = {name: launches[name] - launches_fit[name] for name in launches}
    check(launches_fit["min_dist_argmin"] > 0, "the fit launched min_dist_argmin no time")
    check(search["knn_fused_merge"] > 0, "kneighbors launched knn_fused_merge no time")
    for name, used in (("lut_accumulate_probed", pq and not fast), ("fastscan_lut_accumulate_probed", pq and fast),
                       ("lut_accumulate", False), ("fastscan_lut_accumulate", False)):
        check((search[name] > 0) == used, f"kneighbors launched {name} {search[name]} times")
    check(idx.shape == (ANN_QUERIES, ANN_K) and idx.dtype == np.int64 and dist.dtype == np.float32,
          f"kneighbors gave {idx.shape} {idx.dtype} / {dist.dtype}")
    check(bool(np.isfinite(dist).all()) and bool((np.diff(dist, axis=1) >= 0).all()) and bool((idx >= 0).all()),
          "distances not finite ascending, or an unfilled slot")
    check(np.array_equal(idx, idx2) and np.array_equal(dist, dist2), "the cached kneighbors call gave other results")
    profile = profile_run(torch, lambda: ann_rows(model, query_df), ANN_PROFILE_RANGES, wrappers)
    rec = {"index_bytes_per_item": model.index_bytes_per_item()}
    staged = model._staged_pq[1] if pq else model._staged_index[1]
    rec["l_pad"], rec["nlist_pad"] = staged.l_pad, staged.nlist_pad
    # one sweep block's query rows, and the rows of one scoring launch
    tile = pq_mod.pq_tile_bytes(staged, ANN_NPROBE) if pq else ivf.flat_tile_bytes(staged, ANN_NPROBE)
    rec["block_rows"], rec["scan_rows"] = ivf.sweep_geometry(ANN_QUERIES, ANN_NPROBE * staged.l_pad, tile)
    rec["merge_vs_lex_topk"] = ann_merge_check(torch, ivf, pq_mod, knn_ops, kk, staged, Q, pq_k(params), pq, dev)
    # checks on ANN_CHECK_QUERIES queries, outside the counted window
    i_c, d_c = ann_rows(model, check_df)
    model.setExactSearch(True)
    i_ex, _ = ann_rows(model, check_df)
    model.setExactSearch(False)
    rec["recall_at_10"] = ivf.recall_at_k(i_c[:, :10], i_ex[:, :10])
    rec["recall_at_200"] = ivf.recall_at_k(i_c, i_ex)
    rec["recall_at_10_of_the_16384_query_call"] = ivf.recall_at_k(idx[:ANN_CHECK_QUERIES, :10], i_ex[:, :10])
    check(rec["recall_at_10"] >= gate, f"recall@10 {rec['recall_at_10']} < {gate}")
    if pq:
        model.setAlgoParams(dict(params, refine_ratio=1))
        i_raw, _ = ann_rows(model, check_df)
        model.setAlgoParams(params)
        rec["adc_recall_at_10"] = ivf.recall_at_k(i_raw[:, :10], i_ex[:, :10])
        rec["adc_recall_at_200"] = ivf.recall_at_k(i_raw, i_ex)
    model.save(model_dir)
    i_l, d_l = ann_rows(port.load(model_dir), check_df)
    check(np.array_equal(i_l, i_c) and np.array_equal(d_l.view(np.uint32), d_c.view(np.uint32)),
          "the reloaded model gives other results")
    rec["reloaded_identical"] = True
    if fast:
        model.setAlgoParams(dict(params, hot_fraction=ANN_HOT_FRACTION))
        t0 = time.perf_counter()
        i_t, d_t = ann_rows(model, check_df)
        rec["tiered_s"] = time.perf_counter() - t0
        rec["tier"] = model._staged_pq[1].tier.stats()
        model.setAlgoParams(params)
        check(np.array_equal(i_t, i_c) and np.array_equal(d_t.view(np.uint32), d_c.view(np.uint32)),
              "the tiered search differs from the resident one")
        check(rec["tier"]["misses"] > 0 and rec["tier"]["page_bytes"] > 0, f"the tier paged nothing: {rec['tier']}")
        rec["tiered_identical"] = True
    return {
        "phase": phase, "items": ANN_ITEMS, "cols": ANN_COLS, "queries": ANN_QUERIES, "k": ANN_K,
        "algorithm": algorithm, "algo_params": params, "rows_cut": False,
        "fit_s": fit_s, "first_kneighbors_s": first_s, "kneighbors_s": kneighbors_s,
        "stage_s": first_s - kneighbors_s, "kneighbors_rows_per_s": ANN_QUERIES / kneighbors_s,
        "launches_fit": launches_fit, "launches": launches, "max_memory_allocated_bytes": peak_bytes,
        "check_queries": ANN_CHECK_QUERIES, "recall_gate": gate, **rec, "profile": profile,
    }


def pq_k(params):
    """Candidates the probe merge keeps: k, times refine_ratio when > 1."""
    ratio = params.get("refine_ratio", 1)
    return ANN_K * ratio if ratio > 1 else ANN_K


# ---------------------------------------------------------------------------
# PCA, LinearRegression and LogisticRegression: no kernel of the port's own
# (cuBLAS and cuSOLVER through torch, TF32 off)
# ---------------------------------------------------------------------------

# The reference benchmark's configurations (databricks/run_benchmark.sh as
# SURVEY.md section 6 cites it), with data as bench.py makes it:
# PCA k = 3 on 1,000,000 x 3000 float32 low-rank rows (rank 32 plus 0.1
# noise, bench.py:196-201; run_benchmark.sh:57-64); LinearRegression OLS,
# ridge (regParam 1e-5, maxIter 10) and elastic net (regParam 1e-5,
# elasticNetParam 0.5, maxIter 10) (:66-99) and LogisticRegression
# (regParam 1e-5, maxIter 200; :125-133) on 1,000,000 x 3000 Gaussian X
# with y = X . coef + 0.1 noise, binary y > 0 (bench.py:226-232), 100,000
# more rows held out; the sparse multinomial arm (bench.py:259-301, the
# BASELINE.json shape at one card's scale): 4,000,000 x 100 CSR, one
# nonzero a row, 4 classes, regParam 1e-5, maxIter 100, tol 1e-6.  Not cut.
GLM_ROWS, GLM_HOLDOUT, GLM_COLS, GLM_PARTITIONS, GLM_SEED = 1_000_000, 100_000, 3000, 8, 42
PCA_K, PCA_RANK, PCA_SEED = 3, 32, 11
LINREG_FITS = {
    "ols": {},
    "ridge": dict(regParam=1e-5, maxIter=10),
    "elastic_net": dict(regParam=1e-5, elasticNetParam=0.5, maxIter=10),
}
LOGREG = dict(regParam=1e-5, maxIter=200)
SPARSE_ROWS, SPARSE_COLS, SPARSE_CLASSES, SPARSE_SEED = 4_000_000, 100, 4, 5
SPARSE_LOGREG = dict(regParam=1e-5, maxIter=100, tol=1e-6)
# PCA against the float64 covariance and float64 eigh of the same rows on
# the card: the JAX package's PCA test gates (tests/test_pca.py:40-48),
# component signs equal; the transform against float64 projections of
# 4,096 rows, max |error| over max |projection|
PCA_MEAN_ATOL, PCA_COMP_ATOL, PCA_RATIO_ATOL, PCA_SV_RTOL, PCA_PROJ_RTOL = 1e-4, 1e-3, 1e-4, 1e-3, 1e-5
# OLS and ridge against a float64 solve of the float64 normal equations
# (centred, standardised, ridge's alpha * n) on the card: max |coef -
# coef64| (and |intercept error|) over max |coef64|; the port's solve_linear
# on the float64 statistics against the same solve (ridge shrinks the
# coefficients by ~1e-5 relative, so this is where its alpha scaling shows)
LINREG_RTOL, LINREG_F64_RTOL = 1e-5, 1e-9
# elastic net against the port's CD run on the CPU from the card's float32
# statistics, max |error| over max |coef|; sweep counts equal
ENET_RTOL = 1e-5
HOLDOUT_R2, HOLDOUT_ACCURACY = 0.99, 0.9
# X^T X of 256 rows on the card against float64: max |error| over the
# product of absolute values, entry by entry (fp32 FMA sums stay under ~1e-6;
# TF32 products, 10 mantissa bits, leave ~1e-4)
TF32_PROBE_ROWS, TF32_PROBE_RTOL = 256, 5e-6
# glm_card_vs_cpu: 65,536 x 256, the same fits on the card and under
# use_device("cpu"): PCA components within 1e-4 (signs equal), linear
# coefficients within 1e-5 of max |coef| (CD sweeps equal), logistic
# coefficients within 1e-3 of max(1, max |W|) (regParam 1e-3, tol 1e-6, so
# both reach the same optimum)
CVC_ROWS, CVC_COLS, CVC_SEED = 65536, 256, 77
CVC_PCA_ATOL, CVC_LINEAR_RTOL, CVC_LOGISTIC_ATOL = 1e-4, 1e-5, 1e-3
GLM_PHASES = ("path_pca", "path_linreg", "path_logreg", "path_logreg_sparse", "glm_card_vs_cpu")


def low_rank_data(rows, cols, rank, seed, workers=8):
    """bench.py's PCA rows: A @ B + 0.1 noise with A (rows, rank), B (rank,
    cols) and the noise standard normal float32, filled by `workers`
    threads with independent seeded streams."""
    B = np.random.default_rng(seed).standard_normal((rank, cols), dtype=np.float32)
    X = np.empty((rows, cols), np.float32)
    streams = np.random.SeedSequence(seed + 1).spawn(workers)
    bounds = np.linspace(0, rows, workers + 1, dtype=int)

    def fill(i):
        rng_i = np.random.default_rng(streams[i])
        for lo in range(bounds[i], bounds[i + 1], 16384):
            hi = min(lo + 16384, bounds[i + 1])
            rng_i.standard_normal(out=X[lo:hi], dtype=np.float32)
            X[lo:hi] *= 0.1
            X[lo:hi] += rng_i.standard_normal((hi - lo, rank), dtype=np.float32) @ B

    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(fill, range(workers)))
    return X


def glm_data():
    """bench.py's GLM rows: standard normal X (GLM_ROWS + GLM_HOLDOUT rows),
    coef standard normal, y = X . coef + 0.1 noise, float32."""
    X = normal_data(GLM_ROWS + GLM_HOLDOUT, GLM_COLS, GLM_SEED)
    rng = np.random.default_rng(GLM_SEED + 1)
    coef = rng.standard_normal(GLM_COLS, dtype=np.float32)
    y = X @ coef + np.float32(0.1) * rng.standard_normal(len(X), dtype=np.float32)
    return X, y.astype(np.float32)


def f64_moments(torch, X, dev, y=None, chunk=65536):
    """(n, sum x, X^T X[, sum y, X^T y, sum y^2]) of the host rows in float64
    on the card, a chunk of rows at a time."""
    d = X.shape[1]
    sx = torch.zeros(d, dtype=torch.float64, device=dev)
    G = torch.zeros((d, d), dtype=torch.float64, device=dev)
    sy = torch.zeros((), dtype=torch.float64, device=dev)
    c = torch.zeros(d, dtype=torch.float64, device=dev)
    y2 = torch.zeros((), dtype=torch.float64, device=dev)
    for lo in range(0, len(X), chunk):
        xb = torch.from_numpy(X[lo : lo + chunk]).to(dev).double()
        sx += xb.sum(dim=0)
        G.addmm_(xb.T, xb)
        if y is not None:
            yb = torch.from_numpy(y[lo : lo + chunk]).to(dev).double()
            sy += yb.sum()
            c.addmv_(xb.T, yb)
            y2 += (yb * yb).sum()
        del xb
    return float(len(X)), sx, G, sy, c, y2


def tf32_probe(torch, X, dev):
    """max |X^T X (float32, card) - float64| / (|X|^T |X|) over the entries,
    for the first TF32_PROBE_ROWS rows."""
    xb = torch.from_numpy(X[:TF32_PROBE_ROWS]).to(dev)
    got = (xb.T @ xb).double()
    x64 = xb.double()
    err = (got - x64.T @ x64).abs() / (x64.abs().T @ x64.abs()).clamp_min(1e-30)
    return float(err.max())


def precision_record(torch, X, dev):
    """The card's matmul precision settings after a fit, and the probe."""
    rec = {"allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "float32_matmul_precision": torch.get_float32_matmul_precision(),
           "tf32_probe_rel_err": tf32_probe(torch, X, dev)}
    check(rec["allow_tf32"] is False and rec["float32_matmul_precision"] == "highest",
          f"TF32 is on after the fit: {rec}")
    check(rec["tf32_probe_rel_err"] <= TF32_PROBE_RTOL,
          f"X^T X is not exact float32 on the card: {rec['tf32_probe_rel_err']} > {TF32_PROBE_RTOL}")
    return rec


def concat_col(df, name):
    return np.concatenate([np.asarray(p[name]) for p in df.partitions])


def round_trip(port, model, df, phase, cols):
    """transform -> save -> load -> transform: (the first outputs, seconds of
    the first transform); raises unless the reloaded model's outputs are
    identical."""
    model_dir = os.path.join(REPO, "build", f"chip_smoke_{phase}")
    shutil.rmtree(model_dir, ignore_errors=True)
    t0 = time.perf_counter()
    out = model.transform(df)
    seconds = time.perf_counter() - t0
    first = {c: concat_col(out, c) for c in cols}
    model.save(model_dir)
    out2 = port.load(model_dir).transform(df)
    for c in cols:
        check(np.array_equal(first[c], concat_col(out2, c)), f"{phase}: the reloaded model gives another {c}")
    return first, seconds


def timed_fit(torch, est, df, wrappers):
    """(model, fit seconds, peak device bytes over the bytes allocated
    before the fit, launches of the port's kernels)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launches(wrappers)
    t0 = time.perf_counter()
    model = est.fit(df)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return model, seconds, torch.cuda.max_memory_allocated() - base, read_launches(wrappers)


def synced(torch, fn):
    """(fn(), seconds to its end on the card)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def pca_reference(torch, X, dev, k):
    """The float64 covariance and float64 eigh of the rows on the card:
    (mean, components with the sign rule, variance ratio, singular values)."""
    n, sx, G, *_ = f64_moments(torch, X, dev)
    mean = sx / n
    cov = (G - n * torch.outer(mean, mean)) / (n - 1.0)
    evals, evecs = torch.linalg.eigh((cov + cov.T) * 0.5)
    evals, comps = evals.flip(0), evecs.flip(1).T
    comps = comps[:k]
    comps = comps * torch.sign(comps.gather(1, comps.abs().argmax(dim=1, keepdim=True)))
    top = evals[:k]
    return (mean.cpu().numpy(), comps.cpu().numpy(), (top / evals.sum()).cpu().numpy(),
            torch.sqrt(top * (n - 1.0)).cpu().numpy())


def run_pca_path(torch, port, wrappers, dev):
    """Phase path_pca: PCA(k=3) on the low-rank rows through the public API,
    fit -> transform -> save -> load -> transform, against the float64
    covariance and eigh of the same rows; stage times and a profiled fit."""
    from spark_rapids_ml_tpu_torch.ops import linalg

    t0 = time.perf_counter()
    X = low_rank_data(GLM_ROWS, GLM_COLS, PCA_RANK, PCA_SEED)
    gen_s = time.perf_counter() - t0
    df = port.DataFrame.from_numpy(X, num_partitions=GLM_PARTITIONS)
    est = port.PCA(k=PCA_K)
    model, fit_s, peak, launches = timed_fit(torch, est, df, wrappers)
    precision = precision_record(torch, X, dev)
    outs, transform_s = round_trip(port, model, df, "path_pca", ["pca_features"])
    proj = outs["pca_features"]
    check(proj.shape == (GLM_ROWS, PCA_K) and np.isfinite(proj).all(), f"projections {proj.shape}")

    (mean, comps, ratio, sv), ref_s = synced(torch, lambda: pca_reference(torch, X, dev, PCA_K))
    errs = {
        "mean_max_abs_err": float(np.abs(model.mean_ - mean).max()),
        "components_max_abs_err": float(np.abs(model.components_ - comps).max()),
        "ratio_max_abs_err": float(np.abs(model.explained_variance_ratio_ - ratio).max()),
        "singular_values_max_rel_err": float(np.abs(model.singular_values_ / sv - 1.0).max()),
    }
    check(np.array_equal(np.sign(model.components_[np.arange(PCA_K), np.abs(comps).argmax(axis=1)]),
                         np.sign(comps[np.arange(PCA_K), np.abs(comps).argmax(axis=1)])), "component signs differ")
    check(errs["mean_max_abs_err"] <= PCA_MEAN_ATOL and errs["components_max_abs_err"] <= PCA_COMP_ATOL
          and errs["ratio_max_abs_err"] <= PCA_RATIO_ATOL and errs["singular_values_max_rel_err"] <= PCA_SV_RTOL,
          f"PCA against float64: {errs}")
    want = X[:4096].astype(np.float64) @ model.components_.T
    errs["transform_max_rel_err"] = float(np.abs(proj[:4096] - want).max() / np.abs(want).max())
    check(errs["transform_max_rel_err"] <= PCA_PROJ_RTOL, f"projections against float64: {errs}")

    inputs, ingest_s = synced(torch, lambda: est._build_fit_inputs(df))
    (wsum, mean_t, scatter), moments_s = synced(torch, lambda: linalg.weighted_moments(inputs.X, inputs.weight))
    del inputs
    cov, cov_s = synced(torch, lambda: linalg.covariance(wsum, mean_t, scatter))
    _, eigh_s = synced(torch, lambda: linalg.eigh_descending(cov))
    profile = profile_run(torch, lambda: est.fit(df), ("core.ingest", "pca.fit"), wrappers)
    del X, df, cov, scatter
    return {
        "phase": "path_pca", "rows": GLM_ROWS, "cols": GLM_COLS, "k": PCA_K, "rank": PCA_RANK,
        "partitions": GLM_PARTITIONS, "data_gen_s": gen_s,
        "fit_s": fit_s, "transform_s": transform_s, "transform_rows_per_s": GLM_ROWS / transform_s,
        "max_memory_allocated_bytes": peak, "launches": launches, "precision": precision,
        "explained_variance_ratio": model.explained_variance_ratio_.tolist(),
        "gates": {"mean_atol": PCA_MEAN_ATOL, "components_atol": PCA_COMP_ATOL, "ratio_atol": PCA_RATIO_ATOL,
                  "singular_values_rtol": PCA_SV_RTOL, "transform_rtol": PCA_PROJ_RTOL},
        "errors_vs_float64": errs, "float64_reference_s": ref_s, "reloaded_identical": True,
        "stages_s": {"ingest": ingest_s, "moments": moments_s, "covariance": cov_s, "eigh_float64": eigh_s},
        "moments_bound_s": 2.0 * GLM_ROWS * GLM_COLS ** 2 / PEAK_FP32_FLOPS,
        "profile": profile,
    }


def f64_linear_solve(torch, stats64, alpha, fit_intercept=True, standardize=True):
    """The float64 reference of OLS / Spark ridge, written apart from the
    port: centred normal equations, features scaled to unit variance,
    (G + alpha n I) b = c, no jitter.  (coef, intercept) on the card."""
    n, sx, G, sy, c, _ = stats64
    xm, ym = sx / n, sy / n
    if fit_intercept:
        G = G - n * torch.outer(xm, xm)
        c = c - n * xm * ym
    s = torch.sqrt(torch.diagonal(G) / n) if standardize else torch.ones_like(xm)
    s = torch.where(s > 0, s, torch.ones_like(s))
    A = G / torch.outer(s, s) + alpha * n * torch.eye(len(s), dtype=G.dtype, device=G.device)
    b = torch.linalg.solve(A, c / s) / s
    return b, (ym - xm @ b) if fit_intercept else torch.zeros((), dtype=b.dtype, device=b.device)


def cd_sweep_times(torch, glm, stats, params, dev):
    """One elastic-net CD sweep on the card's statistics, run eagerly and as
    the replay of its captured CUDA graph (ms), and the capture's cost."""
    system, _ = glm._cd_system(stats, float(params["alpha"]), float(params["l1_ratio"]),
                               bool(params["fit_intercept"]), bool(params["normalize"]))
    b = torch.zeros(system[0].shape[0], dtype=system[0].dtype, device=dev)
    md = torch.zeros((), dtype=system[0].dtype, device=dev)
    eager = [synced(torch, lambda: glm._cd_sweep(*system, b, md))[1] for _ in range(2)]
    run, capture_s = synced(torch, lambda: glm._sweep_runner(functools.partial(glm._cd_sweep, *system, b, md), dev))
    replays = [synced(torch, run)[1] for _ in range(3)]
    return {"eager_sweep_ms": [1e3 * t for t in eager], "graph_sweep_ms": [1e3 * t for t in replays],
            "graph_warmup_and_capture_ms": 1e3 * capture_s, "coordinates": int(system[0].shape[0])}


def run_linreg_path(torch, port, wrappers, X, y, dev):
    """Phase path_linreg: OLS, ridge and elastic net from one frame through
    the public API, each fit -> transform -> save -> load -> transform with
    held-out R^2; OLS and ridge against a float64 solve of the float64
    normal equations, elastic net against the port's CD on the CPU from the
    card's statistics; stage times, CD sweeps eager and as a CUDA graph, and
    a profiled ridge fit."""
    from spark_rapids_ml_tpu_torch.ops import glm

    df = port.DataFrame.from_numpy(X[:GLM_ROWS], y[:GLM_ROWS], num_partitions=GLM_PARTITIONS)
    hold = port.DataFrame.from_numpy(X[GLM_ROWS:], num_partitions=1)
    y_hold = y[GLM_ROWS:].astype(np.float64)
    stats64, ref_s = synced(torch, lambda: f64_moments(torch, X[:GLM_ROWS], dev, y[:GLM_ROWS]))
    n, sx, G64, sy, c64, y2 = stats64
    stats64_port = glm.LinregStats(torch.tensor(n, dtype=torch.float64, device=dev), sx / n, sy / n, G64, c64, y2)

    est0 = port.LinearRegression()
    inputs, ingest_s = synced(torch, lambda: est0._build_fit_inputs(df))
    stats32, stats_s = synced(torch, lambda: glm.linreg_sufficient_stats(inputs.X, inputs.y, inputs.weight))
    del inputs
    fits, precision = {}, None
    for name, params in LINREG_FITS.items():
        est = port.LinearRegression(**params)
        port.profiling.reset_counters("glm.")
        model, fit_s, peak, launches = timed_fit(torch, est, df, wrappers)
        if precision is None:
            precision = precision_record(torch, X, dev)
        outs, transform_s = round_trip(port, model, df, f"path_linreg_{name}", ["prediction"])
        check(np.isfinite(outs["prediction"]).all(), f"{name}: non-finite predictions")
        hold_pred = concat_col(model.transform(hold), "prediction")
        r2 = float(1.0 - ((hold_pred - y_hold) ** 2).mean() / y_hold.var())
        check(r2 > HOLDOUT_R2, f"{name}: held-out R^2 {r2} <= {HOLDOUT_R2}")
        tp = dict(est._tpu_params)
        rec = {"params": params, "fit_s": fit_s, "transform_s": transform_s,
               "transform_rows_per_s": GLM_ROWS / transform_s, "max_memory_allocated_bytes": peak,
               "launches": launches, "holdout_r2": r2, "reloaded_identical": True}
        if name in ("ols", "ridge"):
            alpha = float(tp["alpha"])
            b64, b0_64 = f64_linear_solve(torch, stats64, alpha)
            scale = float(b64.abs().max())
            b64_h, b0_h = b64.cpu().numpy(), float(b0_64)
            rec["coef_max_rel_err_vs_float64"] = float(np.abs(model.coef_ - b64_h).max()) / scale
            rec["intercept_rel_err_vs_float64"] = abs(model.intercept_ - b0_h) / scale
            pb, pb0 = glm.solve_linear(stats64_port, alpha, fit_intercept=True, normalize=True)
            rec["port_solve_float64_max_rel_err"] = float((pb - b64).abs().max()) / scale
            check(rec["coef_max_rel_err_vs_float64"] <= LINREG_RTOL and rec["intercept_rel_err_vs_float64"] <= LINREG_RTOL,
                  f"{name} against the float64 solve: {rec}")
            check(rec["port_solve_float64_max_rel_err"] <= LINREG_F64_RTOL, f"{name}: the port's float64 solve: {rec}")
            _, rec["solve_s"] = synced(torch, lambda: glm.solve_linear(stats32, alpha, True, True))
        else:
            sweeps = port.profiling.counters("glm.").get("glm.cd_sweeps")
            cpu_stats = glm.LinregStats(*(t.cpu() for t in stats32))
            (b_cpu, b0_cpu, it_cpu), cpu_s = synced(torch, lambda: glm.solve_elasticnet_cd(
                cpu_stats, float(tp["alpha"]), float(tp["l1_ratio"]), bool(tp["fit_intercept"]),
                bool(tp["normalize"]), int(tp["max_iter"]), float(tp["tol"])))
            scale = float(b_cpu.abs().max())
            rec.update(cd_sweeps=sweeps, cd_sweeps_cpu=it_cpu, cd_cpu_s=cpu_s,
                       coef_max_rel_err_vs_cpu_cd=float(np.abs(model.coef_ - b_cpu.numpy()).max()) / scale,
                       intercept_abs_err_vs_cpu_cd=abs(model.intercept_ - float(b0_cpu)))
            check(sweeps == it_cpu, f"CD sweeps: card {sweeps}, CPU {it_cpu}")
            check(rec["coef_max_rel_err_vs_cpu_cd"] <= ENET_RTOL, f"elastic net against the CPU's CD: {rec}")
            _, rec["cd_s"] = synced(torch, lambda: glm.solve_elasticnet_cd(
                stats32, float(tp["alpha"]), float(tp["l1_ratio"]), bool(tp["fit_intercept"]), bool(tp["normalize"]),
                int(tp["max_iter"]), float(tp["tol"])))
            rec["cd_sweep"] = cd_sweep_times(torch, glm, stats32, tp, dev)
        fits[name] = rec
    profile = profile_run(torch, lambda: port.LinearRegression(**LINREG_FITS["ridge"]).fit(df),
                          ("core.ingest", "glm.stats", "glm.solve"), wrappers)
    del df, hold, stats64, stats64_port, G64
    return {
        "phase": "path_linreg", "rows": GLM_ROWS, "cols": GLM_COLS, "holdout_rows": GLM_HOLDOUT,
        "partitions": GLM_PARTITIONS, "fits": fits, "precision": precision,
        "gates": {"ols_ridge_rtol_vs_float64": LINREG_RTOL, "port_float64_solve_rtol": LINREG_F64_RTOL,
                  "elastic_net_rtol_vs_cpu_cd": ENET_RTOL, "holdout_r2_above": HOLDOUT_R2},
        "stages_s": {"ingest": ingest_s, "stats": stats_s, "float64_reference": ref_s},
        "stats_bound_s": 2.0 * GLM_ROWS * GLM_COLS ** 2 / PEAK_FP32_FLOPS,
        "profile_ridge": profile,
    }


def run_logreg_path(torch, port, wrappers, X, y, dev):
    """Phase path_logreg: binary LogisticRegression(regParam=1e-5,
    maxIter=200) on y > 0 through the public API: fit -> transform -> save ->
    load -> transform, held-out accuracy, the L-BFGS counts, one dense
    objective evaluation timed against its bound, a profiled fit."""
    from spark_rapids_ml_tpu_torch.ops import logistic

    yb = (y > 0).astype(np.float32)
    df = port.DataFrame.from_numpy(X[:GLM_ROWS], yb[:GLM_ROWS], num_partitions=GLM_PARTITIONS)
    hold = port.DataFrame.from_numpy(X[GLM_ROWS:], num_partitions=1)
    est = port.LogisticRegression(**LOGREG)
    port.profiling.reset_counters("lbfgs.")
    model, fit_s, peak, launches = timed_fit(torch, est, df, wrappers)
    solver = port.profiling.counters("lbfgs.")
    precision = precision_record(torch, X, dev)
    cols = ["prediction", "probability", "rawPrediction"]
    outs, transform_s = round_trip(port, model, df, "path_logreg", cols)
    check(all(np.isfinite(outs[c]).all() for c in cols), "non-finite outputs")
    acc = float((concat_col(model.transform(hold), "prediction") == yb[GLM_ROWS:]).mean())
    check(acc > HOLDOUT_ACCURACY, f"held-out accuracy {acc} <= {HOLDOUT_ACCURACY}")

    inputs, ingest_s = synced(torch, lambda: est._build_fit_inputs(df))
    theta = torch.as_tensor(np.concatenate([model.coef_.ravel(), model.intercept_]).astype(np.float32), device=dev)
    wsum = inputs.weight.sum()
    eval_ms = median_ms(torch, lambda: logistic._data_value_and_grad(
        theta, inputs.X, inputs.y, inputs.weight, wsum, 1, GLM_COLS, True), 5)
    del inputs
    eval_bound_ms = 1e3 * 2 * GLM_ROWS * GLM_COLS * 4 / PEAK_BYTES_PER_S  # X read twice
    profile = profile_run(torch, lambda: est.fit(df), ("core.ingest", "lbfgs.fit"), wrappers)
    del df, hold
    return {
        "phase": "path_logreg", "rows": GLM_ROWS, "cols": GLM_COLS, "holdout_rows": GLM_HOLDOUT,
        "params": LOGREG, "fit_s": fit_s, "transform_s": transform_s,
        "transform_rows_per_s": GLM_ROWS / transform_s, "max_memory_allocated_bytes": peak,
        "launches": launches, "precision": precision,
        "lbfgs_iterations": solver.get("lbfgs.iterations"), "lbfgs_evaluations": solver.get("lbfgs.evaluations"),
        "converged": bool(solver.get("lbfgs.converged")), "num_iters": model.num_iters,
        "holdout_accuracy": acc, "holdout_accuracy_above": HOLDOUT_ACCURACY, "reloaded_identical": True,
        "stages_s": {"ingest": ingest_s, "lbfgs": fit_s - ingest_s},
        "evaluation_ms": eval_ms, "evaluation_bound_ms": eval_bound_ms,
        "profiled_lbfgs_ms_per_evaluation": profile["range_host_ms"]["lbfgs.fit"] / solver["lbfgs.evaluations"],
        "profile": profile,
    }


def sparse_glm_data():
    """bench.py's sparse multinomial rows: one (column, value) a row,
    standard normal values, labels the argmax of the row's value times a
    standard normal (cols, 4) weight row.  (CSR matrix, labels float32)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(SPARSE_SEED)
    idx = rng.integers(0, SPARSE_COLS, size=SPARSE_ROWS, dtype=np.int32)
    val = rng.standard_normal(SPARSE_ROWS, dtype=np.float32)
    W_true = rng.standard_normal((SPARSE_COLS, SPARSE_CLASSES), dtype=np.float32)
    y = (val[:, None] * W_true[idx]).argmax(axis=1).astype(np.float32)
    indptr = np.arange(SPARSE_ROWS + 1, dtype=np.int64)
    return sp.csr_matrix((val, idx.astype(np.int64), indptr), shape=(SPARSE_ROWS, SPARSE_COLS)), y


def run_logreg_sparse_path(torch, port, wrappers, dev):
    """Phase path_logreg_sparse: multinomial LogisticRegression on the CSR
    frame through the public API, twice: bit-identical coefficients, no
    dense (N, D) feature tensor on the card, accuracy above the majority
    share; transform; one objective evaluation timed; a profiled fit."""
    from spark_rapids_ml_tpu_torch.ops import logistic

    t0 = time.perf_counter()
    csr, y = sparse_glm_data()
    gen_s = time.perf_counter() - t0
    df = port.DataFrame.from_numpy(csr, y, num_partitions=1)
    est = port.LogisticRegression(**SPARSE_LOGREG)
    port.profiling.reset_counters("lbfgs.")
    first, fit_s, peak, launches = timed_fit(torch, est, df, wrappers)
    solver = port.profiling.counters("lbfgs.")
    second, fit2_s, _, _ = timed_fit(torch, est, df, wrappers)
    check(np.array_equal(first.coef_, second.coef_) and np.array_equal(first.intercept_, second.intercept_),
          "two fits of the same sparse frame differ")
    dense_bytes = SPARSE_ROWS * SPARSE_COLS * 4
    check(peak < dense_bytes, f"the sparse fit peaked at {peak} bytes, not under the dense {dense_bytes}")
    t0 = time.perf_counter()
    pred = concat_col(first.transform(df), "prediction")
    transform_s = time.perf_counter() - t0
    acc = float((pred == y).mean())
    majority = float(np.bincount(y.astype(np.int64)).max() / len(y))
    check(acc > majority, f"accuracy {acc} <= majority share {majority}")

    inputs, ingest_s = synced(torch, lambda: est._build_fit_inputs(df))
    ell = inputs.X
    y_enc = inputs.y.long()
    theta = torch.as_tensor(np.concatenate([first.coef_.ravel(), first.intercept_]).astype(np.float32), device=dev)
    wsum = inputs.weight.sum()
    eval_ms = median_ms(torch, lambda: logistic._data_value_and_grad(
        theta, ell, y_enc, inputs.weight, wsum, SPARSE_CLASSES, SPARSE_COLS, True), 5)
    # bytes the evaluation needs: the ELL pair and its transpose once, the
    # scores written and read back, labels and weights
    eval_bytes = ell.nbytes() + 2 * SPARSE_ROWS * SPARSE_CLASSES * 4 + SPARSE_ROWS * (8 + 4)
    ell_bytes = ell.nbytes()
    del inputs, ell
    profile = profile_run(torch, lambda: est.fit(df), ("core.ingest", "lbfgs.fit"), wrappers)
    del df, csr
    return {
        "phase": "path_logreg_sparse", "rows": SPARSE_ROWS, "cols": SPARSE_COLS, "classes": SPARSE_CLASSES,
        "nnz_per_row": 1, "params": SPARSE_LOGREG, "data_gen_s": gen_s,
        "fit_s": fit_s, "second_fit_s": fit2_s, "identical_fits": True,
        "transform_s": transform_s, "transform_rows_per_s": SPARSE_ROWS / transform_s,
        "max_memory_allocated_bytes": peak, "dense_feature_bytes": dense_bytes, "ell_bytes": ell_bytes,
        "launches": launches, "lbfgs_iterations": solver.get("lbfgs.iterations"),
        "lbfgs_evaluations": solver.get("lbfgs.evaluations"), "converged": bool(solver.get("lbfgs.converged")),
        "accuracy": acc, "majority_share": majority,
        "stages_s": {"ingest": ingest_s, "lbfgs": fit_s - ingest_s},
        "evaluation_ms": eval_ms, "evaluation_bound_ms": 1e3 * eval_bytes / PEAK_BYTES_PER_S,
        "profiled_lbfgs_ms_per_evaluation": profile["range_host_ms"]["lbfgs.fit"] / solver["lbfgs.evaluations"],
        "profile": profile,
    }


def glm_card_vs_cpu(torch, port):
    """Phase glm_card_vs_cpu: the same reduced fits on the card and under
    use_device("cpu"): PCA, OLS, ridge, elastic net, and logistic (binary
    and 4-class, dense and CSR)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(CVC_SEED)
    X = rng.standard_normal((CVC_ROWS, CVC_COLS), dtype=np.float32)
    coef = rng.standard_normal(CVC_COLS, dtype=np.float32)
    y = (X @ coef + np.float32(0.1) * rng.standard_normal(CVC_ROWS, dtype=np.float32)).astype(np.float32)
    W4 = rng.standard_normal((CVC_COLS, 4), dtype=np.float32) / np.float32(8.0)
    noisy = rng.standard_normal((CVC_ROWS, 4), dtype=np.float32)
    y2 = ((X @ W4[:, 0] + noisy[:, 0]) > 0).astype(np.float32)
    y4 = (X @ W4 + noisy).argmax(axis=1).astype(np.float32)
    S = sp.random(CVC_ROWS, CVC_COLS, density=0.05, format="csr", random_state=CVC_SEED, dtype=np.float32)
    S.data = rng.standard_normal(S.nnz, dtype=np.float32)
    s_logits = S @ (W4 * np.float32(8.0)) + noisy
    s2 = (s_logits[:, 0] > 0).astype(np.float32)
    s4 = s_logits.argmax(axis=1).astype(np.float32)
    X_pca = low_rank_data(CVC_ROWS, CVC_COLS, PCA_RANK, CVC_SEED)
    logistic_params = dict(regParam=1e-3, maxIter=200, tol=1e-6)
    cases = [
        ("pca", port.PCA(k=PCA_K), X_pca, None),
        *((name, port.LinearRegression(**params), X, y) for name, params in LINREG_FITS.items()),
        ("logistic_binary", port.LogisticRegression(**logistic_params), X, y2),
        ("logistic_4_class", port.LogisticRegression(**logistic_params), X, y4),
        ("logistic_binary_csr", port.LogisticRegression(**logistic_params), S, s2),
        ("logistic_4_class_csr", port.LogisticRegression(**logistic_params), S, s4),
    ]
    rows = []
    for name, est, feats, labels in cases:
        df = port.DataFrame.from_numpy(feats, labels, num_partitions=2)
        port.profiling.reset_counters()
        card, card_s = synced(torch, lambda: est.fit(df))
        card_counts = port.profiling.counters()
        port.profiling.reset_counters()
        with port.device.use_device("cpu"):
            t0 = time.perf_counter()
            cpu = est.fit(df)
            cpu_s = time.perf_counter() - t0
        cpu_counts = port.profiling.counters()
        rec = {"case": name, "card_fit_s": card_s, "cpu_fit_s": cpu_s}
        if name == "pca":
            a, b = card.components_, cpu.components_
            rec["max_abs_err"] = float(np.abs(a - b).max())
            check(np.array_equal(np.sign(a[np.arange(PCA_K), np.abs(b).argmax(axis=1)]), np.ones(PCA_K)),
                  "card PCA signs differ from the CPU's")
            check(rec["max_abs_err"] <= CVC_PCA_ATOL, f"card and CPU PCA differ: {rec}")
        elif name.startswith("logistic"):
            a = np.concatenate([card.coef_.ravel(), card.intercept_])
            b = np.concatenate([cpu.coef_.ravel(), cpu.intercept_])
            rec.update(max_abs_err=float(np.abs(a - b).max()), scale=float(max(1.0, np.abs(b).max())),
                       iterations_card=card.num_iters, iterations_cpu=cpu.num_iters)
            check(rec["max_abs_err"] <= CVC_LOGISTIC_ATOL * rec["scale"], f"card and CPU logistic differ: {rec}")
        else:
            scale = float(np.abs(cpu.coef_).max())
            rec["max_rel_err"] = float(max(np.abs(card.coef_ - cpu.coef_).max(),
                                           abs(card.intercept_ - cpu.intercept_)) / scale)
            rec["cd_sweeps"] = [card_counts.get("glm.cd_sweeps"), cpu_counts.get("glm.cd_sweeps")]
            check(rec["cd_sweeps"][0] == rec["cd_sweeps"][1], f"CD sweeps differ: {rec}")
            check(rec["max_rel_err"] <= CVC_LINEAR_RTOL, f"card and CPU linear fits differ: {rec}")
        rows.append(rec)
    return {"phase": "glm_card_vs_cpu", "rows": CVC_ROWS, "cols": CVC_COLS,
            "tolerances": {"pca_atol": CVC_PCA_ATOL, "linear_rtol": CVC_LINEAR_RTOL,
                           "logistic_atol": CVC_LOGISTIC_ATOL}, "cases": rows}


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
    for later in ("knn_audit", "knn_streamed", "path_knn_mesh", "knn_ring"):
        if later in phases and "path_knn" not in phases:
            parser.error(f"{later} runs on path_knn's items and results: add path_knn")
    if "knn_ring" in phases and "path_knn_mesh" not in phases:
        parser.error("knn_ring runs on path_knn_mesh's sharded items: add path_knn_mesh")
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
    from spark_rapids_ml_tpu_torch.ops import exchange_kernels as ek
    from spark_rapids_ml_tpu_torch.ops import forest_hist as fh
    from spark_rapids_ml_tpu_torch.ops import knn as knn_ops
    from spark_rapids_ml_tpu_torch.ops import knn_kernels as kk
    from spark_rapids_ml_tpu_torch.ops import nearest_center as nc
    from spark_rapids_ml_tpu_torch.ops import pq_kernels as pk
    from spark_rapids_ml_tpu_torch.ann import ivfflat as ivf
    from spark_rapids_ml_tpu_torch.ann import pq as pq_mod
    from spark_rapids_ml_tpu_torch.parallel import topology

    wrappers = {
        "min_dist_argmin": nc.min_dist_argmin,
        "bin_features_fm": binning.bin_features_fm,
        "node_histograms_mma": fh.node_histograms_mma,
        "node_histograms_atomic": fh.node_histograms_atomic,
        "node_histograms_bucketed": fh.node_histograms_bucketed,
        "knn_candidates": kk.knn_candidates,
        "knn_candidates_audit": kk.knn_candidates_audit,
        "knn_fused_merge": kk.knn_fused_merge,
        "knn_count": kk.knn_count,
        "lut_accumulate": pk.lut_accumulate,
        "lut_accumulate_probed": pk.lut_accumulate_probed,
        "fastscan_lut_accumulate": pk.fastscan_lut_accumulate,
        "fastscan_lut_accumulate_probed": pk.fastscan_lut_accumulate_probed,
        "ring_shift": ek.ring_shift,
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
        unaligned = [check_kernel_shape(torch, nc, n, d, k, gen, dev, misaligned)
                     for n, d, k, misaligned in SHAPES_UNALIGNED]
        emit({"phase": "kernels", "kernel": "min_dist_argmin", "dtype": "float32",
              "peak_fp32_flops": PEAK_FP32_FLOPS, "peak_bytes_per_s": PEAK_BYTES_PER_S,
              "shapes": rows, "unaligned": unaligned})
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
        results["kernels_forest"] = check_forest_kernels(torch, port, binning, fh, _build, X_rf, dev)
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

    if "kernels_knn" in phases:
        results["kernels_knn"] = check_knn_kernels(torch, kk, nc, knn_ops, _build, dev)
        emit(results["kernels_knn"])
    if "kernels_exchange" in phases:
        results["kernels_exchange"] = check_exchange_kernel(torch, ek, topology, dev)
        emit(results["kernels_exchange"])
        emit(check_exchange_peer(torch, ek, topology))
    if "path_knn" in phases:
        t0 = time.perf_counter()
        X_knn = normal_data(KNN_ITEMS, COLS, KNN_ITEM_SEED)
        Q_knn = normal_data(KNN_QUERIES, COLS, KNN_QUERY_SEED)
        emit({"phase": "knn_data", "items": KNN_ITEMS, "queries": KNN_QUERIES, "cols": COLS,
              "seconds": time.perf_counter() - t0})
        results["path_knn"], knn_model, knn_idx, knn_dist = run_knn_path(
            torch, port, knn_ops, wrappers, X_knn, Q_knn, dev)
        emit(results["path_knn"])
        if "knn_audit" in phases:
            results["knn_audit"] = knn_audit(torch, knn_ops, wrappers, knn_model, Q_knn, knn_idx, knn_dist, dev)
            emit(results["knn_audit"])
        if "knn_streamed" in phases:
            emit(knn_streamed(torch, port, knn_ops, wrappers, X_knn, Q_knn, knn_model._staged_items[1],
                              knn_dist, dev))
        if "path_knn_mesh" in phases:
            results["path_knn_mesh"], mesh_prepared = run_knn_mesh_path(
                torch, port, knn_ops, wrappers, X_knn, Q_knn, knn_model._staged_items[1], knn_idx, knn_dist, dev)
            emit(results["path_knn_mesh"])
            if "knn_ring" in phases:
                results["knn_ring"] = knn_ring(torch, port, knn_ops, ek, wrappers, mesh_prepared,
                                               knn_model._staged_items[1], Q_knn, dev)
                emit(results["knn_ring"])
            del mesh_prepared
        del X_knn, knn_model

    if "kernels_ann" in phases:
        results["kernels_ann"] = check_ann_kernels(torch, pk, kk, nc, ivf, pq_mod, _build, dev)
        emit(results["kernels_ann"])
    ann_phases = [p for p in ANN_ARMS if p in phases]
    if ann_phases:
        t0 = time.perf_counter()
        X_ann, Q_ann = ann_data()
        emit({"phase": "ann_data", "items": ANN_ITEMS, "queries": ANN_QUERIES, "cols": ANN_COLS,
              "seconds": time.perf_counter() - t0})
        for phase in ann_phases:
            results[phase] = run_ann_arm(torch, port, ivf, pq_mod, knn_ops, kk, wrappers, phase, X_ann, Q_ann, dev)
            emit(results[phase])
        del X_ann, Q_ann

    if "path_pca" in phases:
        emit(run_pca_path(torch, port, wrappers, dev))
    if {"path_linreg", "path_logreg"} & set(phases):
        t0 = time.perf_counter()
        X_glm, y_glm = glm_data()
        emit({"phase": "glm_data", "rows": GLM_ROWS + GLM_HOLDOUT, "cols": GLM_COLS,
              "seconds": time.perf_counter() - t0})
        if "path_linreg" in phases:
            emit(run_linreg_path(torch, port, wrappers, X_glm, y_glm, dev))
        if "path_logreg" in phases:
            emit(run_logreg_path(torch, port, wrappers, X_glm, y_glm, dev))
        del X_glm, y_glm
    if "path_logreg_sparse" in phases:
        emit(run_logreg_sparse_path(torch, port, wrappers, dev))
    if "glm_card_vs_cpu" in phases:
        emit(glm_card_vs_cpu(torch, port))

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
        reg = results.get("path_rf_reg", {}).get("launches", {})
        r = kf["bin_features_fm"][0]
        rows.append({
            "name": "bin_features_fm", "route": "cuda", "source": KERNEL_SOURCES["bin_features_fm"],
            "replaces": "spark_rapids_ml_tpu/ops/pallas_tpu.py:219", "launches": clf.get("bin_features_fm"),
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": [r[k] for k in ("n", "d", "edges", "n_pad")],
        })
        # B3 at the classifier's level 0 (tensor-core route) and level 6
        # (the atomic route's most frequent launch), launches by route
        clf_levels = {r["level"]: r for r in kf["node_histograms_levels"] if r["path"] == "clf"}
        by_route = {route: {"path_rf_clf": clf.get(f"node_histograms_{route}"),
                            "path_rf_reg": reg.get(f"node_histograms_{route}")} for route in ("mma", "atomic")}
        # (the classifier declares its stats integers: the atomic route's
        # int32 cells)
        for name, r in (("node_histograms_mma", clf_levels[0]), ("node_histograms_atomic", clf_levels[max(clf_levels)])):
            route = name.rsplit("_", 1)[1]
            rows.append({
                "name": name, "route": "cuda", "source": KERNEL_SOURCES[name],
                "replaces": "spark_rapids_ml_tpu/ops/forest_hist.py:73", "launches": clf.get(name),
                "max_abs_err": r[f"max_abs_err_{route}"],
                "ms": r["atomic_int_ms"] if route == "atomic" else r["mma_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "shape": [r[k] for k in ("f_pad", "n", "t_pack", "nodes", "s_dim", "n_bins")],
                "launches_by_route": by_route,
            })
        r = kf["node_histograms_bucketed"][0]
        rows.append({
            "name": "node_histograms_bucketed", "route": "cuda", "source": KERNEL_SOURCES["node_histograms_bucketed"],
            "replaces": "spark_rapids_ml_tpu/ops/forest_hist.py:182", "launches": clf.get("node_histograms_bucketed"),
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": [r[k] for k in ("f_pad", "n", "t_pack_or_buckets", "nodes", "s_dim", "n_bins")],
        })
    kn = results.get("kernels_knn")
    if kn is not None:
        path = results.get("path_knn", {}).get("launches", {})
        audit = results.get("knn_audit", {}).get("launches", {})
        picks = (
            ("knn_candidates", "spark_rapids_ml_tpu/ops/pallas_knn.py:212", path),
            ("knn_candidates_audit", "spark_rapids_ml_tpu/ops/pallas_knn.py:191", audit),
            ("knn_fused_merge", "spark_rapids_ml_tpu/ops/pallas_knn.py:544", path),
            ("knn_count", "spark_rapids_ml_tpu/ops/pallas_knn.py:308", audit),
        )
        mesh = results.get("path_knn_mesh", {}).get("launches", {})
        for name, replaces, launches in picks:
            r = kn[name]
            rows.append({
                "name": name, "route": "cuda", "source": KERNEL_SOURCES[name], "replaces": replaces,
                "launches": launches.get(name), "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], "shape": [r["n"], r["d"], r["q"], r["m"], r["k"]],
                "launches_mesh": mesh.get(name),
            })
    ka = results.get("kernels_ann")
    merge_row = next((row for row in rows if row["name"] == "knn_fused_merge"), None)
    if ka is not None and merge_row is not None:
        # B7 at the ANN arms' pools, each k with the launches of its arm
        arms = dict(zip(ANN_MERGE_KS, ANN_ARMS))
        merge_row["ann_pool"] = [
            {key: r[key] for key in ("q", "pool", "k", "route", "kernel_ms", "window_ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by", "max_abs_err")}
            | {"launches": results.get(arms[r["k"]], {}).get("launches", {}).get("knn_fused_merge"),
               "arm": arms[r["k"]]}
            for r in ka["knn_fused_merge_ann"] if not r["tied"]
        ]
    if ka is not None:
        for name, arm in (("lut_accumulate_probed", "path_ann_pq"), ("fastscan_lut_accumulate_probed", "path_ann_pq4")):
            r = ka[name]
            rows.append({
                "name": name, "route": "cuda", "source": KERNEL_SOURCES[name],
                "replaces": {"lut_accumulate_probed": "spark_rapids_ml_tpu/ops/pallas_pq.py:60",
                             "fastscan_lut_accumulate_probed": "spark_rapids_ml_tpu/ops/pallas_pq.py:170"}[name],
                "launches": results.get(arm, {}).get("launches", {}).get(name), "max_abs_err": r["max_abs_err"],
                "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"], "shape": [r["b"], r["r"], r["m_sub"], r["ksub"]],
            })
    ke = results.get("kernels_exchange")
    if ke is not None:
        r = ke["ring_shift"]
        rows.append({
            "name": "ring_shift", "route": "cuda", "source": KERNEL_SOURCES["ring_shift"],
            "replaces": "spark_rapids_ml_tpu/parallel/exchange.py:484",
            "launches": results.get("knn_ring", {}).get("launches_ring", {}).get("ring_shift"),
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": [r["shards"], *r["shape"]],
        })
    return {"kernels": rows, "seconds": seconds}


PHASES = ["kernels", "path", "kernels_forest", "path_rf_clf", "path_rf_reg", "forest_card_vs_cpu",
          "kernels_knn", "kernels_exchange", "path_knn", "knn_audit", "knn_streamed", "path_knn_mesh", "knn_ring",
          "kernels_ann", "path_ann", "path_ann_pq", "path_ann_pq4", *GLM_PHASES]
KERNEL_SOURCES = {
    "min_dist_argmin": "spark_rapids_ml_tpu_torch/csrc/min_dist_argmin.cu",
    "bin_features_fm": "spark_rapids_ml_tpu_torch/csrc/bin_features_fm.cu",
    "node_histograms_mma": "spark_rapids_ml_tpu_torch/csrc/forest_hist.cu",
    "node_histograms_atomic": "spark_rapids_ml_tpu_torch/csrc/forest_hist.cu",
    "node_histograms_bucketed": "spark_rapids_ml_tpu_torch/csrc/forest_hist.cu",
    "knn_candidates": "spark_rapids_ml_tpu_torch/csrc/knn_topm.cu",
    "knn_candidates_audit": "spark_rapids_ml_tpu_torch/csrc/knn_topm.cu",
    "knn_fused_merge": "spark_rapids_ml_tpu_torch/csrc/knn_merge.cu",
    "knn_count": "spark_rapids_ml_tpu_torch/csrc/knn_topm.cu",
    "lut_accumulate": "spark_rapids_ml_tpu_torch/csrc/pq_lut.cu",
    "lut_accumulate_probed": "spark_rapids_ml_tpu_torch/csrc/pq_lut.cu",
    "fastscan_lut_accumulate": "spark_rapids_ml_tpu_torch/csrc/pq_lut.cu",
    "fastscan_lut_accumulate_probed": "spark_rapids_ml_tpu_torch/csrc/pq_lut.cu",
    "ring_shift": "spark_rapids_ml_tpu_torch/csrc/ring_shift.cu",
}


if __name__ == "__main__":
    sys.exit(main())
