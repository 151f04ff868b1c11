#
# Streaming incremental-fit engines (srml-stream).
#
# Counterpart of spark_rapids_ml_tpu/stream/engines.py: the partial_fit /
# merge / finalize contract over the batch estimators.  Each engine wraps
# one configured estimator, ingests row chunks (numpy blocks, the port's
# DataFrame, or a pandas partition, pandas imported only for that case),
# stages each chunk on the device, computes the chunk's partial statistics
# there, and folds them into a small mergeable StreamState (state.py) in
# float64.  finalize() builds a regular fitted model of the batch model
# class through the estimator's own _materialize_model, so a streamed model
# transforms, persists and loads like its batch twin.
#
# Staging: a chunk is padded to its pow2 row bucket (chunk_bucket, floor
# bucket_lo rows, 256 by default: the JAX package's SRML_STREAM_BUCKET_LO
# as an engine option) in a pinned host buffer, filled by a few threads when
# large, and copied to the card without blocking; pad rows carry zero
# weight.  The engine keeps two buffers for each array of the chunk and
# bucket and uses them in turn, each rewritten only after the event behind
# its last copy has completed, so filling one chunk overlaps the card's
# work on the one before.  The JAX package's AOT executable cache
# (ops/precompile.cached_kernel) has nothing to cache here.
#
# The fold: the state's additive fields stay float64 tensors on the device
# the chunks run on, each chunk's float32 partials added to them there, and
# the running quantities a chunk needs (KMeans's centers, the logistic warm
# start) are derived there too; the host state is brought up to date when
# it is read (state, state_dict, merge, finalize).  The JAX package reads
# each chunk's partials back and adds them in numpy; this makes the same
# float64 additions (and divisions) in the same order, so the same bits.  At
# D = 3000 the JAX layout's readback of a 36-MB Gram and 9M host adds took
# 47.6 ms a chunk of 8,192 rows against 5.9 ms for the device fold, equal
# states, on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py path_stream).
#
# Chunk math runs on one device, in an order fixed by the chunk (never by a
# mesh), so streamed states are device-independent data, and scale-out is
# the state merge across ranks (state.allgather_merge).
#
# Equality contract, as in the JAX package:
#   - linreg / PCA: partial_fit over k chunks equals the port's batch fit on
#     the union bit for bit on the exact data families (integer-valued
#     features, pow2 row counts): the chunk partials are exact float32 sums,
#     the float64 fold is exact, and finalize derives the means (float32
#     quotients) and solves through the batch fit's own functions
#     (ops/glm.solve_linear / solve_elasticnet_cd, ops/linalg's
#     _pca_from_moments) on the same device;
#   - kmeans / logreg: quality-gated; one-pass mini-batch Lloyd and
#     warm-started chunk L-BFGS have no bitwise batch twin.
#
# Counters: stream.h2d_transfers and stream.bytes (each staged array and its
# padded bytes), stream.rows, stream.chunks.  Ranges (record_function, with
# their wall seconds in profiling.phase_times()): stream.update,
# stream.finalize, stream.kmeans_init.
#

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import device as _device
from .. import profiling
from ..utils import materialize_feature_block
from .state import StreamState

# smallest streamed-chunk row bucket (the ANN assign-block floor)
_CHUNK_BUCKET_LO = 256

H2D_COUNTER = "stream.h2d_transfers"
BYTES_COUNTER = "stream.bytes"
# a staging buffer at least this large is filled by _FILL_THREADS threads
_PARALLEL_FILL_BYTES = 32 << 20
_FILL_THREADS = min(8, os.cpu_count() or 1)
_fill_pool: Optional[ThreadPoolExecutor] = None


def chunk_bucket(n: int, lo: int = _CHUNK_BUCKET_LO) -> int:
    """The pow2 row bucket (at least lo) a streamed chunk of n rows is
    staged at."""
    b = max(1, int(lo))
    while b < n:
        b *= 2
    return b


def _chunk_arrays(
    chunk: Any,
    y: Optional[Any],
    weight: Optional[Any],
    dtype: np.dtype,
    input_col: Optional[str],
    input_cols: Optional[List[str]],
    label_col: str,
    weight_col: str,
) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
    """One streamed chunk as host (X, y, w) arrays.  A frame chunk (the
    port's DataFrame, or a pandas partition, converted by
    DataFrame.from_pandas) materializes its feature column(s) as batch
    ingest does and reads labels and weights from the configured columns;
    a numpy chunk passes through with explicit y / weight."""
    from ..dataframe import DataFrame

    if (type(chunk).__module__ or "").startswith("pandas"):
        chunk = DataFrame.from_pandas(chunk)
    if not isinstance(chunk, DataFrame):
        X = np.ascontiguousarray(np.asarray(chunk), dtype=dtype)
        if X.ndim != 2:
            raise ValueError(f"streamed chunk must be 2-D, got shape {X.shape}")
        yv = None if y is None else np.asarray(y)
        wv = None if weight is None else np.asarray(weight)
        for name, v in (("y", yv), ("weight", wv)):
            if v is not None and v.shape[0] != X.shape[0]:
                # a zero pad would fold fabricated labels at full weight
                raise ValueError(f"chunk {name} has {v.shape[0]} rows but X has {X.shape[0]}")
        return X, yv, wv
    if y is not None or weight is not None:
        raise ValueError("frame chunks carry labels/weights in their own columns; pass y/weight only with numpy chunks")
    if chunk._device_features is not None:
        raise ValueError("streamed chunks are host rows; DataFrame.from_device frames are not taken")
    parts = [p for p in chunk.partitions if len(p)]
    if not parts:
        return np.zeros((0, 0), dtype=dtype), None, None
    missing = [c for c in ([input_col] if input_col is not None else input_cols or []) if c not in parts[0].columns]
    if missing:
        raise ValueError(f"Input column(s) {missing} not found in the chunk's columns {parts[0].columns}")
    Xs, ys, ws = [], [], []
    for part in parts:
        Xs.append(materialize_feature_block(part, input_col, input_cols, dtype))
        if label_col in part.columns:
            ys.append(np.asarray(part[label_col]))
        if weight_col in part.columns:
            ws.append(np.asarray(part[weight_col], dtype))
    X = np.concatenate(Xs) if len(Xs) > 1 else Xs[0]
    yv = (np.concatenate(ys) if len(ys) > 1 else ys[0]) if ys else None
    wv = (np.concatenate(ws) if len(ws) > 1 else ws[0]) if ws else None
    return X, yv, wv


def _fill(host: np.ndarray, a: np.ndarray) -> None:
    """host[:n] = a (cast to host's dtype) and the pad rows zeroed; a large
    copy split by rows over a thread pool (numpy copies without the GIL)."""
    global _fill_pool
    n = a.shape[0]
    if a.nbytes >= _PARALLEL_FILL_BYTES and _FILL_THREADS > 1:
        if _fill_pool is None:
            _fill_pool = ThreadPoolExecutor(_FILL_THREADS, thread_name_prefix="stream-fill")
        bounds = np.linspace(0, n, _FILL_THREADS + 1, dtype=int)
        list(_fill_pool.map(lambda j: np.copyto(host[bounds[j] : bounds[j + 1]], a[bounds[j] : bounds[j + 1]]),
                            range(_FILL_THREADS)))
    else:
        host[:n] = a
    host[n:] = 0


class _Stager:
    """Two pinned host buffers for each (array of the chunk, bucket), used
    in turn, and their non-blocking copies to the device (plain host tensors
    on the CPU, where the computation that reads a buffer has ended before
    the next chunk is written into it)."""

    def __init__(self) -> None:
        self._buffers: Dict[tuple, list] = {}

    def stage(self, name: str, arr: np.ndarray, bucket: int, dtype: np.dtype, dev: torch.device) -> torch.Tensor:
        a = np.asarray(arr)
        key = (name, bucket, a.shape[1:], np.dtype(dtype).str, dev.type)
        slots = self._buffers.setdefault(key, [None, None, 0])  # two (buffer, event) and the next one's index
        turn = slots[2]
        slots[2] = 1 - turn
        if slots[turn] is None:
            like = torch.from_numpy(np.zeros(0, dtype))
            buf, done = torch.empty((bucket,) + a.shape[1:], dtype=like.dtype, pin_memory=dev.type == "cuda"), None
        else:
            buf, done = slots[turn]
            if done is not None:
                done.synchronize()  # the last copy out of this buffer has ended
        _fill(buf.numpy(), a)
        if dev.type == "cuda":
            out = buf.to(dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            out = buf.to(dev)
        slots[turn] = (buf, done)
        profiling.incr_counter(H2D_COUNTER)
        profiling.incr_counter(BYTES_COUNTER, int(buf.nbytes))
        return out


class StreamingEngine:
    """Shared partial_fit plumbing: the wrapped estimator's columns, chunk
    staging, row accounting and the state's wire helpers."""

    kind: str = ""

    # the state field whose trailing axis is the feature width: a fresh
    # engine that adopts a peer's state recovers n_cols without a chunk
    _N_COLS_FIELD = {"pca": "xwsum", "linreg": "xwsum", "logreg": "WS", "kmeans": "init_centers"}

    def __init__(self, estimator: Any, bucket_lo: int = _CHUNK_BUCKET_LO):
        if int(bucket_lo) < 1:
            raise ValueError(f"bucket_lo must be >= 1, got {bucket_lo}")
        self._estimator = estimator
        self._params: Dict[str, Any] = dict(estimator._tpu_params)
        self._input_col, self._input_cols = estimator._get_input_columns()
        self._label_col = (
            estimator.getOrDefault("labelCol")
            if estimator.hasParam("labelCol") and estimator.isDefined("labelCol")
            else "label"
        )
        self._weight_col = (
            estimator.getOrDefault("weightCol")
            if estimator.hasParam("weightCol") and estimator.isDefined("weightCol")
            else "weight"
        )
        self._dtype = np.dtype(np.float32)  # streaming is float32 only, as in the JAX package
        self._bucket_lo = int(bucket_lo)
        self._stager = _Stager()
        self._n_cols: Optional[int] = None
        self._rows = 0
        self._chunks = 0
        self._state: Optional[StreamState] = None
        # the additive fields as float64 tensors on _acc_dev; the host
        # state's copies of them are behind while _acc_ahead
        self._acc: Optional[Dict[str, torch.Tensor]] = None
        self._acc_dev: Optional[torch.device] = None
        self._acc_ahead = False

    # -- public surface ----------------------------------------------------
    @property
    def rows_ingested(self) -> int:
        return self._rows

    @property
    def chunks_ingested(self) -> int:
        return self._chunks

    @property
    def state(self) -> StreamState:
        if self._state is None:
            raise RuntimeError(
                f"Streaming{type(self._estimator).__name__} has ingested no chunks yet; call partial_fit first"
            )
        if self._acc_ahead:  # read the device's float64 fields back
            for name, t in self._acc.items():
                self._state.arrays[name] = t.to("cpu", copy=True).numpy()
            self._acc_ahead = False
        return self._state

    def state_dict(self) -> Dict[str, Any]:
        """The state's JSON-able wire form (srml-stream/v1)."""
        return self.state.to_dict()

    def merge(self, other: Any) -> "StreamingEngine":
        """Fold another stream's state into this engine: a peer engine, a
        StreamState, or its wire dict (the JAX package's included).  Rows
        and chunks sum; a fresh engine adopts the peer state whole, its
        identity anchors included."""
        if isinstance(other, StreamingEngine):
            peer, rows, chunks = other.state, other._rows, other._chunks
        elif isinstance(other, StreamState):
            peer, rows, chunks = other, 0, 0
        else:
            peer, rows, chunks = StreamState.from_dict(other), 0, 0
        if peer.kind != self.kind:
            raise ValueError(f"cannot merge a stream state of kind {peer.kind!r} into a {self.kind!r} engine")
        self._state = peer.copy() if self._state is None else self.state.merge(peer)
        self._acc = None  # the next fold starts from the merged host state
        if self._n_cols is None:
            self._n_cols = int(self._state.arrays[self._N_COLS_FIELD[self.kind]].shape[-1])
        self._rows += rows
        self._chunks += chunks
        self._post_merge()
        return self

    def partial_fit(self, chunk: Any, y: Any = None, weight: Any = None) -> "StreamingEngine":
        """Ingest one chunk: stage it at its bucket, run the engine's chunk
        update on the device, fold the partials into the state."""
        X, yv, wv = _chunk_arrays(
            chunk, y, weight, self._dtype, self._input_col, self._input_cols, self._label_col, self._weight_col
        )
        n = X.shape[0]
        if n == 0:
            return self
        if self._n_cols is None:
            self._n_cols = int(X.shape[1])
        elif int(X.shape[1]) != self._n_cols:
            raise ValueError(f"chunk feature width {X.shape[1]} != stream width {self._n_cols}")
        if wv is None:
            wv = np.ones(n, self._dtype)
        dev = _device.resolve()
        with profiling.phase("stream.update"):
            self._update(X, yv, np.asarray(wv, self._dtype), dev)
        self._rows += n
        self._chunks += 1
        profiling.incr_counter("stream.rows", n)
        profiling.incr_counter("stream.chunks")
        return self

    def finalize(self) -> Any:
        """A fitted model of the batch model class from the accumulated
        state, through the estimator's own _materialize_model."""
        dev = _device.resolve()
        with profiling.phase("stream.finalize", dev):
            return self._estimator._materialize_model(self._finalize_result(dev))

    # -- engine hooks ------------------------------------------------------
    def _stage(self, name: str, arr: np.ndarray, dev: torch.device, dtype: Any = None) -> torch.Tensor:
        """One array of the chunk (`name`: X, y or w) on the device, padded
        to the chunk's bucket."""
        return self._stager.stage(name, arr, chunk_bucket(arr.shape[0], self._bucket_lo), dtype or self._dtype, dev)

    def _fold(self, partials: Dict[str, torch.Tensor], dev: torch.device) -> None:
        """Fold one chunk's partials (tensors on `dev`) into the state's
        float64 accumulators on `dev` (module header)."""
        if self._acc is None or self._acc_dev != dev:
            host = self.state.arrays
            self._acc = {name: torch.from_numpy(host[name]).to(dev, copy=True) for name in partials}
            self._acc_dev = dev
        for name, t in partials.items():
            self._acc[name].add_(t.to(torch.float64))
        self._acc_ahead = True

    def _running(self, dev: torch.device) -> Dict[str, torch.Tensor]:
        """The state's fields as float64 tensors on `dev`: the device
        accumulators where they are, else the host state's."""
        if self._acc is not None and self._acc_dev == dev:
            return self._acc
        return {name: torch.from_numpy(a).to(dev) for name, a in self.state.arrays.items()}

    def _update(self, X: np.ndarray, y: Optional[np.ndarray], w: np.ndarray, dev: torch.device) -> None:
        raise NotImplementedError

    def _finalize_result(self, dev: torch.device) -> Dict[str, Any]:
        raise NotImplementedError

    def _post_merge(self) -> None:
        pass

    def _need_labels(self, y: Optional[np.ndarray]) -> None:
        if y is None:
            raise ValueError(
                f"{type(self).__name__} chunks need labels (y= for numpy chunks, a {self._label_col!r} column for "
                "frame chunks)"
            )


class StreamingPCA(StreamingEngine):
    """PCA over a row stream: each chunk's weighted moments
    (ops/linalg.stream_moments_chunk_kernel) folded into float64 (wsum,
    xwsum, scatter); finalize runs the batch fit's covariance and float64
    eigh on the accumulated moments (ops/linalg.pca_finalize_moments)."""

    kind = "pca"

    def _update(self, X, y, w, dev) -> None:
        from ..ops.linalg import stream_moments_chunk_kernel

        parts = stream_moments_chunk_kernel(self._stage("X", X, dev), self._stage("w", w, dev))
        if self._state is None:
            d = self._n_cols
            self._state = StreamState("pca", {"wsum": np.zeros(()), "xwsum": np.zeros(d), "scatter": np.zeros((d, d))})
        self._fold(dict(zip(("wsum", "xwsum", "scatter"), parts)), dev)

    def _finalize_result(self, dev) -> Dict[str, Any]:
        from ..ops.linalg import pca_finalize_moments

        st = self.state.arrays
        d = self._n_cols
        k = min(int(self._params.get("n_components") or min(self._rows, d)), d)
        # the exact float64 fold goes down to the compute dtype before the
        # mean is derived: the batch fit's float32 quotient
        mean, components, var, ratio, sv = pca_finalize_moments(
            *(st[name].astype(self._dtype) for name in ("wsum", "xwsum", "scatter")), k, dev
        )
        return {
            "mean_": mean,
            "components_": components,
            "explained_variance_": var,
            "explained_variance_ratio_": ratio,
            "singular_values_": sv,
            "n_cols": self._n_cols,
            "dtype": str(self._dtype),
        }


class StreamingLinearRegression(StreamingEngine):
    """Linear regression over a row stream: each chunk's unreduced
    sufficient statistics (ops/glm.stream_linreg_chunk_kernel) folded into
    float64; finalize solves them with the batch fit's solver choice
    (ops/glm.solve_linear / solve_elasticnet_cd) and its host float64
    intercept."""

    kind = "linreg"

    def _update(self, X, y, w, dev) -> None:
        from ..ops.glm import stream_linreg_chunk_kernel

        self._need_labels(y)
        parts = stream_linreg_chunk_kernel(
            self._stage("X", X, dev), self._stage("y", np.asarray(y, self._dtype), dev), self._stage("w", w, dev)
        )
        names = ("wsum", "xwsum", "G", "ysum", "c", "y2")
        if self._state is None:
            d = self._n_cols
            self._state = StreamState("linreg", {
                "wsum": np.zeros(()), "xwsum": np.zeros(d), "G": np.zeros((d, d)),
                "ysum": np.zeros(()), "c": np.zeros(d), "y2": np.zeros(()),
            })
        self._fold(dict(zip(names, parts)), dev)

    def _finalize_result(self, dev) -> Dict[str, Any]:
        from ..models.linear_regression import _host_intercept
        from ..ops.glm import LinregStats, solve_elasticnet_cd, solve_linear

        st = self.state.arrays

        def t(name: str) -> torch.Tensor:
            return torch.from_numpy(st[name].astype(self._dtype)).to(dev)

        wsum = t("wsum")
        # the means as the batch fit derives them: float32 quotients on the
        # device
        stats = LinregStats(wsum, t("xwsum") / wsum, t("ysum") / wsum, t("G"), t("c"), t("y2"))
        p = self._params
        alpha, l1_ratio = float(p["alpha"]), float(p["l1_ratio"])
        fit_intercept, normalize = bool(p["fit_intercept"]), bool(p["normalize"])
        if alpha == 0.0 or l1_ratio == 0.0:  # the batch fit's solver choice
            coef, _ = solve_linear(stats, alpha, fit_intercept=fit_intercept, normalize=normalize)
        else:
            coef, _, n_iter = solve_elasticnet_cd(
                stats, alpha, l1_ratio, fit_intercept=fit_intercept, normalize=normalize,
                max_iter=int(p["max_iter"]), tol=float(p["tol"]),
            )
            profiling.incr_counter("glm.cd_sweeps", n_iter)
        coef64 = coef.cpu().numpy().astype(np.float64)
        return {
            "coef_": coef64,
            "intercept_": _host_intercept(coef64, stats.x_mean.cpu().numpy(), stats.y_mean.cpu().numpy(),
                                          fit_intercept),
            "n_cols": self._n_cols,
            "dtype": str(self._dtype),
        }


class StreamingKMeans(StreamingEngine):
    """Mini-batch Lloyd over a row stream: the first chunk trains the
    initial centers with the batch fit's init and Lloyd iterations
    (ops/kmeans), then every chunk assigns its rows to the running centers
    (ops/kmeans.stream_kmeans_chunk_kernel) and folds weighted per-center
    sums and counts into the state, so a running center is the weighted
    mean of every row ever assigned to it.  Merge adds (sums, counts);
    streams must share the init anchor."""

    kind = "kmeans"

    def __init__(self, estimator: Any, **options: Any):
        super().__init__(estimator, **options)
        self._init_centers: Optional[np.ndarray] = None

    def _init_from_chunk(self, X: np.ndarray, w: np.ndarray, dev: torch.device) -> np.ndarray:
        from ..ops.kmeans import lloyd_iterations, random_init, scalable_kmeans_pp_init

        p = self._params
        k = int(p["n_clusters"])
        generator = torch.Generator().manual_seed(int(p["random_state"]) & 0x7FFFFFFF)
        Xd = torch.from_numpy(X).to(dev)
        wd = torch.from_numpy(w).to(dev)
        chunk = min(int(p["max_samples_per_batch"]), X.shape[0])
        if p["init"] == "random":
            centers0 = random_init(Xd, wd, k, generator)
        else:
            round_size = max(1, min(int(float(p["oversampling_factor"]) * k), X.shape[0]))
            centers0 = scalable_kmeans_pp_init(Xd, wd, k, generator, rounds=4, round_size=round_size, chunk=chunk)
        centers, _, _ = lloyd_iterations(Xd, wd, centers0, int(p["max_iter"]), float(p["tol"]), chunk)
        return centers.cpu().numpy().astype(np.float64)

    def _update(self, X, y, w, dev) -> None:
        from ..ops.kmeans import stream_kmeans_chunk_kernel

        if self._init_centers is None:
            with profiling.phase("stream.kmeans_init", dev):
                self._init_centers = self._init_from_chunk(X, w, dev)
        if self._state is None:
            k, d = self._init_centers.shape
            self._state = StreamState("kmeans", {
                "sums": np.zeros((k, d)), "counts": np.zeros(k), "cost": np.zeros(()),
                "init_centers": self._init_centers,
            })
        centers = self._running_centers(dev).to(torch.float32)
        sums, counts, cost = stream_kmeans_chunk_kernel(self._stage("X", X, dev), self._stage("w", w, dev), centers)
        self._fold({"sums": sums, "counts": counts, "cost": cost}, dev)

    def _running_centers(self, dev: torch.device) -> torch.Tensor:
        """The exact weighted mean of every row assigned to each center so
        far (the init center where none was), float64 on `dev`: the same
        divisions as the JAX package's host numpy."""
        st = self._running(dev)
        counts = st["counts"]
        init = torch.from_numpy(self._init_centers).to(dev)
        return torch.where((counts > 0)[:, None], st["sums"] / counts.clamp_min(1.0)[:, None], init)

    def _post_merge(self) -> None:
        self._init_centers = self.state.arrays["init_centers"]

    def _finalize_result(self, dev) -> Dict[str, Any]:
        return {
            "cluster_centers_": self._running_centers(torch.device("cpu")).numpy(),
            "n_cols": self._n_cols,
            "dtype": str(self._dtype),
            "n_iter_": self._chunks,
            "inertia_": float(self.state.arrays["cost"]),
        }


class StreamingLogisticRegression(StreamingEngine):
    """Logistic regression over a row stream: each chunk runs the batch
    objective's L-BFGS / OWL-QN warm-started from the running coefficients
    (ops/logistic.logistic_warm_fit_kernel), and the state folds
    weight-scaled coefficient sums (iterate averaging), so a merge across
    ranks is the row-weighted mean of their streams.  The class set is an
    identity anchor: declared up front (classes=) or found in the first
    chunk; a later chunk with an unseen label fails."""

    kind = "logreg"

    def __init__(self, estimator: Any, classes: Optional[Any] = None, **options: Any):
        super().__init__(estimator, **options)
        self._classes = None if classes is None else np.unique(np.asarray(classes, np.float64))

    def _update(self, X, y, w, dev) -> None:
        from ..ops.logistic import logistic_warm_fit_kernel

        self._need_labels(y)
        yv = np.asarray(y, np.float64)
        classes = np.unique(yv) if self._classes is None else self._classes
        if len(classes) < 2:
            raise ValueError(
                "first chunk holds a single label class; declare the full class set via "
                "streaming(classes=...) when early chunks may be single-class"
            )
        idx = np.clip(np.searchsorted(classes, yv), 0, len(classes) - 1)
        if not np.array_equal(classes[idx], yv):
            unseen = sorted(set(np.unique(yv)) - set(classes))
            raise ValueError(
                f"chunk contains labels outside the stream's class set: {unseen}; declare them up front via "
                "streaming(classes=...)"
            )
        # the class set is fixed only by a chunk that passed the checks
        self._classes = classes
        kcls = 1 if len(classes) == 2 else len(classes)
        if self._state is None:
            d = self._n_cols
            self._state = StreamState("logreg", {
                "WS": np.zeros((kcls, d)), "bs": np.zeros((kcls,)), "wsum": np.zeros(()), "classes": classes,
            })
        W0, b0 = self._running_coefs(dev)
        p = self._params
        C = float(p["C"])
        reg = 1.0 / C if C > 0 else 0.0
        l1_ratio = float(p.get("l1_ratio") or 0.0)
        W, b = logistic_warm_fit_kernel(
            self._stage("X", X, dev), self._stage("y", idx.astype(np.int32), dev, np.int32), self._stage("w", w, dev),
            W0.to(torch.float32), b0.to(torch.float32), reg, l1_ratio, float(p["tol"]), k=kcls,
            fit_intercept=bool(p["fit_intercept"]), max_iter=int(p["max_iter"]), use_owlqn=reg > 0 and l1_ratio > 0,
        )[:2]
        cw = float(np.asarray(w, np.float64).sum())
        self._fold({"WS": W.to(torch.float64) * cw, "bs": b.to(torch.float64) * cw,
                    "wsum": torch.tensor(cw, dtype=torch.float64, device=dev)}, dev)

    def _running_coefs(self, dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The row-weighted average of every chunk's coefficients, float64
        on `dev` (zeros before the first chunk's fold)."""
        st = self._running(dev)
        wsum = st["wsum"].clamp_min(1e-30)
        return st["WS"] / wsum, st["bs"] / wsum

    def _post_merge(self) -> None:
        self._classes = self.state.arrays["classes"]

    def _finalize_result(self, dev) -> Dict[str, Any]:
        W, b = self._running_coefs(torch.device("cpu"))
        return {
            "coef_": W.numpy(),
            "intercept_": b.numpy(),
            "classes_": np.asarray(self._classes, np.float64),
            "n_cols": self._n_cols,
            "dtype": str(self._dtype),
            "num_iters": self._chunks,
        }


_ENGINES = {
    "KMeans": StreamingKMeans,
    "PCA": StreamingPCA,
    "LinearRegression": StreamingLinearRegression,
    "LogisticRegression": StreamingLogisticRegression,
}


def streaming_fit(estimator: Any, **kwargs: Any) -> StreamingEngine:
    """The streaming engine of a configured estimator: the functional form
    of the estimators' streaming() hooks."""
    name = type(estimator).__name__
    cls = _ENGINES.get(name)
    if cls is None:
        raise TypeError(
            f"{name} has no streaming engine; streamable estimators: {sorted(_ENGINES)} (forest and UMAP "
            "streaming are non-goals, as in the JAX package)"
        )
    return cls(estimator, **kwargs)
