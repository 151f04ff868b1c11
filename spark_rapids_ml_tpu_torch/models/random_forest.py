#
# RandomForest classifier/regressor estimators and models.
#
# Counterpart of spark_rapids_ml_tpu/models/random_forest.py: the same Spark
# param mapping, max_features mapping and solver defaults, the same model
# attributes (dense per-node arrays features_, thresholds_, leaf_values_,
# node_counts_, impurities_), and the same output columns — prediction, plus
# probability and rawPrediction for the classifier.
#
# The fit: quantile edges from a bounded strided row sample (each shard's
# valid rows strided down to its quota, the sample budget divided over the
# shard count, as the JAX package divides it), then one of two growths, by
# the JAX package's _mxu_eligible rule with "TPU backend" read as "the
# port's histogram builder":
#   - a one-shard fit within the histogram builder's limits (bins <= 128,
#     max_features <= 1024, a depth the slot budget covers) bins into the
#     feature-major int8 layout (kernel B2), draws per-tree Poisson(1)
#     bootstrap weights from a seeded torch.Generator on the bins' device,
#     and grows level-wise on the node histograms (ops/forest_grow.py,
#     kernels B3 and B4);
#   - every other fit — more than one shard, or outside those limits —
#     bins each shard with B2 (one launch a group of <= 127 edges) and grows
#     on the scatter engine (ops/forest.grow_forest), the trees in the JAX
#     package's chunks (a chunk's seed seed + 7919 * t0).  Its bootstrap
#     weights come from one seeded CPU torch.Generator over the global valid
#     rows, sliced to the shards, so one seed gives one forest on any shard
#     count.
# Either bootstrap differs from the JAX package's jax.random.poisson draws;
# without bootstrap the engine's forests equal the JAX package's on the same
# shard count, node for node where the stats are integers.
#
# Model selection: fitMultiple bins once (once for each distinct maxBins
# and growth) and grows each param map's forest over the same bins;
# _combine concatenates the sub-models' trees along the tree axis with
# their counts (tree_counts, kept through persistence), and
# _transformEvaluate scores every sub-model in one pass over each partition
# (RegressionEvaluator for the regressor, MulticlassClassificationEvaluator
# for the classifier).
#
# _serving_entry serves one forest traversal of a padded batch
# (ops/forest.forest_predict, serving/entry.kernel_entry), the outputs
# mapped as transform() maps them.
#
# Across processes (parallel/runner.py) the binning sample is each rank's
# strided rows gathered over the control plane in rank order (the quota
# divides the budget over the global shard count), the bootstrap draws
# index the job's valid rows (mesh.valid_spans), and every multi-rank fit
# grows on the scatter engine, whose histogram psum crosses the processes.
#
# trees_to_dicts exports the forest as the JAX package's nested dicts, and
# cpu() converts it to the pyspark.ml forest model through them
# (spark/interop.py; it needs pyspark and an active SparkSession).
#

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch
from torch.profiler import record_function

from .. import device as _device
from ..core import (
    FitInputs,
    _release_fit_features,
    _TpuEstimatorSupervised,
    _TpuModelWithPredictionCol,
    discover_label_classes,
)
from ..dataframe import DataFrame
from ..ops.forest import bin_features_feature_major, bin_features_wide, compute_bin_edges, forest_predict
from ..ops.forest import grow_forest as grow_forest_engine
from ..ops.forest_grow import depth_supported, grow_forest
from ..ops.forest_hist import ROW_TILE
from ..ops.labels import encode_labels
from ..parallel.mesh import valid_spans
from ..params import (
    HasFeaturesCol,
    HasFeaturesCols,
    HasLabelCol,
    HasPredictionCol,
    HasProbabilityCol,
    HasRawPredictionCol,
    HasSeed,
    HasVerbose,
    HasWeightCol,
    Param,
    TypeConverters,
    _dummy,
    _TpuParams,
)
from ..utils import get_logger
from .linear_regression import _RegressionModelEvaluationMixIn
from .logistic_regression import _ClassificationModelEvaluationMixIn

_MAX_SUPPORTED_DEPTH = 16  # dense tree layout: 2^(d+1)-1 node slots
# the limits of histogram growth (the JAX package's _mxu_eligible)
_MAX_BINS = 128
_MAX_FEATURES = 1024
# binning sample: at most this many rows and this many bytes
_BINNING_SAMPLE_ROWS = 16_384
_BINNING_SAMPLE_BYTES = 32 << 20


def _binning_quota(n_cols: int, itemsize: int, n_shards: int) -> int:
    """Rows each shard may give the binning sample: the row/byte budget
    divided over the shard count (the floor sits on the total)."""
    budget = max(2048, min(_BINNING_SAMPLE_ROWS, _BINNING_SAMPLE_BYTES // max(1, n_cols * itemsize)))
    return max(1, budget // max(1, n_shards))


def _binning_rows(shard_weight: np.ndarray, quota: int) -> np.ndarray:
    """One shard's sampled row indices: its rows with weight > 0,
    ceil-strided over the whole range down to the quota."""
    idx = np.flatnonzero(shard_weight > 0)
    if idx.size > quota:
        idx = idx[:: -(-idx.size // quota)]
    return idx


def _binning_sample(inputs: FitInputs) -> np.ndarray:
    """The binning sample on the host: each shard's strided rows, in shard
    order; across processes every rank's, gathered in rank order over the
    control plane (the quota divides the budget over the global shards, so
    the gathered total stays within it)."""
    quota = _binning_quota(inputs.n_cols, inputs.X[0].element_size(), inputs.mesh.size)
    parts = []
    for x, w in zip(inputs.X, inputs.weight):
        rows = _binning_rows(w.cpu().numpy(), quota)
        if rows.size:
            parts.append(x[torch.from_numpy(rows).to(x.device)].cpu().numpy())
    local = np.concatenate(parts) if parts else np.zeros((0, inputs.n_cols), dtype=inputs.dtype)
    if inputs.nranks > 1 and inputs.control_plane is not None:
        from ..parallel.runner import allgather_ndarray

        local = np.concatenate(allgather_ndarray(inputs.control_plane, inputs.rank, local)).astype(
            inputs.dtype, copy=False)
    return local


def _on_histogram_builder(mesh_size: int, n_bins: int, max_features: int, max_depth: int, s_split: int) -> bool:
    """Whether a fit grows on the histogram builder (ops/forest_grow.py):
    one shard and within its limits (the JAX package's _mxu_eligible).
    Every other fit grows on the scatter engine."""
    return (
        mesh_size == 1
        and n_bins <= _MAX_BINS
        and max_features <= _MAX_FEATURES
        and depth_supported(max_depth, s_split)
    )


def _engine_tree_chunk(n_trees: int, max_depth: int, n_cols: int, max_features: int, n_pad: int, s_dim: int) -> int:
    """Trees a scatter-engine run grows together (the JAX package's
    chunking): the (combined, D) feature-subset scores of the deepest level
    within 512 MB, the per-tree stats within 2 GB."""
    t_sub = max(1, (512 << 20) // max(1, (2**max_depth) * n_cols * 4)) if max_features < n_cols else n_trees
    t_stats = max(1, (2 << 30) // max(1, n_pad * s_dim * 4))
    return max(1, min(n_trees, t_sub, t_stats))


def _engine_tree_stats(stats, weight, counts, n_trees: int, n_rows: int):
    """Per-shard (S, Tc, n_loc) bootstrap-weighted stats: stats (S, n_loc)
    times weight (n_loc,) times the bootstrap counts (Tc, n_rows) of the
    global valid rows (None: no bootstrap), each shard taking its slice
    (mesh.valid_spans: across processes, its rank's)."""
    out = []
    spans = valid_spans([int(w.shape[0]) for w in weight], n_rows)
    for st, w, (start, take) in zip(stats, weight, spans):
        n_loc = int(w.shape[0])
        if counts is None:
            w_t = w[None, :].expand(n_trees, n_loc)
        else:
            bw = torch.zeros((counts.shape[0], n_loc), dtype=counts.dtype)
            bw[:, :take] = counts[:, start : start + take]
            w_t = w[None, :] * bw.to(device=w.device, dtype=w.dtype)
        out.append(st[:, None, :] * w_t[None])
    return out


def _str_or_numerical(value: str) -> Union[str, float, int]:
    """'0.3' -> 0.3, '5' -> 5, else the string."""
    try:
        return int(value)
    except (TypeError, ValueError):
        try:
            return float(value)
        except (TypeError, ValueError):
            return value


def _resolve_max_features(value: Any, n_cols: int, is_classification: bool, n_trees: int) -> int:
    """Spark featureSubsetStrategy semantics: auto = all when numTrees == 1,
    else sqrt (classification) / onethird (regression)."""
    if value == "auto" or value is None:
        if n_trees == 1:
            return n_cols
        return max(1, int(math.sqrt(n_cols))) if is_classification else max(1, int(n_cols / 3.0))
    if value == "sqrt":
        return max(1, int(math.sqrt(n_cols)))
    if value == "log2":
        return max(1, int(math.log2(n_cols)))
    if isinstance(value, float):
        return max(1, min(n_cols, int(value * n_cols)))
    return max(1, min(n_cols, int(value)))


class _RandomForestClass(_TpuParams):
    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        return {
            "maxBins": "n_bins",
            "maxDepth": "max_depth",
            "numTrees": "n_estimators",
            "impurity": "split_criterion",
            "featureSubsetStrategy": "max_features",
            "bootstrap": "bootstrap",
            "seed": "random_state",
            "minInstancesPerNode": "min_samples_leaf",
            "minInfoGain": "",
            "maxMemoryInMB": "",
            "cacheNodeIds": "",
            "checkpointInterval": "",
            "subsamplingRate": "",
            "minWeightFractionPerNode": "",
            "weightCol": None,
            "leafCol": None,
        }

    @classmethod
    def _param_value_mapping(cls):
        def _subset_mapping(v):
            maybe = _str_or_numerical(v) if isinstance(v, str) else v
            if isinstance(maybe, (int, float)) and not isinstance(maybe, bool):
                return maybe
            return {"onethird": 1 / 3.0, "all": 1.0, "auto": "auto", "sqrt": "sqrt", "log2": "log2"}.get(maybe)

        return {"max_features": _subset_mapping}

    @classmethod
    def _get_tpu_params_default(cls) -> Dict[str, Any]:
        return {
            "n_estimators": 100,
            "max_depth": 16,
            "max_features": "auto",
            "n_bins": 128,
            "bootstrap": True,
            "verbose": False,
            "min_samples_leaf": 1,
            "min_samples_split": 2,
            "max_samples": 1.0,
            "max_leaves": -1,
            "min_impurity_decrease": 0.0,
            "random_state": None,
            "max_batch_size": 4096,
        }


class _RandomForestParams(
    _RandomForestClass,
    HasFeaturesCol,
    HasFeaturesCols,
    HasLabelCol,
    HasPredictionCol,
    HasSeed,
    HasWeightCol,
    HasVerbose,
):
    numTrees = Param(_dummy(), "numTrees", "number of trees to train (>= 1)", TypeConverters.toInt)
    maxDepth = Param(_dummy(), "maxDepth", "maximum depth of the tree (>= 0, <= 16)", TypeConverters.toInt)
    maxBins = Param(_dummy(), "maxBins", "max number of bins for discretizing continuous features", TypeConverters.toInt)
    impurity = Param(_dummy(), "impurity", "criterion used for information gain calculation", TypeConverters.toString)
    featureSubsetStrategy = Param(_dummy(), "featureSubsetStrategy", "number of features to consider per split (auto|all|onethird|sqrt|log2|n|fraction)", TypeConverters.toString)
    bootstrap = Param(_dummy(), "bootstrap", "whether bootstrap samples are used", TypeConverters.toBoolean)
    minInstancesPerNode = Param(_dummy(), "minInstancesPerNode", "minimum number of instances each child must have after split", TypeConverters.toInt)
    minInfoGain = Param(_dummy(), "minInfoGain", "minimum information gain for a split (ignored)", TypeConverters.toFloat)
    subsamplingRate = Param(_dummy(), "subsamplingRate", "fraction of data used per tree (ignored)", TypeConverters.toFloat)
    maxMemoryInMB = Param(_dummy(), "maxMemoryInMB", "max memory for histogram aggregation (ignored)", TypeConverters.toInt)
    cacheNodeIds = Param(_dummy(), "cacheNodeIds", "ignored", TypeConverters.toBoolean)
    checkpointInterval = Param(_dummy(), "checkpointInterval", "ignored", TypeConverters.toInt)
    minWeightFractionPerNode = Param(_dummy(), "minWeightFractionPerNode", "ignored", TypeConverters.toFloat)

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self._setDefault(
            numTrees=20,
            maxDepth=5,
            maxBins=32,
            featureSubsetStrategy="auto",
            bootstrap=True,
            minInstancesPerNode=1,
            minInfoGain=0.0,
            subsamplingRate=1.0,
            maxMemoryInMB=256,
            cacheNodeIds=False,
            checkpointInterval=10,
            minWeightFractionPerNode=0.0,
        )

    def setNumTrees(self, value: int):
        return self._set_params(numTrees=value)

    def setMaxDepth(self, value: int):
        return self._set_params(maxDepth=value)

    def setMaxBins(self, value: int):
        return self._set_params(maxBins=value)

    def setImpurity(self, value: str):
        return self._set_params(impurity=value)

    def setFeatureSubsetStrategy(self, value: str):
        return self._set_params(featureSubsetStrategy=value)

    def setSeed(self, value: int):
        return self._set_params(seed=value)

    def getNumTrees(self) -> int:
        return self.getOrDefault("numTrees")

    def getMaxDepth(self) -> int:
        return self.getOrDefault("maxDepth")

    def getMaxBins(self) -> int:
        return self.getOrDefault("maxBins")


class _RandomForestEstimator(_RandomForestParams, _TpuEstimatorSupervised):
    _is_classification = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._initialize_tpu_params()
        self._set_params(**kwargs)

    def _label_stats(self, inputs: FitInputs):
        """Per shard: the (S, n_loc) unweighted stat rows and the per-row
        value the deep phase needs (class index or target); and the extra
        model attributes."""
        raise NotImplementedError

    def _enable_fit_multiple_in_single_pass(self) -> bool:
        return True

    def _supportsTransformEvaluate(self, evaluator: Any) -> bool:
        from ..evaluation import MulticlassClassificationEvaluator, RegressionEvaluator

        if self._is_classification:
            return isinstance(evaluator, MulticlassClassificationEvaluator)
        return isinstance(evaluator, RegressionEvaluator)

    def _get_tpu_fit_func(self, dataset: DataFrame, extra_params: Optional[List[Dict[str, Any]]] = None):
        logger = get_logger(type(self))
        is_classification = self._is_classification

        def _settings(params: Dict[str, Any], n_cols: int) -> Dict[str, Any]:
            """One map's tree settings."""
            max_depth = int(params["max_depth"])
            if max_depth > _MAX_SUPPORTED_DEPTH:
                raise ValueError(
                    f"maxDepth > {_MAX_SUPPORTED_DEPTH} is not supported by the dense tree layout (got {max_depth})"
                )
            n_trees = int(params["n_estimators"])
            criterion = params.get("split_criterion")
            seed = params.get("random_state")
            return {
                "max_depth": max_depth,
                "n_trees": n_trees,
                "n_bins": int(params["n_bins"]),
                "kind": "regression" if not is_classification else ("entropy" if criterion == "entropy" else "gini"),
                "max_features": _resolve_max_features(
                    params.get("max_features", "auto"), n_cols, is_classification, n_trees
                ),
                "seed": int(seed) & 0x7FFFFFFF if seed is not None else 42,
                "bootstrap": bool(params.get("bootstrap", True)),
                "min_samples_leaf": float(params.get("min_samples_leaf", 1)),
                "min_impurity_decrease": float(params.get("min_impurity_decrease", 0.0)),
            }

        def _grow_on_builder(inputs, st, edges, bins_fm, stats, y_vals):
            """The one-shard histogram builder (B3 / B4)."""
            n_pad = bins_fm.shape[1]
            pad = n_pad - stats.shape[1]
            stats = torch.nn.functional.pad(stats.float(), (0, pad)).contiguous()
            y_vals = torch.nn.functional.pad(y_vals.float(), (0, pad))
            w_pad = torch.nn.functional.pad(inputs.weight[0].float(), (0, n_pad - inputs.weight[0].shape[0]))
            if is_classification:
                base_stats, stats3 = stats, None
            else:
                base_stats, stats3 = stats[:2], stats
            n_trees = st["n_trees"]
            if st["bootstrap"]:
                gen = torch.Generator(device=bins_fm.device).manual_seed((st["seed"] + 104729) & 0x7FFFFFFF)
                counts = torch.poisson(torch.ones((n_trees, n_pad), device=bins_fm.device), generator=gen)
                w_trees = w_pad[None, :] * counts
                del counts
            else:
                w_trees = w_pad[None, :].expand(n_trees, n_pad).contiguous()
            return grow_forest(
                bins_fm, base_stats, w_trees, stats3, edges,
                max_depth=st["max_depth"], n_bins=st["n_bins"], kind=st["kind"],
                max_features=st["max_features"], min_samples_leaf=st["min_samples_leaf"],
                min_impurity_decrease=st["min_impurity_decrease"], seed=st["seed"], y_vals=y_vals,
                # without weightCol every row weighs 1: the classifier's
                # stats are bootstrap counts x one-hot classes, integers
                integer_stats=is_classification and inputs.host_w is None,
            )

        def _grow_on_engine(inputs, st, edges, bins, stats):
            """The scatter engine over every shard, in tree chunks."""
            n_trees = st["n_trees"]
            t_chunk = _engine_tree_chunk(
                n_trees, st["max_depth"], inputs.n_cols, st["max_features"], inputs.n_pad, stats[0].shape[0]
            )
            gen = torch.Generator().manual_seed((st["seed"] + 104729) & 0x7FFFFFFF) if st["bootstrap"] else None
            parts = []
            for t0 in range(0, n_trees, t_chunk):
                tc = min(t_chunk, n_trees - t0)
                counts = (
                    torch.poisson(torch.ones((tc, inputs.n_rows)), generator=gen) if gen is not None else None
                )
                stats_t = _engine_tree_stats(stats, inputs.weight, counts, tc, inputs.n_rows)
                del counts
                parts.append(grow_forest_engine(
                    bins, stats_t, edges, max_depth=st["max_depth"], n_bins=st["n_bins"], kind=st["kind"],
                    max_features=st["max_features"], min_samples_leaf=st["min_samples_leaf"],
                    min_impurity_decrease=st["min_impurity_decrease"], seed=(st["seed"] + 7919 * t0) & 0x7FFFFFFF,
                ))
                del stats_t
            if len(parts) == 1:
                return parts[0]
            return tuple(np.concatenate([p[i] for p in parts]) for i in range(5))

        def _fit(inputs: FitInputs, params: Dict[str, Any]):
            stats, y_vals, extra_attrs = self._label_stats(inputs)
            s_split = 2 if not is_classification else stats[0].shape[0]
            maps = [params] if extra_params is None else [{**params, **o} for o in extra_params]
            settings = [_settings(p, inputs.n_cols) for p in maps]
            on_builder = [
                _on_histogram_builder(inputs.mesh.size, st["n_bins"], st["max_features"], st["max_depth"], s_split)
                for st in settings
            ]

            # quantile edges from a bounded strided row sample, on the host;
            # one binning for each distinct (growth, maxBins), shared by the
            # maps
            edges_of: Dict[int, np.ndarray] = {}
            binned: Dict[Any, Any] = {}
            with record_function("forest.bin"):
                sample = _binning_sample(inputs)
                for st, builder in zip(settings, on_builder):
                    n_bins = st["n_bins"]
                    if n_bins not in edges_of:
                        edges_of[n_bins] = compute_bin_edges(sample, n_bins)
                    edges = torch.from_numpy(edges_of[n_bins])
                    if (builder, n_bins) in binned:
                        continue
                    if builder:
                        x = inputs.X[0]
                        n_pad = -(-x.shape[0] // ROW_TILE) * ROW_TILE
                        binned[(builder, n_bins)] = bin_features_feature_major(x.float(), edges, n_pad)
                    else:
                        binned[(builder, n_bins)] = [bin_features_wide(x.float(), edges, x.shape[0]) for x in inputs.X]
                del sample
            # the features are not needed once binned: free them for the
            # tree growth (12 GB at the 1M x 3000 flagship)
            _release_fit_features(inputs)

            results = []
            for st, builder in zip(settings, on_builder):
                edges = edges_of[st["n_bins"]]
                bins = binned[(builder, st["n_bins"])]
                if builder:
                    grown = _grow_on_builder(inputs, st, edges, bins, stats[0], y_vals[0])
                else:
                    grown = _grow_on_engine(inputs, st, edges, bins, stats)
                features, thresholds, leaf_values, node_counts, impurities = grown
                logger.info(
                    "grew %d trees on the %s (depth<=%d, bins=%d)", st["n_trees"],
                    "histogram builder" if builder else "scatter engine", st["max_depth"], st["n_bins"],
                )
                results.append({
                    "features_": features,
                    "thresholds_": thresholds,
                    "leaf_values_": leaf_values,
                    "node_counts_": node_counts,
                    "impurities_": impurities,
                    "max_depth": st["max_depth"],
                    "n_cols": inputs.n_cols,
                    "dtype": str(inputs.dtype),
                    **extra_attrs,
                })
            return results[0] if extra_params is None else results

        return _fit


class _RandomForestModelBase(_RandomForestParams, _TpuModelWithPredictionCol):
    """Shared forest model: dense arrays + batched traversal predict.

    A _combine'd multi-model holds its sub-models' trees concatenated along
    the tree axis, with `_tree_counts` the trees of each; it only scores
    (_transformEvaluate), it does not transform."""

    @property
    def _num_models(self) -> int:
        counts = getattr(self, "_tree_counts", None)
        return len(counts) if counts else 1

    @classmethod
    def _construct(cls, attrs: Dict[str, Any]) -> "_RandomForestModelBase":
        """A combined model's split into sub-models (tree_counts) is an
        attribute, not a constructor argument: reattach it on load."""
        attrs = dict(attrs)
        tc = attrs.pop("tree_counts", None)
        model = cls(**attrs)
        if tc is not None:
            model._tree_counts = [int(c) for c in np.asarray(tc).tolist()]
            model._model_attributes["tree_counts"] = model._tree_counts
        return model

    @classmethod
    def _combine(cls, models: List["_RandomForestModelBase"]) -> "_RandomForestModelBase":
        """The sub-models' trees concatenated, each dense layout padded to the
        deepest one (a shallower tree embeds unchanged in the deeper node
        indexing), with the trees of each sub-model in tree_counts."""
        assert models and all(isinstance(m, cls) for m in models)
        first = models[0]
        assert all(m.n_cols == first.n_cols for m in models)
        assert all(m.leaf_values_.shape[2] == first.leaf_values_.shape[2] for m in models), (
            "cannot combine forests with different value widths"
        )
        m_max = max(m.features_.shape[1] for m in models)

        def pad_nodes(a: np.ndarray, fill: Any = 0) -> np.ndarray:
            if a.shape[1] == m_max:
                return a
            width = [(0, 0), (0, m_max - a.shape[1])] + [(0, 0)] * (a.ndim - 2)
            return np.pad(a, width, constant_values=fill)

        kwargs: Dict[str, Any] = dict(
            features_=np.concatenate([pad_nodes(m.features_, -1) for m in models]),
            thresholds_=np.concatenate([pad_nodes(m.thresholds_) for m in models]),
            leaf_values_=np.concatenate([pad_nodes(m.leaf_values_) for m in models]),
            node_counts_=np.concatenate([pad_nodes(m.node_counts_) for m in models]),
            impurities_=np.concatenate([pad_nodes(m.impurities_) for m in models]),
            max_depth=max(int(m.max_depth) for m in models),
            n_cols=first.n_cols,
            dtype=first.dtype,
        )
        if hasattr(first, "classes_"):
            assert all(np.array_equal(m.classes_, first.classes_) for m in models), (
                "cannot combine classifiers fit on different label sets"
            )
            kwargs.update(classes_=first.classes_, num_classes=first.num_classes)
        combined = cls(**kwargs)
        combined._tree_counts = [m.features_.shape[0] for m in models]
        combined._model_attributes["tree_counts"] = combined._tree_counts
        first._copyValues(combined)
        combined._tpu_params.update(first._tpu_params)
        combined._float32_inputs = first._float32_inputs
        return combined

    def _rows_on_device(self, features: np.ndarray) -> torch.Tensor:
        features = np.atleast_2d(np.asarray(features))
        if features.shape[1] != self.n_cols:
            raise ValueError(f"feature width {features.shape[1]} != model n_cols {self.n_cols}")
        np_dtype = self._transform_dtype(self.dtype)
        return torch.from_numpy(np.ascontiguousarray(features, dtype=np_dtype)).to(_device.resolve())

    def _per_model_values(self, features: np.ndarray) -> List[np.ndarray]:
        """(N, V) mean leaf values of each sub-model, over one upload of the
        rows: each sub-model's tree slice, as its own transform computes
        them."""
        X = self._rows_on_device(features)
        dev = X.device
        f = torch.tensor(self.features_, dtype=torch.int32, device=dev)
        t = torch.tensor(self.thresholds_.astype(self._transform_dtype(self.dtype)), device=dev)
        v = torch.tensor(self.leaf_values_, dtype=torch.float32, device=dev)
        counts = getattr(self, "_tree_counts", None) or [self.features_.shape[0]]
        out, off = [], 0
        for c in counts:
            sl = slice(off, off + c)
            off += c
            out.append(forest_predict(X, f[sl], t[sl], v[sl], int(self.max_depth)))
        return [o.cpu().numpy() for o in out]

    def _serving_values_entry(self, postprocess, out_cols: List[str], mesh: Any = None):
        """Serving plumbing shared by both forest models: the mean-leaf-values
        traversal of a padded batch on the mesh's first device (the entry
        points' device without a mesh); `postprocess` maps the host values
        to the output columns."""
        if self._num_models != 1:
            raise ValueError("combined multi-models are not servable")
        from ..serving.entry import kernel_entry

        np_dtype = self._transform_dtype(self.dtype)
        dev = mesh.devices[0] if mesh is not None else _device.resolve()
        f = torch.tensor(self.features_, dtype=torch.int32, device=dev)
        t = torch.tensor(self.thresholds_.astype(np_dtype), device=dev)
        v = torch.tensor(self.leaf_values_, dtype=torch.float32, device=dev)
        max_depth = int(self.max_depth)
        return kernel_entry(
            "serve.forest",
            lambda X, f, t, v: forest_predict(X, f, t, v, max_depth),
            (f, t, v),
            lambda out: postprocess(out[0]),
            device=dev,
            dtype=np_dtype,
            n_cols=self.n_cols,
            out_cols=out_cols,
            info={"num_trees": int(self.features_.shape[0])},
        )

    def _predict_values(self, features: np.ndarray) -> np.ndarray:
        """(N, V) mean leaf values of the rows of `features`."""
        assert self._num_models == 1, "transform() of a combined multi-model: use _transformEvaluate"
        return self._per_model_values(features)[0]

    def _transformEvaluate(self, dataset: Any, evaluator: Any, params: Any = None) -> List[float]:
        return self._transform_evaluate(dataset, evaluator, self._num_models)

    @property
    def getNumTrees(self) -> int:  # property for pyspark API parity
        return self.features_.shape[0]

    @property
    def treeWeights(self) -> List[float]:
        return [1.0] * self.features_.shape[0]

    @property
    def totalNumNodes(self) -> int:
        return int((self.features_ >= 0).sum() * 2 + (self.features_ >= 0).shape[0])

    def trees_to_dicts(self) -> List[Dict[str, Any]]:
        """The forest as nested dicts, one a tree (the JAX package's portable
        export): an internal node {split_feature, threshold, gain,
        instance_count, yes, no}, a leaf {leaf_value, instance_count}.  The
        node arrays become lists once, before the walk."""
        feats = np.asarray(self.features_).tolist()
        thr = np.asarray(self.thresholds_).tolist()
        leaf = np.asarray(self.leaf_values_).tolist()
        cnt = np.asarray(self.node_counts_).tolist()
        imp = np.asarray(self.impurities_).tolist()
        out = []
        for f, th, lv, ct, im in zip(feats, thr, leaf, cnt, imp):

            def node_dict(i: int) -> Dict[str, Any]:
                if f[i] < 0:
                    return {"leaf_value": lv[i], "instance_count": float(ct[i])}
                return {
                    "split_feature": int(f[i]),
                    "threshold": float(th[i]),
                    "gain": float(im[i]),
                    "instance_count": float(ct[i]),
                    "yes": node_dict(2 * i + 1),
                    "no": node_dict(2 * i + 2),
                }

            out.append(node_dict(0))
        return out

    def cpu(self):
        """This forest as the pyspark.ml RandomForest model of its kind,
        built tree by tree through py4j (needs pyspark and an active
        SparkSession)."""
        from ..spark.interop import to_spark_random_forest_model

        return to_spark_random_forest_model(self)


_FOREST_ATTRS = ("features_", "thresholds_", "leaf_values_", "node_counts_", "impurities_")


class RandomForestClassifier(_RandomForestEstimator):
    """Random-forest classifier over the fit's row shards, with the Spark ML API."""

    _is_classification = True

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._setDefault(impurity="gini")
        if "impurity" not in kwargs:
            self._set_tpu_value("split_criterion", "gini")

    @classmethod
    def _param_value_mapping(cls):
        mapping = dict(super()._param_value_mapping())
        mapping["split_criterion"] = lambda x: {"gini": "gini", "entropy": "entropy"}.get(x)
        return mapping

    def _label_stats(self, inputs: FitInputs):
        # int32 label cast, as the JAX package (and Spark) cast class labels
        classes = discover_label_classes(inputs, cast=np.int32)
        y_idx = [encode_labels(y.to(torch.int32), torch.from_numpy(classes)) for y in inputs.y]
        onehot = [torch.nn.functional.one_hot(i, len(classes)).T.to(w.dtype) for i, w in zip(y_idx, inputs.weight)]
        return onehot, y_idx, {"classes_": classes.astype(np.float64), "num_classes": len(classes)}

    def _create_model(self, result: Dict[str, Any]) -> "RandomForestClassificationModel":
        return RandomForestClassificationModel(**result)


class RandomForestClassificationModel(
    HasProbabilityCol, HasRawPredictionCol, _ClassificationModelEvaluationMixIn, _RandomForestModelBase
):
    def __init__(
        self,
        features_: np.ndarray,
        thresholds_: np.ndarray,
        leaf_values_: np.ndarray,
        node_counts_: np.ndarray,
        impurities_: np.ndarray,
        max_depth: int,
        n_cols: int,
        dtype: str,
        classes_: np.ndarray,
        num_classes: int,
    ) -> None:
        arrays = dict(zip(_FOREST_ATTRS, (features_, thresholds_, leaf_values_, node_counts_, impurities_)))
        attrs = {k: np.asarray(v) for k, v in arrays.items()}
        attrs.update(
            max_depth=int(max_depth), n_cols=int(n_cols), dtype=str(dtype),
            classes_=np.asarray(classes_), num_classes=int(num_classes),
        )
        super().__init__(**attrs)
        for k, v in attrs.items():
            setattr(self, k, v)

    @property
    def numClasses(self) -> int:
        return self.num_classes

    def _out_columns(self) -> List[str]:
        return [
            self.getOrDefault("predictionCol"),
            self.getOrDefault("probabilityCol"),
            self.getOrDefault("rawPredictionCol"),
        ]

    def _outputs(self, values: np.ndarray) -> Dict[str, np.ndarray]:
        probs = values / np.maximum(values.sum(axis=1, keepdims=True), 1e-12)
        pred_col, prob_col, raw_col = self._out_columns()
        return {
            pred_col: self.classes_[probs.argmax(axis=1)].astype(np.float64),
            prob_col: probs.astype(np.float64),
            raw_col: (probs * self.features_.shape[0]).astype(np.float64),
        }

    def _get_tpu_transform_func(self, dataset: DataFrame):
        return lambda features: self._outputs(self._predict_values(features))

    def _serving_entry(self, mesh: Any = None):
        """Online inference hook (serving/): one forest traversal per padded
        batch, class mapping and normalisation on the host as in
        transform()."""
        return self._serving_values_entry(self._outputs, self._out_columns(), mesh)

    def _get_eval_predict_func(self):
        """features -> ((M, n) predictions, (M, n, C) probabilities) of every
        sub-model, as each one's transform gives them."""
        classes = self.classes_

        def _predict_all(features: np.ndarray):
            preds, probs = [], []
            for values in self._per_model_values(features):
                p = values / np.maximum(values.sum(axis=1, keepdims=True), 1e-12)
                probs.append(p.astype(np.float64))
                preds.append(classes[p.argmax(axis=1)].astype(np.float64))
            return np.stack(preds), np.stack(probs)

        return _predict_all

    def predict(self, value: np.ndarray) -> float:
        probs = self._predict_values(np.asarray(value)[None, :])
        return float(self.classes_[int(probs[0].argmax())])

    def predictProbability(self, value: np.ndarray) -> np.ndarray:
        probs = self._predict_values(np.asarray(value)[None, :])[0]
        return probs / max(probs.sum(), 1e-12)


class RandomForestRegressor(_RandomForestEstimator):
    """Random-forest regressor over the fit's row shards, with the Spark ML API."""

    _is_classification = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._setDefault(impurity="variance")
        if "impurity" not in kwargs:
            self._set_tpu_value("split_criterion", "variance")

    @classmethod
    def _param_value_mapping(cls):
        mapping = dict(super()._param_value_mapping())
        mapping["split_criterion"] = lambda x: {"variance": "variance", "mse": "variance"}.get(x)
        return mapping

    def _label_stats(self, inputs: FitInputs):
        return [torch.stack([torch.ones_like(y), y, y * y]) for y in inputs.y], inputs.y, {}

    def _create_model(self, result: Dict[str, Any]) -> "RandomForestRegressionModel":
        return RandomForestRegressionModel(**result)


class RandomForestRegressionModel(_RegressionModelEvaluationMixIn, _RandomForestModelBase):
    def __init__(
        self,
        features_: np.ndarray,
        thresholds_: np.ndarray,
        leaf_values_: np.ndarray,
        node_counts_: np.ndarray,
        impurities_: np.ndarray,
        max_depth: int,
        n_cols: int,
        dtype: str,
    ) -> None:
        arrays = dict(zip(_FOREST_ATTRS, (features_, thresholds_, leaf_values_, node_counts_, impurities_)))
        attrs = {k: np.asarray(v) for k, v in arrays.items()}
        attrs.update(max_depth=int(max_depth), n_cols=int(n_cols), dtype=str(dtype))
        super().__init__(**attrs)
        for k, v in attrs.items():
            setattr(self, k, v)

    def _get_tpu_transform_func(self, dataset: DataFrame):
        pred_col = self.getOrDefault("predictionCol")
        return lambda features: {pred_col: self._predict_values(features)[:, 0].astype(np.float64)}

    def _serving_entry(self, mesh: Any = None):
        """Online inference hook (serving/): one forest traversal per padded
        batch, the first value column as the prediction."""
        pred_col = self.getOrDefault("predictionCol")
        return self._serving_values_entry(lambda values: {pred_col: values[:, 0].astype(np.float64)},
                                          [pred_col], mesh)

    def _get_eval_predict_func(self):
        """features -> (M, n) float64 predictions of every sub-model."""
        return lambda features: np.stack([v[:, 0].astype(np.float64) for v in self._per_model_values(features)])

    def predict(self, value: np.ndarray) -> float:
        return float(self._predict_values(np.asarray(value)[None, :])[0, 0])
