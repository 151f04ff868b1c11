#
# RandomForest classifier/regressor estimators and models.
#
# Counterpart of spark_rapids_ml_tpu/models/random_forest.py on one device:
# the same Spark param mapping, max_features mapping and solver defaults, the
# same model attributes (dense per-node arrays features_, thresholds_,
# leaf_values_, node_counts_, impurities_), and the same output columns —
# prediction, plus probability and rawPrediction for the classifier.
#
# The fit: quantile edges from a bounded strided row sample (on the host),
# binning into the feature-major int8 layout (kernel B2), per-tree Poisson(1)
# bootstrap weights, and level-wise growth on the node histograms
# (ops/forest_grow.py, kernels B3 and B4).  That growth is the port's only
# route: a fit outside its limits (bins <= 128, max_features <= 1024, a depth
# the slot budget covers) raises NotImplementedError.  The JAX package sends
# such fits, and every multi-device fit, to its mesh-parallel scatter engine,
# which is not ported.  The bootstrap draws from a seeded torch.Generator, so
# its weights differ from the JAX package's (jax.random.poisson).
#
# Not carried over yet: _transformEvaluate and the evaluators, fitMultiple,
# model combining, cpu() (pyspark.ml conversion), the serving hooks, and
# multi-rank binning.
#

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch
from torch.profiler import record_function

from .. import device as _device
from ..core import FitInputs, _TpuEstimatorSupervised, _TpuModelWithPredictionCol, discover_label_classes
from ..dataframe import DataFrame
from ..ops.forest import bin_features_feature_major, compute_bin_edges, forest_predict
from ..ops.forest_grow import depth_supported, grow_forest
from ..ops.forest_hist import ROW_TILE
from ..ops.labels import encode_labels
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

_MAX_SUPPORTED_DEPTH = 16  # dense tree layout: 2^(d+1)-1 node slots
# the limits of histogram growth (the JAX package's _mxu_eligible)
_MAX_BINS = 128
_MAX_FEATURES = 1024
# binning sample: at most this many rows and this many bytes
_BINNING_SAMPLE_ROWS = 16_384
_BINNING_SAMPLE_BYTES = 32 << 20


def _binning_rows(weight: np.ndarray, n_cols: int, itemsize: int) -> np.ndarray:
    """Row indices of the binning sample: the rows with weight > 0,
    ceil-strided over the whole row range down to the row/byte budget."""
    budget = max(2048, min(_BINNING_SAMPLE_ROWS, _BINNING_SAMPLE_BYTES // max(1, n_cols * itemsize)))
    idx = np.flatnonzero(weight > 0)
    if idx.size > budget:
        idx = idx[:: -(-idx.size // budget)]
    return idx


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
        """(S, N_pad) unweighted stat rows, the per-row value the deep phase
        needs (class index or target), and extra model attributes."""
        raise NotImplementedError

    def _get_tpu_fit_func(self, dataset: DataFrame):
        logger = get_logger(type(self))
        is_classification = self._is_classification

        def _fit(inputs: FitInputs, params: Dict[str, Any]) -> Dict[str, Any]:
            max_depth = int(params["max_depth"])
            if max_depth > _MAX_SUPPORTED_DEPTH:
                raise ValueError(
                    f"maxDepth > {_MAX_SUPPORTED_DEPTH} is not supported by the dense tree layout (got {max_depth})"
                )
            n_trees = int(params["n_estimators"])
            n_bins = int(params["n_bins"])
            criterion = params.get("split_criterion")
            kind = "regression" if not is_classification else ("entropy" if criterion == "entropy" else "gini")
            max_features = _resolve_max_features(
                params.get("max_features", "auto"), inputs.n_cols, is_classification, n_trees
            )
            seed = params.get("random_state")
            seed = int(seed) & 0x7FFFFFFF if seed is not None else 42
            bootstrap = bool(params.get("bootstrap", True))
            stats, y_vals, extra_attrs = self._label_stats(inputs)
            s_split = 2 if not is_classification else stats.shape[0]
            limits = [
                (n_bins <= _MAX_BINS, f"maxBins {n_bins} > {_MAX_BINS}"),
                (max_features <= _MAX_FEATURES, f"{max_features} features per split > {_MAX_FEATURES}"),
                (depth_supported(max_depth, s_split), f"maxDepth {max_depth} exceeds the slot budget of {s_split} stat rows"),
            ]
            broken = [why for ok, why in limits if not ok]
            if broken:
                raise NotImplementedError(
                    f"{'; '.join(broken)}: the port grows forests only from node histograms; "
                    "the JAX package's scatter engine (ops/forest.grow_forest), which takes such "
                    "fits, is not ported"
                )

            # quantile edges from a bounded strided row sample, on the host
            X = inputs.X
            with record_function("forest.bin"):
                w_host = inputs.weight.cpu().numpy()
                rows = _binning_rows(w_host[: inputs.n_rows], inputs.n_cols, X.element_size())
                sample = X[torch.from_numpy(rows).to(X.device)].cpu().numpy()
                edges = compute_bin_edges(sample, n_bins)
                n_pad = -(-X.shape[0] // ROW_TILE) * ROW_TILE
                bins_fm = bin_features_feature_major(X.float(), torch.from_numpy(edges), n_pad)
            # the feature tensor is not needed once binned: free it for the
            # tree growth (12 GB at the 1M x 3000 flagship)
            inputs.X = X = None

            dev = bins_fm.device
            pad = n_pad - stats.shape[1]
            stats = torch.nn.functional.pad(stats.float(), (0, pad)).contiguous()
            y_vals = torch.nn.functional.pad(y_vals.float(), (0, pad))
            w_pad = torch.nn.functional.pad(inputs.weight.float(), (0, n_pad - inputs.weight.shape[0]))
            if bootstrap:
                gen = torch.Generator(device=dev).manual_seed((seed + 104729) & 0x7FFFFFFF)
                counts = torch.poisson(torch.ones((n_trees, n_pad), device=dev), generator=gen)
                w_trees = w_pad[None, :] * counts
                del counts
            else:
                w_trees = w_pad[None, :].expand(n_trees, n_pad).contiguous()
            if is_classification:
                base_stats, stats3 = stats, None
            else:
                base_stats, stats3 = stats[:2], stats
            features, thresholds, leaf_values, node_counts, impurities = grow_forest(
                bins_fm, base_stats, w_trees, stats3, edges,
                max_depth=max_depth, n_bins=n_bins, kind=kind, max_features=max_features,
                min_samples_leaf=float(params.get("min_samples_leaf", 1)),
                min_impurity_decrease=float(params.get("min_impurity_decrease", 0.0)),
                seed=seed, y_vals=y_vals,
                # without weightCol every row weighs 1: the classifier's stats
                # are bootstrap counts x one-hot classes, integers
                integer_stats=is_classification and inputs.host_w is None,
            )
            logger.info("grew %d trees (depth<=%d, bins=%d)", n_trees, max_depth, n_bins)
            return {
                "features_": features,
                "thresholds_": thresholds,
                "leaf_values_": leaf_values,
                "node_counts_": node_counts,
                "impurities_": impurities,
                "max_depth": max_depth,
                "n_cols": inputs.n_cols,
                "dtype": str(inputs.dtype),
                **extra_attrs,
            }

        return _fit


class _RandomForestModelBase(_RandomForestParams, _TpuModelWithPredictionCol):
    """Shared forest model: dense arrays + batched traversal predict."""

    def _predict_values(self, features: np.ndarray) -> np.ndarray:
        """(N, V) mean leaf values of the rows of `features`."""
        features = np.atleast_2d(np.asarray(features))
        if features.shape[1] != self.n_cols:
            raise ValueError(f"feature width {features.shape[1]} != model n_cols {self.n_cols}")
        np_dtype = self._transform_dtype(self.dtype)
        dev = _device.resolve()
        X = torch.from_numpy(np.ascontiguousarray(features, dtype=np_dtype)).to(dev)
        values = forest_predict(
            X,
            torch.tensor(self.features_, dtype=torch.int32, device=dev),
            torch.tensor(self.thresholds_.astype(np_dtype), device=dev),
            torch.tensor(self.leaf_values_, dtype=torch.float32, device=dev),
            int(self.max_depth),
        )
        return values.cpu().numpy()

    @property
    def getNumTrees(self) -> int:  # property for pyspark API parity
        return self.features_.shape[0]

    @property
    def treeWeights(self) -> List[float]:
        return [1.0] * self.features_.shape[0]

    @property
    def totalNumNodes(self) -> int:
        return int((self.features_ >= 0).sum() * 2 + (self.features_ >= 0).shape[0])


_FOREST_ATTRS = ("features_", "thresholds_", "leaf_values_", "node_counts_", "impurities_")


class RandomForestClassifier(_RandomForestEstimator):
    """Random-forest classifier on one device, with the Spark ML API."""

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
        y_idx = encode_labels(inputs.y.to(torch.int32), torch.from_numpy(classes))
        onehot = torch.nn.functional.one_hot(y_idx, len(classes)).T.to(inputs.weight.dtype)
        return onehot, y_idx, {"classes_": classes.astype(np.float64), "num_classes": len(classes)}

    def _create_model(self, result: Dict[str, Any]) -> "RandomForestClassificationModel":
        return RandomForestClassificationModel(**result)


class RandomForestClassificationModel(HasProbabilityCol, HasRawPredictionCol, _RandomForestModelBase):
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

    def predict(self, value: np.ndarray) -> float:
        probs = self._predict_values(np.asarray(value)[None, :])
        return float(self.classes_[int(probs[0].argmax())])

    def predictProbability(self, value: np.ndarray) -> np.ndarray:
        probs = self._predict_values(np.asarray(value)[None, :])[0]
        return probs / max(probs.sum(), 1e-12)


class RandomForestRegressor(_RandomForestEstimator):
    """Random-forest regressor on one device, with the Spark ML API."""

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
        y = inputs.y
        return torch.stack([torch.ones_like(y), y, y * y]), y, {}

    def _create_model(self, result: Dict[str, Any]) -> "RandomForestRegressionModel":
        return RandomForestRegressionModel(**result)


class RandomForestRegressionModel(_RandomForestModelBase):
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

    def predict(self, value: np.ndarray) -> float:
        return float(self._predict_values(np.asarray(value)[None, :])[0, 0])
