#
# LogisticRegression estimator/model (binary sigmoid and multinomial
# softmax; L2, L1 and elastic net through L-BFGS / OWL-QN).
#
# Counterpart of spark_rapids_ml_tpu/models/logistic_regression.py: the same
# param mapping (regParam -> C = 1 / regParam) and penalty derivation from
# (regParam, elasticNetParam), the same model attributes (coef_ (k, D),
# intercept_ (k,), classes_, n_cols, dtype, num_iters) and transform
# columns: prediction, probability (binary: the sigmoid, multinomial: a
# stable softmax) and rawPrediction ([-z, z] for binary).  Classes come from
# core.discover_label_classes and the labels are encoded on each shard's
# device (ops/labels.encode_labels); every objective evaluation sums the
# shards' partials with one psum, and the solve runs on the mesh's first
# device (ops/logistic.py).  CSR input fits and transforms through the ELL layout,
# with a deterministic gradient (ops/sparse.ell_rmatmat).
#
# Model selection: fitMultiple fits every param map over one ingest and one
# label encoding; _fitBatchedSweep fits every (fold, map) of a
# CrossValidator as one lane-batched L-BFGS run a penalty family (smooth,
# and OWL-QN when elasticNetParam > 0) over one staged dataset
# (ops/logistic.sweep_logistic_fit_kernel), when the grid varies only
# regParam and elasticNetParam and the input is dense; _combine stacks
# models and _transformEvaluate scores them in one pass over each partition
# (MulticlassClassificationEvaluator only, as in the JAX package), on the
# Spark executors for a live pyspark frame (_partition_metrics a batch,
# spark/adapter.executor_transform_evaluate).
#
# streaming(classes=None) returns the partial_fit / merge / finalize
# engine (stream/engines.StreamingLogisticRegression).
#
# _serving_entry serves decision scores, probabilities and label indices of
# a padded batch in one call (serving/entry.kernel_entry).
#
# _lane_entry is the multiplexed hook (serving/multiplex.py): (W, b) as one
# lane of ops/logistic.lane_logistic_predict_kernel, the class labels in
# its meta.
#
# cpu() converts to a pyspark.ml LogisticRegressionModel (spark/interop.py;
# it needs pyspark and an active SparkSession).
#

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from .. import device as _device
from .. import profiling
from ..core import (
    FitInputs,
    _TpuEstimatorSupervised,
    _TpuModelWithPredictionCol,
    discover_label_classes,
)
from ..dataframe import DataFrame, as_dataframe, partition_of
from ..metrics.multiclass import MulticlassMetrics
from ..ops.labels import encode_labels
from ..ops.lanes import pack_lane_subset
from ..ops.logistic import (
    lane_logistic_predict_kernel,
    logistic_decision_kernel,
    logistic_fit_kernel,
    scores_to_labels,
    scores_to_probs,
    sweep_logistic_fit_kernel,
)
from ..ops.sparse import EllMatrix
from ..ops.sweep import stage_fold_ids
from ..ops.sparse import ell_device_from_scipy
from ..params import (
    HasElasticNetParam,
    HasFeaturesCol,
    HasFeaturesCols,
    HasFitIntercept,
    HasLabelCol,
    HasMaxIter,
    HasPredictionCol,
    HasProbabilityCol,
    HasRawPredictionCol,
    HasRegParam,
    HasStandardization,
    HasTol,
    HasVerbose,
    HasWeightCol,
    Param,
    TypeConverters,
    _dummy,
    _TpuParams,
)
from ..utils import get_logger
from .linear_regression import _device_rows, _frame_blocks


class _ClassificationModelEvaluationMixIn:
    """Single-pass transform-evaluate of a (combined) classification model:
    every sub-model's predictions of a block of rows in one pass, merged
    into MulticlassMetrics per sub-model (shared with the forest
    classifier)."""

    def _partition_metrics(
        self, part: Any, evaluator: Any, num_models: int, predict_all: Any = None
    ) -> List[MulticlassMetrics]:
        """One partition's (or mapInPandas batch's) metric partials, one a
        sub-model: the Spark executor route's unit (a caller looping over
        partitions passes one predict_all, staged once)."""
        from ..core import extract_partition_features

        needs_probs = evaluator.getMetricName() == "logLoss"
        input_col, input_cols = self._get_input_columns()
        dtype = self._transform_dtype(self._model_attributes.get("dtype"))
        feats = extract_partition_features(part, input_col, input_cols, dtype)
        label_col = self.getOrDefault("labelCol")
        labels = np.asarray(partition_of(part, [label_col])[label_col])
        if predict_all is None:
            predict_all = self._get_eval_predict_func()
        preds, probs = predict_all(feats)  # (M, n), (M, n, C)
        return [
            MulticlassMetrics.from_arrays(
                labels, preds[i], probs=probs[i] if needs_probs else None, eps=evaluator.getEps()
            )
            for i in range(num_models)
        ]

    def _transform_evaluate(self, dataset: Any, evaluator: Any, num_models: int) -> List[float]:
        from ..core import _use_executor_path
        from ..evaluation import MulticlassClassificationEvaluator

        if not isinstance(evaluator, MulticlassClassificationEvaluator):
            raise NotImplementedError(f"{evaluator} is unsupported yet.")
        if _use_executor_path(dataset):
            from ..spark.adapter import executor_transform_evaluate

            return executor_transform_evaluate(self, dataset, evaluator, num_models)
        return self._evaluate_blocks(_frame_blocks(self, as_dataframe(dataset)), evaluator, num_models)

    def _evaluate_blocks(self, blocks: Iterable[Tuple[Any, np.ndarray]], evaluator: Any, num_models: int) -> List[float]:
        """The metrics of each sub-model over (features, labels) blocks, one
        partial a block, merged in order; features a host block or a tensor
        on the device."""
        needs_probs = evaluator.getMetricName() == "logLoss"
        predict_all = self._get_eval_predict_func()
        metrics: List[Optional[MulticlassMetrics]] = [None] * num_models
        for features, labels in blocks:
            preds, probs = predict_all(features)
            for i in range(num_models):
                m = MulticlassMetrics.from_arrays(
                    labels, preds[i], probs=probs[i] if needs_probs else None, eps=evaluator.getEps()
                )
                metrics[i] = m if metrics[i] is None else metrics[i].merge(m)
        return [m.evaluate(evaluator) for m in metrics]  # type: ignore[union-attr]


class LogisticRegressionClass(_TpuParams):
    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        return {
            "maxIter": "max_iter",
            "regParam": "C",
            "elasticNetParam": "l1_ratio",
            "tol": "tol",
            "fitIntercept": "fit_intercept",
            "threshold": None,
            "thresholds": None,
            "standardization": "",
            "weightCol": None,
            "aggregationDepth": None,
            "family": "",
            "maxBlockSizeInMB": None,
        }

    @classmethod
    def _param_value_mapping(cls):
        # Spark's regParam -> C = 1 / regParam (0 stays 0)
        return {"C": lambda x: 1 / x if x > 0.0 else (0.0 if x == 0.0 else None)}

    @classmethod
    def _get_tpu_params_default(cls) -> Dict[str, Any]:
        return {
            "fit_intercept": True,
            "verbose": False,
            "C": 1.0,
            "penalty": "l2",
            "l1_ratio": None,
            "max_iter": 1000,
            "tol": 0.0001,
        }

    @staticmethod
    def _reg_params_value_mapping(reg_param: float, elasticnet_param: float):
        """(regParam, elasticNetParam) -> (penalty, C, l1_ratio)."""
        if reg_param == 0.0:
            return "none", 0.0, elasticnet_param
        if elasticnet_param == 0.0:
            return "l2", 1.0 / reg_param, elasticnet_param
        if elasticnet_param == 1.0:
            return "l1", 1.0 / reg_param, elasticnet_param
        return "elasticnet", 1.0 / reg_param, elasticnet_param


class _LogisticRegressionParams(
    LogisticRegressionClass,
    HasFeaturesCol,
    HasFeaturesCols,
    HasLabelCol,
    HasPredictionCol,
    HasProbabilityCol,
    HasRawPredictionCol,
    HasMaxIter,
    HasTol,
    HasRegParam,
    HasElasticNetParam,
    HasFitIntercept,
    HasStandardization,
    HasWeightCol,
    HasVerbose,
):
    family = Param(
        _dummy(), "family", "the name of family (auto|binomial|multinomial); detected automatically",
        TypeConverters.toString,
    )
    threshold = Param(_dummy(), "threshold", "binary classification threshold", TypeConverters.toFloat)

    # CSR input fits and transforms through the ELL layout (ops/sparse.py)
    _supports_sparse_input = True

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self._setDefault(
            maxIter=100,
            regParam=0.0,
            elasticNetParam=0.0,
            tol=1e-6,
            standardization=True,
            family="auto",
        )

    def setMaxIter(self, value: int):
        return self._set_params(maxIter=value)

    def setRegParam(self, value: float):
        return self._set_params(regParam=value)

    def setElasticNetParam(self, value: float):
        return self._set_params(elasticNetParam=value)

    def setTol(self, value: float):
        return self._set_params(tol=value)

    def setFitIntercept(self, value: bool):
        return self._set_params(fitIntercept=value)

    def setProbabilityCol(self, value: str):
        return self._set_params(probabilityCol=value)

    def setRawPredictionCol(self, value: str):
        return self._set_params(rawPredictionCol=value)


class LogisticRegression(_LogisticRegressionParams, _TpuEstimatorSupervised):
    """Logistic regression over the fit's row shards through L-BFGS /
    OWL-QN.  The
    solver's iterations, objective evaluations and converged fits are
    counted in profiling counters lbfgs.iterations, lbfgs.evaluations and
    lbfgs.converged."""

    def __init__(self, **kwargs: Any) -> None:
        if not kwargs.get("float32_inputs", True):
            get_logger(type(self)).warning(
                "This estimator does not support double precision inputs. "
                "Setting float32_inputs to False will be ignored."
            )
            kwargs.pop("float32_inputs")
        super().__init__()
        self._initialize_tpu_params()
        self._set_tpu_reg_params()
        self._set_params(**kwargs)
        self._set_tpu_reg_params()

    def _set_tpu_reg_params(self) -> None:
        penalty, C, l1_ratio = self._reg_params_value_mapping(
            self.getOrDefault("regParam"), self.getOrDefault("elasticNetParam")
        )
        self._tpu_params["penalty"] = penalty
        self._tpu_params["C"] = C
        self._tpu_params["l1_ratio"] = l1_ratio

    def _set_params(self, **kwargs: Any):
        out = super()._set_params(**kwargs)
        if hasattr(self, "_tpu_params") and ("regParam" in kwargs or "elasticNetParam" in kwargs):
            self._set_tpu_reg_params()
        return out

    def _enable_fit_multiple_in_single_pass(self) -> bool:
        return True

    def _supportsTransformEvaluate(self, evaluator: Any) -> bool:
        from ..evaluation import MulticlassClassificationEvaluator

        return isinstance(evaluator, MulticlassClassificationEvaluator)

    def _get_tpu_fit_func(self, dataset: DataFrame, extra_params: Optional[List[Dict[str, Any]]] = None):
        logger = get_logger(type(self))

        def _single_fit(inputs: FitInputs, params: Dict[str, Any], classes: np.ndarray, y_enc) -> Dict[str, Any]:
            C = float(params["C"])
            l1_ratio = float(params.get("l1_ratio") or 0.0)
            reg = 1.0 / C if C > 0 else 0.0
            k = 1 if len(classes) == 2 else len(classes)
            with record_function("lbfgs.fit"):
                W, b, n_iter, converged, n_evals = logistic_fit_kernel(
                    inputs.X,
                    y_enc,
                    inputs.weight,
                    k,
                    reg,
                    l1_ratio,
                    bool(params["fit_intercept"]),
                    int(params["max_iter"]),
                    float(params["tol"]),
                    reg > 0 and l1_ratio > 0,
                )
            profiling.incr_counter("lbfgs.iterations", n_iter)
            profiling.incr_counter("lbfgs.evaluations", n_evals)
            profiling.incr_counter("lbfgs.converged", int(converged))
            logger.info("L-BFGS iters: %d converged: %s", n_iter, converged)
            return {
                "coef_": W.cpu().numpy().astype(np.float64),
                "intercept_": b.cpu().numpy().astype(np.float64),
                "classes_": np.asarray(classes, dtype=np.float64),
                "n_cols": inputs.n_cols,
                "dtype": str(inputs.dtype),
                "num_iters": n_iter,
            }

        def _fit(inputs: FitInputs, params: Dict[str, Any]):
            if inputs.y is None:
                raise ValueError("LogisticRegression needs a label column")
            classes = discover_label_classes(inputs)
            if len(classes) < 2:
                raise RuntimeError("LogisticRegression requires at least two distinct labels")
            # class indices on the labels' device (pad rows clamp into
            # range; their weight is 0)
            y_enc = [encode_labels(y, torch.as_tensor(classes.astype(inputs.host_y.dtype))) for y in inputs.y]
            if extra_params is None:
                return _single_fit(inputs, params, classes, y_enc)
            return [_single_fit(inputs, {**params, **override}, classes, y_enc) for override in extra_params]

        return _fit

    def _create_model(self, result: Dict[str, Any]) -> "LogisticRegressionModel":
        return LogisticRegressionModel(**result)

    # -- batched sweep -----------------------------------------------------
    def _supportsBatchedSweep(self, df: Any, paramMaps: List[Dict[Param, Any]], evaluator: Any) -> bool:
        if not paramMaps or not self._supportsTransformEvaluate(evaluator):
            return False
        try:
            overrides = [self._paramMap_to_tpu_overrides(pm) for pm in paramMaps]
        except ValueError:
            return False
        if any(set(ov) - {"C", "l1_ratio"} for ov in overrides):
            return False  # only the regularizer axes ride as lanes
        return not self._sweep_sparse_input(as_dataframe(df))

    def _fitBatchedSweep(
        self, df: Any, paramMaps: List[Dict[Param, Any]], n_folds: int, seed: int
    ) -> List[List[Dict[str, Any]]]:
        """Every (fold, map) fit as one lane-batched L-BFGS run a penalty
        family over one staged dataset: folds as weight masks, candidates as
        reg / l1 lanes, each lane with its own convergence."""
        params = dict(self._tpu_params)
        cand = []
        for pm in paramMaps:
            p = {**params, **self._paramMap_to_tpu_overrides(pm)}
            C = float(p["C"])
            l1_ratio = float(p.get("l1_ratio") or 0.0)
            reg = 1.0 / C if C > 0 else 0.0
            cand.append((reg, l1_ratio, reg > 0 and l1_ratio > 0))
        dev = _device.resolve()
        with profiling.phase("tuning.sweep.ingest", dev):
            inputs = self._build_fit_inputs(as_dataframe(df))
        if inputs.y is None:
            raise ValueError("LogisticRegression needs a label column")
        if isinstance(inputs.X[0], EllMatrix):
            raise ValueError("the batched sweep takes dense features")
        classes = discover_label_classes(inputs)
        if len(classes) < 2:
            raise RuntimeError("LogisticRegression requires at least two distinct labels")
        kcls = 1 if len(classes) == 2 else len(classes)
        fid = stage_fold_ids(inputs.n_rows, inputs.n_pad, n_folds, seed, inputs.mesh)
        y_enc = [encode_labels(y, torch.as_tensor(classes.astype(inputs.host_y.dtype))) for y in inputs.y]
        results: List[List[Dict[str, Any]]] = [[{} for _ in cand] for _ in range(n_folds)]
        logger = get_logger(type(self))
        # one lane-batched run a penalty family: OWL-QN is another optimizer
        # and cannot share lanes with the smooth penalties
        with profiling.phase("tuning.sweep.solve", dev):
            for owlqn in (False, True):
                idxs = [i for i, c in enumerate(cand) if c[2] == owlqn]
                if not idxs:
                    continue
                family = "owlqn" if owlqn else "lbfgs"
                _, (regs, l1s) = pack_lane_subset(cand, idxs, fields=(0, 1))
                with profiling.phase(f"tuning.sweep.solve.{family}", dev):
                    W, b, n_iter, conv, n_evals = sweep_logistic_fit_kernel(
                        inputs.X, y_enc, inputs.weight, fid, regs, l1s, float(params["tol"]),
                        k_folds=n_folds, kcls=kcls, fit_intercept=bool(params["fit_intercept"]),
                        max_iter=int(params["max_iter"]), use_owlqn=owlqn,
                    )
                    W_h, b_h = W.cpu().numpy(), b.cpu().numpy()
                    n_iter_h, conv_h = n_iter.cpu().numpy(), conv.cpu().numpy()
                profiling.incr_counter(f"tuning.sweep.{family}.iterations", int(n_iter_h.max()))
                profiling.incr_counter(f"tuning.sweep.{family}.evaluations", n_evals)
                logger.info(
                    "sweep L-BFGS iters (fold x candidate): %s converged: %s",
                    n_iter_h[:, : len(idxs)].tolist(), conv_h[:, : len(idxs)].tolist(),
                )
                for j, i in enumerate(idxs):
                    for f in range(n_folds):
                        results[f][i] = {
                            "coef_": W_h[f, j].astype(np.float64),
                            "intercept_": b_h[f, j].astype(np.float64),
                            "classes_": np.asarray(classes, dtype=np.float64),
                            "n_cols": inputs.n_cols,
                            "dtype": str(inputs.dtype),
                            "num_iters": int(n_iter_h[f, j]),
                        }
        return results

    def streaming(self, classes: Any = None, **kwargs: Any):
        """The streaming engine over this estimator (partial_fit / merge /
        finalize; stream/engines.StreamingLogisticRegression); `classes`
        declares the label set up front, else the first chunk's labels are
        the set."""
        from ..stream.engines import StreamingLogisticRegression

        return StreamingLogisticRegression(self, classes=classes, **kwargs)


class LogisticRegressionModel(_LogisticRegressionParams, _ClassificationModelEvaluationMixIn, _TpuModelWithPredictionCol):
    """A fitted logistic model; a _combine'd model holds M models' coef_
    (M, k, D) and intercept_ (M, k) and only scores them
    (_transformEvaluate)."""

    def __init__(
        self,
        coef_: np.ndarray,
        intercept_: np.ndarray,
        classes_: np.ndarray,
        n_cols: int,
        dtype: str,
        num_iters: Union[int, List[int]] = 0,
    ) -> None:
        super().__init__(
            coef_=np.asarray(coef_),
            intercept_=np.asarray(intercept_),
            classes_=np.asarray(classes_),
            n_cols=int(n_cols),
            dtype=str(dtype),
            num_iters=num_iters,
        )
        self.coef_ = np.asarray(coef_)
        self.intercept_ = np.asarray(intercept_)
        self.classes_ = np.asarray(classes_)
        self.n_cols = int(n_cols)
        self.dtype = str(dtype)
        self.num_iters = num_iters
        self._num_classes = len(self.classes_)

    @property
    def numClasses(self) -> int:
        return self._num_classes

    @property
    def coefficients(self) -> np.ndarray:
        if self.coef_.shape[0] == 1:
            return self.coef_[0]
        raise AttributeError(
            "Multinomial models contain a matrix of coefficients, use coefficientMatrix instead."
        )

    @property
    def intercept(self) -> float:
        if len(self.intercept_) == 1:
            return float(self.intercept_[0])
        raise AttributeError("Multinomial models contain a vector of intercepts, use interceptVector instead.")

    @property
    def coefficientMatrix(self) -> np.ndarray:
        return self.coef_

    @property
    def interceptVector(self) -> Any:
        """The intercepts, dense or sparse by Spark's compression rule
        (sparse when 1.5 (nnz + 1) < size): a pyspark Vector when pyspark is
        installed, else the numpy array."""
        intercepts = self.intercept_
        try:
            from pyspark.ml.linalg import Vectors
        except ImportError:
            return intercepts
        nnz = int(np.count_nonzero(intercepts))
        if 1.5 * (nnz + 1.0) < len(intercepts):
            return Vectors.sparse(len(intercepts), {i: float(v) for i, v in enumerate(intercepts) if v != 0})
        return Vectors.dense(list(intercepts))

    def _device_params(self, np_dtype: np.dtype):
        dev = _device.resolve()
        W = torch.as_tensor(self.coef_.astype(np_dtype), device=dev)
        b = torch.as_tensor(self.intercept_.astype(np_dtype), device=dev)
        return W, b

    def _scores(self, value: np.ndarray) -> torch.Tensor:
        np_dtype = self._transform_dtype(self.dtype)
        W, b = self._device_params(np_dtype)
        x = torch.as_tensor(np.asarray(value, np_dtype)[None, :], device=W.device)
        return logistic_decision_kernel(x, W, b)

    def predict(self, value: np.ndarray) -> float:
        idx = int(scores_to_labels(self._scores(value), self._num_classes)[0])
        return float(self.classes_[idx])

    def predictProbability(self, value: np.ndarray) -> np.ndarray:
        return scores_to_probs(self._scores(value), self._num_classes)[0].cpu().numpy()

    def cpu(self):
        """This model as a pyspark.ml.classification.LogisticRegressionModel
        (needs pyspark and an active SparkSession)."""
        from ..spark.interop import to_spark_logistic_model

        return to_spark_logistic_model(self)

    def _serving_entry(self, mesh: Any = None):
        """Online inference hook (serving/): scores, probabilities and label
        indices of a padded batch from one call on the device, mapped to the
        output columns as transform() maps them."""
        if self._num_models != 1:
            raise ValueError("combined multi-models are not servable")
        from ..serving.entry import kernel_entry

        np_dtype = self._transform_dtype(self.dtype)
        dev = mesh.devices[0] if mesh is not None else _device.resolve()
        W = torch.as_tensor(self.coef_.astype(np_dtype), device=dev)
        b = torch.as_tensor(self.intercept_.astype(np_dtype), device=dev)
        num_classes = self._num_classes

        def serve_kernel(X: torch.Tensor, W: torch.Tensor, b: torch.Tensor):
            scores = logistic_decision_kernel(X, W, b)
            return scores, scores_to_probs(scores, num_classes), scores_to_labels(scores, num_classes)

        return kernel_entry(
            "serve.logreg",
            serve_kernel,
            (W, b),
            self._serve_postprocess(),
            device=dev,
            dtype=np_dtype,
            n_cols=self.n_cols,
            out_cols=[self.getOrDefault(c) for c in ("predictionCol", "probabilityCol", "rawPredictionCol")],
            info={"num_classes": num_classes},
        )

    def _serve_postprocess(self):
        """(scores, probabilities, label indices) host arrays -> the output
        columns, as transform() maps them (the dedicated and the lane
        entries share it)."""
        classes = self.classes_
        num_classes = self._num_classes
        pred_col = self.getOrDefault("predictionCol")
        prob_col = self.getOrDefault("probabilityCol")
        raw_col = self.getOrDefault("rawPredictionCol")

        def post(out) -> Dict[str, Any]:
            scores, probs, labels = out
            raw = scores.astype(np.float64)
            if num_classes == 2 and raw.shape[1] == 1:
                raw = np.concatenate([-raw, raw], axis=1)
            return {
                pred_col: classes[labels.astype(np.int64)].astype(np.float64),
                prob_col: probs.astype(np.float64),
                raw_col: raw,
            }

        return post

    def _lane_entry(self, mesh: Any = None):
        """Multiplexed serving hook (serving/multiplex): (W, b) as ONE lane
        of the lane-stacked fused decision/probability/label kernel.  The
        class labels ride `meta`: variants sharing a lane buffer must agree
        on them, because the shared postprocess maps label indices through
        variant 0's classes_."""
        if self._num_models != 1:
            raise ValueError("combined multi-models are not servable")
        from ..serving.multiplex import LaneEntry

        np_dtype = self._transform_dtype(self.dtype)
        classes = np.asarray(self.classes_)
        return LaneEntry(
            name="lanes.logreg",
            n_cols=self.n_cols,
            dtype=np_dtype,
            out_cols=[self.getOrDefault(c) for c in ("predictionCol", "probabilityCol", "rawPredictionCol")],
            leaves=(np.ascontiguousarray(self.coef_.astype(np_dtype)), np.ascontiguousarray(self.intercept_.astype(np_dtype))),
            kernel=lane_logistic_predict_kernel,
            statics={"num_classes": self._num_classes},
            postprocess=self._serve_postprocess(),
            meta=(str(classes.dtype), classes.tobytes()),
            info={"num_classes": self._num_classes},
            device=mesh.devices[0] if mesh is not None else _device.resolve(),
        )

    @property
    def _num_models(self) -> int:
        return self.coef_.shape[0] if self.coef_.ndim == 3 else 1

    @classmethod
    def _combine(cls, models: List["LogisticRegressionModel"]) -> "LogisticRegressionModel":
        assert models and all(isinstance(m, cls) for m in models)
        first = models[0]
        combined = cls(
            coef_=np.stack([m.coef_ for m in models]),
            intercept_=np.stack([m.intercept_ for m in models]),
            classes_=first.classes_,
            n_cols=first.n_cols,
            dtype=first.dtype,
            num_iters=[int(np.ravel(m.num_iters)[0]) for m in models],
        )
        first._copyValues(combined)
        combined._tpu_params.update(first._tpu_params)
        combined._float32_inputs = first._float32_inputs
        return combined

    def _transformEvaluate(self, dataset: Any, evaluator: Any, params: Any = None) -> List[float]:
        return self._transform_evaluate(dataset, evaluator, self._num_models)

    def _get_eval_predict_func(self):
        """features -> ((M, n) float64 predictions, (M, n, C) float64
        probabilities) of every sub-model: one product of the partition with
        the stacked (M k, D) coefficients."""
        np_dtype = self._transform_dtype(self.dtype)
        dev = _device.resolve()
        coefs = self.coef_ if self.coef_.ndim == 3 else self.coef_[None]  # (M, k, D)
        intercepts = self.intercept_ if self.intercept_.ndim == 2 else self.intercept_[None]  # (M, k)
        M, k, d = coefs.shape
        W = torch.as_tensor(coefs.reshape(M * k, d).astype(np_dtype), device=dev)
        b = torch.as_tensor(intercepts.reshape(M * k).astype(np_dtype), device=dev)
        classes, num_classes = self.classes_, self._num_classes

        def _predict_all(features: Any):
            scores = logistic_decision_kernel(_device_rows(features, np_dtype, dev), W, b).reshape(-1, M, k)
            preds, probs = [], []
            for i in range(M):
                idx = scores_to_labels(scores[:, i], num_classes).cpu().numpy().astype(np.int64)
                preds.append(classes[idx].astype(np.float64))
                probs.append(scores_to_probs(scores[:, i], num_classes).cpu().numpy().astype(np.float64))
            return np.stack(preds), np.stack(probs)

        return _predict_all

    def _out_columns(self) -> List[str]:
        return [
            self.getOrDefault("predictionCol"),
            self.getOrDefault("probabilityCol"),
            self.getOrDefault("rawPredictionCol"),
        ]

    def _get_tpu_transform_func(self, dataset: DataFrame):
        assert self._num_models == 1, "transform() of a combined multi-model: use _transformEvaluate"
        np_dtype = self._transform_dtype(self.dtype)
        W, b = self._device_params(np_dtype)
        classes = self.classes_
        num_classes = self._num_classes
        pred_col = self.getOrDefault("predictionCol")
        prob_col = self.getOrDefault("probabilityCol")
        raw_col = self.getOrDefault("rawPredictionCol")

        def _transform(features: Any) -> Dict[str, Any]:
            if hasattr(features, "tocsr"):  # a CSR partition: ELL on the device
                X = ell_device_from_scipy(features, np_dtype, W.device, transpose=False)
            else:
                X = torch.from_numpy(np.ascontiguousarray(features, dtype=np_dtype)).to(W.device)
            scores = logistic_decision_kernel(X, W, b)
            probs = scores_to_probs(scores, num_classes).cpu().numpy().astype(np.float64)
            idx = scores_to_labels(scores, num_classes).cpu().numpy().astype(np.int64)
            raw = scores.cpu().numpy().astype(np.float64)
            if num_classes == 2 and raw.shape[1] == 1:
                raw = np.concatenate([-raw, raw], axis=1)
            return {pred_col: classes[idx].astype(np.float64), prob_col: probs, raw_col: raw}

        return _transform
