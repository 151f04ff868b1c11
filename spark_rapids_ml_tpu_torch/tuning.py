#
# Model selection: ParamGridBuilder, CrossValidator, CrossValidatorModel.
#
# Counterpart of spark_rapids_ml_tpu/tuning.py.  Two routes:
#   - the fold loop: each fold's train frame is fitted for every param map
#     (fitMultiple: one pass when the estimator fits maps in one pass), and
#     the fold's models are scored on its validation frame, all together
#     through _combine + _transformEvaluate when the estimator supports the
#     evaluator, else one evaluate(transform) a model;
#   - the batched sweep, for estimators whose solvers take candidate lanes
#     (the GLMs, _supportsBatchedSweep): one staged dataset, folds as weight
#     masks, every (fold, map) fit in a few solver passes
#     (_fitBatchedSweep), then single-pass scoring of each fold's
#     validation rows gathered on the device from the staged dataset, in
#     the partitions randomSplit gives the fold: the fold loop's blocks and
#     metric partials without the host copy of the folds and their upload
#     (the JAX package scores host fold frames), so the two routes agree
#     (bit for bit on integer-valued linear data).
# Both end in _finish: the mean and spread of the fold metrics, the best
# map, and its refit on the whole frame (which finds the sweep's staged
# dataset in the fit-input cache).
#
# The route is the batched sweep whenever the estimator accepts it; the
# private _fit(..., batched=False) takes the fold loop (tests and
# chip_smoke.py compare the two).  There is no environment switch, and a
# batched sweep that fails raises: it never falls back to the fold loop.
# Folds run on a thread pool of `parallelism` threads over the one device.
# The JAX package serialises fold fits on its CPU backend (a lock for
# XLA:CPU's cross-module rendezvous); the port has no such rendezvous and
# no lock.
#
# Each stage's wall seconds (the card synchronised at its end) are kept in
# _last_fit_phase_times: tuning.sweep.{ingest,stats,solve,cd,score,refit} on
# the batched route, tuning.folds.{fit,score,refit} on the fold loop, inside
# torch.profiler ranges of the same names; counters tuning.candidates and
# tuning.folds count the batched sweeps' work.
# A live pyspark DataFrame is cross-validated on the cluster, as in the JAX
# package: Spark folds it (_kFold_spark: randomSplit and union, each fold
# cached and unpersisted once scored), each fold fits through the barrier
# stage and is scored on the executors, and the best map is refitted
# through the barrier stage; the dataset is never collected.  That route is
# the fold loop.
#

from __future__ import annotations

import itertools
import json
import os
from multiprocessing.pool import ThreadPool
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import device as _device
from . import profiling
from .core import _TpuEstimator, _TpuModel, _use_executor_path, gather_global_rows
from .core import load as _load_any
from .dataframe import DataFrame, as_dataframe, random_split_ids
from .params import Param, Params, TypeConverters, _dummy
from .utils import get_logger


class ParamGridBuilder:
    """pyspark.ml.tuning.ParamGridBuilder: the product of the grids."""

    def __init__(self) -> None:
        self._param_grid: Dict[Param, List[Any]] = {}

    def addGrid(self, param: Param, values: List[Any]) -> "ParamGridBuilder":
        if not isinstance(param, Param):
            raise TypeError("param must be an instance of Param")
        self._param_grid[param] = list(values)
        return self

    def baseOn(self, *args: Any) -> "ParamGridBuilder":
        if isinstance(args[0], dict):
            for param, value in args[0].items():
                self.addGrid(param, [value])
        else:
            for param, value in args:
                self.addGrid(param, [value])
        return self

    def build(self) -> List[Dict[Param, Any]]:
        keys = list(self._param_grid.keys())
        grids = [self._param_grid[k] for k in keys]
        return [dict(zip(keys, combo)) for combo in itertools.product(*grids)]


class _ValidatorParams(Params):
    numFolds = Param(_dummy(), "numFolds", "number of folds for cross validation (>= 2)", TypeConverters.toInt)
    parallelism = Param(_dummy(), "parallelism", "number of threads to run parallel folds", TypeConverters.toInt)
    collectSubModels = Param(
        _dummy(), "collectSubModels", "whether to collect sub models during fitting", TypeConverters.toBoolean
    )
    seed = Param(_dummy(), "seed", "random seed for fold assignment", TypeConverters.toInt)

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(numFolds=3, parallelism=1, collectSubModels=False, seed=0)
        self._estimator: Optional[_TpuEstimator] = None
        self._evaluator: Any = None
        self._estimatorParamMaps: List[Dict[Param, Any]] = []

    def getEstimator(self) -> Optional[_TpuEstimator]:
        return self._estimator

    def setEstimator(self, value: _TpuEstimator):
        self._estimator = value
        return self

    def getEvaluator(self) -> Any:
        return self._evaluator

    def setEvaluator(self, value: Any):
        self._evaluator = value
        return self

    def getEstimatorParamMaps(self) -> List[Dict[Param, Any]]:
        return self._estimatorParamMaps

    def setEstimatorParamMaps(self, value: List[Dict[Param, Any]]):
        self._estimatorParamMaps = list(value)
        return self

    def getNumFolds(self) -> int:
        return self.getOrDefault("numFolds")

    def setNumFolds(self, value: int):
        self.set(self.getParam("numFolds"), value)
        return self

    def getParallelism(self) -> int:
        return self.getOrDefault("parallelism")

    def setParallelism(self, value: int):
        self.set(self.getParam("parallelism"), value)
        return self

    def getCollectSubModels(self) -> bool:
        return self.getOrDefault("collectSubModels")

    def setSeed(self, value: int):
        self.set(self.getParam("seed"), value)
        return self


class CrossValidator(_ValidatorParams):
    """K-fold cross validation: the batched sweep for the GLMs, else one
    single-pass fit and evaluation a fold where the estimator supports it."""

    def __init__(
        self,
        estimator: Optional[_TpuEstimator] = None,
        estimatorParamMaps: Optional[List[Dict[Param, Any]]] = None,
        evaluator: Any = None,
        numFolds: int = 3,
        seed: int = 0,
        parallelism: int = 1,
        collectSubModels: bool = False,
    ) -> None:
        super().__init__()
        if estimator is not None:
            self.setEstimator(estimator)
        if estimatorParamMaps is not None:
            self.setEstimatorParamMaps(estimatorParamMaps)
        if evaluator is not None:
            self.setEvaluator(evaluator)
        self.setNumFolds(numFolds)
        self.setSeed(seed)
        self.setParallelism(parallelism)
        self.set(self.getParam("collectSubModels"), collectSubModels)
        self.logger = get_logger(type(self))
        self._last_fit_phase_times: Dict[str, float] = {}

    def _kFold(self, df: DataFrame) -> List[Tuple[DataFrame, DataFrame]]:
        """(train, validation) frames of each fold: randomSplit's folds, the
        train frame the other folds' partitions."""
        n = self.getNumFolds()
        folds = df.randomSplit([1.0] * n, seed=self.getOrDefault("seed"))
        return [
            (DataFrame([p for j, f in enumerate(folds) if j != i for p in f.partitions]), folds[i])
            for i in range(n)
        ]

    def _kFold_spark(self, sdf: Any) -> List[Tuple[Any, Any]]:
        """(train, validation) frames of each fold of a live pyspark
        DataFrame, made by Spark (randomSplit and union), each cached: the
        fit and the scoring both act on them."""
        n = self.getNumFolds()
        folds = sdf.randomSplit([1.0] * n, seed=self.getOrDefault("seed"))
        pairs = []
        for i in range(n):
            train = None
            for j, f in enumerate(folds):
                if j == i:
                    continue
                train = f if train is None else train.union(f)
            pairs.append((train.cache(), folds[i].cache()))
        return pairs

    def fit(self, dataset: Any) -> "CrossValidatorModel":
        if _use_executor_path(dataset):
            # the cluster route: folds, fits and scoring stay on the executors
            folds = self._kFold_spark(dataset)

            def _release_fold(train: Any, valid: Any) -> None:
                train.unpersist()
                valid.unpersist()

            try:
                # each fold is released once scored, so the executors never
                # hold every fold's cached frames at once
                return self._fit(dataset, batched=False, datasets=folds, fold_cleanup=_release_fold)
            finally:
                for train, valid in folds:  # the error paths
                    _release_fold(train, valid)
        return self._fit(dataset)

    def _fit(
        self, dataset: Any, batched: bool = True, datasets: Optional[List[Tuple[Any, Any]]] = None,
        fold_cleanup: Optional[Any] = None,
    ) -> "CrossValidatorModel":
        """The cross validation; batched=False takes the fold loop even
        where the batched sweep would run.  `datasets` gives the folds'
        (train, validation) frames (the cluster route's), and
        `fold_cleanup(train, validation)` runs after each fold."""
        if datasets is not None:
            est, eva, epm = self.getEstimator(), self.getEvaluator(), self.getEstimatorParamMaps()
            assert est is not None and eva is not None and epm, "estimator, evaluator and estimatorParamMaps must be set"
            profiling.reset_phase_times()
            single_pass = isinstance(est, _TpuEstimator) and est._supportsTransformEvaluate(eva)
            model = self._fit_folds(dataset, est, eva, epm, single_pass, datasets, fold_cleanup)
            self._last_fit_phase_times = profiling.phase_times()
            return model
        df = as_dataframe(dataset)
        est, eva, epm = self.getEstimator(), self.getEvaluator(), self.getEstimatorParamMaps()
        assert est is not None and eva is not None and epm, "estimator, evaluator and estimatorParamMaps must be set"
        profiling.reset_phase_times()
        single_pass = isinstance(est, _TpuEstimator) and est._supportsTransformEvaluate(eva)
        if batched and single_pass and est._supportsBatchedSweep(df, epm, eva):
            model = self._fit_batched(df, est, eva, epm)
        else:
            model = self._fit_folds(df, est, eva, epm, single_pass)
        self._last_fit_phase_times = profiling.phase_times()
        return model

    def _fit_folds(
        self, df: Any, est: _TpuEstimator, eva: Any, epm: List[Dict[Param, Any]], single_pass: bool,
        datasets: Optional[List[Tuple[Any, Any]]] = None, fold_cleanup: Optional[Any] = None,
    ) -> "CrossValidatorModel":
        n_folds = self.getNumFolds()
        collect_sub = self.getCollectSubModels()
        if datasets is None:
            datasets = self._kFold(df)
        dev = _device.resolve()

        def one_fold(fold: int):
            train, valid = datasets[fold]
            try:
                with profiling.phase("tuning.folds.fit", dev):
                    models = [m for _, m in sorted(est.fitMultiple(train, epm), key=lambda im: im[0])]
                with profiling.phase("tuning.folds.score", dev):
                    if single_pass:
                        metrics = models[0]._combine(models)._transformEvaluate(valid, eva)
                    else:
                        metrics = [eva.evaluate(m.transform(valid)) for m in models]
            finally:
                if fold_cleanup is not None:
                    fold_cleanup(train, valid)
            return fold, metrics, models if collect_sub else None

        metrics_all: List[List[float]] = [[] for _ in range(n_folds)]
        sub_models: Optional[List[List[_TpuModel]]] = [[] for _ in range(n_folds)] if collect_sub else None
        pool = ThreadPool(processes=min(self.getParallelism(), max(1, n_folds)))
        try:
            for fold, metrics, models in pool.imap_unordered(one_fold, range(n_folds)):
                metrics_all[fold] = metrics
                if sub_models is not None:
                    sub_models[fold] = models
        finally:
            pool.close()
            pool.join()
        return self._finish(df, est, eva, epm, metrics_all, sub_models, "tuning.folds")

    def _fit_batched(
        self, df: DataFrame, est: _TpuEstimator, eva: Any, epm: List[Dict[Param, Any]]
    ) -> "CrossValidatorModel":
        """The batched sweep: every (fold, map) fit over one staged dataset,
        then the fold loop's own validation frames and single-pass scoring."""
        n_folds = self.getNumFolds()
        dev = _device.resolve()
        with profiling.phase("tuning.sweep", dev):
            profiling.incr_counter("tuning.candidates", len(epm))
            profiling.incr_counter("tuning.folds", n_folds)
            fold_results = est._fitBatchedSweep(df, epm, n_folds, self.getOrDefault("seed"))
            # the sequential fits' own materialisation, map values included
            fold_models = [
                [est._materialize_model(dict(attrs), epm[i]) for i, attrs in enumerate(results)]
                for results in fold_results
            ]
            with profiling.phase("tuning.sweep.score", dev):
                metrics_all = self._score_staged(df, est, eva, fold_models)
        self.logger.info("batched sweep: %d candidates x %d folds over one staged dataset", len(epm), n_folds)
        sub_models = fold_models if self.getCollectSubModels() else None
        return self._finish(df, est, eva, epm, metrics_all, sub_models, "tuning.sweep")

    def _score_staged(
        self, df: DataFrame, est: _TpuEstimator, eva: Any, fold_models: List[List[_TpuModel]]
    ) -> List[List[float]]:
        """Each fold's models scored in one pass over its validation rows,
        gathered on the device from the sweep's staged dataset (the
        fit-input cache's) in the partitions randomSplit gives the fold: the
        fold loop's frames, rows and metric partials, without their host
        copy and upload."""
        inputs = est._build_fit_inputs(df)
        label_col = est.getOrDefault("labelCol")
        labels = np.concatenate([np.asarray(p[label_col]) for p in df.partitions])
        fold_of = random_split_ids(inputs.n_rows, self.getNumFolds(), self.getOrDefault("seed"))
        metrics_all = []
        for fold, models in enumerate(fold_models):
            rows = np.flatnonzero(fold_of == fold)
            blocks = (
                (gather_global_rows(inputs.X, ix, inputs.device), labels[ix])
                for ix in np.array_split(rows, max(1, df.num_partitions))
                if len(ix)
            )
            metrics_all.append(models[0]._combine(models)._evaluate_blocks(blocks, eva, len(models)))
        return metrics_all

    def _finish(
        self,
        df: Any,
        est: _TpuEstimator,
        eva: Any,
        epm: List[Dict[Param, Any]],
        metrics_all: List[List[float]],
        sub_models: Optional[List[List[_TpuModel]]],
        route: str,
    ) -> "CrossValidatorModel":
        """Both routes' tail: the mean and spread of the fold metrics, the
        best map, its refit on the whole frame."""
        avg = np.mean(np.asarray(metrics_all), axis=0)
        std = np.std(np.asarray(metrics_all), axis=0)
        best_index = int(np.argmax(avg) if eva.isLargerBetter() else np.argmin(avg))
        self.logger.info("CV avg metrics: %s; best param map index: %d", avg.tolist(), best_index)
        with profiling.phase(f"{route}.refit", _device.resolve()):
            best_model = est.fit(df, epm[best_index])
        cv_model = CrossValidatorModel(
            bestModel=best_model, avgMetrics=avg.tolist(), subModels=sub_models, stdMetrics=std.tolist()
        )
        cv_model._estimator = est
        cv_model._evaluator = eva
        cv_model._estimatorParamMaps = epm
        self._copyValues(cv_model)
        return cv_model

    def copy(self, extra: Optional[Dict] = None) -> "CrossValidator":
        """pyspark CrossValidator.copy: the estimator and the evaluator are
        copied too, and the param-map list duplicated."""
        that = super().copy(extra)
        if self._estimator is not None:
            that._estimator = self._estimator.copy()
        if self._evaluator is not None and hasattr(self._evaluator, "copy"):
            that._evaluator = self._evaluator.copy()
        that._estimatorParamMaps = [dict(pm) for pm in self._estimatorParamMaps]
        return that


class CrossValidatorModel(_ValidatorParams):
    def __init__(
        self,
        bestModel: _TpuModel,
        avgMetrics: Optional[List[float]] = None,
        subModels: Optional[List[List[_TpuModel]]] = None,
        stdMetrics: Optional[List[float]] = None,
    ) -> None:
        super().__init__()
        self.bestModel = bestModel
        self.avgMetrics = avgMetrics or []
        self.stdMetrics = stdMetrics or []
        self.subModels = subModels

    def transform(self, dataset: Any) -> DataFrame:
        return self.bestModel.transform(dataset)

    def write(self) -> "_CrossValidatorModelWriter":
        return _CrossValidatorModelWriter(self)

    def save(self, path: str) -> None:
        self.write().save(path)

    @classmethod
    def read(cls) -> "_CrossValidatorModelReader":
        return _CrossValidatorModelReader()

    @classmethod
    def load(cls, path: str) -> "CrossValidatorModel":
        return cls.read().load(path)


class _CrossValidatorModelWriter:
    """The JAX package's layout: metadata.json (avgMetrics, stdMetrics,
    numFolds) and the best model under bestModel/."""

    def __init__(self, instance: CrossValidatorModel):
        self.instance = instance

    def overwrite(self) -> "_CrossValidatorModelWriter":
        return self

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        meta = {
            "class": f"{__name__}.CrossValidatorModel",
            "avgMetrics": self.instance.avgMetrics,
            "stdMetrics": self.instance.stdMetrics,
            "numFolds": self.instance.getNumFolds(),
        }
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(meta, f, indent=2)
        self.instance.bestModel.save(os.path.join(path, "bestModel"))


class _CrossValidatorModelReader:
    """Reads the layout above, also as the JAX package writes it (its best
    model loads through core.load's class mapping)."""

    def load(self, path: str) -> CrossValidatorModel:
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        model = CrossValidatorModel(
            bestModel=_load_any(os.path.join(path, "bestModel")),  # type: ignore[arg-type]
            avgMetrics=meta.get("avgMetrics"),
            stdMetrics=meta.get("stdMetrics"),
        )
        model.setNumFolds(meta.get("numFolds", 3))
        return model
