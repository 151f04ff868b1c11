#
# UMAP estimator/model.
#
# Counterpart of spark_rapids_ml_tpu/models/umap.py: the same solver params
# through the identity mapping plus sample_fraction and outputCol
# "embedding", the same model attributes (embedding_, raw_data_, n_cols,
# dtype).  The fit samples with np.random.default_rng(seed), builds the
# exact kNN self-join at query_block 32768 over the device-resident
# FitInputs.X (its row shards gathered onto the mesh's first device,
# core.whole_rows; ops/knn: kernels B5 -> B7 on the card; row-sharded over
# the mesh with num_workers > 1), the IVF-Flat self-join (built on the mesh's
# first device, searched on the mesh), or takes precomputed_knn, then runs
# ops/umap.umap_fit_embedding on the mesh (its layout column-sharded over
# more than one shard).  With labelCol
# set the fit is supervised (NaN labels are unknown).  raw_data_ stays the
# device tensor when it is float32 and is fetched to the host on save.
# Transform stages the training rows once (prepare_items), uploads the
# embedding once, and per partition runs the query search and the
# refinement epochs.
#
# The JAX package's environment knobs are engine options with its defaults
# (setEngineOptions, or keywords of _get_tpu_fit_func): graph "exact" or
# "ivfflat" (SRML_UMAP_ANN: the IVF-Flat self-join of ann/ivfflat, B1 in its
# index build), ann_nlist / ann_nprobe (SRML_UMAP_ANN_NLIST / _NPROBE, 0 =
# sqrt(n) lists, half of them probed), degree_cap, degree_quantile,
# epoch_block and table_size (SRML_UMAP_DEGREE_CAP, _DEGREE_QUANTILE,
# _EPOCH_BLOCK, _TABLE).
#
# On a Spark cluster of more than one worker the fit runs as one barrier
# task, sampled with Spark before the coalesce (_cluster_fit_single_task,
# spark/adapter.barrier_fit_estimator); transform stays on the executors.
# UMAPModel has no cpu(), as in the JAX package (pyspark.ml has no UMAP).
# UMAPModel has no serving entry, as in the JAX package: serving one raises
# the base hook's error (core._TpuModel._serving_entry).
#

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..core import FitInputs, _TpuEstimator, _TpuModel, whole_rows
from ..dataframe import DataFrame
from ..ops.knn import knn_search_prepared, prepare_items
from ..ops.umap import (
    DEGREE_CAP,
    DEGREE_QUANTILE,
    EPOCH_BLOCK,
    NEG_TABLE,
    find_ab_params,
    umap_fit_embedding,
    umap_transform_embedding,
)
from ..parallel.mesh import Mesh, get_mesh
from ..params import (
    HasFeaturesCol,
    HasFeaturesCols,
    HasLabelCol,
    HasOutputCol,
    Param,
    TypeConverters,
    _dummy,
    _TpuParams,
)
from ..profiling import phase
from ..utils import get_logger


_ENGINE_DEFAULTS: Dict[str, Any] = {
    "graph": "exact",
    "ann_nlist": 0,
    "ann_nprobe": 0,
    "degree_cap": DEGREE_CAP,
    "degree_quantile": DEGREE_QUANTILE,
    "epoch_block": EPOCH_BLOCK,
    "table_size": NEG_TABLE,
}


def engine_options(base: Dict[str, Any], **overrides: Any) -> Dict[str, Any]:
    """The engine options: the defaults, then `base`, then `overrides`,
    checked."""
    unknown = set(base) | set(overrides)
    unknown -= set(_ENGINE_DEFAULTS)
    if unknown:
        raise ValueError(f"unknown UMAP engine options {sorted(unknown)}; known: {sorted(_ENGINE_DEFAULTS)}")
    opts = {**_ENGINE_DEFAULTS, **base, **overrides}
    if opts["graph"] not in ("exact", "ivfflat"):
        raise ValueError(f"graph={opts['graph']!r} is not supported (only 'exact' or 'ivfflat')")
    return opts


def _ann_self_join(X: np.ndarray, k: int, seed: int, mesh: Mesh, nlist: int = 0, nprobe: int = 0):
    """(dists, ids) kNN self-join through the IVF-Flat engine: sqrt(n) lists
    and half of them probed by default (the graph feeds the layout's
    attraction edges, so it probes deeper than serving's quarter).  The
    index is built on the mesh's first device and searched on the mesh."""
    from ..ann.ivfflat import build_ivfflat_packed, default_nlist, index_from_packed, ivfflat_search_prepared

    n = X.shape[0]
    nlist = int(nlist) or default_nlist(n)
    nprobe = int(nprobe) or max(8, nlist // 2)
    packed = build_ivfflat_packed(X, np.arange(n, dtype=np.int64), nlist, seed=seed, device=mesh.devices[0])
    dists, ids = ivfflat_search_prepared(index_from_packed(packed, mesh), X, k, nprobe)
    if (ids < 0).any():
        # the graph assembly takes ids as dense row indices: a -1 slot (the
        # probed lists held fewer than k rows) must not become an edge
        raise RuntimeError(
            "IVF-Flat self-join returned unfillable neighbor slots at "
            f"nlist={nlist} nprobe={nprobe}; raise ann_nprobe (or use graph='exact')"
        )
    return dists, ids


class UMAPClass(_TpuParams):
    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        # identity mapping: every route that sets the Spark param (copy,
        # param maps, set) reaches the solver dict too
        return {
            name: name
            for name in (
                "n_neighbors", "n_components", "metric", "n_epochs", "learning_rate", "init", "min_dist",
                "spread", "set_op_mix_ratio", "local_connectivity", "repulsion_strength",
                "negative_sample_rate", "transform_queue_size", "a", "b", "random_state",
            )
        }

    @classmethod
    def _get_tpu_params_default(cls) -> Dict[str, Any]:
        return {
            "n_neighbors": 15,
            "n_components": 2,
            "metric": "euclidean",
            "n_epochs": None,
            "learning_rate": 1.0,
            "init": "spectral",
            "min_dist": 0.1,
            "spread": 1.0,
            "set_op_mix_ratio": 1.0,
            "local_connectivity": 1.0,
            "repulsion_strength": 1.0,
            "negative_sample_rate": 5,
            "transform_queue_size": 4.0,
            "a": None,
            "b": None,
            "precomputed_knn": None,
            "random_state": None,
            "verbose": False,
        }


class _UMAPParams(UMAPClass, HasFeaturesCol, HasFeaturesCols, HasLabelCol, HasOutputCol):
    n_neighbors = Param(_dummy(), "n_neighbors", "size of the local neighborhood", TypeConverters.toFloat)
    n_components = Param(_dummy(), "n_components", "dimension of the embedded space", TypeConverters.toInt)
    metric = Param(_dummy(), "metric", "distance metric (euclidean)", TypeConverters.toString)
    n_epochs = Param(_dummy(), "n_epochs", "number of optimization epochs", TypeConverters.toInt)
    learning_rate = Param(_dummy(), "learning_rate", "initial embedding learning rate", TypeConverters.toFloat)
    init = Param(_dummy(), "init", "low-dim initialization (spectral|random)", TypeConverters.toString)
    min_dist = Param(_dummy(), "min_dist", "minimum embedded point distance", TypeConverters.toFloat)
    spread = Param(_dummy(), "spread", "scale of the embedded points", TypeConverters.toFloat)
    set_op_mix_ratio = Param(_dummy(), "set_op_mix_ratio", "fuzzy union vs intersection mix", TypeConverters.toFloat)
    local_connectivity = Param(_dummy(), "local_connectivity", "local connectivity (nearest assumed-connected neighbors)", TypeConverters.toFloat)
    repulsion_strength = Param(_dummy(), "repulsion_strength", "weight of negative samples", TypeConverters.toFloat)
    negative_sample_rate = Param(_dummy(), "negative_sample_rate", "negative samples per positive", TypeConverters.toInt)
    transform_queue_size = Param(_dummy(), "transform_queue_size", "transform search queue factor", TypeConverters.toFloat)
    a = Param(_dummy(), "a", "embedding curve parameter a", TypeConverters.toFloat)
    b = Param(_dummy(), "b", "embedding curve parameter b", TypeConverters.toFloat)
    random_state = Param(_dummy(), "random_state", "random seed", TypeConverters.toInt)
    sample_fraction = Param(_dummy(), "sample_fraction", "fraction of rows used for fit", TypeConverters.toFloat)

    # engine options set through setEngineOptions (not Spark params, not
    # persisted); replaced, never mutated, so copies may share it
    _engine: Dict[str, Any] = {}

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self._setDefault(sample_fraction=1.0, outputCol="embedding")

    def getSampleFraction(self) -> float:
        return self.getOrDefault("sample_fraction")

    def setSampleFraction(self, value: float):
        return self._set_params(sample_fraction=value)

    def setOutputCol(self, value: str):
        return self._set_params(outputCol=value)

    def setFeaturesCol(self, value: Union[str, List[str]]):
        if isinstance(value, str):
            self._set_params(featuresCol=value)
        else:
            self._set_params(featuresCols=value)
        return self

    def setEngineOptions(self, **options: Any):
        """Engine options in place of the JAX package's environment knobs:
        graph ("exact" | "ivfflat"), ann_nlist, ann_nprobe, degree_cap,
        degree_quantile, epoch_block, table_size."""
        engine_options(self._engine, **options)
        self._engine = {**self._engine, **options}
        return self


def _seed_of(params: Dict[str, Any]) -> int:
    seed = params.get("random_state")
    return int(seed) & 0x7FFFFFFF if seed is not None else 42


class UMAP(_UMAPParams, _TpuEstimator):
    """UMAP on one device or a mesh: the exact kNN graph on the card's kNN
    kernels, the fuzzy graph assembled on the device, the spectral init and
    the SGD layout with the JAX package's threefry draws."""

    # single-node fit by design, as the JAX package's; on a cluster the
    # adapter runs it as one barrier task
    _supports_multicontroller_fit = False
    _cluster_fit_single_task = True

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._initialize_tpu_params()
        self._set_params(**kwargs)

    def _fit_label_col(self) -> Optional[str]:
        # supervised only when the user set labelCol
        return self.getOrDefault("labelCol") if self.isSet("labelCol") else None

    def _get_tpu_fit_func(self, dataset: DataFrame, extra_params=None, **engine: Any):
        logger = get_logger(type(self))
        sample_fraction = self.getSampleFraction()
        opts = engine_options(self._engine, **engine)
        num_workers = self.num_workers

        def _fit(inputs: FitInputs, params: Dict[str, Any]) -> Dict[str, Any]:
            valid = (whole_rows(inputs.weight) > 0).cpu().numpy()
            seed = _seed_of(params)
            X = whole_rows(inputs.X)
            y = inputs.host_y[valid[: inputs.n_rows]] if inputs.host_y is not None else None
            if not valid.all():
                X = X[torch.from_numpy(np.flatnonzero(valid)).to(X.device)]
            if sample_fraction < 1.0:
                keep = np.random.default_rng(seed).random(X.shape[0]) < sample_fraction
                X = X[torch.from_numpy(np.flatnonzero(keep)).to(X.device)]
                y = y[keep] if y is not None else None
            n = X.shape[0]
            if n == 0:
                raise RuntimeError(
                    "UMAP fit received 0 rows after sampling "
                    f"(sample_fraction={sample_fraction}); increase sample_fraction or the dataset size"
                )
            k = int(min(params["n_neighbors"], n))
            mesh = get_mesh(num_workers)
            with phase("umap.knn", X.device):
                if params.get("precomputed_knn") is not None:
                    pre_ids, pre_dists = params["precomputed_knn"]
                    ids = np.asarray(pre_ids)[:, :k]
                    dists = np.asarray(pre_dists)[:, :k]
                    if ids.shape[0] != n:
                        raise ValueError(
                            f"precomputed_knn has {ids.shape[0]} rows but the (sampled) training set has {n}"
                        )
                elif opts["graph"] == "ivfflat":
                    dists, ids = _ann_self_join(
                        X.float().cpu().numpy(), k, seed, mesh, opts["ann_nlist"], opts["ann_nprobe"]
                    )
                else:
                    prepared = prepare_items(X, np.arange(n, dtype=np.int64), mesh)
                    dists, ids = knn_search_prepared(prepared, X, k, query_block=32768)
                    del prepared
            a, b = params.get("a"), params.get("b")
            if a is None or b is None:
                a, b = find_ab_params(float(params["spread"]), float(params["min_dist"]))
            logger.info("UMAP graph built: n=%d k=%d (a=%.3f b=%.3f)", n, k, a, b)
            embedding = umap_fit_embedding(
                ids,
                dists,
                n_components=int(params["n_components"]),
                a=a,
                b=b,
                n_epochs=params.get("n_epochs"),
                learning_rate=float(params["learning_rate"]),
                init=str(params["init"]),
                set_op_mix_ratio=float(params["set_op_mix_ratio"]),
                local_connectivity=float(params["local_connectivity"]),
                repulsion_strength=float(params["repulsion_strength"]),
                negative_sample_rate=int(params["negative_sample_rate"]),
                seed=seed,
                y=y,
                mesh=mesh,
                degree_cap=int(opts["degree_cap"]),
                degree_quantile=float(opts["degree_quantile"]),
                epoch_block=int(opts["epoch_block"]),
                table_size=int(opts["table_size"]),
            )
            # a float32 training set stays the device tensor; others go to
            # the host rather than take a float32 copy on the device
            raw = X if X.dtype == torch.float32 else X.float().cpu().numpy()
            return {
                "embedding_": embedding.astype(np.float32),
                "raw_data_": raw,
                "n_cols": inputs.n_cols,
                "dtype": str(inputs.dtype),
            }

        return _fit

    def _create_model(self, result: Dict[str, Any]) -> "UMAPModel":
        model = UMAPModel(**result)
        model._engine = self._engine
        return model


class UMAPModel(_UMAPParams, _TpuModel):
    def __init__(self, embedding_: np.ndarray, raw_data_: Any, n_cols: int, dtype: str) -> None:
        # raw_data_ may be the fit's device tensor: transform stages it on
        # the device as it is, save fetches a host copy once
        raw = raw_data_ if isinstance(raw_data_, torch.Tensor) else np.asarray(raw_data_)
        super().__init__(
            embedding_=np.asarray(embedding_),
            raw_data_=raw,
            n_cols=int(n_cols),
            dtype=str(dtype),
        )
        self.embedding_ = np.asarray(embedding_)
        self.raw_data_ = raw
        self.n_cols = int(n_cols)
        self.dtype = str(dtype)

    def _get_model_attributes(self) -> Dict[str, Any]:
        attrs = self._model_attributes
        if isinstance(attrs["raw_data_"], torch.Tensor):
            attrs["raw_data_"] = attrs["raw_data_"].cpu().numpy()
            self.raw_data_ = attrs["raw_data_"]
        return attrs

    @property
    def embedding(self) -> np.ndarray:
        return self.embedding_

    def _out_columns(self) -> List[str]:
        return [self.getOrDefault("outputCol")]

    def _get_tpu_transform_func(self, dataset: DataFrame):
        out_col = self.getOrDefault("outputCol")
        p = self._tpu_params
        nr = int(self.raw_data_.shape[0])
        k = int(min(p.get("n_neighbors", 15), nr))
        local_connectivity = float(p.get("local_connectivity", 1.0))
        a, b = p.get("a"), p.get("b")
        if a is None or b is None:
            a, b = find_ab_params(float(p.get("spread", 1.0)), float(p.get("min_dist", 0.1)))
        seed = _seed_of(p)
        epoch_block = int(engine_options(self._engine)["epoch_block"])
        mesh: Mesh = get_mesh(self.num_workers)
        # the training rows and the embedding go to the device once, for
        # every partition
        prepared = prepare_items(self.raw_data_, np.arange(nr, dtype=np.int64), mesh)
        emb_f32 = self.embedding_.astype(np.float32)
        emb_dev = torch.from_numpy(emb_f32).to(mesh.devices[0])

        def _transform(features: np.ndarray) -> Dict[str, Any]:
            dists, ids = knn_search_prepared(prepared, features, k)
            emb = umap_transform_embedding(
                ids,
                dists,
                emb_f32,
                local_connectivity,
                a=a,
                b=b,
                n_epochs=p.get("n_epochs"),
                learning_rate=float(p.get("learning_rate", 1.0)),
                repulsion_strength=float(p.get("repulsion_strength", 1.0)),
                negative_sample_rate=int(p.get("negative_sample_rate", 5)),
                seed=seed,
                train_embedding_dev=emb_dev,
                epoch_block=epoch_block,
            )
            return {out_col: emb.astype(np.float64)}

        return _transform
