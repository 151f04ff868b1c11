#
# Weights carried across from the JAX package.
#
# A JAX-fitted model's _get_model_attributes(), with its arrays as numpy,
# becomes the port's model.  Neither framework's other side is imported:
# the attributes are plain numpy and Python values.
#

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from .dataframe import DataFrame
from .models.approximate_nn import ApproximateNearestNeighbors, ApproximateNearestNeighborsModel
from .models.kmeans import KMeansModel
from .models.knn import NearestNeighbors, NearestNeighborsModel
from .models.linear_regression import LinearRegressionModel
from .models.logistic_regression import LogisticRegressionModel
from .models.pca import PCAModel
from .models.random_forest import RandomForestClassificationModel, RandomForestRegressionModel
from .models.umap import UMAPModel
from .stream.state import KINDS, WIRE_SCHEMA, StreamState


def kmeans_model_from_reference(attrs: Dict[str, Any]) -> KMeansModel:
    """KMeansModel from the JAX package's KMeansModel attributes
    (cluster_centers_, n_cols, dtype, n_iter_, inertia_)."""
    return KMeansModel(
        cluster_centers_=np.asarray(attrs["cluster_centers_"]),
        n_cols=int(attrs["n_cols"]),
        dtype=str(attrs["dtype"]),
        n_iter_=int(attrs.get("n_iter_", 0)),
        inertia_=float(attrs.get("inertia_", 0.0)),
    )


def pca_model_from_reference(attrs: Dict[str, Any]) -> PCAModel:
    """PCAModel from the JAX package's PCAModel attributes (mean_,
    components_, explained_variance_, explained_variance_ratio_,
    singular_values_, n_cols, dtype)."""
    return PCAModel(
        **{name: np.asarray(attrs[name], np.float64) for name in (
            "mean_", "components_", "explained_variance_", "explained_variance_ratio_", "singular_values_")},
        n_cols=int(attrs["n_cols"]),
        dtype=str(attrs["dtype"]),
    )


def linear_regression_model_from_reference(attrs: Dict[str, Any]) -> LinearRegressionModel:
    """LinearRegressionModel from the JAX package's LinearRegressionModel
    attributes (coef_, intercept_, n_cols, dtype) of a single model."""
    return LinearRegressionModel(
        coef_=np.asarray(attrs["coef_"], np.float64),
        intercept_=float(attrs["intercept_"]),
        n_cols=int(attrs["n_cols"]),
        dtype=str(attrs["dtype"]),
    )


def logistic_regression_model_from_reference(attrs: Dict[str, Any]) -> LogisticRegressionModel:
    """LogisticRegressionModel from the JAX package's LogisticRegressionModel
    attributes (coef_ (k, D), intercept_ (k,), classes_, n_cols, dtype,
    num_iters) of a single model."""
    return LogisticRegressionModel(
        coef_=np.asarray(attrs["coef_"], np.float64),
        intercept_=np.asarray(attrs["intercept_"], np.float64),
        classes_=np.asarray(attrs["classes_"], np.float64),
        n_cols=int(attrs["n_cols"]),
        dtype=str(attrs["dtype"]),
        num_iters=int(np.ravel(attrs.get("num_iters", 0))[0]),
    )


def random_forest_model_from_reference(attrs: Dict[str, Any]):
    """RandomForestClassificationModel (when the attributes carry classes_)
    or RandomForestRegressionModel from the JAX package's forest model
    attributes (features_, thresholds_, leaf_values_, node_counts_,
    impurities_, max_depth, n_cols, dtype[, classes_, num_classes])."""
    common = dict(
        features_=np.asarray(attrs["features_"], np.int32),
        thresholds_=np.asarray(attrs["thresholds_"], np.float32),
        leaf_values_=np.asarray(attrs["leaf_values_"], np.float32),
        node_counts_=np.asarray(attrs["node_counts_"], np.float32),
        impurities_=np.asarray(attrs["impurities_"], np.float32),
        max_depth=int(attrs["max_depth"]),
        n_cols=int(attrs["n_cols"]),
        dtype=str(attrs["dtype"]),
    )
    if "classes_" in attrs:
        return RandomForestClassificationModel(
            classes_=np.asarray(attrs["classes_"]), num_classes=int(attrs["num_classes"]), **common
        )
    return RandomForestRegressionModel(**common)


def umap_model_from_reference(attrs: Dict[str, Any]) -> UMAPModel:
    """UMAPModel from the JAX package's UMAPModel attributes (embedding_,
    raw_data_, n_cols, dtype); the Spark params are the estimator's to set."""
    return UMAPModel(
        embedding_=np.asarray(attrs["embedding_"], np.float32),
        raw_data_=np.asarray(attrs["raw_data_"], np.float32),
        n_cols=int(attrs["n_cols"]),
        dtype=str(attrs["dtype"]),
    )


def nearest_neighbors_model_from_reference(
    items: np.ndarray, ids: np.ndarray, params: Dict[str, Any]
) -> NearestNeighborsModel:
    """A fitted NearestNeighborsModel from what a JAX NearestNeighborsModel
    holds: kNN learns no weights, its state is the item set (items (n, D))
    with its int64 ids, and its Spark params (k, idCol, featuresCol, ...).
    The ids go in the id column as they are, generated or not."""
    est = NearestNeighbors(**params)
    item_df = DataFrame(
        [{est.getOrDefault("featuresCol"): np.asarray(items), est.getIdCol(): np.asarray(ids, np.int64)}]
    )
    return est._model_for(item_df)


def stream_state_from_reference(d: Dict[str, Any]) -> StreamState:
    """The port's StreamState from a JAX streaming engine's state_dict()
    (or any srml-stream/v1 wire dict): checked against the schema, the
    kinds and the shapes each field declares.  A port engine's merge()
    takes the result, so a stream begun by the JAX package goes on here."""
    if d.get("schema") != WIRE_SCHEMA:
        raise ValueError(f"unknown stream state schema {d.get('schema')!r}; expected {WIRE_SCHEMA}")
    if d.get("kind") not in KINDS:
        raise ValueError(f"unknown stream state kind {d.get('kind')!r}; one of {KINDS}")
    for name, spec in d["arrays"].items():
        if int(np.prod(spec["shape"], dtype=np.int64)) != len(spec["data"]):
            raise ValueError(f"stream state field {name!r}: {len(spec['data'])} values for shape {spec['shape']}")
    return StreamState.from_dict(d)


_ANN_ATTRS = (
    "centroids_", "packed_items_", "packed_ids_", "list_counts_", "n_lists", "n_items", "n_cols", "dtype",
    "pq_codes_", "pq_scalars_", "pq_codebooks_", "pq_n_bits", "pq_rotation_",
)


def approximate_nearest_neighbors_model_from_reference(
    attrs: Dict[str, Any], params: Optional[Dict[str, Any]] = None
) -> ApproximateNearestNeighborsModel:
    """ApproximateNearestNeighborsModel from the JAX package's model
    attributes (centroids_, packed_items_, packed_ids_, list_counts_, n_lists,
    n_items, n_cols, dtype and, for ivfpq, pq_codes_, pq_scalars_,
    pq_codebooks_, pq_n_bits, pq_rotation_) and optionally its Spark params
    (k, algorithm, algoParams, ...).  Without an `algorithm` param it
    follows the payload: ivfpq when the attributes carry PQ codes."""
    params = dict(params or {})
    params.setdefault("algorithm", "ivfflat" if attrs.get("pq_codes_") is None else "ivfpq")
    model = ApproximateNearestNeighborsModel(**{name: attrs.get(name) for name in _ANN_ATTRS if name in attrs})
    est = ApproximateNearestNeighbors(**params)
    est._copyValues(model)
    model._tpu_params.update(est._tpu_params)
    return model
