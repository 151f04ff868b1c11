#
# Weights carried across from the JAX package.
#
# A JAX-fitted model's _get_model_attributes(), with its arrays as numpy,
# becomes the port's model.  Neither framework's other side is imported:
# the attributes are plain numpy and Python values.
#

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from .models.kmeans import KMeansModel
from .models.random_forest import RandomForestClassificationModel, RandomForestRegressionModel


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
