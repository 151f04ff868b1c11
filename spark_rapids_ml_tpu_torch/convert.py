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
