#
# spark_rapids_ml_tpu_torch: the PyTorch/CUDA port of spark_rapids_ml_tpu.
# Same estimators, models and DataFrame facade; plain tensor code is PyTorch,
# and each TPU kernel of the JAX package becomes a CUDA kernel written by
# hand for Hopper (csrc/).  Entry points run on cuda:0 unless the caller
# asks for the CPU with device.use_device("cpu").
#
from .version import __version__
from .core import load
from .dataframe import DataFrame
from .models.approximate_nn import ApproximateNearestNeighbors, ApproximateNearestNeighborsModel
from .models.kmeans import KMeans, KMeansModel
from .models.knn import NearestNeighbors, NearestNeighborsModel
from .models.linear_regression import LinearRegression, LinearRegressionModel
from .models.logistic_regression import LogisticRegression, LogisticRegressionModel
from .models.pca import PCA, PCAModel
from .models.random_forest import (
    RandomForestClassificationModel,
    RandomForestClassifier,
    RandomForestRegressionModel,
    RandomForestRegressor,
)

__all__ = [
    "__version__",
    "ApproximateNearestNeighbors",
    "ApproximateNearestNeighborsModel",
    "DataFrame",
    "KMeans",
    "KMeansModel",
    "LinearRegression",
    "LinearRegressionModel",
    "LogisticRegression",
    "LogisticRegressionModel",
    "NearestNeighbors",
    "NearestNeighborsModel",
    "PCA",
    "PCAModel",
    "RandomForestClassificationModel",
    "RandomForestClassifier",
    "RandomForestRegressionModel",
    "RandomForestRegressor",
    "load",
]
