#
# spark_rapids_ml_tpu_torch: the PyTorch/CUDA port of spark_rapids_ml_tpu.
# Same estimators, models and DataFrame facade; plain tensor code is PyTorch,
# and each TPU kernel of the JAX package becomes a CUDA kernel written by
# hand for Hopper (csrc/).  Entry points run on cuda:0 unless the caller
# asks for the CPU with device.use_device("cpu").
#
from .version import __version__
from .core import clear_fit_cache, load
from .dataframe import DataFrame
from .evaluation import (
    BinaryClassificationEvaluator,
    ClusteringEvaluator,
    MulticlassClassificationEvaluator,
    RegressionEvaluator,
)
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
from .models.umap import UMAP, UMAPModel
from .pipeline import Pipeline, PipelineModel
from .stream import StreamingSession, streaming_fit
from .tuning import CrossValidator, CrossValidatorModel, ParamGridBuilder

__all__ = [
    "__version__",
    "ApproximateNearestNeighbors",
    "ApproximateNearestNeighborsModel",
    "BinaryClassificationEvaluator",
    "ClusteringEvaluator",
    "CrossValidator",
    "CrossValidatorModel",
    "DataFrame",
    "KMeans",
    "KMeansModel",
    "LinearRegression",
    "LinearRegressionModel",
    "LogisticRegression",
    "LogisticRegressionModel",
    "MulticlassClassificationEvaluator",
    "NearestNeighbors",
    "NearestNeighborsModel",
    "PCA",
    "PCAModel",
    "ParamGridBuilder",
    "Pipeline",
    "PipelineModel",
    "RandomForestClassificationModel",
    "RandomForestClassifier",
    "RandomForestRegressionModel",
    "RandomForestRegressor",
    "RegressionEvaluator",
    "StreamingSession",
    "UMAP",
    "UMAPModel",
    "clear_fit_cache",
    "load",
    "streaming_fit",
]
