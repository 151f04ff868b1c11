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
from .models.kmeans import KMeans, KMeansModel

__all__ = ["__version__", "DataFrame", "KMeans", "KMeansModel", "load"]
