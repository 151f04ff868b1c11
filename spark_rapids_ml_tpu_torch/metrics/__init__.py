#
# Evaluation metrics in mergeable partial form: regression moments,
# multiclass confusion counts, binary ranking curves and the silhouette.
#
# Counterpart of spark_rapids_ml_tpu/metrics/, this package's own copy
# (numpy only; the port never imports the JAX package).  Each partition's
# partial statistics are computed from its prediction columns and merged,
# as Spark's Scala MulticlassMetrics / RegressionMetrics aggregate, on the
# driver or, for a live pyspark frame, in the Spark tasks
# (spark/adapter.py).  The JAX package's EvalMetricInfo and
# transform_evaluate_metric have no caller here and are not carried over
# (ROADMAP A, "Not carried over, by design").
#

from .binary import BinaryClassificationMetrics
from .multiclass import MulticlassMetrics, log_loss
from .regression import RegressionMetrics, _SummarizerBuffer

__all__ = [
    "RegressionMetrics",
    "_SummarizerBuffer",
    "MulticlassMetrics",
    "BinaryClassificationMetrics",
    "log_loss",
]
