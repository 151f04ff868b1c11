#
# srml-stream on the port: partial_fit / merge / finalize engines over the
# batch estimators (engines.py), the mergeable state and its srml-stream/v1
# wire form (state.py), and the train-while-serve session (session.py).
# Counterpart of spark_rapids_ml_tpu/stream; the live IVF-Flat index lives
# beside the index it mutates, ann/mutable.py.
#

from .engines import (
    StreamingEngine,
    StreamingKMeans,
    StreamingLinearRegression,
    StreamingLogisticRegression,
    StreamingPCA,
    streaming_fit,
)
from .session import StreamingSession
from .state import StreamState, allgather_merge, merge_all

__all__ = [
    "StreamingEngine",
    "StreamingKMeans",
    "StreamingLinearRegression",
    "StreamingLogisticRegression",
    "StreamingPCA",
    "StreamingSession",
    "StreamState",
    "allgather_merge",
    "merge_all",
    "streaming_fit",
]
