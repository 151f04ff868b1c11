#
# srml-serve: the online inference layer of the port.
#
# Counterpart of spark_rapids_ml_tpu/serving (the same module names,
# classes, counter names and SRML_SERVE_* environment variables):
#
#   batcher.py   dynamic micro-batching: bounded queue, coalesce-until-
#                deadline, fast ServerOverloaded rejection, per-request
#                deadlines
#   entry.py     the model <-> engine contract (ServingEntry), the one
#                pow2 row-bucket rule, pinned-host uploads and readbacks
#   engine.py    ModelServer: a dispatch worker per server that warms every
#                bucket on its own thread (steady state = zero new warm-ups,
#                asserted), restart supervision, wedge recovery, depth-2
#                pipelining, latency percentiles
#   registry.py  named servers over in-memory or loaded models, with
#                zero-downtime hot swap
#   scheduler.py admission / priority classes and least-outstanding pick
#   router.py    replica sets over slice-pool leases, health-aware routing,
#                load shedding, failover and rolling swap
#   slicepool.py the capacity ledger of disjoint device slices
#
# Multiplexed lane servers and the autoscaler (multiplex.py, autoscale.py)
# wait for ROADMAP A13b.
#
from .batcher import (
    MicroBatcher,
    RequestTimeout,
    ServerDraining,
    ServerOverloaded,
)
from .engine import (
    DEGRADED,
    DRAINING,
    READY,
    RECOVERING,
    SEVERITY,
    STATE_CODES,
    UNHEALTHY,
    WARMING,
    ModelServer,
    ServerRecovering,
    ServerUnhealthy,
)
from .entry import ServingEntry, bucket_rows, entry_for, kernel_entry, serve_buckets
from .registry import ModelRegistry, default_registry
from .router import Router
from .scheduler import (
    DEFAULT_CLASS,
    PRIORITY_CLASSES,
    NoReplicaAvailable,
    RequestShed,
)
from .slicepool import CapacityExhausted, SliceLease, SlicePool

__all__ = [
    "CapacityExhausted",
    "SliceLease",
    "SlicePool",
    "DEFAULT_CLASS",
    "DEGRADED",
    "DRAINING",
    "MicroBatcher",
    "ModelRegistry",
    "ModelServer",
    "NoReplicaAvailable",
    "PRIORITY_CLASSES",
    "READY",
    "RECOVERING",
    "RequestShed",
    "RequestTimeout",
    "Router",
    "SEVERITY",
    "STATE_CODES",
    "ServerDraining",
    "ServerOverloaded",
    "ServerRecovering",
    "ServerUnhealthy",
    "ServingEntry",
    "UNHEALTHY",
    "WARMING",
    "bucket_rows",
    "default_registry",
    "entry_for",
    "kernel_entry",
    "serve_buckets",
]
