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
#                load shedding, failover, rolling swap, scale_to and
#                replace_replica, multiplexed sets
#   multiplex.py srml-lanes: K same-shape model variants stacked on a pow2
#                lane axis behind one lane kernel per micro-batch, with LRU
#                lane paging (in-place page-in on a copy stream)
#   slicepool.py the capacity ledger of disjoint device slices
#   autoscale.py signal-driven scale-up / scale-down with hysteresis and
#                cooldowns, and the repair of terminal replicas, through
#                Router.scale_to / Router.replace_replica
#
from .autoscale import Autoscaler, AutoscalePolicy
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
from .multiplex import LaneEntry, MultiplexServer, lane_entry_for, lane_signature
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
    "Autoscaler",
    "AutoscalePolicy",
    "CapacityExhausted",
    "SliceLease",
    "SlicePool",
    "DEFAULT_CLASS",
    "DEGRADED",
    "DRAINING",
    "LaneEntry",
    "MicroBatcher",
    "ModelRegistry",
    "ModelServer",
    "MultiplexServer",
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
    "lane_entry_for",
    "lane_signature",
    "serve_buckets",
]
