#
# Distributed-runtime lifecycle of a multi-process fit.
#
# Counterpart of spark_rapids_ml_tpu/parallel/context.py.  The control-plane
# contract is copied as it is: RetryPolicy, ControlPlaneTimeout,
# RemoteRankError, the ControlPlane protocol, LocalControlPlane and the
# SRML_CP_* knobs.  TpuContext keeps the JAX package's three phases, over
# torch.distributed instead of jax.distributed:
#
#   1. faults.site("context.init");
#   2. rank 0 advertises host:port (the plane's allocate_port() where it has
#      one, a free ephemeral port otherwise) and every rank allGathers it,
#      together with its device identity;
#   3. every rank calls torch.distributed.init_process_group(backend,
#      init_method="tcp://host:port", rank, world_size, timeout), the
#      timeout SRML_CP_ROUND_TIMEOUT_S (never torch's 30-minute default).
#
# The backend is a rule, not a fallback (choose_backend): nccl only when
# every rank drives CUDA devices and no card serves two ranks (NCCL refuses
# a duplicate GPU); gloo otherwise, on the CPU or with ranks sharing one
# card.  The choice is logged and kept in the phase record (`phases`).  An
# NCCL init or collective that fails raises; nothing gives way to gloo.
#
# __exit__ keeps the abort contract: an original failure broadcasts the
# abort marker through the control plane first (a relayed RemoteRankError
# does not), a clean exit calls destroy_process_group(), and the abort path
# skips every collective teardown, since a peer is gone.
#

from __future__ import annotations

import datetime
import json
import random
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Protocol, Sequence, Tuple

from ..utils import env_float as _env_float
from ..utils import get_logger
from . import faults

# -- control-plane knobs, shared by every plane implementation ----------------
ROUND_TIMEOUT_ENV = "SRML_CP_ROUND_TIMEOUT_S"
RETRIES_ENV = "SRML_CP_RETRIES"
BACKOFF_ENV = "SRML_CP_BACKOFF_S"
_DEFAULT_ROUND_TIMEOUT_S = 300.0
_DEFAULT_RETRIES = 3
_DEFAULT_BACKOFF_S = 0.05


@dataclass(frozen=True)
class RetryPolicy:
    """The SRML_CP_RETRIES / SRML_CP_BACKOFF_S contract, parsed once at
    plane construction and shared by the file and TCP planes.  `run`
    retries `fn` on the given transient exception types with exponential
    backoff and deterministic per-rank jitter."""

    retries: int
    backoff_s: float

    @classmethod
    def from_env(cls) -> "RetryPolicy":
        return cls(
            retries=int(_env_float(RETRIES_ENV, _DEFAULT_RETRIES)),
            backoff_s=_env_float(BACKOFF_ENV, _DEFAULT_BACKOFF_S),
        )

    def run(
        self,
        fn,
        jitter: random.Random,
        retry_on: Tuple[type, ...] = (OSError,),
        counter: str = "cp.io_retries",
    ):
        from .. import profiling

        attempt = 0
        while True:
            try:
                return fn()
            except retry_on:
                if attempt >= self.retries:
                    raise
                delay = self.backoff_s * (2 ** attempt) * (
                    1.0 + 0.25 * jitter.random()
                )
                profiling.incr_counter(counter)
                attempt += 1
                time.sleep(delay)


class ControlPlaneTimeout(TimeoutError):
    """A gather round ran out its per-round budget with ranks still missing:
    carries the round number, the ranks that never posted and the knob that
    bounds the budget.  A TimeoutError subclass."""

    def __init__(
        self,
        plane: str,
        round_no: int,
        missing_ranks: Sequence[int],
        timeout_s: float,
        knob: str = ROUND_TIMEOUT_ENV,
    ):
        self.plane = plane
        self.round_no = int(round_no)
        self.missing_ranks = sorted(int(r) for r in missing_ranks)
        self.timeout_s = float(timeout_s)
        self.knob = knob
        super().__init__(
            f"{plane} round {self.round_no}: ranks {self.missing_ranks} "
            f"never posted within {self.timeout_s}s ({knob} bounds each "
            "round)"
        )


class RemoteRankError(RuntimeError):
    """Another rank of the job failed (orderly abort) or died (no marker:
    killed, OOMed) while this rank waited on a collective.  Names the origin
    rank, its exception type and the innermost span it was in."""

    def __init__(
        self,
        rank: int,
        message: str,
        span: Optional[str] = None,
        etype: Optional[str] = None,
    ):
        self.rank = int(rank)
        self.span = span
        self.etype = etype
        where = f" in span {span!r}" if span else ""
        what = f"{etype}: {message}" if etype else message
        super().__init__(f"remote rank {self.rank}{where}: {what}")


class ControlPlane(Protocol):
    """Minimal control-plane contract: allGather of strings + barrier.

    allGather must return messages indexed by rank (result[r] = rank r's
    message): the host-frame collectives (parallel/exchange.py) and the
    distributed kneighbors index results positionally.  Planes may also
    provide ``allGatherBytes(bytes) -> List[bytes]``, which exchange.py
    uses to skip base64."""

    def allGather(self, message: str) -> List[str]: ...

    def barrier(self) -> None: ...


class LocalControlPlane:
    """Single-controller control plane: one process drives the whole mesh, so
    gather/barrier are identities."""

    def __init__(self) -> None:
        self._health: dict = {}

    def allGather(self, message: str) -> List[str]:
        return [message]

    def allGatherBytes(self, message: bytes) -> List[bytes]:
        return [message]

    def barrier(self) -> None:
        return None

    # srml-watch health surface (non-collective): an in-process store
    def publish_health(self, payload: str) -> None:
        try:
            rank = int(json.loads(payload).get("rank", 0))
        except (ValueError, TypeError):
            rank = 0
        self._health[rank] = payload

    def read_health(self) -> dict:
        return dict(self._health)

    # abort surface: no peers to warn, the same method shape
    def abort(self, payload: str) -> None:
        return None

    def check_abort(self) -> Optional[Dict[str, Any]]:
        return None

    def close(self) -> None:
        return None


def device_identity(devices: Sequence[Any]) -> List[str]:
    """The identities of a rank's devices for the backend rule: the UUID of
    each CUDA device, "cpu" for a CPU device."""
    import torch

    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda":
            index = d.index if d.index is not None else torch.cuda.current_device()
            out.append(f"cuda:{torch.cuda.get_device_properties(index).uuid}")
        else:
            out.append(d.type)
    return out


def choose_backend(identities: Sequence[Sequence[str]]) -> str:
    """The process-group backend of ranks with these device identities (one
    list a rank): "nccl" when every rank drives CUDA devices only and no
    card appears under two ranks, else "gloo" (the CPU, or ranks sharing a
    card, which NCCL refuses)."""
    seen: Dict[str, int] = {}
    for rank, ids in enumerate(identities):
        if not ids or any(not i.startswith("cuda:") for i in ids):
            return "gloo"
        for i in set(ids):
            if i in seen and seen[i] != rank:
                return "gloo"
            seen[i] = rank
    return "nccl"


class TpuContext:
    """Context manager bootstrapping torch.distributed for one multi-process
    session (module header).  With nranks == 1 it is a no-op.  `devices`
    are this rank's devices (default: the entry points' device list); their
    identities decide the backend.  After __enter__, `backend` and `group`
    name the process group and `phases` holds the phase record (backend,
    bootstrap seconds, coordinator)."""

    def __init__(
        self,
        rank: int,
        nranks: int,
        control_plane: Optional[ControlPlane] = None,
        devices: Optional[Sequence[Any]] = None,
    ):
        self._rank = rank
        self._nranks = nranks
        self._cp = control_plane or LocalControlPlane()
        self._devices = devices
        self._initialized_distributed = False
        self._logger = get_logger(type(self))
        self.backend: Optional[str] = None
        self.group: Any = None
        self.phases: Dict[str, Any] = {}

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def nranks(self) -> int:
        return self._nranks

    def __enter__(self) -> "TpuContext":
        t0 = time.perf_counter()
        faults.site("context.init", rank=self._rank)
        if self._nranks > 1:
            import torch.distributed as dist

            from .. import device as _device
            from .netplane import _free_port, _local_ip

            if self._rank == 0:
                if hasattr(self._cp, "allocate_port"):
                    port = self._cp.allocate_port()
                else:
                    port = _free_port()
                addr = f"{_local_ip()}:{port}"
            else:
                addr = ""
            devs = self._devices if self._devices is not None else _device.devices()
            gathered = [json.loads(m) for m in self._cp.allGather(json.dumps(
                {"rank": self._rank, "addr": addr, "devices": device_identity(devs)}
            ))]
            coordinator = ""
            for info in gathered:
                if info["rank"] == 0:
                    coordinator = info["addr"]
            assert coordinator, "rank 0 coordinator address missing from allGather"
            identities = [g["devices"] for g in sorted(gathered, key=lambda g: g["rank"])]
            self.backend = choose_backend(identities)
            if self.backend == "nccl":
                # NCCL binds a rank's communicator to the current device
                import torch

                torch.cuda.set_device(next(torch.device(d) for d in devs if torch.device(d).type == "cuda"))
            self._logger.info(
                "rank %d/%d: process group over %s at %s (device identities %s)",
                self._rank, self._nranks, self.backend, coordinator, identities,
            )
            dist.init_process_group(
                self.backend,
                init_method=f"tcp://{coordinator}",
                rank=self._rank,
                world_size=self._nranks,
                timeout=datetime.timedelta(
                    seconds=_env_float(ROUND_TIMEOUT_ENV, _DEFAULT_ROUND_TIMEOUT_S)
                ),
            )
            self._initialized_distributed = True
            self.group = dist.group.WORLD
            self.phases = {
                "backend": self.backend,
                "coordinator": coordinator,
                "device_identities": identities,
            }
        self.phases["bootstrap_s"] = time.perf_counter() - t0
        return self

    def __exit__(self, exc_type: Any, exc_val: Any, exc_tb: Any) -> None:
        # an original failure broadcasts the abort marker first, so peers
        # blocked in a gather raise RemoteRankError within one poll; a
        # RemoteRankError is itself a relayed abort and is not re-broadcast
        if (
            exc_type is not None
            and self._nranks > 1
            and not isinstance(exc_val, RemoteRankError)
            and hasattr(self._cp, "abort")
        ):
            try:
                from .. import watch

                self._cp.abort(json.dumps({
                    "rank": self._rank,
                    "etype": exc_type.__name__,
                    "message": str(exc_val)[:512],
                    "span": watch.failing_span(),
                }))
            except Exception as abort_exc:  # noqa: BLE001 - best effort
                self._logger.warning("abort broadcast failed: %s", abort_exc)
        if self._initialized_distributed:
            if exc_type is not None:
                # destroy_process_group may wait on a peer that is gone:
                # the abort path detaches without it and lets process
                # teardown reclaim the sockets (NCCL abort() vs destroy())
                self._logger.warning(
                    "abort path (%s unwinding): skipping the collective "
                    "process-group teardown; a peer is gone",
                    exc_type.__name__,
                )
            else:
                import torch.distributed as dist

                dist.destroy_process_group()
            self._initialized_distributed = False
        return None
