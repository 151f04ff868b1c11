#
# Launcher-agnostic multi-process fit execution.
#
# Counterpart of spark_rapids_ml_tpu/parallel/runner.py: one OS process per
# rank (what one Spark barrier task would be), each holding its own row
# partitions, cooperating through a small string control plane
# (FileControlPlane over a shared directory, the TCP plane of netplane.py,
# or Spark's BarrierTaskContext).  The flow per rank:
#
#   1. TpuContext bootstraps torch.distributed (the rendezvous address
#      allGathered over the control plane, the backend by its rule);
#   2. a global mesh spans the ranks, process-major: this rank's devices
#      (the entry points' device list) are global shards rank * L .. rank *
#      L + L - 1 (parallel/mesh.py);
#   3. per-rank partition sizes are allGathered into a PartitionDescriptor;
#   4. each rank's rows fill its share of the global padded rows, split
#      over its local shards: the share is the largest rank's rows rounded
#      up to the local shard count, so a rank pads inside its own share; a
#      rank with zero rows still joins every gather; the ranks' input dtypes
#      must agree; labels and weights stay float32 or wider;
#   5. the same fit function as on one process runs on every rank inside
#      mesh.process_scope: the collectives of parallel/exchange.py cross
#      processes there, so the solvers cannot tell the job's mesh from a
#      one-process mesh of the same global shard count (an even split gives
#      its bits);
#   6. the results are replicated; every rank encodes them (the JAX
#      package's JSON-safe attribute wire, torch.Tensor in place of
#      jax.Array), with the telemetry snapshot merged across ranks.
#
# Under SRML_PROFILE=<dir> each rank's fit function is captured by
# profiling.maybe_trace into <dir>/<Estimator>-rank<r>.
# make_control_plane builds the plane named by SRML_CP ("file" or "tcp").
# The JAX module's initialize_persistent_cache has no counterpart: the port
# compiles nothing per shape (ops/precompile.py header).
#

from __future__ import annotations

import base64
import contextlib
import json
import os
import random
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from .. import profiling
from ..utils import env_float as _env_float
from . import faults
from .context import (  # noqa: F401 - the knobs are re-exported here, as in the JAX package
    BACKOFF_ENV,
    RETRIES_ENV,
    ROUND_TIMEOUT_ENV,
    ControlPlane,
    ControlPlaneTimeout,
    LocalControlPlane,
    RemoteRankError,
    RetryPolicy,
    TpuContext,
    _DEFAULT_ROUND_TIMEOUT_S,
)
from .mesh import Mesh, process_scope, set_rank_rows, shard_rows
from .partition import PartitionDescriptor

# which control plane make_control_plane builds: "file" (default, shared
# filesystem) or "tcp" (the socket plane, parallel/netplane.py)
CP_ENV = "SRML_CP"


def make_control_plane(root: str, rank: int, nranks: int, timeout: Optional[float] = None):
    """Control-plane factory honoring SRML_CP: launchers and workers build
    their plane through this one chokepoint, so a job reruns on the TCP
    plane by flipping an environment variable."""
    kind = os.environ.get(CP_ENV, "file").strip().lower() or "file"
    if kind == "file":
        return FileControlPlane(root, rank, nranks, timeout=timeout)
    if kind == "tcp":
        from .netplane import bootstrap_tcp_plane

        return bootstrap_tcp_plane(root, rank, nranks, timeout=timeout)
    raise ValueError(f"{CP_ENV}={kind!r}: known planes are 'file' and 'tcp'")


class FileControlPlane:
    """Control plane over a shared filesystem: allGather by atomic per-rank
    message files in numbered rounds, barrier as an empty gather (counters
    cp.rounds, cp.bytes_out, cp.bytes_in).  The rendezvous root must be
    empty per job.

    Fast abort: every plane writes an `alive_rank<k>.pid` liveness file at
    construction and holds an exclusive flock on it for the process
    lifetime; gather waits probe the peers' locks (the kernel releases a
    dead process's locks even while it is an unreaped zombie) with a pid
    check as fallback, so a rank killed mid-collective surfaces as
    RemoteRankError naming it within one poll interval.  abort(payload)
    publishes an `abort-r<k>.json` marker that blocked gathers raise as
    RemoteRankError.  close() removes this rank's presence files and, once
    no other survivor remains, the dead peers'."""

    def __init__(self, root: str, rank: int, nranks: int,
                 timeout: Optional[float] = None, poll: float = 0.02):
        self._root = root
        self._rank = rank
        self._nranks = nranks
        self._round = 0
        self._timeout = (
            timeout
            if timeout is not None
            else _env_float(ROUND_TIMEOUT_ENV, _DEFAULT_ROUND_TIMEOUT_S)
        )
        self._poll = poll
        # deterministic per-rank backoff jitter; the retry policy is parsed
        # once here and shared by contract with the TCP plane
        self._jitter = random.Random(10007 + rank)
        self._retry = RetryPolicy.from_env()
        os.makedirs(root, exist_ok=True)
        self._alive_fd: Optional[int] = None
        self._register_alive()

    # -- file paths ----------------------------------------------------------
    def _alive_path(self, rank: int) -> str:
        return os.path.join(self._root, f"alive_rank{rank:05d}.pid")

    def _abort_path(self, rank: int) -> str:
        return os.path.join(self._root, f"abort-r{rank:05d}.json")

    def _register_alive(self) -> None:
        """Publish `<pid> flock|nolock` and, where the filesystem supports
        it, hold an exclusive flock on the file for the process lifetime
        (the mode word tells peers which death probe to trust).  An entry
        already naming our pid (a sibling plane of this process, in a
        thread-mocked harness) is left alone."""
        path = self._alive_path(self._rank)
        try:
            with open(path) as f:
                parts = f.read().split()
            if parts and parts[0] == str(os.getpid()):
                return
        except OSError:
            pass
        self._write_atomic(path, f"{os.getpid()} nolock")
        try:
            import fcntl

            fd = os.open(path, os.O_RDWR)
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                os.close(fd)
                return
            self._alive_fd = fd  # held until close() / process death
            content = f"{os.getpid()} flock".encode()
            os.pwrite(fd, content, 0)
            os.ftruncate(fd, len(content))
        except (ImportError, OSError):
            pass

    # -- retrying I/O ---------------------------------------------------------
    def _retry_io(self, fn):
        return self._retry.run(fn, self._jitter)

    def _write_atomic(self, path: str, text_or_bytes) -> None:
        data = (
            text_or_bytes.encode("utf-8")
            if isinstance(text_or_bytes, str)
            else text_or_bytes
        )
        tmp = path + f".tmp{os.getpid()}"

        def _write():
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)  # atomic publish

        self._retry_io(_write)

    def _read_bytes(self, path: str) -> bytes:
        def _read():
            with open(path, "rb") as f:
                return f.read()

        return self._retry_io(_read)

    # -- the gather protocol --------------------------------------------------
    def allGather(self, message: str) -> List[str]:
        return [b.decode("utf-8") for b in self._gather_round(message.encode("utf-8"))]

    def allGatherBytes(self, message: bytes) -> List[bytes]:
        """Binary gather round: raw frames, no base64 (parallel/exchange.py
        takes this path where a plane has it)."""
        return self._gather_round(message)

    def _gather_round(self, message: bytes) -> List[bytes]:
        r = self._round
        self._round += 1
        message = faults.site("cp.gather", rank=self._rank, payload=message)
        profiling.incr_counter("cp.rounds")
        profiling.incr_counter("cp.bytes_out", len(message))
        path = os.path.join(self._root, f"round{r:05d}_rank{self._rank:05d}.msg")
        self._write_atomic(path, message)
        expected = [
            os.path.join(self._root, f"round{r:05d}_rank{i:05d}.msg")
            for i in range(self._nranks)
        ]
        deadline = time.monotonic() + self._timeout
        while not all(os.path.exists(p) for p in expected):
            missing = [i for i, p in enumerate(expected) if not os.path.exists(p)]
            # a foreign abort marker or a dead peer ends the wait within one
            # poll interval, naming the culprit
            self._raise_if_aborted()
            self._raise_if_peer_dead(missing)
            if time.monotonic() > deadline:
                raise ControlPlaneTimeout("FileControlPlane", r, missing, self._timeout)
            time.sleep(self._poll)
        out = [self._read_bytes(p) for p in expected]
        profiling.incr_counter("cp.bytes_in", sum(len(b) for b in out))
        return out

    def barrier(self) -> None:
        faults.site("cp.barrier", rank=self._rank)
        self.allGather("")

    # -- abort protocol --------------------------------------------------------
    def abort(self, payload: str) -> None:
        """Atomically publish this rank's abort marker (JSON: rank, etype,
        message, span); fire-and-forget."""
        profiling.incr_counter("cp.abort_markers")
        self._write_atomic(self._abort_path(self._rank), payload)

    def check_abort(self) -> Optional[Dict[str, Any]]:
        """The first foreign abort marker's decoded payload, or None; a torn
        marker degrades to a payload naming its rank."""
        for i in range(self._nranks):
            if i == self._rank:
                continue
            p = self._abort_path(i)
            if not os.path.exists(p):
                continue
            try:
                info = json.loads(self._read_bytes(p).decode("utf-8"))
                if isinstance(info, dict):
                    info.setdefault("rank", i)
                    return info
            except (OSError, ValueError):
                pass
            return {"rank": i}
        return None

    def _raise_if_aborted(self) -> None:
        info = self.check_abort()
        if info is None:
            return
        profiling.incr_counter("cp.remote_aborts")
        raise RemoteRankError(
            rank=int(info.get("rank", -1)),
            message=info.get("message", "aborted"),
            span=info.get("span"),
            etype=info.get("etype"),
        )

    @staticmethod
    def _pid_alive(pid: int) -> bool:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return False
        except (PermissionError, OSError):
            return True  # exists but not ours (or unknowable): assume alive
        return True

    def _peer_dead_reason(self, rank: int) -> Optional[str]:
        """Why rank `rank` is believed dead, or None (alive / not yet
        registered): its liveness flock is free, or (nolock registrations)
        its pid is gone."""
        path = self._alive_path(rank)
        try:
            with open(path) as f:
                parts = f.read().split()
        except OSError:
            return None
        try:
            pid = int(parts[0])
        except (IndexError, ValueError):
            return None
        if len(parts) > 1 and parts[1] == "flock":
            # the registrant holds the lock: the probe is authoritative
            # (a remote rank's pid means nothing to this kernel)
            try:
                import fcntl

                fd = os.open(path, os.O_RDONLY)
                try:
                    fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                except OSError:
                    return None  # lock held: alive
                else:
                    fcntl.flock(fd, fcntl.LOCK_UN)
                    return (
                        f"process (pid {pid}) released its liveness lock "
                        "(exited; possibly an unreaped zombie)"
                    )
                finally:
                    os.close(fd)
            except (ImportError, OSError):
                pass
        if not self._pid_alive(pid):
            return f"process (pid {pid}) is gone"
        return None

    def _raise_if_peer_dead(self, missing_ranks: List[int]) -> None:
        """A rank that registered but is provably gone died without a
        marker; only ranks this gather waits on are scanned."""
        for i in missing_ranks:
            reason = self._peer_dead_reason(i)
            if reason is None:
                continue
            profiling.incr_counter("cp.dead_peers")
            raise RemoteRankError(
                rank=i,
                message=(
                    f"{reason} mid-collective without an abort marker "
                    "(killed / OOM / segfault)"
                ),
            )

    def close(self) -> None:
        """Release this rank's liveness lock and remove its presence files
        (alive pid, heartbeat); the last survivor to close also removes the
        dead peers' (their alive file is the evidence slower survivors
        poll).  Round messages and abort markers stay with the job root."""
        for path in (
            self._alive_path(self._rank),
            os.path.join(self._root, f"health_rank{self._rank:05d}.json"),
        ):
            with contextlib.suppress(OSError):
                os.remove(path)
        if self._alive_fd is not None:
            with contextlib.suppress(OSError):
                os.close(self._alive_fd)  # releases the flock
            self._alive_fd = None
        for i in range(self._nranks):
            if i == self._rank:
                continue
            if os.path.exists(self._alive_path(i)) and self._peer_dead_reason(i) is None:
                return
        for i in range(self._nranks):
            if i == self._rank:
                continue
            for path in (
                self._alive_path(i),
                os.path.join(self._root, f"health_rank{i:05d}.json"),
            ):
                with contextlib.suppress(OSError):
                    os.remove(path)

    # -- health surface (non-collective) --------------------------------------
    def publish_health(self, payload: str) -> None:
        """Atomically overwrite this rank's heartbeat file; no rank waits on
        it (watch.HeartbeatPublisher calls it from its own thread)."""
        path = os.path.join(self._root, f"health_rank{self._rank:05d}.json")
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(payload)
        os.replace(tmp, path)

    def read_health(self) -> Dict[int, str]:
        """The latest heartbeat payload per rank (missing ranks absent)."""
        out: Dict[int, str] = {}
        for i in range(self._nranks):
            p = os.path.join(self._root, f"health_rank{i:05d}.json")
            try:
                with open(p) as f:
                    out[i] = f.read()
            except OSError:
                continue
        return out


def global_mesh(rank: int, nranks: int, group: Any = None, backend: str = "") -> Mesh:
    """The job's data mesh: this rank's devices (the entry points' device
    list) as global shards rank * L .. rank * L + L - 1, process-major as
    the JAX package orders it."""
    from .. import device as _device

    return Mesh(_device.devices(), rank=rank, nranks=nranks, group=group, backend=backend)


# -- JSON-safe model-attribute transport ----------------------------------------
# The process that launched the ranks gets model attributes back through
# strings, so arrays ride as base64 raw bytes with dtype and shape: the JAX
# package's wire, letter for letter.


def _encode_value(v: Any) -> Any:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, np.ndarray):
        return {
            "__ndarray__": base64.b64encode(np.ascontiguousarray(v).tobytes()).decode("ascii"),
            "dtype": str(v.dtype),
            "shape": list(v.shape),
        }
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, dict):
        return {k: _encode_value(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_encode_value(x) for x in v]
    return v


def _decode_value(v: Any) -> Any:
    if isinstance(v, dict):
        if "__ndarray__" in v:
            return (
                np.frombuffer(base64.b64decode(v["__ndarray__"]), dtype=np.dtype(v["dtype"]))
                .reshape(v["shape"])
                .copy()
            )
        return {k: _decode_value(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_decode_value(x) for x in v]
    return v


def encode_attrs(attrs: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _encode_value(v) for k, v in attrs.items()}


def decode_attrs(attrs: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _decode_value(v) for k, v in attrs.items()}


def allgather_ndarray(control_plane: Any, rank: int, arr: np.ndarray) -> List[np.ndarray]:
    """Rank-ordered allGather of one ndarray over the string control plane,
    on the attribute codec: every rank receives the same rank-ordered list,
    so what it derives (bin edges, class sets) agrees across ranks."""
    msg = json.dumps({"rank": rank, "v": _encode_value(np.asarray(arr))})
    blocks = sorted((json.loads(m) for m in control_plane.allGather(msg)), key=lambda g: g["rank"])
    return [_decode_value(g["v"]) for g in blocks]


# -- the distributed fit session -------------------------------------------------

_UNSUPPORTED = (
    "{name} does not yet support multi-process (barrier) training: its fit "
    "function host-fetches row-sharded inputs. Train with num_workers=1 or "
    "SRML_SPARK_COLLECT=1 (driver-local fit)."
)


class DistributedFitSession:
    """One torch.distributed lifetime; fits any number of estimators over
    the job's mesh.  `context` is the session's TpuContext (backend,
    bootstrap seconds); `last_fit` the seconds of the last fit on this
    rank (ingest, fit)."""

    def __init__(self, rank: int, nranks: int, control_plane: ControlPlane, context: Optional[TpuContext] = None):
        self.rank = rank
        self.nranks = nranks
        self.control_plane = control_plane
        self.context = context
        self.mesh = global_mesh(
            rank, nranks,
            group=context.group if context is not None else None,
            backend=context.backend or "" if context is not None else "",
        )
        self.last_fit: Dict[str, float] = {}

    def build_fit_inputs(self, estimator: Any, df: Any) -> Any:
        """FitInputs of this rank's rows over the job's mesh (module header,
        step 4)."""
        from ..core import FitInputs, _partition_features
        from ..utils import materialize_feature_block

        input_col, input_cols = estimator._get_input_columns()
        parts = [p for p in df.partitions if len(p) > 0]
        # a rank with zero rows still joins every gather, reporting empty
        # sizes and taking its dtype from the data-bearing ranks
        dtype = estimator._use_dtype(df, input_col, input_cols) if parts else None
        feats = []
        for p in parts:
            f = _partition_features(estimator, p, input_col, input_cols, dtype)
            if hasattr(f, "tocsr"):
                f = materialize_feature_block(p, input_col, input_cols, dtype, densify_sparse=True)
            feats.append(f)
        n_loc = sum(int(f.shape[0]) for f in feats)
        n_cols_loc = int(feats[0].shape[1]) if feats else 0
        pdesc = PartitionDescriptor.gather(
            [int(f.shape[0]) for f in feats], n_cols_loc, self.rank, self.nranks, self.control_plane,
            extra={"dtype": str(dtype) if dtype is not None else ""},
        )
        if pdesc.m == 0:
            raise RuntimeError("Dataset is empty; cannot fit")
        n_cols = pdesc.n
        dtypes = {e["dtype"] for e in pdesc.extras if e.get("dtype")}
        if len(dtypes) > 1:
            raise ValueError(f"ranks disagree on input dtype: {sorted(dtypes)}")
        if dtype is None:
            dtype = np.dtype(dtypes.pop())
        if n_loc and n_cols_loc != n_cols:
            raise ValueError(f"rank {self.rank} has {n_cols_loc} feature columns, other ranks have {n_cols}")
        rank_rows = [pdesc.rank_rows(r) for r in range(self.nranks)]
        local = self.mesh.local_size
        # every rank contributes the same padded share, covering the
        # largest rank: a rank pads inside its own share
        share = -(-max(rank_rows) // local) * local
        pad = [np.zeros((share - n_loc, n_cols), dtype=dtype)] if share > n_loc else []
        from ..core import torch_dtype

        X = shard_rows(feats + pad, self.mesh, torch_dtype(dtype))[0]
        set_rank_rows(rank_rows)

        label_col = estimator._fit_label_col()
        weight_col = (
            estimator.getOrDefault("weightCol")
            if estimator.hasParam("weightCol") and estimator.isSet("weightCol")
            else None
        )
        # the one-process ingest's rule (core._add_labels_and_weights): the
        # valid-row mask in the feature dtype without a label or weight
        # column, else float32 or wider
        if label_col is None and weight_col is None:
            ldtype = np.dtype(dtype)
        else:
            ldtype = np.dtype(np.float32) if np.dtype(dtype).itemsize < 4 else np.dtype(dtype)

        def column(name: str) -> np.ndarray:
            if parts and name not in df.columns:
                raise ValueError(f"Column '{name}' not found in dataset {df.columns}")
            values = [np.asarray(p[name], dtype=ldtype) for p in parts]
            return np.concatenate(values) if values else np.zeros(0, dtype=ldtype)

        def sharded(values: np.ndarray) -> List[torch.Tensor]:
            full = np.zeros(share, dtype=ldtype)
            full[:n_loc] = values
            return shard_rows(full, self.mesh)[0]

        inputs = FitInputs(
            X=X, weight=[], n_rows=pdesc.m, n_cols=n_cols, mesh=self.mesh, pdesc=pdesc, dtype=np.dtype(dtype),
            rank=self.rank, nranks=self.nranks, control_plane=self.control_plane,
        )
        if weight_col is not None:
            inputs.host_w = column(weight_col)
            inputs.weight = sharded(inputs.host_w)
        else:
            inputs.weight = sharded(np.ones(n_loc, dtype=ldtype))
        if label_col is not None:
            inputs.host_y = column(label_col)
            inputs.y = sharded(inputs.host_y)
        return inputs

    def fit(
        self,
        estimator: Any,
        partitions: Any,
        extra_params: Optional[List[Dict[str, Any]]] = None,
    ) -> List[Dict[str, Any]]:
        """Run the estimator's fit function over the job's mesh; returns the
        JSON-safe encoded model-attribute dict(s), one per param map.
        `partitions` is this rank's partitions (a port DataFrame or a
        sequence of {column: array} mappings)."""
        from .. import watch
        from ..core import TELEMETRY_ATTR
        from ..dataframe import DataFrame
        from ..sanitize import sanitize_scope

        if self.nranks > 1 and not getattr(estimator, "_supports_multicontroller_fit", True):
            raise NotImplementedError(_UNSUPPORTED.format(name=type(estimator).__name__))
        df = partitions if isinstance(partitions, DataFrame) else DataFrame(list(partitions))
        profiling.reset_phase_times()
        counters0 = profiling.counters()
        tag = f"fit-{type(estimator).__name__}-rank{self.rank}"
        # every rank heartbeats through the plane's non-collective publish
        # surface (rank 0 also runs the stall watchdog when
        # SRML_WATCH_STALL_S > 0); an exception inside the fit dumps the
        # flight ring before it propagates
        health = watch.start_fit_health(self.control_plane, self.rank, self.nranks)
        try:
            with watch.flight_scope(tag), profiling.trace_session(tag), process_scope(self.mesh):
                # the fit-task injection site (action=die: a rank killed
                # mid-fit; action=raise: the abort-marker broadcast)
                faults.site("runner.fit", rank=self.rank)
                t0 = time.perf_counter()
                with profiling.phase("runner.build_inputs"):
                    inputs = self.build_fit_inputs(estimator, df)
                t1 = time.perf_counter()
                if extra_params is None:
                    fit_func = estimator._get_tpu_fit_func(df)
                else:
                    fit_func = estimator._get_tpu_fit_func(df, extra_params=extra_params)
                with profiling.maybe_trace(f"{type(estimator).__name__}-rank{self.rank}"), \
                        sanitize_scope(self.mesh.devices[0]), profiling.phase("runner.fit"):
                    result = fit_func(inputs, dict(estimator._tpu_params))
                del inputs
                t2 = time.perf_counter()
        finally:
            health.stop()
        self.last_fit = {"build_inputs_s": t1 - t0, "fit_s": t2 - t1}
        # the telemetry snapshot, merged across ranks through one gather
        # round before rank 0's results leave for the caller
        snap = profiling.TelemetrySnapshot.capture(counters0, rank=self.rank)
        merged = snap
        if self.nranks > 1:
            gathered = self.control_plane.allGather(json.dumps(snap.to_dict()))
            snaps = sorted((json.loads(m) for m in gathered), key=lambda d: d.get("meta", {}).get("ranks", [0]))
            merged = profiling.TelemetrySnapshot.from_dict(snaps[0])
            for d in snaps[1:]:
                merged = merged.merge(profiling.TelemetrySnapshot.from_dict(d))
        self.control_plane.barrier()
        results = result if isinstance(result, list) else [result]
        encoded = [encode_attrs(r) for r in results]
        for e in encoded:
            e[TELEMETRY_ATTR] = merged.to_dict()
        return encoded


@contextlib.contextmanager
def distributed_session(
    rank: int, nranks: int, control_plane: Optional[ControlPlane] = None
) -> Iterator[DistributedFitSession]:
    """One TpuContext lifetime over `control_plane`, yielding the fit
    session; the plane is closed after the context's exit (an abort marker
    of the exception path is published first)."""
    cp = control_plane or LocalControlPlane()
    try:
        with TpuContext(rank, nranks, cp) as ctx:
            yield DistributedFitSession(rank, nranks, cp, ctx)
    finally:
        closer = getattr(cp, "close", None)
        if closer is not None:
            closer()


def run_distributed_fit(
    estimator: Any,
    partitions: Any,
    rank: int,
    nranks: int,
    control_plane: Optional[ControlPlane] = None,
    extra_params: Optional[List[Dict[str, Any]]] = None,
) -> List[Dict[str, Any]]:
    """One-shot: bootstrap the distributed runtime, fit, tear down (what a
    Spark barrier task calls)."""
    with distributed_session(rank, nranks, control_plane) as session:
        return session.fit(estimator, partitions, extra_params)
