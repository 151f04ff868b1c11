#
# Deterministic fault injection (srml-shield).
#
# Copy of spark_rapids_ml_tpu/parallel/faults.py, which imports no JAX: the
# same SRML_FAULTS grammar, actions, strict parsing and site registry, so a
# plan written for the JAX package arms the same fault here.  Named
# injection sites call site(name, rank=, tag=, payload=) where the layers
# can hang or die; a FaultPlan parsed from SRML_FAULTS selects WHERE (site),
# WHO (rank= / tag=), WHEN (call= -- the Nth arrival at that site in this
# process, 1-based) and WHAT (action):
#
#   SRML_FAULTS = spec[;spec...]
#   spec        = site[:field]...
#   field       = rank=<int> | call=<int> | tag=<str>
#               | action=(die|raise|kill|delay|corrupt|drop|partition)
#               | delay=<float s>
#
#   serving.dispatch:tag=km:call=3:action=kill   km's worker dies, batch 3
#
# Actions: die (os._exit(17)), raise (FaultInjected), kill
# (InjectedWorkerDeath, a BaseException that ends the current worker thread
# and not the process: the serving supervisor's restart path catches it),
# delay (sleep, then continue: a wedge), corrupt (flip payload bytes), drop
# and partition (cp.net.* wire sites only).
#
# The port calls every site of the registry: serving.dispatch in
# serving/engine.ModelServer._dispatch (tag = the server's name); cp.gather
# and cp.barrier in the file and TCP planes (parallel/runner.py,
# netplane.py), cp.net.send / cp.net.recv on every wire frame of the TCP
# plane; context.init in parallel/context.TpuContext; runner.fit in
# runner.DistributedFitSession.fit; exchange.ring_pass in
# exchange.ring_pass_bytes; knn.ring_hop in ops/knn.distributed_kneighbors.
# The Spark barrier tasks that would carry these plans to executors are
# ROADMAP A14c-2.
#
# With SRML_FAULTS unset the plan is None and site() is one global load and
# one `is None` branch.
#

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

_log = logging.getLogger("spark_rapids_ml_tpu_torch.faults")

FAULTS_ENV = "SRML_FAULTS"

# exit code of action=die: distinct from every interpreter/pytest code so a
# chaos harness can assert the victim died BY INJECTION, not by accident
DIE_EXIT_CODE = 17

# the site registry, the JAX package's own.  site() accepts
# any name — sites are strings, not an enum — but parse_plan() warns on a
# spec naming a site outside this registry, which catches the typo'd plan
# that would otherwise never fire.
SITES = (
    "cp.gather",
    "cp.barrier",
    "cp.net.send",
    "cp.net.recv",
    "exchange.ring_pass",
    "knn.ring_hop",
    "runner.fit",
    "serving.dispatch",
    "context.init",
)

_ACTIONS = ("die", "raise", "kill", "delay", "corrupt", "drop", "partition")

# wire sites share one sticky partition set: a partition armed at either
# direction silences BOTH (a real partition has no half-duplex)
_WIRE_PREFIX = "cp.net."


class _Dropped:
    """Singleton sentinel returned by action=drop/partition at wire sites:
    the caller discards the frame (send skips the write, recv skips the
    dispatch).  Identity-checked (`is DROPPED`), never equality."""

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return "<faults.DROPPED>"


DROPPED = _Dropped()


class FaultInjected(RuntimeError):
    """Raised at an injection site by action=raise (and by action=corrupt
    at a site with no byte payload to corrupt)."""

    def __init__(self, site: str, rank: Optional[int], call: int):
        self.site = site
        self.rank = rank
        self.call = call
        super().__init__(
            f"injected fault at site {site!r} (rank={rank}, call #{call})"
        )


class InjectedWorkerDeath(BaseException):
    """action=kill: deliberately NOT an Exception, so per-batch error
    relays (which catch Exception) let it escape and kill the enclosing
    worker thread — the serving supervisor's restart path catches it at
    the thread's top frame."""

    def __init__(self, site: str, call: int):
        self.site = site
        self.call = call
        super().__init__(f"injected worker death at site {site!r} (call #{call})")


@dataclass(frozen=True)
class FaultSpec:
    """One armed fault: WHERE/WHO/WHEN/WHAT (module docstring grammar)."""

    site: str
    action: str
    rank: Optional[int] = None     # None = any rank
    call: Optional[int] = None     # None = every arrival; N = the Nth only
    tag: Optional[str] = None      # None = any tag (serving: server name)
    delay_s: float = 0.0

    def matches(self, rank: Optional[int], tag: Optional[str], count: int) -> bool:
        if self.rank is not None and self.rank != rank:
            return False
        if self.tag is not None and self.tag != tag:
            return False
        if self.call is not None and self.call != count:
            return False
        return True


def _parse_spec(text: str) -> FaultSpec:
    parts = [p for p in text.strip().split(":") if p]
    if not parts:
        raise ValueError(f"empty fault spec in {FAULTS_ENV}")
    site = parts[0]
    if site not in SITES:
        # not fatal — new sites may outrun the registry — but loud: a
        # typo'd site is a chaos gate that never fires
        _log.warning(
            "%s names unknown site %r (registered: %s) — this fault will "
            "only fire if code calls faults.site(%r)",
            FAULTS_ENV, site, ", ".join(SITES), site,
        )
    fields: Dict[str, str] = {}
    for f in parts[1:]:
        if "=" not in f:
            raise ValueError(
                f"{FAULTS_ENV}: malformed field {f!r} in spec {text!r} "
                "(expected key=value)"
            )
        k, v = f.split("=", 1)
        if k not in ("rank", "call", "tag", "action", "delay"):
            raise ValueError(
                f"{FAULTS_ENV}: unknown field {k!r} in spec {text!r} "
                "(rank/call/tag/action/delay)"
            )
        fields[k] = v
    action = fields.get("action")
    delay_s = float(fields["delay"]) if "delay" in fields else 0.0
    if action is None:
        if "delay" not in fields:
            raise ValueError(
                f"{FAULTS_ENV}: spec {text!r} has no action= (and no "
                f"delay= shorthand); actions: {'/'.join(_ACTIONS)}"
            )
        action = "delay"
    if action not in _ACTIONS:
        raise ValueError(
            f"{FAULTS_ENV}: unknown action {action!r} in spec {text!r} "
            f"(one of {'/'.join(_ACTIONS)})"
        )
    if action == "delay" and delay_s <= 0:
        raise ValueError(
            f"{FAULTS_ENV}: action=delay needs delay=<seconds> in {text!r}"
        )
    if action in ("drop", "partition") and not site.startswith(_WIRE_PREFIX):
        raise ValueError(
            f"{FAULTS_ENV}: action={action} only applies to wire sites "
            f"({_WIRE_PREFIX}*) — {text!r} would silently vanish a "
            "collective payload"
        )
    return FaultSpec(
        site=site,
        action=action,
        rank=int(fields["rank"]) if "rank" in fields else None,
        call=int(fields["call"]) if "call" in fields else None,
        tag=fields.get("tag"),
        delay_s=delay_s,
    )


class FaultPlan:
    """Every armed FaultSpec plus the per-(site, tag) arrival counters that
    make call= selection deterministic (counters are per-process: each rank
    of a multi-process job counts its own arrivals)."""

    def __init__(self, specs: List[FaultSpec]):
        self.specs = list(specs)
        self._lock = threading.Lock()
        self._counts: Dict[Tuple[str, Optional[str]], int] = {}
        # ranks whose cp.net.* traffic is sticky-dropped (action=partition)
        self._partitioned: set = set()

    def counts(self) -> Dict[Tuple[str, Optional[str]], int]:
        with self._lock:
            return dict(self._counts)

    def partitioned(self) -> set:
        with self._lock:
            return set(self._partitioned)

    def fire(self, name: str, rank: Optional[int], tag: Optional[str], payload):
        key = (name, tag)
        with self._lock:
            self._counts[key] = count = self._counts.get(key, 0) + 1
            if name.startswith(_WIRE_PREFIX) and rank in self._partitioned:
                return DROPPED  # the partition swallows both directions
        for spec in self.specs:
            if spec.site != name or not spec.matches(rank, tag, count):
                continue
            return self._apply(spec, name, rank, count, payload)
        return payload

    def _apply(self, spec: FaultSpec, name: str, rank, count: int, payload):
        _log.error(
            "FAULT INJECTED: site=%s rank=%s call=%d action=%s",
            name, rank, count, spec.action,
        )
        if spec.action == "die":
            # simulate SIGKILL/OOM: no marker, no teardown, no flush —
            # survivors must detect the absence, not a message
            os._exit(DIE_EXIT_CODE)
        if spec.action == "raise":
            raise FaultInjected(name, rank, count)
        if spec.action == "kill":
            raise InjectedWorkerDeath(name, count)
        if spec.action == "delay":
            time.sleep(spec.delay_s)
            return payload
        if spec.action == "drop":
            return DROPPED
        if spec.action == "partition":
            with self._lock:
                self._partitioned.add(rank)
            return DROPPED
        # corrupt: flip bytes in the payload; a site with nothing to
        # corrupt degrades to the orderly failure
        if not isinstance(payload, (bytes, bytearray)) or len(payload) == 0:
            raise FaultInjected(name, rank, count)
        buf = bytearray(payload)
        buf[0] ^= 0xFF                  # kill any magic header
        buf[len(buf) // 2] ^= 0xFF      # and a body byte
        return bytes(buf)


def parse_plan(text: Optional[str]) -> Optional[FaultPlan]:
    if not text or not text.strip():
        return None
    specs = [_parse_spec(s) for s in text.split(";") if s.strip()]
    if not specs:
        return None
    return FaultPlan(specs)


def _load() -> Optional[FaultPlan]:
    return parse_plan(os.environ.get(FAULTS_ENV))


_PLAN: Optional[FaultPlan] = _load()


def site(name: str, rank: Optional[int] = None, tag: Optional[str] = None,
         payload=None):
    """The ONE injection chokepoint.  Unarmed (SRML_FAULTS unset): a single
    module-global `is None` branch, nothing else — zero overhead at every
    call site (gated structurally).  Armed: counts the arrival and applies
    the first matching spec's action; returns `payload` (possibly
    corrupted) so byte-frame sites can thread their wire payload through."""
    if _PLAN is None:
        return payload
    return _PLAN.fire(name, rank, tag, payload)


def plan() -> Optional[FaultPlan]:
    """The installed FaultPlan (None = unarmed)."""
    return _PLAN


def armed() -> bool:
    return _PLAN is not None


def reload() -> Optional[FaultPlan]:
    """Re-parse SRML_FAULTS (tests arm/disarm per-case; arrival counters
    reset with the new plan)."""
    global _PLAN
    _PLAN = _load()
    return _PLAN
