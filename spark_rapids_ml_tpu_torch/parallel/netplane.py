#
# srml-wire: the TCP control plane.
#
# Copy of spark_rapids_ml_tpu/parallel/netplane.py, which imports no JAX:
# the same ControlPlane surface (allGather / allGatherBytes / barrier /
# publish_health / read_health / abort / check_abort / close) over a
# coordinator socket server with length-prefixed binary frames, the same
# frame codec (_pack_frame / _read_frame, magic SRCP), session epochs and
# fencing (StaleEpochError), typed coordinator loss (CoordinatorLost),
# leases refreshed by any frame (pings at lease/3, SRML_CP_LEASE_S), pushed
# abort and death notices, and coordinator-allocated ports: allocate_port()
# hands out the torch.distributed rendezvous port of parallel/context.py,
# so concurrent sessions through one coordinator never race for one port.
#
# The coordinator is a control-plane rendezvous: it moves kilobyte frames
# at collective-round rates (and the host frames of distributed_kneighbors
# and the binning sample), while the fits' reductions ride torch.distributed
# (parallel/exchange.py).  bootstrap_tcp_plane() hosts it in rank 0's
# process and publishes host:port through the job directory.
#
# The advertised host (_local_ip) is SRML_CP_HOST when set, else the
# address of the egress interface, else what the host name resolves to.
# The JAX package finds the egress interface with a UDP connect() to a
# private probe address, which sends no packet; the port reads the same
# answer, the route the kernel would take to that address, from the routing
# table (/proc/net/route) and the interface's address (SIOCGIFADDR), so it
# opens no socket toward any address at all.
#
# Fault injection: cp.net.send / cp.net.recv wrap every wire frame, so
# SRML_FAULTS can drop single frames (action=drop), sever a rank
# bidirectionally (action=partition), corrupt frames on the wire (the
# receiver's magic/bounds checks fail loudly), or delay them; cp.gather and
# cp.barrier wrap the collective rounds.  Every recv/accept runs under a
# socket timeout, so no wait is unbounded.
#

from __future__ import annotations

import contextlib
import json
import os
import random
import socket
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

from .. import profiling, sanitize
from ..utils import env_float as _env_float
from ..utils import get_logger
from . import faults
from .context import (
    ControlPlaneTimeout,
    RemoteRankError,
    RetryPolicy,
    ROUND_TIMEOUT_ENV,
    _DEFAULT_ROUND_TIMEOUT_S,
)

_log = get_logger("srml.netplane")

# -- knobs (docs/robustness.md §wire knobs) -----------------------------------
# The lease is the wire plane's detection interval: a member whose last
# frame is older than the lease is declared dead.  Default couples to the
# srml-watch heartbeat (1.5 heartbeats) so the chaos contract "a lost rank
# is named within 2 heartbeat intervals" holds by construction: detection
# latency <= lease + lease/4 (scan poll) = 1.875 heartbeats.  Client pings
# ride at lease/3, so a healthy link refreshes the lease ~4x per expiry.
LEASE_ENV = "SRML_CP_LEASE_S"
# the host a coordinator and a rank 0 advertise (module header)
HOST_ENV = "SRML_CP_HOST"

_MAGIC = b"SRCP"
_HEADER = struct.Struct("<4scIQ")  # magic, frame type, meta len, blob len
_MAX_META = 1 << 20          # sanity bound: corrupt length fields fail loudly
_MAX_BLOB = 1 << 40
_IDLE_POLL_S = 0.25          # socket timeout granularity for liveness checks

# frame types: client -> coordinator
_HELLO, _GATHER, _ABORT, _HEALTH, _READ_HEALTH = b"H", b"G", b"A", b"E", b"R"
_PING, _ALLOC_PORT, _LEAVE, _GATHER_STATE = b"P", b"O", b"L", b"S"
# frame types: coordinator -> client
_WELCOME, _FENCED, _GATHER_RESULT = b"W", b"F", b"g"
_ABORT_PUSH, _DEAD_PUSH, _HEALTH_SNAPSHOT, _PORT, _PONG = (
    b"a", b"d", b"h", b"o", b"q"
)


def lease_interval_s() -> float:
    """The membership lease (seconds): SRML_CP_LEASE_S, defaulting to 1.5x
    the srml-watch heartbeat so lease expiry + scan poll stays under the
    documented 2-heartbeat detection bound."""
    from .. import watch

    return _env_float(LEASE_ENV, 1.5 * watch.heartbeat_interval_s())


class ProtocolError(RuntimeError):
    """A wire frame failed the magic/bounds checks — corruption (or a
    non-SRCP speaker).  Always loud: garbage is never decoded silently."""


class StaleEpochError(RuntimeError):
    """The coordinator fenced this connection: the presented session epoch
    belongs to a previous incarnation of the rank (or the rank was already
    declared dead this session).  A fenced process must NOT rejoin the
    collective — its peers have already been told it is gone."""

    def __init__(self, rank: int, epoch: Optional[int], reason: str):
        self.rank = int(rank)
        self.epoch = epoch
        super().__init__(
            f"rank {rank} fenced by coordinator (epoch {epoch}): {reason}"
        )


class CoordinatorLost(RuntimeError):
    """The coordinator connection closed or fell silent past the lease —
    the control plane is gone, so no collective can complete.  Typed so
    survivors of a killed coordinator fail in bounded time naming the
    culprit (the coordinator), never with a bare socket error or a hang."""

    def __init__(self, address: str, reason: str):
        self.address = address
        super().__init__(f"coordinator {address} lost: {reason}")


# -- helpers ------------------------------------------------------------------


# the JAX package's probe address: its route names the egress interface
_PROBE_ADDR = "10.255.255.255"
_RTF_UP = 0x1
_SIOCGIFADDR = 0x8915


def _route_iface(table: str, dest: str = _PROBE_ADDR) -> Optional[str]:
    """The interface of the route the kernel would take to `dest`, from the
    text of /proc/net/route: the longest matching prefix among the routes
    that are up, the lowest metric among equals; None without one."""
    target = struct.unpack("=I", socket.inet_aton(dest))[0]
    best: Optional[Tuple[Tuple[int, int], str]] = None
    for line in table.splitlines()[1:]:
        f = line.split()
        if len(f) < 8:
            continue
        net, flags, metric, mask = int(f[1], 16), int(f[3], 16), int(f[6]), int(f[7], 16)
        if not flags & _RTF_UP or target & mask != net:
            continue
        key = (bin(mask).count("1"), -metric)
        if best is None or key > best[0]:
            best = (key, f[0])
    return best[1] if best else None


def _iface_ipv4(iface: str) -> Optional[str]:
    """The IPv4 address of interface `iface`, or None."""
    try:
        import fcntl

        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            req = struct.pack("256s", iface.encode()[:15])
            return socket.inet_ntoa(fcntl.ioctl(s.fileno(), _SIOCGIFADDR, req)[20:24])
    except (ImportError, OSError):
        return None


def _read_routes() -> str:
    try:
        with open("/proc/net/route") as f:
            return f.read()
    except OSError:
        return ""


def _local_ip() -> str:
    """The host this process advertises (module header): SRML_CP_HOST, else
    the egress interface's address, else the host name's."""
    override = os.environ.get(HOST_ENV, "").strip()
    if override:
        return override
    iface = _route_iface(_read_routes())
    ip = _iface_ipv4(iface) if iface else None
    if ip:
        return ip
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def _free_port() -> int:
    # NOTE: inherently racy (the caller rebinds the port after we release
    # it) — kept only as the fallback for planes WITHOUT allocate_port();
    # the coordinator's reservation ledger is the race-free path.
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _pack_frame(ftype: bytes, meta: Dict[str, Any], blob: bytes = b"") -> bytes:
    mbytes = json.dumps(meta, separators=(",", ":")).encode("utf-8")
    return _HEADER.pack(_MAGIC, ftype, len(mbytes), len(blob)) + mbytes + blob


def _send_all(sock: socket.socket, frame: bytes, deadline_s: float) -> None:
    """Write the whole frame with explicit partial-send tracking.  NEVER
    sendall here: the socket carries the _IDLE_POLL_S timeout (recv poll
    granularity), and a sendall that times out mid-frame loses the count
    of bytes already written — a permanently desynced stream.  send()
    either writes >= 1 byte or raises socket.timeout having written NONE,
    so looping it keeps the frame boundary exact; `deadline_s` bounds the
    total stall (a receiver that stops draining for that long is dead)."""
    deadline = time.monotonic() + deadline_s
    view = memoryview(frame)
    off = 0
    while off < len(view):
        try:
            off += sock.send(view[off:])
        except socket.timeout:
            if time.monotonic() > deadline:
                raise OSError(
                    f"send stalled: peer drained nothing for {deadline_s}s "
                    f"({off}/{len(view)} bytes written)"
                )


def _parse_header(hdr: bytes) -> Tuple[bytes, int, int]:
    magic, ftype, mlen, blen = _HEADER.unpack(hdr)
    if magic != _MAGIC:
        raise ProtocolError(f"bad frame magic {magic!r} (corrupt wire frame)")
    if mlen > _MAX_META or blen > _MAX_BLOB:
        raise ProtocolError(
            f"implausible frame lengths meta={mlen} blob={blen} (corrupt)"
        )
    return ftype, mlen, blen


def _read_exact(sock: socket.socket, n: int, stop: threading.Event) -> bytes:
    """Read exactly n bytes; socket timeouts mid-buffer keep accumulating
    (the per-recv settimeout is liveness granularity, not a deadline) until
    `stop` is set.  b'' from the kernel means the peer closed: OSError."""
    sock.settimeout(_IDLE_POLL_S)  # every recv is poll-bounded (R10)
    buf = bytearray()
    while len(buf) < n:
        if stop.is_set():
            raise OSError("connection shut down locally")
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout:
            continue
        if not chunk:
            raise OSError("connection closed by peer")
        buf.extend(chunk)
    return bytes(buf)


def _read_frame(
    sock: socket.socket, stop: threading.Event
) -> Optional[Tuple[bytes, Dict[str, Any], bytes, bytes]]:
    """One whole frame (type, meta, blob, raw bytes), or None when the
    socket idled through a poll interval with no data (the caller's chance
    to run liveness checks).  Raw bytes are returned so wire fault sites
    can corrupt/drop the frame as ONE unit."""
    sock.settimeout(_IDLE_POLL_S)  # every recv is poll-bounded (R10)
    try:
        first = sock.recv(1)
    except socket.timeout:
        return None
    if not first:
        raise OSError("connection closed by peer")
    hdr = first + _read_exact(sock, _HEADER.size - 1, stop)
    ftype, mlen, blen = _parse_header(hdr)
    rest = _read_exact(sock, mlen + blen, stop)
    try:
        meta = json.loads(rest[:mlen].decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as exc:
        raise ProtocolError(f"corrupt frame meta: {exc}") from exc
    return ftype, meta, rest[mlen:], hdr + rest


def _reparse_frame(raw: bytes) -> Tuple[bytes, Dict[str, Any], bytes]:
    """Re-parse a (possibly fault-corrupted) raw frame: the magic/bounds/
    JSON checks are the loud-failure contract for corrupt wire bytes."""
    ftype, mlen, blen = _parse_header(raw[: _HEADER.size])
    body = raw[_HEADER.size:]
    if len(body) != mlen + blen:
        raise ProtocolError("frame length mismatch (corrupt wire frame)")
    try:
        meta = json.loads(body[:mlen].decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as exc:
        raise ProtocolError(f"corrupt frame meta: {exc}") from exc
    return ftype, meta, body[mlen:]


# -- the coordinator ----------------------------------------------------------


@dataclass
class _Member:
    rank: int
    epoch: int
    conn: socket.socket
    # class-level lockdep name: every member's send lock is one node (order
    # is a code discipline); the static R11 pass can't follow this lock
    # through _send_to's parameter, so the runtime check carries it alone
    send_lock: Any = field(
        default_factory=lambda: sanitize.lockdep_lock("net.coord.member_send")
    )
    last_seen: float = 0.0


class CoordinatorServer:
    """The rendezvous side of the wire plane: tracks membership by lease,
    collects gather rounds, rebroadcasts aborts/deaths as pushes, fences
    stale epochs, and reserves torch.distributed ports.  Hosted in rank 0's
    process by bootstrap_tcp_plane(), or standalone by a launcher."""

    def __init__(
        self,
        nranks: int,
        host: str = "",
        advertise_host: Optional[str] = None,
        port: int = 0,
        lease_s: Optional[float] = None,
    ):
        self._nranks = int(nranks)
        self._host = host
        self._advertise_host = advertise_host
        self._port = port
        self._lease_s = lease_s if lease_s is not None else lease_interval_s()
        self._lock = sanitize.lockdep_lock("net.coord.state")
        self._members: Dict[int, _Member] = {}
        self._next_epoch: Dict[int, int] = {}
        self._dead: Dict[int, str] = {}            # rank -> reason
        self._aborts: Dict[int, bytes] = {}        # rank -> abort payload
        self._health: Dict[int, str] = {}
        self._rounds: Dict[int, Dict[int, bytes]] = {}
        self._handed_ports: Set[int] = set()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._listener: Optional[socket.socket] = None
        self._address = ""

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> str:
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self._host, self._port))
        self._listener.listen(max(8, 2 * self._nranks))
        self._listener.settimeout(_IDLE_POLL_S)
        host = self._advertise_host or _local_ip()
        self._address = f"{host}:{self._listener.getsockname()[1]}"
        for name, target in (
            ("srml-netcp-accept", self._accept_loop),
            ("srml-netcp-scan", self._scan_loop),
        ):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            with self._lock:
                self._threads.append(t)
        return self._address

    @property
    def address(self) -> str:
        return self._address

    def stop(self, grace_s: float = 2.0) -> None:
        """Shut the coordinator down: wait up to grace_s for members to
        LEAVE (so sibling ranks' clean closes are not misread as a lost
        coordinator), then close everything and join every thread — the
        no-orphan-sockets/threads half of the teardown contract."""
        deadline = time.monotonic() + grace_s
        while time.monotonic() < deadline:
            with self._lock:
                if not self._members:
                    break
            time.sleep(0.01)
        self._stop.set()
        if self._listener is not None:
            with contextlib.suppress(OSError):
                self._listener.close()
        with self._lock:
            members = list(self._members.values())
            self._members.clear()
        for m in members:
            with contextlib.suppress(OSError):
                m.conn.close()
        with self._lock:
            threads, self._threads = list(self._threads), []
        for t in threads:  # join OUTSIDE the lock (R11: no waits under it)
            t.join(timeout=5.0)

    # -- accept / per-connection reader --------------------------------------
    def _accept_loop(self) -> None:
        self._listener.settimeout(_IDLE_POLL_S)  # accept is poll-bounded (R10)
        while not self._stop.is_set():
            try:
                conn, _addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed: shutting down
            conn.settimeout(_IDLE_POLL_S)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(
                target=self._serve_conn, args=(conn,),
                name=f"srml-netcp-conn-{conn.fileno()}", daemon=True,
            )
            t.start()
            # prune finished per-connection threads as we go: reconnect /
            # fence churn must not grow the list (or stop()'s join sweep)
            # without bound over a long coordinator lifetime.  Under the
            # state lock: stop()'s join sweep snapshots this list from
            # another thread (graftlint R12)
            with self._lock:
                self._threads = [x for x in self._threads if x.is_alive()]
                self._threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        member: Optional[_Member] = None
        try:
            member = self._handshake(conn)
            if member is None:
                return
            while not self._stop.is_set():
                got = _read_frame(conn, self._stop)
                if got is None:
                    continue
                ftype, meta, blob, _raw = got
                with self._lock:
                    if self._members.get(member.rank) is not member:
                        return  # fenced/superseded mid-read: drop the frame
                    member.last_seen = time.monotonic()
                if ftype == _LEAVE:
                    self._remove_member(member.rank, member.epoch)
                    return
                self._dispatch(member, ftype, meta, blob)
        except ProtocolError as exc:
            # corrupt frames from a member are a death sentence for that
            # member — the codec contract is fail-loud, never decode-garbage
            if member is not None:
                self._declare_dead(member, f"protocol violation: {exc}")
        except OSError:
            # connection dropped without LEAVE: the SIGKILL/crash shape —
            # declare the member dead NOW (the kernel's FIN beats the lease)
            if member is not None:
                self._declare_dead(
                    member,
                    "connection closed without leave (killed / crashed)",
                )
        finally:
            with contextlib.suppress(OSError):
                conn.close()

    def _handshake(self, conn: socket.socket) -> Optional[_Member]:
        got = None
        deadline = time.monotonic() + self._lease_s * 2
        while got is None:
            if time.monotonic() > deadline:
                return None
            got = _read_frame(conn, self._stop)
        ftype, meta, _blob, _raw = got
        if ftype != _HELLO:
            raise ProtocolError(f"expected HELLO, got {ftype!r}")
        rank = int(meta["rank"])
        nranks = int(meta["nranks"])
        epoch = meta.get("epoch")
        if nranks != self._nranks:
            self._send_to(conn, threading.Lock(), _FENCED, {
                "reason": f"nranks mismatch: job has {self._nranks}, "
                          f"rank {rank} claims {nranks}",
            })
            return None
        with self._lock:
            reason = self._fence_reason(rank, epoch)
            if reason is None:
                if epoch is None:
                    epoch = self._next_epoch.get(rank, 0) + 1
                    self._next_epoch[rank] = epoch
                member = _Member(rank=rank, epoch=int(epoch), conn=conn,
                                 last_seen=time.monotonic())
                self._members[rank] = member
        if reason is not None:
            profiling.incr_counter("cp.net.fenced_rejoins")
            self._send_to(conn, threading.Lock(), _FENCED, {
                "rank": rank, "stale_epoch": epoch, "reason": reason,
            })
            return None
        self._send_to(member.conn, member.send_lock, _WELCOME, {
            "epoch": member.epoch, "lease_s": self._lease_s,
        })
        # a joiner must learn of failures that predate it (it may be a
        # straggler connecting into an already-failing session)
        with self._lock:
            dead = dict(self._dead)
            aborts = dict(self._aborts)
        for r, why in dead.items():
            self._send_to(member.conn, member.send_lock, _DEAD_PUSH,
                          {"rank": r, "reason": why})
        for r, payload in aborts.items():
            if r != rank:
                self._send_to(member.conn, member.send_lock, _ABORT_PUSH,
                              {"rank": r}, payload)
        return member

    def _fence_reason(self, rank: int, epoch) -> Optional[str]:
        """Why this (rank, epoch) join must be fenced, or None.  Caller
        holds the lock."""
        if rank in self._dead:
            return (
                f"rank {rank} was already declared dead this session "
                f"({self._dead[rank]}); a rejoining zombie is fenced"
            )
        current = self._members.get(rank)
        if epoch is None:
            if current is not None:
                return (
                    f"rank {rank} already has a live member (epoch "
                    f"{current.epoch}); a duplicate fresh join is fenced"
                )
            return None
        if current is not None and current.epoch == int(epoch):
            # the reconnect path: same incarnation resuming after a
            # transient drop — replace the connection
            with contextlib.suppress(OSError):
                current.conn.close()
            profiling.incr_counter("cp.net.reconnects")
            return None
        latest = self._next_epoch.get(rank, 0)
        return (
            f"epoch {epoch} is stale (latest incarnation is {latest}); "
            "a previous-incarnation zombie is fenced"
        )

    # -- frame dispatch -------------------------------------------------------
    def _dispatch(
        self, member: _Member, ftype: bytes, meta: Dict[str, Any], blob: bytes
    ) -> None:
        if ftype == _PING:
            self._send_to(member.conn, member.send_lock, _PONG, {})
        elif ftype == _GATHER:
            self._on_gather(member, int(meta["round"]), blob)
        elif ftype == _ABORT:
            self._on_abort(member.rank, blob)
        elif ftype == _HEALTH:
            with self._lock:
                self._health[member.rank] = blob.decode("utf-8")
        elif ftype == _READ_HEALTH:
            with self._lock:
                snap = {str(r): p for r, p in self._health.items()}
            self._send_to(member.conn, member.send_lock, _HEALTH_SNAPSHOT,
                          {"seq": meta["seq"], "health": snap})
        elif ftype == _ALLOC_PORT:
            port = self._allocate_port()
            self._send_to(member.conn, member.send_lock, _PORT,
                          {"seq": meta["seq"], "port": port})
        elif ftype == _GATHER_STATE:
            # on-demand progress introspection: ONLY a timing-out client
            # asks (a per-post broadcast would cost nranks^2 frames per
            # round on the happy path for data read once per failure)
            with self._lock:
                posted = sorted(self._rounds.get(int(meta["round"]), {}))
            self._send_to(member.conn, member.send_lock, _HEALTH_SNAPSHOT,
                          {"seq": meta["seq"], "posted": posted})
        else:
            raise ProtocolError(f"unknown frame type {ftype!r}")

    def _on_gather(self, member: _Member, round_no: int, payload: bytes) -> None:
        complete = None
        with self._lock:
            posts = self._rounds.setdefault(round_no, {})
            posts[member.rank] = payload
            if len(posts) == self._nranks:
                complete = [posts[r] for r in range(self._nranks)]
                del self._rounds[round_no]
            targets = list(self._members.values())
        if complete is not None:
            blob = b"".join(complete)
            meta = {"round": round_no, "counts": [len(p) for p in complete]}
            for m in targets:
                self._send_to(m.conn, m.send_lock, _GATHER_RESULT, meta, blob)

    def _on_abort(self, rank: int, payload: bytes) -> None:
        with self._lock:
            self._aborts[rank] = payload
            targets = [m for r, m in self._members.items() if r != rank]
        profiling.incr_counter("cp.net.pushed_aborts")
        for m in targets:
            self._send_to(m.conn, m.send_lock, _ABORT_PUSH, {"rank": rank},
                          payload)

    def _allocate_port(self) -> int:
        """Reserve a currently-free port and record it in the hand-out
        ledger: two sessions served by this coordinator can never receive
        the same port, which is the race _free_port() could not close.
        (A process OUTSIDE the coordinator's tenancy can still grab it —
        the ledger removes the common intra-job race, not the OS.)"""
        for _ in range(128):
            with socket.socket() as s:
                s.bind((self._host, 0))
                port = s.getsockname()[1]
            with self._lock:
                if port not in self._handed_ports:
                    self._handed_ports.add(port)
                    profiling.incr_counter("cp.net.alloc_ports")
                    return port
        raise RuntimeError("coordinator could not reserve a fresh port")

    # -- membership ----------------------------------------------------------
    def _remove_member(self, rank: int, epoch: int) -> None:
        with self._lock:
            m = self._members.get(rank)
            if m is not None and m.epoch == epoch:
                del self._members[rank]

    def _declare_dead(self, member: _Member, reason: str) -> None:
        rank = member.rank
        with self._lock:
            if self._members.get(rank) is not member or rank in self._dead:
                return  # a superseded conn of a resumed member, or already dead
            del self._members[rank]
            self._dead[rank] = reason
            # the dead incarnation's epoch is now fenced: _fence_reason
            # rejects any rejoin for a dead rank this session
            targets = list(self._members.values())
        profiling.incr_counter("cp.net.dead_pushes")
        _log.error("coordinator: rank %d declared dead: %s", rank, reason)
        # tell the FENCED member first (a lease-expired-but-resumed rank
        # must learn it was fenced, not keep posting), then sever its
        # connection so its frames can never land in a round again — the
        # enforcement half of "never silently readmitted"
        self._send_to(member.conn, member.send_lock, _DEAD_PUSH,
                      {"rank": rank, "reason": reason})
        with contextlib.suppress(OSError):
            member.conn.close()
        for m in targets:
            self._send_to(m.conn, m.send_lock, _DEAD_PUSH,
                          {"rank": rank, "reason": reason})

    def _scan_loop(self) -> None:
        poll = max(0.01, self._lease_s / 4.0)
        while not self._stop.wait(poll):
            now = time.monotonic()
            with self._lock:
                expired = [
                    (m, now - m.last_seen)
                    for m in self._members.values()
                    if now - m.last_seen > self._lease_s
                ]
            for m, age in expired:
                profiling.incr_counter("cp.net.lease_expiries")
                self._declare_dead(
                    m,
                    f"lease expired ({age:.2f}s > {self._lease_s}s without "
                    f"a frame; {LEASE_ENV}) — killed, wedged, or partitioned",
                )

    def _send_to(
        self, conn: socket.socket, lock: threading.Lock,
        ftype: bytes, meta: Dict[str, Any], blob: bytes = b"",
    ) -> None:
        frame = _pack_frame(ftype, meta, blob)
        try:
            with lock:
                _send_all(conn, frame, deadline_s=max(10.0, 4 * self._lease_s))
        except OSError:
            # the member is gone or stopped draining; a partially-written
            # frame would desync the stream, so the connection must DIE —
            # its reader thread then owns the death diagnosis
            with contextlib.suppress(OSError):
                conn.close()


# -- the client plane ---------------------------------------------------------


class TcpControlPlane:
    """ControlPlane over one coordinator socket: the srml-wire counterpart
    of FileControlPlane, same surface, same injection sites (cp.gather /
    cp.barrier) plus the wire sites (cp.net.send / cp.net.recv).

    All waits are bounded: gathers by the per-round SRML_CP_ROUND_TIMEOUT_S
    budget (raising the typed ControlPlaneTimeout naming the missing
    ranks), request/response frames by the lease.  Remote failures arrive
    as coordinator pushes and surface as RemoteRankError (abort marker or
    expired lease, naming the rank) or StaleEpochError (this process was
    fenced); a lost coordinator raises CoordinatorLost."""

    def __init__(
        self,
        address: str,
        rank: int,
        nranks: int,
        timeout: Optional[float] = None,
        resume_epoch: Optional[int] = None,
        owned_server: Optional[CoordinatorServer] = None,
        addr_file: Optional[str] = None,
    ):
        self._address = address
        self._rank = int(rank)
        self._nranks = int(nranks)
        self._timeout = (
            timeout
            if timeout is not None
            else _env_float(ROUND_TIMEOUT_ENV, _DEFAULT_ROUND_TIMEOUT_S)
        )
        self._retry = RetryPolicy.from_env()
        self._jitter = random.Random(20011 + rank)  # seeded: graftlint R4
        self._lease_s = lease_interval_s()
        self._owned_server = owned_server
        self._addr_file = addr_file
        self._round = 0
        self._seq = 0
        self._epoch: Optional[int] = resume_epoch
        self._closed = False
        self._stop = threading.Event()
        self._send_lock = sanitize.lockdep_lock("net.plane.send")
        self._lock = sanitize.lockdep_lock("net.plane.state")
        self._wake = threading.Condition(self._lock)
        self._results: Dict[int, List[bytes]] = {}
        self._abort: Optional[Dict[str, Any]] = None
        self._dead: Optional[Tuple[int, str]] = None
        self._fenced: Optional[str] = None
        self._lost: Optional[str] = None
        self._health: Dict[int, str] = {}
        self._replies: Dict[int, Dict[str, Any]] = {}
        self._last_rx = time.monotonic()

        host, port = address.rsplit(":", 1)
        # transient connect failures (coordinator still binding, SYN drops
        # under churn) retry with the shared SRML_CP_RETRIES/BACKOFF
        # policy; EXHAUSTION surfaces typed (never a bare socket error —
        # the module contract the chaos workers key their exit codes on)
        try:
            self._sock = self._retry.run(
                lambda: socket.create_connection(
                    (host, int(port)), timeout=10.0
                ),
                self._jitter,
            )
        except OSError as exc:
            raise CoordinatorLost(
                address,
                f"connect failed after {self._retry.retries} retries: {exc}",
            ) from exc
        self._sock.settimeout(_IDLE_POLL_S)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._hello()
        self._rx_thread = threading.Thread(
            target=self._recv_loop, name=f"srml-netcp-rx-r{rank}", daemon=True
        )
        self._rx_thread.start()
        self._ping_thread = threading.Thread(
            target=self._ping_loop, name=f"srml-netcp-ping-r{rank}",
            daemon=True,
        )
        self._ping_thread.start()

    # -- bootstrap ------------------------------------------------------------
    def _hello(self) -> None:
        _send_all(self._sock, _pack_frame(_HELLO, {
            "rank": self._rank, "nranks": self._nranks, "epoch": self._epoch,
        }), deadline_s=max(self._timeout, 10.0))
        deadline = time.monotonic() + max(self._timeout, 10.0)
        got = None
        while got is None:
            if time.monotonic() > deadline:
                raise CoordinatorLost(self._address, "no HELLO reply")
            try:
                got = _read_frame(self._sock, self._stop)
            except OSError as exc:
                raise CoordinatorLost(
                    self._address, f"connection lost during handshake: {exc}"
                ) from exc
        ftype, meta, _blob, _raw = got
        if ftype == _FENCED:
            with contextlib.suppress(OSError):
                self._sock.close()
            raise StaleEpochError(
                self._rank, meta.get("stale_epoch"),
                meta.get("reason", "fenced"),
            )
        if ftype != _WELCOME:
            raise ProtocolError(f"expected WELCOME, got {ftype!r}")
        self._epoch = int(meta["epoch"])
        self._lease_s = float(meta.get("lease_s", self._lease_s))

    @property
    def epoch(self) -> int:
        """This incarnation's session epoch (the fencing token)."""
        return int(self._epoch)

    # -- wire I/O (the cp.net.* fault sites) ----------------------------------
    def _send_frame(
        self, ftype: bytes, meta: Dict[str, Any], blob: bytes = b""
    ) -> None:
        if self._closed:
            # one plane = one session: close() tears the membership down
            # (LEAVE + fenced epoch semantics); silently reusing the dead
            # socket would surface as a misleading CoordinatorLost
            raise RuntimeError(
                f"TcpControlPlane rank {self._rank} is closed — build a "
                "new plane for a new session (distributed_session closes "
                "the plane it is given at teardown)"
            )
        frame = _pack_frame(ftype, meta, blob)
        frame = faults.site("cp.net.send", rank=self._rank, payload=frame)
        if frame is faults.DROPPED:
            profiling.incr_counter("cp.net.drops")
            return  # the wire ate it (injected loss / partition)
        profiling.incr_counter("cp.net.sends")
        profiling.incr_counter("cp.net.bytes_out", len(frame))
        try:
            with self._send_lock:
                _send_all(self._sock, frame, deadline_s=self._timeout)
        except OSError as exc:
            self._note_lost(f"send failed: {exc}")
            self._raise_if_failed()
            raise CoordinatorLost(self._address, f"send failed: {exc}")

    def _recv_loop(self) -> None:
        while not self._stop.is_set():
            try:
                got = _read_frame(self._sock, self._stop)
            except (OSError, ProtocolError) as exc:
                if not self._stop.is_set():
                    self._note_lost(str(exc))
                return
            now = time.monotonic()
            if got is None:
                # idle: a silent coordinator past 2 leases is lost (the
                # inbound half of a partition; PONGs refresh this)
                if now - self._last_rx > 2 * self._lease_s:
                    self._note_lost(
                        f"no frames for {now - self._last_rx:.2f}s "
                        f"(> 2x lease {self._lease_s}s) — coordinator dead "
                        "or this host partitioned"
                    )
                    return
                continue
            _ftype, _meta, _blob, raw = got
            raw = faults.site("cp.net.recv", rank=self._rank, payload=raw)
            if raw is faults.DROPPED:
                profiling.incr_counter("cp.net.drops")
                continue
            profiling.incr_counter("cp.net.recvs")
            profiling.incr_counter("cp.net.bytes_in", len(raw))
            try:
                ftype, meta, blob = _reparse_frame(raw)
            except ProtocolError as exc:
                self._note_lost(f"corrupt frame from coordinator: {exc}")
                return
            self._last_rx = now
            self._on_frame(ftype, meta, blob)

    def _on_frame(self, ftype: bytes, meta: Dict[str, Any], blob: bytes) -> None:
        with self._wake:
            if ftype == _GATHER_RESULT:
                counts = meta["counts"]
                out, off = [], 0
                for c in counts:
                    out.append(blob[off: off + int(c)])
                    off += int(c)
                self._results[int(meta["round"])] = out
            elif ftype == _ABORT_PUSH:
                info: Dict[str, Any] = {"rank": int(meta["rank"])}
                with contextlib.suppress(ValueError, UnicodeDecodeError):
                    decoded = json.loads(blob.decode("utf-8"))
                    if isinstance(decoded, dict):
                        info = decoded
                        info.setdefault("rank", int(meta["rank"]))
                self._abort = info
            elif ftype == _DEAD_PUSH:
                rank, reason = int(meta["rank"]), meta.get("reason", "dead")
                if rank == self._rank:
                    # the coordinator thinks WE are dead: we are fenced
                    self._fenced = reason
                elif self._dead is None:
                    self._dead = (rank, reason)
            elif ftype in (_HEALTH_SNAPSHOT, _PORT):
                # request/response mailbox: the whole meta is the reply
                self._replies[int(meta["seq"])] = meta
            elif ftype == _PONG:
                pass
            else:
                self._lost = f"unknown frame type {ftype!r} from coordinator"
            self._wake.notify_all()

    def _note_lost(self, reason: str) -> None:
        with self._wake:
            if self._lost is None:
                self._lost = reason
            self._wake.notify_all()

    def _ping_loop(self) -> None:
        period = max(0.01, self._lease_s / 3.0)
        while not self._stop.wait(period):
            try:
                self._send_frame(_PING, {})
            except Exception as exc:  # noqa: BLE001 - lease keep-alive only
                # typed failures (CoordinatorLost / RemoteRankError /
                # injected faults) surface from the WAITING ops; the
                # pinger's job is just to stop refreshing a dead link
                _log.debug("lease ping stopped: %s", exc)
                return

    # -- failure surfacing ----------------------------------------------------
    def _raise_if_failed(self) -> None:
        """Surface any pushed failure, most specific first.  Caller need
        not hold the lock (reads are single-assignment)."""
        if self._abort is not None:
            info = self._abort
            profiling.incr_counter("cp.remote_aborts")
            raise RemoteRankError(
                rank=int(info.get("rank", -1)),
                message=info.get("message", "aborted"),
                span=info.get("span"),
                etype=info.get("etype"),
            )
        if self._dead is not None:
            rank, reason = self._dead
            profiling.incr_counter("cp.dead_peers")
            raise RemoteRankError(rank=rank, message=reason)
        if self._fenced is not None:
            raise StaleEpochError(self._rank, self._epoch, self._fenced)
        if self._lost is not None:
            raise CoordinatorLost(self._address, self._lost)

    # -- the ControlPlane surface ---------------------------------------------
    def allGather(self, message: str) -> List[str]:
        return [
            b.decode("utf-8")
            for b in self._gather_round(message.encode("utf-8"))
        ]

    def allGatherBytes(self, message: bytes) -> List[bytes]:
        return self._gather_round(message)

    def _gather_round(self, message: bytes) -> List[bytes]:
        r = self._round
        self._round += 1
        message = faults.site("cp.gather", rank=self._rank, payload=message)
        self._send_frame(_GATHER, {"round": r, "rank": self._rank}, message)
        deadline = time.monotonic() + self._timeout
        with self._wake:
            while r not in self._results and time.monotonic() <= deadline:
                self._raise_if_failed()
                self._wake.wait(timeout=0.05)
            out = self._results.pop(r, None)
        if out is not None:
            return out
        # timed out: ask the coordinator who never posted (on demand — a
        # per-post broadcast would cost nranks^2 frames per happy round),
        # re-check for a result that raced the query, then raise typed
        self._raise_if_failed()
        missing = self._query_missing(r)
        with self._wake:
            out = self._results.pop(r, None)
        if out is not None:
            return out
        raise ControlPlaneTimeout("TcpControlPlane", r, missing, self._timeout)

    def _query_missing(self, round_no: int) -> List[int]:
        try:
            posted = set(
                self._request(_GATHER_STATE, {"round": round_no}).get(
                    "posted", []
                )
            )
        except Exception:  # noqa: BLE001 - introspection is best-effort
            posted = set()  # coordinator unreachable: report all as missing
        return sorted(set(range(self._nranks)) - {int(p) for p in posted})

    def barrier(self) -> None:
        faults.site("cp.barrier", rank=self._rank)
        self.allGather("")

    # -- request/response helpers ---------------------------------------------
    def _request(self, ftype: bytes, extra: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            self._seq += 1
            seq = self._seq
        self._send_frame(ftype, {"seq": seq, **extra})
        bound = max(2 * self._lease_s, 5.0)
        deadline = time.monotonic() + bound
        with self._wake:
            while seq not in self._replies:
                self._raise_if_failed()
                if time.monotonic() > deadline:
                    raise CoordinatorLost(
                        self._address,
                        f"no reply to {ftype!r} within {bound:.1f}s",
                    )
                self._wake.wait(timeout=0.05)
            return self._replies.pop(seq)

    # -- srml-shield abort surface --------------------------------------------
    def abort(self, payload: str) -> None:
        """Publish this rank's abort marker; the coordinator PUSHES it to
        every peer immediately — sub-RTT propagation instead of the file
        plane's 50 ms poll floor (bench_control_plane measures this)."""
        profiling.incr_counter("cp.abort_markers")
        self._send_frame(
            _ABORT, {"rank": self._rank}, payload.encode("utf-8")
        )

    def check_abort(self) -> Optional[Dict[str, Any]]:
        return self._abort

    # -- srml-watch health surface (non-collective) ---------------------------
    def publish_health(self, payload: str) -> None:
        # every frame refreshes the lease server-side, so heartbeats do
        # double duty: watch liveness AND membership lease
        self._send_frame(
            _HEALTH, {"rank": self._rank}, payload.encode("utf-8")
        )

    def read_health(self) -> Dict[int, str]:
        reply = self._request(_READ_HEALTH, {})
        return {int(r): p for r, p in reply.get("health", {}).items()}

    # -- coordinator port reservation -----------------------------------------
    def allocate_port(self) -> int:
        """A coordinator-reserved port for torch.distributed (context.py uses
        this on rank 0 when present — the rebind-race fix)."""
        return int(self._request(_ALLOC_PORT, {})["port"])

    # -- teardown -------------------------------------------------------------
    def close(self) -> None:
        """Idempotent: LEAVE best-effort, stop the pinger/receiver, close
        the socket, and (when this plane bootstrapped the coordinator) stop
        the server and reap the address file — no orphaned sockets,
        threads, or files survive a clean close."""
        if self._closed:
            return
        with contextlib.suppress(Exception):
            self._send_frame(_LEAVE, {"rank": self._rank})
        self._closed = True  # AFTER the LEAVE: _send_frame refuses once set
        self._stop.set()
        with contextlib.suppress(OSError):
            self._sock.close()
        self._ping_thread.join(timeout=5.0)
        self._rx_thread.join(timeout=5.0)
        if self._owned_server is not None:
            self._owned_server.stop()
            self._owned_server = None
        if self._addr_file is not None:
            with contextlib.suppress(OSError):
                os.remove(self._addr_file)


# -- shared-directory bootstrap ----------------------------------------------

_ADDR_FILE = "coordinator.addr"


def bootstrap_tcp_plane(
    root: str,
    rank: int,
    nranks: int,
    timeout: Optional[float] = None,
) -> TcpControlPlane:
    """Rendezvous through a shared job directory: rank 0 hosts the
    coordinator in-process and publishes host:port atomically; other ranks
    wait (bounded by the round timeout) for the address and connect.  After
    bootstrap, NOTHING rides the filesystem — every collective, heartbeat,
    and abort is wire frames (this is what the SRML_CP=tcp knob runs the
    whole multicontroller matrix on)."""
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, _ADDR_FILE)
    bound = (
        timeout
        if timeout is not None
        else _env_float(ROUND_TIMEOUT_ENV, _DEFAULT_ROUND_TIMEOUT_S)
    )
    if rank == 0:
        # a CRASHED previous session in this root never reaped its addr
        # file — unlink any leftover BEFORE starting, so no sibling can
        # rendezvous on the stale endpoint
        with contextlib.suppress(OSError):
            os.remove(path)
        server = CoordinatorServer(nranks)
        address = server.start()
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(address)
        os.replace(tmp, path)
        return TcpControlPlane(
            address, rank, nranks, timeout=timeout,
            owned_server=server, addr_file=path,
        )
    deadline = time.monotonic() + bound
    while True:
        address = ""
        with contextlib.suppress(OSError):
            with open(path) as f:
                address = f.read().strip()
        if address:
            try:
                return TcpControlPlane(address, rank, nranks, timeout=timeout)
            except CoordinatorLost:
                # a stale address from a crashed previous session (rank 0
                # unlinks it at startup, but this reader may have raced
                # that): keep polling for the fresh publication
                if time.monotonic() > deadline:
                    raise
        if time.monotonic() > deadline:
            raise ControlPlaneTimeout("TcpControlPlane bootstrap", 0, [0], bound)
        time.sleep(0.02)
