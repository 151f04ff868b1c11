# The port's control planes (spark_rapids_ml_tpu_torch/parallel/runner.py
# FileControlPlane, parallel/netplane.py TcpControlPlane, parallel/context.py
# LocalControlPlane) against the JAX package's contract, on the CPU:
#
#   - the conformance scenarios of tests/test_control_plane_contract.py on
#     the port's file and TCP planes (threads a rank) and its local plane,
#     with the typed errors' messages equal to the JAX package's;
#   - the netplane cases that need no process kill: frame corruption,
#     lease expiry, epoch fencing, coordinator loss, port allocation, and
#     the context's use of an allocated port; the backend rule;
#   - wire parity: a frame of the port's pack_arrays / _pack_frame /
#     attribute codec is byte-equal to the JAX package's for the same
#     input, and each side decodes the other's;
#   - stream.allgather_merge over a FileControlPlane across threads, for
#     each of the four streaming states, equal to the JAX package's merge.
#
# Tolerances: none; every comparison is exact.
import contextlib
import json
import os
import threading
import time

import numpy as np
import pytest

from spark_rapids_ml_tpu.parallel import context as ref_context
from spark_rapids_ml_tpu.parallel import exchange as ref_exchange
from spark_rapids_ml_tpu.parallel import netplane as ref_netplane
from spark_rapids_ml_tpu.parallel import runner as ref_runner

from spark_rapids_ml_tpu_torch import profiling
from spark_rapids_ml_tpu_torch.parallel import context, exchange, netplane, runner
from spark_rapids_ml_tpu_torch.parallel.context import (
    ControlPlaneTimeout,
    LocalControlPlane,
    RemoteRankError,
    TpuContext,
    choose_backend,
)
from spark_rapids_ml_tpu_torch.parallel.netplane import (
    CoordinatorLost,
    CoordinatorServer,
    ProtocolError,
    StaleEpochError,
    TcpControlPlane,
)
from spark_rapids_ml_tpu_torch.parallel.runner import FileControlPlane

NRANKS = 3


class _PlaneHarness:
    """nranks plane instances over one rendezvous, and their teardown."""

    def __init__(self, kind, tmp_path):
        self.kind = kind
        self.tmp_path = tmp_path
        self._server = None
        self.built = []

    def build(self, timeout=30.0):
        if self.kind == "file":
            planes = [FileControlPlane(str(self.tmp_path / "cp"), r, NRANKS, timeout=timeout) for r in range(NRANKS)]
        else:
            self._server = CoordinatorServer(NRANKS, host="127.0.0.1", advertise_host="127.0.0.1", lease_s=5.0)
            addr = self._server.start()
            planes = [TcpControlPlane(addr, r, NRANKS, timeout=timeout) for r in range(NRANKS)]
        self.built.extend(planes)
        return planes

    def teardown(self):
        for p in self.built:
            with contextlib.suppress(Exception):
                p.close()
        if self._server is not None:
            self._server.stop(grace_s=0.2)


@pytest.fixture(params=["file", "tcp"])
def harness(request, tmp_path):
    h = _PlaneHarness(request.param, tmp_path)
    yield h
    h.teardown()


def _run_ranks(fn, planes):
    """fn(rank, plane) on one thread a rank; {rank: result}, re-raising the
    first worker error."""
    results, errors = {}, {}

    def run(r):
        try:
            results[r] = fn(r, planes[r])
        except Exception as exc:  # noqa: BLE001 - relayed to the test
            errors[r] = exc

    threads = [threading.Thread(target=run, args=(r,), name=f"tcp-r{r}") for r in range(len(planes))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    if errors:
        raise next(iter(errors.values()))
    return results


# -- the conformance scenarios -------------------------------------------------


def test_allgather_is_rank_indexed(harness):
    planes = harness.build()
    results = _run_ranks(lambda r, p: p.allGather(f"msg-from-{r}"), planes)
    for r in range(NRANKS):
        assert results[r] == [f"msg-from-{i}" for i in range(NRANKS)]


def test_allgather_bytes_round_trips_raw_binary(harness):
    planes = harness.build()
    payloads = [bytes([r, 0x00, 0xFF, 0xFE]) + b"\x80raw" for r in range(NRANKS)]
    results = _run_ranks(lambda r, p: p.allGatherBytes(payloads[r]), planes)
    for r in range(NRANKS):
        assert results[r] == payloads


def test_consecutive_rounds_stay_ordered(harness):
    planes = harness.build()

    def rounds(r, p):
        out = [p.allGather(f"{r}:{i}") for i in range(4)]
        p.barrier()
        return out

    results = _run_ranks(rounds, planes)
    for r in range(NRANKS):
        for i in range(4):
            assert results[r][i] == [f"{j}:{i}" for j in range(NRANKS)]


def test_health_publish_read_is_nonblocking(harness):
    planes = harness.build()
    _run_ranks(lambda r, p: p.publish_health(json.dumps({"rank": r, "progress": r * 10})), planes)
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        health = planes[0].read_health()
        if set(health) == set(range(NRANKS)):
            break
        time.sleep(0.02)
    assert set(health) == set(range(NRANKS))
    for r, payload in health.items():
        assert json.loads(payload)["rank"] == r
    planes[1].publish_health(json.dumps({"rank": 1, "progress": 99}))
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and json.loads(planes[0].read_health()[1])["progress"] != 99:
        time.sleep(0.02)
    assert json.loads(planes[0].read_health()[1])["progress"] == 99


def test_abort_marker_shape_and_gather_interrupt(harness):
    planes = harness.build()
    marker = {"rank": 1, "etype": "ValueError", "message": "induced", "span": "solver.step"}
    errs = {}

    def waiter(rank):
        try:
            planes[rank].allGather("blocked")
        except RemoteRankError as exc:
            errs[rank] = exc

    threads = [threading.Thread(target=waiter, args=(r,), name=f"tcp-abort-r{r}") for r in (0, 2)]
    for t in threads:
        t.start()
    time.sleep(0.2)
    planes[1].abort(json.dumps(marker))
    for t in threads:
        t.join(timeout=15.0)
    assert set(errs) == {0, 2}
    for exc in errs.values():
        assert (exc.rank, exc.etype, exc.span) == (1, "ValueError", "solver.step")
        assert str(exc) == str(ref_context.RemoteRankError(1, "induced", span="solver.step", etype="ValueError"))
    info = planes[0].check_abort()
    assert info is not None and info["rank"] == 1
    assert info["etype"] == "ValueError" and info["span"] == "solver.step"


def test_round_timeout_typed_with_round_and_missing_ranks(harness):
    planes = harness.build(timeout=0.4)
    errs = {}

    def run(r, p):
        if r == 1:
            time.sleep(1.2)  # rank 1 never posts within the budget
            return None
        try:
            p.allGather("present")
        except ControlPlaneTimeout as exc:
            errs[r] = exc
        return None

    _run_ranks(run, planes)
    assert set(errs) == {0, 2}
    for exc in errs.values():
        assert isinstance(exc, TimeoutError)
        assert exc.round_no == 0 and exc.missing_ranks == [1] and exc.timeout_s == 0.4
        assert exc.knob == "SRML_CP_ROUND_TIMEOUT_S"
        assert str(exc) == str(ref_context.ControlPlaneTimeout(exc.plane, 0, [1], 0.4))


def test_close_is_idempotent_and_reaps_presence(harness, tmp_path):
    planes = harness.build()
    _run_ranks(lambda r, p: p.allGather(f"{r}"), planes)
    for p in planes:
        p.close()
        p.close()
    if harness.kind == "file":
        leftovers = [f for f in os.listdir(tmp_path / "cp") if f.startswith(("alive_", "health_"))]
        assert leftovers == []


def test_local_plane_satisfies_the_surface():
    cp = LocalControlPlane()
    assert cp.allGather("m") == ["m"]
    assert cp.allGatherBytes(b"\x00\xff") == [b"\x00\xff"]
    assert cp.barrier() is None
    cp.publish_health(json.dumps({"rank": 0, "progress": 1}))
    assert json.loads(cp.read_health()[0])["progress"] == 1
    cp.abort(json.dumps({"rank": 0}))
    assert cp.check_abort() is None
    cp.close()
    cp.close()


@pytest.mark.parametrize("args", [
    ("FileControlPlane", 3, [2, 0], 1.5),
    ("TcpControlPlane", 0, [1], 300.0),
])
def test_typed_errors_read_as_the_jax_package_s(args):
    assert str(ControlPlaneTimeout(*args)) == str(ref_context.ControlPlaneTimeout(*args))
    assert ControlPlaneTimeout(*args).missing_ranks == ref_context.ControlPlaneTimeout(*args).missing_ranks
    assert str(RemoteRankError(2, "gone")) == str(ref_context.RemoteRankError(2, "gone"))
    assert (context.ROUND_TIMEOUT_ENV, context.RETRIES_ENV, context.BACKOFF_ENV) == (
        ref_context.ROUND_TIMEOUT_ENV, ref_context.RETRIES_ENV, ref_context.BACKOFF_ENV)


# -- the netplane cases that need no process kill -----------------------------


def _netcp_threads():
    return [t.name for t in threading.enumerate() if t.name.startswith("srml-netcp")]


@pytest.fixture
def coordinator():
    """A running coordinator and a client factory; teardown checks that no
    netplane thread outlives the test."""
    made = []

    def build(nranks, lease_s=1.0, timeout=10.0):
        srv = CoordinatorServer(nranks, host="127.0.0.1", advertise_host="127.0.0.1", lease_s=lease_s)
        addr = srv.start()
        made.append(srv)

        def client(rank, **kw):
            kw.setdefault("timeout", timeout)
            cp = TcpControlPlane(addr, rank, nranks, **kw)
            made.append(cp)
            return cp

        return srv, addr, client

    yield build
    for m in reversed(made):
        with contextlib.suppress(Exception):
            (m.close if isinstance(m, TcpControlPlane) else m.stop)()
    deadline = time.monotonic() + 10.0
    while _netcp_threads() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert _netcp_threads() == [], "orphaned netplane threads after teardown"


def test_frame_codec_round_trip_and_loud_corruption():
    frame = netplane._pack_frame(b"G", {"round": 3, "rank": 1}, b"\x00\xffpayload")
    ftype, meta, blob = netplane._reparse_frame(frame)
    assert (ftype, meta["round"], blob) == (b"G", 3, b"\x00\xffpayload")
    bad = bytearray(frame)
    bad[0] ^= 0xFF
    with pytest.raises(ProtocolError, match="magic"):
        netplane._reparse_frame(bytes(bad))
    bad2 = bytearray(frame)
    bad2[7] = 0xFF  # meta-length high byte
    with pytest.raises(ProtocolError):
        netplane._reparse_frame(bytes(bad2))
    bad3 = bytearray(frame)
    bad3[len(bad3) - len(b"\x00\xffpayload") - 2] ^= 0xFF
    with pytest.raises(ProtocolError):
        netplane._reparse_frame(bytes(bad3))


def test_lease_expiry_names_the_silent_rank(coordinator):
    _srv, _addr, client = coordinator(2, lease_s=0.5)
    cp0, cp1 = client(0), client(1)
    cp1._stop.set()  # silent, socket open: the wedge shape
    got = {}
    t0 = time.monotonic()

    def waiter():
        try:
            cp0.allGather("x")
        except RemoteRankError as exc:
            got["e"] = (exc, time.monotonic() - t0)

    w = threading.Thread(target=waiter, name="tcp-lease-waiter")
    w.start()
    w.join(timeout=10.0)
    exc, dt = got["e"]
    assert exc.rank == 1 and "lease expired" in str(exc)
    assert "SRML_CP_LEASE_S" in str(exc)
    assert dt < 2 * 0.5 + 0.5, f"detection took {dt:.2f}s"


def test_stale_epoch_rejoin_is_fenced(coordinator):
    _srv, addr, client = coordinator(2, lease_s=0.4)
    cp0, cp1 = client(0), client(1)
    zombie_epoch = cp1.epoch
    cp1._stop.set()  # the lease declares rank 1 dead
    with pytest.raises(RemoteRankError, match="rank 1"):
        cp0.allGather("x")
    before = profiling.counter("cp.net.fenced_rejoins")
    with pytest.raises(StaleEpochError, match="fenced"):
        TcpControlPlane(addr, 1, 2, timeout=5, resume_epoch=zombie_epoch)
    with pytest.raises(StaleEpochError, match="fenced"):
        TcpControlPlane(addr, 1, 2, timeout=5)
    assert profiling.counter("cp.net.fenced_rejoins") - before == 2


def test_duplicate_live_rank_join_is_fenced(coordinator):
    _srv, addr, client = coordinator(2)
    client(0)
    client(1)
    with pytest.raises(StaleEpochError, match="duplicate"):
        TcpControlPlane(addr, 1, 2, timeout=5)


def test_coordinator_death_is_typed_and_bounded(coordinator):
    srv, _addr, client = coordinator(2, lease_s=0.5)
    cp0 = client(0)
    got = {}
    t0 = time.monotonic()

    def waiter():
        try:
            cp0.allGather("x")
        except CoordinatorLost as exc:
            got["e"] = (exc, time.monotonic() - t0)

    w = threading.Thread(target=waiter, name="tcp-lost-waiter")
    w.start()
    time.sleep(0.2)
    srv.stop(grace_s=0.0)
    w.join(timeout=10.0)
    exc, dt = got["e"]
    assert "coordinator" in str(exc) and dt < 2.0


def test_allocated_ports_are_never_reissued(coordinator):
    _srv, _addr, client = coordinator(1)
    cp = client(0)
    ports = [cp.allocate_port() for _ in range(16)]
    assert len(set(ports)) == 16
    assert all(1024 <= p <= 65535 for p in ports)


# a routing table as /proc/net/route prints it (addresses as native-order
# hex): a default route on eth0, 10.0.0.0/8 on eth1, and 10.255.0.0/16 on
# eth2, which is down
_ROUTES = (
    "Iface\tDestination\tGateway \tFlags\tRefCnt\tUse\tMetric\tMask\t\tMTU\tWindow\tIRTT\n"
    "eth0\t00000000\t010200C0\t0003\t0\t0\t100\t00000000\t0\t0\t0\n"
    "eth1\t0000000A\t00000000\t0001\t0\t0\t0\t000000FF\t0\t0\t0\n"
    "eth2\t0000FF0A\t00000000\t0000\t0\t0\t0\t0000FFFF\t0\t0\t0\n"
)


def test_egress_route_is_the_longest_prefix_that_is_up():
    assert netplane._route_iface(_ROUTES) == "eth1"
    assert netplane._route_iface("\n".join(_ROUTES.splitlines()[:2])) == "eth0"
    assert netplane._route_iface(_ROUTES.splitlines()[0]) is None


def test_advertised_host_is_the_egress_address(monkeypatch):
    """With SRML_CP_HOST unset a rank advertises its egress interface's
    address, not the loopback (ranks on other hosts dial it); the variable
    overrides it."""
    monkeypatch.delenv(netplane.HOST_ENV, raising=False)
    monkeypatch.setattr(netplane, "_read_routes", lambda: _ROUTES)
    monkeypatch.setattr(netplane, "_iface_ipv4", {"eth1": "10.1.2.3"}.get)
    assert netplane._local_ip() == "10.1.2.3"
    monkeypatch.setenv(netplane.HOST_ENV, "192.0.2.77")
    assert netplane._local_ip() == "192.0.2.77"


def test_advertised_host_of_this_host_is_not_the_loopback(monkeypatch):
    monkeypatch.delenv(netplane.HOST_ENV, raising=False)
    iface = netplane._route_iface(netplane._read_routes())
    ip = netplane._local_ip()
    assert ip == netplane._iface_ipv4(iface)
    assert not ip.startswith("127.")


def test_context_uses_coordinator_allocated_port(monkeypatch):
    """Rank 0 takes the process group's port from the plane's
    allocate_port, and the process group gets the stated timeout and the
    backend the rule picks (gloo on the CPU)."""
    import torch.distributed as dist

    class _PortPlane:
        def __init__(self):
            self.handed = []

        def allGather(self, message):
            return [message, json.dumps({"rank": 1, "addr": "", "devices": ["cpu"]})]

        def barrier(self):
            return None

        def allocate_port(self):
            self.handed.append(45713)
            return 45713

    captured = {}
    monkeypatch.setattr(dist, "init_process_group", lambda backend, **kw: captured.update(kw, backend=backend))
    monkeypatch.setenv("SRML_CP_ROUND_TIMEOUT_S", "42")
    monkeypatch.setenv(netplane.HOST_ENV, "192.0.2.77")
    cp = _PortPlane()
    ctx = TpuContext(rank=0, nranks=2, control_plane=cp, devices=["cpu"])
    ctx.__enter__()
    try:
        assert cp.handed == [45713]
        assert captured["init_method"] == "tcp://192.0.2.77:45713"
        assert captured["backend"] == "gloo" == ctx.phases["backend"]
        assert captured["timeout"].total_seconds() == 42.0
        assert (captured["rank"], captured["world_size"]) == (0, 2)
    finally:
        ctx._initialized_distributed = False  # the process group was a stub
        ctx.__exit__(None, None, None)


@pytest.mark.parametrize("identities, backend", [
    ([["cpu"] * 4, ["cpu"] * 4], "gloo"),
    ([["cuda:GPU-a"], ["cuda:GPU-a"]], "gloo"),        # two ranks on one card
    ([["cuda:GPU-a", "cuda:GPU-a"], ["cuda:GPU-b"]], "nccl"),
    ([["cuda:GPU-a"], ["cpu"]], "gloo"),
    ([["cuda:GPU-a"], ["cuda:GPU-b"], ["cuda:GPU-c"]], "nccl"),
])
def test_backend_rule(identities, backend):
    assert choose_backend(identities) == backend


# -- wire parity with the JAX package ------------------------------------------

_ARRAYS = [
    [np.arange(12, dtype=np.float32).reshape(3, 4)],
    [np.array(5, np.int64), np.zeros((0, 7), np.float64), np.array([True, False])],
    [np.arange(6, dtype=np.int32).reshape(2, 3)[:, ::2], np.full((2, 2, 2), -1, np.int64)],
]


@pytest.mark.parametrize("arrays", _ARRAYS)
def test_pack_arrays_byte_equal_and_cross_decodes(arrays):
    ours, theirs = exchange.pack_arrays(arrays), ref_exchange.pack_arrays(arrays)
    assert ours == theirs
    for decoded in (exchange.unpack_arrays(theirs), ref_exchange.unpack_arrays(ours)):
        assert len(decoded) == len(arrays)
        for a, b in zip(decoded, arrays):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_control_frames_byte_equal_and_cross_decode():
    meta = {"round": 7, "rank": 2, "epoch": 3}
    blob = b"\x00\x01payload\xff"
    ours, theirs = netplane._pack_frame(b"G", meta, blob), ref_netplane._pack_frame(b"G", meta, blob)
    assert ours == theirs
    assert netplane._reparse_frame(theirs) == ref_netplane._reparse_frame(ours) == (b"G", meta, blob)


def test_attribute_codec_byte_equal_and_cross_decodes():
    import torch

    attrs = {
        "coef_": np.linspace(-1, 1, 5),
        "classes_": np.array([1.0, 3.0, 5.0], np.float32),
        "n_iter_": np.int64(12),
        "nested": {"w": np.eye(2, dtype=np.float32), "ids": [np.arange(3), 4]},
        "name": "m",
    }
    ours = json.dumps(runner.encode_attrs(attrs), sort_keys=True)
    theirs = json.dumps(ref_runner.encode_attrs(attrs), sort_keys=True)
    assert ours == theirs
    # a tensor travels as the array it holds
    assert runner.encode_attrs({"t": torch.arange(4.0)}) == ref_runner.encode_attrs({"t": np.arange(4.0, dtype=np.float32)})
    for decoded in (runner.decode_attrs(json.loads(theirs)), ref_runner.decode_attrs(json.loads(ours))):
        np.testing.assert_array_equal(decoded["coef_"], attrs["coef_"])
        assert decoded["classes_"].dtype == np.float32
        np.testing.assert_array_equal(decoded["nested"]["w"], attrs["nested"]["w"])
        np.testing.assert_array_equal(decoded["nested"]["ids"][0], np.arange(3))
        assert decoded["n_iter_"] == 12 and decoded["name"] == "m"


# -- host frames over a real plane ----------------------------------------------


def test_host_frame_collectives_over_a_file_plane(tmp_path):
    """allgather_bytes, ring_pass_bytes and alltoall_bytes over a
    FileControlPlane, with frames past the chunk size: what each rank gets
    is the JAX helpers' result on the same payloads."""
    planes = [FileControlPlane(str(tmp_path / "cp"), r, NRANKS, timeout=30) for r in range(NRANKS)]
    payloads = [bytes([r]) * (3 * 1000 + r) for r in range(NRANKS)]
    dests = [[bytes([r, d]) * (700 + d) if d != r else b"" for d in range(NRANKS)] for r in range(NRANKS)]

    def run(r, p):
        return (
            exchange.allgather_bytes(p, payloads[r], chunk=1000),
            exchange.ring_pass_bytes(p, r, NRANKS, payloads[r], chunk=1000),
            exchange.alltoall_bytes(p, r, NRANKS, dests[r], chunk=500),
        )

    got = _run_ranks(run, planes)
    for p in planes:
        p.close()
    for r in range(NRANKS):
        gathered, ring, a2a = got[r]
        assert gathered == payloads
        assert ring == payloads[(r - 1) % NRANKS]
        assert a2a == [dests[s][r] for s in range(NRANKS)]


# -- streaming state merges over a file plane ------------------------------------

CHUNK = 128


def _engines(pkg, kind):
    return {
        "linreg": lambda: pkg.LinearRegression(maxIter=20).streaming(),
        "pca": lambda: pkg.PCA(k=3).setInputCol("features").streaming(),
        "kmeans": lambda: pkg.KMeans(k=3, maxIter=5, seed=1).setFeaturesCol("features").streaming(),
        "logreg": lambda: pkg.LogisticRegression(maxIter=10).streaming(),
    }[kind]()


@pytest.mark.parametrize("kind", ["linreg", "pca", "kmeans", "logreg"])
def test_allgather_merge_over_a_file_plane(tmp_path, kind):
    """Each thread-rank ingests its own chunks; allgather_merge over a
    FileControlPlane gives every rank the state the JAX package's merge of
    the same partial states gives."""
    import spark_rapids_ml_tpu as ref
    from spark_rapids_ml_tpu.dataframe import stream_chunk_ids
    from spark_rapids_ml_tpu.stream import StreamState as RefStreamState
    from spark_rapids_ml_tpu.stream import merge_all as ref_merge_all

    import spark_rapids_ml_tpu_torch as port
    from spark_rapids_ml_tpu_torch.device import use_device
    from spark_rapids_ml_tpu_torch.stream import allgather_merge

    rng = np.random.default_rng(3)
    n, d = 512, 8
    X = rng.integers(-4, 5, size=(n, d)).astype(np.float32)
    y = (X @ np.arange(1.0, d + 1.0)).astype(np.float64)
    labels = {"linreg": y, "logreg": (X[:, 0] > 0).astype(np.float64)}.get(kind)
    cid = stream_chunk_ids(n, CHUNK, seed=5)
    with use_device("cpu"):
        states = []
        for r in range(NRANKS):
            eng = _engines(port, kind)
            # KMeans streams share the init anchor of their first chunk: every
            # rank starts from chunk 0
            own = list(range(r, int(cid.max()) + 1, NRANKS))
            if kind == "kmeans":
                own = [0] + list(range(1 + r, int(cid.max()) + 1, NRANKS))
            for c in own:
                m = cid == c
                eng.partial_fit(X[m], y=None if labels is None else labels[m])
            states.append(eng.state)
        planes = [FileControlPlane(str(tmp_path / "cp"), r, NRANKS, timeout=30) for r in range(NRANKS)]
        merged = _run_ranks(lambda r, p: allgather_merge(p, states[r]), planes)
        for p in planes:
            p.close()
    ref_merged = ref_merge_all([RefStreamState.from_dict(json.loads(json.dumps(s.to_dict()))) for s in states])
    for r in range(NRANKS):
        assert merged[r].to_dict() == json.loads(json.dumps(ref_merged.to_dict()))
    assert ref is not None
