# The port's serving policy (spark_rapids_ml_tpu_torch.serving) against the
# JAX package's, on the CPU.
#
# Policy scenarios run on the echo stub of tests/test_serving.py, once on
# each package, and the deterministic parts of what they observe must be
# equal: request, row, batch, rejection, timeout, error, death and restart
# counters, lifecycle state codes, the synthetic warm-up dispatches and the
# echoed values.  The worker is held on an event (never a sleep) wherever a
# scenario needs a backlog, so every compared count is fixed by the
# scenario, not by timing.
#
# The pure functions (scheduler.admit / pick / shed_fractions /
# aggregate_fill, bucket_rows / serve_buckets / shape_bucket, the slice
# pool's allocate / release / CapacityExhausted) are held against the JAX
# package's on the same inputs, drawn by hypothesis.
import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import spark_rapids_ml_tpu.serving as ref_serving
from spark_rapids_ml_tpu import profiling as ref_profiling
from spark_rapids_ml_tpu.ops import precompile as ref_precompile
from spark_rapids_ml_tpu.parallel import faults as ref_faults
from spark_rapids_ml_tpu.serving import scheduler as ref_scheduler
from spark_rapids_ml_tpu.serving import slicepool as ref_slicepool

import spark_rapids_ml_tpu_torch.serving as port_serving
from spark_rapids_ml_tpu_torch import profiling as port_profiling
from spark_rapids_ml_tpu_torch.ops import precompile as port_precompile
from spark_rapids_ml_tpu_torch.parallel import faults as port_faults
from spark_rapids_ml_tpu_torch.serving import scheduler as port_scheduler
from spark_rapids_ml_tpu_torch.serving import slicepool as port_slicepool
from spark_rapids_ml_tpu_torch.device import use_device

WAIT_S = 30.0


class Pkg:
    def __init__(self, name, serving, profiling, faults):
        self.name = name
        self.S = serving
        self.P = profiling
        self.F = faults


PKGS = {
    "jax": Pkg("jax", ref_serving, ref_profiling, ref_faults),
    "port": Pkg("port", port_serving, port_profiling, port_faults),
}


@pytest.fixture
def arm(monkeypatch):
    """arm(spec): SRML_FAULTS for both packages' fault modules (arrival
    counters reset); disarmed after the test."""

    def _arm(spec):
        monkeypatch.setenv(port_faults.FAULTS_ENV, spec)
        ref_faults.reload()
        port_faults.reload()

    yield _arm
    monkeypatch.delenv(port_faults.FAULTS_ENV, raising=False)
    ref_faults.reload()
    port_faults.reload()


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


class Echo:
    """Servable stub: echoes row sums.  With `hold` set, a dispatch signals
    `entered` and blocks until `release` is set (what builds a backlog)."""

    def __init__(self, S, n_cols=4, out_col="echo"):
        self.S = S
        self.n_cols = n_cols
        self.out_col = out_col
        self.calls = []
        self.hold = threading.Event()
        self.entered = threading.Event()
        self.release = threading.Event()

    def _serving_entry(self, mesh=None):
        def call(batch):
            if self.hold.is_set():
                self.entered.set()
                assert self.release.wait(WAIT_S)
            self.calls.append(batch.shape[0])
            return {self.out_col: batch.sum(axis=1)}

        return self.S.ServingEntry(name="serve.echo", n_cols=self.n_cols, dtype=np.dtype(np.float32),
                                   out_cols=[self.out_col], call=call, warm=lambda buckets: [])


def recovered(pkg, srv, ns, n=1):
    """Until the server is READY again with `n` restarts counted (the
    counter moves just after the state)."""
    return until(lambda: srv.state() == pkg.S.READY and pkg.P.counter(f"serving.{ns}.restarts") >= n)


def until(pred, timeout_s=WAIT_S):
    """Poll `pred` (bounded) until it holds; its last value."""
    deadline = time.monotonic() + timeout_s
    while not pred() and time.monotonic() < deadline:
        threading.Event().wait(0.01)
    return pred()


def counts(pkg, ns, keys):
    c = pkg.P.counters(f"serving.{ns}.")
    return {k: c.get(f"serving.{ns}.{k}", 0) for k in keys}


def outcome(fut):
    """A future's result values, or its exception's type name."""
    try:
        out = fut.result(timeout=WAIT_S)
    except Exception as exc:  # noqa: BLE001 - the scenario records it
        return type(exc).__name__
    return {k: np.asarray(v).tolist() for k, v in out.items()}


def held_server(pkg, name, **kw):
    """A server over a held Echo whose worker is parked inside its first
    real dispatch (of the returned first future)."""
    model = Echo(pkg.S)
    srv = pkg.S.ModelServer(name, model, **kw)
    model.hold.set()
    first = srv.submit(np.ones(4, np.float32))
    assert model.entered.wait(WAIT_S)
    model.hold.clear()
    return srv, model, first


# -- the scenarios --------------------------------------------------------------


def sc_coalesce(pkg, arm):
    srv, model, first = held_server(pkg, "pol_coal", max_batch=64, max_wait_ms=20)
    try:
        futs = [srv.submit(np.full(4, i, np.float32)) for i in range(7)]
        model.release.set()
        out = [outcome(f) for f in [first] + futs]
    finally:
        srv.shutdown()
    return {"out": out, "calls": model.calls,
            "counts": counts(pkg, "pol_coal", ("requests", "rows", "batches", "coalesced_batches"))}


def sc_deadline_flush(pkg, arm):
    with pkg.S.ModelServer("pol_dead", Echo(pkg.S), max_batch=64, max_wait_ms=5) as srv:
        out = srv.predict(np.ones(4, np.float32))
    return {"out": out["echo"].tolist(), "counts": counts(pkg, "pol_dead", ("batches", "flush_deadline"))}


def sc_full_flush(pkg, arm):
    model = Echo(pkg.S)
    srv = pkg.S.ModelServer("pol_full", model, max_batch=4, max_wait_ms=10_000)
    try:
        model.hold.set()
        first = srv.submit(np.ones((4, 4), np.float32))  # full: flushes at once
        assert model.entered.wait(WAIT_S)
        model.hold.clear()
        rest = [srv.submit(np.ones((2, 4), np.float32)) for _ in range(2)]
        model.release.set()
        out = [outcome(f) for f in [first] + rest]  # 10 s each if deadline-bound
    finally:
        srv.shutdown()
    return {"out": out, "counts": counts(pkg, "pol_full", ("batches", "flush_full", "flush_deadline"))}


def sc_padding(pkg, arm):
    model = Echo(pkg.S)
    with pkg.S.ModelServer("pol_pad", model, max_batch=64, max_wait_ms=1) as srv:
        srv.predict(np.ones((3, 4), np.float32))
    return {"calls": model.calls, "counts": counts(pkg, "pol_pad", ("pad_rows", "warmed_buckets"))}


def sc_validation(pkg, arm):
    errors = []
    with pkg.S.ModelServer("pol_val", Echo(pkg.S), max_batch=8, max_wait_ms=1) as srv:
        for shape in ((2, 3), (0, 4), (9, 4)):
            with pytest.raises(ValueError) as ei:
                srv.submit(np.zeros(shape, np.float32))
            errors.append(str(ei.value).split(";")[0].split("(")[0])
    return {"errors": errors}


def sc_overload(pkg, arm):
    srv, model, first = held_server(pkg, "pol_over", max_batch=4, max_wait_ms=1, queue_depth=8)
    try:
        futs, rejected = [], 0
        for _ in range(64):
            try:
                futs.append(srv.submit(np.ones(4, np.float32)))
            except pkg.S.ServerOverloaded:
                rejected += 1
        model.release.set()
        out = [outcome(f) for f in [first] + futs]
    finally:
        srv.shutdown()
    return {"rejected": rejected, "out": out, "counts": counts(pkg, "pol_over", ("requests", "rejected", "rows"))}


def sc_queue_deadline(pkg, arm):
    srv, model, first = held_server(pkg, "pol_to", max_batch=2, max_wait_ms=1)
    try:
        doomed = srv.submit(np.ones(4, np.float32), timeout_ms=1e-3)
        survivor = srv.submit(np.ones(4, np.float32))
        model.release.set()
        out = [outcome(f) for f in (first, doomed, survivor)]
    finally:
        srv.shutdown()
    return {"out": out, "counts": counts(pkg, "pol_to", ("requests", "timeouts", "batches"))}


def sc_drain(pkg, arm):
    srv, model, first = held_server(pkg, "pol_drain", max_batch=4, max_wait_ms=50)
    futs = [srv.submit(np.ones(4, np.float32)) for _ in range(6)]
    model.release.set()
    srv.drain()
    done = all(f.done() for f in [first] + futs)
    with pytest.raises(RuntimeError, match="shut down") as ei:
        srv.submit(np.ones(4, np.float32))
    srv.shutdown()
    return {"done": done, "draining_error": type(ei.value).__name__, "alive": srv._worker.is_alive(),
            "state": srv.state(), "out": [outcome(f) for f in futs]}


def sc_dispatch_error(pkg, arm):
    class Flaky(Echo):
        def _serving_entry(self, mesh=None):
            entry = super()._serving_entry(mesh)
            n = {"calls": 0}
            inner = entry.call

            def call(batch):
                n["calls"] += 1
                if n["calls"] == 4:  # the first dispatch after the 3 warm-ups
                    raise RuntimeError("boom")
                return inner(batch)

            entry.call = call
            return entry

    with pkg.S.ModelServer("pol_flaky", Flaky(pkg.S), max_batch=64, max_wait_ms=1) as srv:
        first = outcome(srv.submit(np.ones(4, np.float32)))
        second = outcome(srv.submit(np.ones(4, np.float32)))
    return {"out": [first, second], "counts": counts(pkg, "pol_flaky", ("errors", "requests", "batches"))}


def sc_worker_death(pkg, arm):
    arm("serving.dispatch:tag=pol_die:call=1:action=kill")
    srv = pkg.S.ModelServer("pol_die", Echo(pkg.S), max_batch=4, max_wait_ms=5)
    try:
        dead = outcome(srv.submit(np.ones((3, 4), np.float32)))
        ready = recovered(pkg, srv, "pol_die")
        after = srv.predict(np.ones(4, np.float32))["echo"].tolist()
        health = srv.health()
    finally:
        srv.shutdown(drain=False)
    return {"dead": dead, "ready": ready, "after": after, "restarts": health["restarts"],
            "state_code": health["state_code"],
            "counts": counts(pkg, "pol_die", ("worker_deaths", "restarts", "requests", "rows"))}


def sc_drain_during_recovery(pkg, arm):
    arm("serving.dispatch:tag=pol_drec:call=1:action=kill")
    srv = pkg.S.ModelServer("pol_drec", Echo(pkg.S), max_batch=2, max_wait_ms=1)
    try:
        fut = srv.submit(np.ones((2, 4), np.float32))
        srv.drain(timeout_s=20.0)  # must not raise TimeoutError
        out = outcome(fut)
    finally:
        srv.shutdown(drain=False)
    return {"out": out, "counts": counts(pkg, "pol_drec", ("worker_deaths", "requests"))}


def sc_wedge(pkg, arm):
    import os

    arm("serving.dispatch:tag=pol_wedge:call=1:delay=1.0")
    os.environ["SRML_WATCH_STALL_S"] = "0.2"
    srv = pkg.S.ModelServer("pol_wedge", Echo(pkg.S), max_batch=4, max_wait_ms=2)
    try:
        fut = srv.submit(np.ones(4, np.float32))
        restarted = until(lambda: (srv.state(), pkg.P.counter("serving.pol_wedge.restarts"))[1] >= 1)
        ready = recovered(pkg, srv, "pol_wedge")
        wedged = outcome(fut)
        after = srv.predict(np.ones((2, 4), np.float32))["echo"].tolist()
    finally:
        os.environ["SRML_WATCH_STALL_S"] = "0"
        srv.shutdown(drain=False)
    return {"restarted": restarted, "ready": ready, "wedged": wedged, "after": after,
            "unhealthy_seen": pkg.P.counter("serving.pol_wedge.unhealthy") >= 1,
            "restarts": pkg.P.counter("serving.pol_wedge.restarts")}


def sc_restart_budget(pkg, arm):
    import os

    os.environ["SRML_SERVE_MAX_RESTARTS"] = "1"
    arm("serving.dispatch:tag=pol_budget:action=kill")
    srv = pkg.S.ModelServer("pol_budget", Echo(pkg.S), max_batch=4, max_wait_ms=2)
    try:
        first = outcome(srv.submit(np.ones(4, np.float32)))
        ready = recovered(pkg, srv, "pol_budget")
        second = outcome(srv.submit(np.ones(4, np.float32)))
        unhealthy = until(lambda: srv.state() == pkg.S.UNHEALTHY)
        with pytest.raises((pkg.S.ServerUnhealthy, pkg.S.ServerRecovering)) as ei:
            srv.submit(np.ones(4, np.float32))
        state_code = srv.health()["state_code"]
    finally:
        del os.environ["SRML_SERVE_MAX_RESTARTS"]
        srv.shutdown(drain=False)
    return {"out": [first, second], "ready": ready, "unhealthy": unhealthy, "refused": type(ei.value).__name__,
            "state_code": state_code, "counts": counts(pkg, "pol_budget", ("restarts", "worker_deaths"))}


def sc_depth2(pkg, arm):
    srv, model, first = held_server(pkg, "pol_d2", max_batch=4, max_wait_ms=1, inflight_depth=2)
    try:
        futs = [srv.submit(np.ones(4, np.float32)) for _ in range(9)]
        staged = until(lambda: max(pkg.P.durations("serve.pol_d2.inflight_depth").get(
            "serve.pol_d2.inflight_depth", [0.0])) >= 2.0)
        model.release.set()
        out = [outcome(f) for f in [first] + futs]
        stats = srv.stats()
    finally:
        srv.shutdown()
    return {"staged": staged, "out": out, "inflight_depth": stats["inflight_depth"],
            "counts": counts(pkg, "pol_d2", ("requests", "rows"))}


def sc_depth2_death(pkg, arm):
    arm("serving.dispatch:tag=pol_d2die:call=2:action=kill")
    srv = pkg.S.ModelServer("pol_d2die", Echo(pkg.S), max_batch=4, max_wait_ms=1, inflight_depth=2)
    try:
        first = srv.predict(np.ones(4, np.float32))["echo"].tolist()  # call 1 survives
        dead = outcome(srv.submit(np.ones((4, 4), np.float32)))
        ready = recovered(pkg, srv, "pol_d2die")
        after = srv.predict(np.ones(4, np.float32))["echo"].tolist()
    finally:
        srv.shutdown(drain=False)
    return {"first": first, "dead": dead, "ready": ready, "after": after,
            "counts": counts(pkg, "pol_d2die", ("restarts", "worker_deaths"))}


def sc_registry(pkg, arm):
    with pkg.S.ModelRegistry(max_batch=8, max_wait_ms=1) as reg:
        reg.register("pol_reg", Echo(pkg.S))
        with pytest.raises(ValueError, match="already registered"):
            reg.register("pol_reg", Echo(pkg.S))
        out = reg.get("pol_reg").predict(np.ones(4, np.float32))["echo"].tolist()
        names = reg.names()
        health = reg.health()
        gauges = sorted(k for k in pkg.P.export_metrics()["gauges"] if k.startswith("health.pol_reg."))
        swapped = reg.swap("pol_reg", Echo(pkg.S))
        after = swapped.predict(np.ones(4, np.float32))["echo"].tolist()
        with pytest.raises(ValueError, match="n_cols 4 -> 6"):
            reg.swap("pol_reg", Echo(pkg.S, n_cols=6))
        reg.unregister("pol_reg")
        with pytest.raises(KeyError):
            reg.get("pol_reg")
    return {"out": out, "after": after, "names": names, "state": health["state"],
            "models": {n: m["state_code"] for n, m in health["models"].items()}, "gauges": gauges,
            "swaps": pkg.P.counter("serving.pol_reg.swaps")}


SCENARIOS = {name[3:]: fn for name, fn in sorted(globals().items()) if name.startswith("sc_")}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_policy_scenario_matches_jax(scenario, arm):
    got = {}
    for name, pkg in PKGS.items():
        pkg.P.reset_counters("serving.pol_")
        pkg.P.reset_durations("serve.pol_")
        got[name] = SCENARIOS[scenario](pkg, arm)
    assert got["port"] == got["jax"]


# -- pure functions -------------------------------------------------------------


@settings(max_examples=60, deadline=None)
@given(n=st.integers(0, 5000), lo=st.sampled_from([1, 2, 16, 64]), hi=st.integers(1, 1 << 14))
def test_shape_bucket_matches_jax(n, lo, hi):
    assert port_precompile.shape_bucket(n, lo, hi) == ref_precompile.shape_bucket(n, lo, hi)


@settings(max_examples=60, deadline=None)
@given(n=st.integers(1, 4096), max_batch=st.integers(1, 4096))
def test_bucket_rules_match_jax(n, max_batch):
    assert port_serving.bucket_rows(n, max_batch) == ref_serving.bucket_rows(n, max_batch)
    assert port_serving.serve_buckets(max_batch) == ref_serving.serve_buckets(max_batch)


def test_bucket_rules_fixed_points():
    for S in (ref_serving, port_serving):
        assert S.bucket_rows(1, 256) == 16 and S.bucket_rows(17, 256) == 32
        assert S.bucket_rows(300, 256) == 256
        assert S.serve_buckets(256) == [16, 32, 64, 128, 256] and S.serve_buckets(8) == [16]


@settings(max_examples=40, deadline=None)
@given(raw=st.one_of(st.none(), st.lists(st.one_of(st.floats(-2, 3, allow_nan=False), st.just("junk")),
                                         min_size=0, max_size=4)))
def test_shed_fractions_match_jax(raw):
    import os

    text = None if raw is None else ",".join(str(v) for v in raw)
    old = os.environ.pop(port_scheduler.SHED_FRACTIONS_ENV, None)
    try:
        if text is not None:
            os.environ[port_scheduler.SHED_FRACTIONS_ENV] = text
        assert port_scheduler.shed_fractions() == ref_scheduler.shed_fractions()
    finally:
        os.environ.pop(port_scheduler.SHED_FRACTIONS_ENV, None)
        if old is not None:
            os.environ[port_scheduler.SHED_FRACTIONS_ENV] = old


@settings(max_examples=60, deadline=None)
@given(klass=st.sampled_from(["interactive", "standard", "batch", "junk"]), fill=st.floats(0.0, 1.5))
def test_admit_matches_jax(klass, fill):
    results = []
    for sch in (ref_scheduler, port_scheduler):
        try:
            results.append(sch.admit(klass, fill))
        except ValueError as exc:
            results.append(str(exc))
    assert results[0] == results[1]


class FakeReplica:
    def __init__(self, name, state, outstanding, queued, depth):
        self.name, self._state, self._outstanding, self._queued, self._depth = name, state, outstanding, queued, depth

    def effective_state(self):
        return self._state

    def state(self):
        return self._state

    def outstanding(self):
        return self._outstanding

    def queued_rows(self):
        return self._queued

    def queue_depth(self):
        return self._depth


_replica = st.tuples(st.sampled_from(["WARMING", "READY", "DEGRADED", "DRAINING", "UNHEALTHY", "RECOVERING"]),
                     st.integers(0, 9), st.integers(0, 64), st.integers(0, 64))


@settings(max_examples=80, deadline=None)
@given(reps=st.lists(_replica, min_size=0, max_size=6))
def test_pick_and_fill_match_jax(reps):
    fakes = [FakeReplica(f"m-r{i}", *r) for i, r in enumerate(reps)]
    out = []
    for sch in (ref_scheduler, port_scheduler):
        try:
            rep, mode = sch.pick(fakes)
            picked = (rep.name, mode)
        except (ref_scheduler.NoReplicaAvailable, port_scheduler.NoReplicaAvailable) as exc:
            picked = ("none", str(exc))
        out.append((picked, sch.aggregate_fill(fakes), sch.aggregate_occupancy(fakes)))
    assert out[0] == out[1]


@settings(max_examples=40, deadline=None)
@given(slice_devices=st.integers(1, 9), ops=st.lists(st.tuples(st.booleans(), st.booleans()), max_size=12))
def test_slicepool_ledger_matches_jax(slice_devices, ops):
    """The same allocate (oversubscribe or not) / release sequence over 8
    devices gives the same leases, refusals and stats in both pools."""
    import jax

    def run(mod, devices, dev_id):
        try:
            pool = mod.SlicePool(slice_devices=slice_devices, devices=devices)
        except ValueError as exc:
            return [("init", str(exc))]
        log, held = [], []
        try:
            for i, (alloc, over) in enumerate(ops):
                if alloc or not held:
                    try:
                        lease = pool.allocate(f"o{i}", oversubscribe=over)
                        held.append(lease)
                        log.append(("lease", lease.index, lease.shared, [dev_id(d) for d in lease.devices]))
                    except mod.CapacityExhausted:
                        log.append(("exhausted", pool.free()))
                else:
                    lease = held.pop(0)
                    pool.release(lease)
                    pool.release(lease)  # idempotent
                    log.append(("release", pool.free()))
            stats = pool.stats()
            log.append((stats["capacity"], stats["free"], stats["shared_leases"], stats["stranded_devices"]))
        finally:
            pool.close()
        return log

    ref_log = run(ref_slicepool, jax.devices()[:8], lambda d: d.id)
    port_log = run(port_slicepool, ["cpu"] * 8, lambda d: 0)
    # device identity differs (8 distinct jax devices, one torch cpu
    # device 8 times): compare everything but the device ids, and the
    # jax device ids against the lease's slot
    strip = [e[:3] if e[0] == "lease" else e for e in ref_log]
    assert strip == [e[:3] if e[0] == "lease" else e for e in port_log]


def test_slicepool_on_one_device_grants_shared_leases_only_when_asked():
    pool = port_slicepool.SlicePool(devices=["cpu"])
    try:
        first = pool.allocate("a")
        with pytest.raises(port_slicepool.CapacityExhausted, match="allow_oversubscribe"):
            pool.allocate("b")
        shared = pool.allocate("b", oversubscribe=True)
        assert shared.shared and shared.mesh.devices == first.mesh.devices
        assert port_profiling.export_metrics("slicepool.")["gauges"]["slicepool.shared_leases"] == 1.0
    finally:
        pool.close()


def test_batcher_cancelled_and_hold_match_jax():
    """take(cancelled=) leaves the queue intact; take(hold=) keeps an
    expired partial batch open until kick() or a full batch."""
    for S, P in ((ref_serving, ref_profiling), (port_serving, port_profiling)):
        from importlib import import_module

        batcher = import_module(S.__name__ + ".batcher")
        b = batcher.MicroBatcher(n_cols=4, dtype=np.dtype(np.float32), counter_ns="serving.pol_holdb",
                                 max_batch=4, max_wait_ms=1, queue_depth=64)
        fut = b.submit(np.ones((1, 4), np.float32))
        assert b.take(cancelled=lambda: True) is batcher.CANCELLED
        batch, _ = b.take()
        batcher.resolve_future(batch[0].future, {"ok": np.ones(1)})
        assert fut.result(timeout=5)
        held = threading.Event()
        held.set()
        out = {}

        def consume():
            out["batch"], out["reason"] = b.take(hold=held.is_set)

        b.submit(np.ones((1, 4), np.float32))
        t = threading.Thread(target=consume)
        t.start()
        assert until(lambda: P.counter("serving.pol_holdb.held_open") > 0)
        for _ in range(3):
            b.submit(np.ones((1, 4), np.float32))
        t.join(timeout=WAIT_S)
        assert not t.is_alive() and len(out["batch"]) == 4 and out["reason"] == "full"
        b.submit(np.ones((1, 4), np.float32))
        t = threading.Thread(target=consume)
        t.start()
        held.clear()
        b.kick()
        t.join(timeout=WAIT_S)
        assert not t.is_alive() and out["reason"] == "deadline"
        b.stop()
