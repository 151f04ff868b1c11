# The port's elastic serving plane (spark_rapids_ml_tpu_torch.serving:
# SlicePool, Router.scale_to / replace_replica, Autoscaler) against the JAX
# package's, on the CPU: every case of tests/test_autoscale.py, run on both
# packages (the JAX package over its 8 forced CPU devices, the port under
# use_device(["cpu"] * 8)).
#
# The policy cases never sleep: each package's autoscale module reads a
# test-driven clock (its `profiling` seen through _Clock, whose now() the
# test advances), the tests call tick() themselves, and a replica's worker
# is held inside a dispatch on an event while the queue fills.  The
# decisions then depend on the clock and the queues alone, so the
# decision journals (time, decision, reason, replica counts) and the
# autoscale.* / router.* counters must be equal across the packages; a
# repair's reason names each package's warm path, so only its decision and
# counts are compared.  Device identity differs (8 distinct JAX devices,
# one torch CPU device 8 times): leases are compared by slot.
import threading
import time

import numpy as np
import pytest

import spark_rapids_ml_tpu.serving as ref_serving
from spark_rapids_ml_tpu import profiling as ref_profiling
from spark_rapids_ml_tpu.parallel import faults as ref_faults
from spark_rapids_ml_tpu.serving import autoscale as ref_autoscale
from spark_rapids_ml_tpu.serving import scheduler as ref_scheduler

import spark_rapids_ml_tpu_torch.serving as port_serving
from spark_rapids_ml_tpu_torch import convert
from spark_rapids_ml_tpu_torch import profiling as port_profiling
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.parallel import faults as port_faults
from spark_rapids_ml_tpu_torch.parallel.mesh import carve_device_slices as port_carve
from spark_rapids_ml_tpu_torch.serving import autoscale as port_autoscale
from spark_rapids_ml_tpu_torch.serving import scheduler as port_scheduler

WAIT_S = 30.0


class Pkg:
    def __init__(self, S, P, sch, autoscale, faults):
        self.S, self.P, self.sch, self.autoscale, self.faults = S, P, sch, autoscale, faults


PKGS = {
    "jax": Pkg(ref_serving, ref_profiling, ref_scheduler, ref_autoscale, ref_faults),
    "port": Pkg(port_serving, port_profiling, port_scheduler, port_autoscale, port_faults),
}


class _Clock:
    """A package's profiling module with a test-driven now(): what its
    autoscale module reads as the time of a tick."""

    def __init__(self, P, t0=1000.0):
        self._P, self.t = P, t0

    def now(self):
        return self.t

    def __getattr__(self, name):
        return getattr(self._P, name)


@pytest.fixture(autouse=True)
def _eight_cpu_devices():
    with use_device(["cpu"] * 8):
        yield


@pytest.fixture
def clocks(monkeypatch):
    """One _Clock per package, installed as its autoscale module's view of
    profiling for this test."""
    out = {}
    for name, pkg in PKGS.items():
        out[name] = _Clock(pkg.P)
        monkeypatch.setattr(pkg.autoscale, "profiling", out[name])
    return out


@pytest.fixture
def arm(monkeypatch):
    def _arm(spec):
        monkeypatch.setenv(port_faults.FAULTS_ENV, spec)
        ref_faults.reload()
        port_faults.reload()

    yield _arm
    monkeypatch.delenv(port_faults.FAULTS_ENV, raising=False)
    ref_faults.reload()
    port_faults.reload()


class Echo:
    """Servable stub: echoes row sums; `hold` parks the next dispatch inside
    call() until `release` (the router tests' idiom)."""

    def __init__(self, S, n_cols=4, out_col="echo"):
        self.S, self.n_cols, self.out_col = S, n_cols, out_col
        self.hold = threading.Event()
        self.entered = threading.Event()
        self.release = threading.Event()

    def _serving_entry(self, mesh=None):
        def call(batch):
            if self.hold.is_set():
                self.entered.set()
                assert self.release.wait(WAIT_S)
            return {self.out_col: batch.sum(axis=1)}

        return self.S.ServingEntry(name="serve.echo", n_cols=self.n_cols, dtype=np.dtype(np.float32),
                                   out_cols=[self.out_col], call=call, warm=lambda buckets: [])


def until(pred, timeout_s=WAIT_S):
    deadline = time.monotonic() + timeout_s
    while not pred() and time.monotonic() < deadline:
        threading.Event().wait(0.01)
    return pred()


def _tight_policy(S, **over):
    base = dict(min_replicas=1, max_replicas=3, window_s=0.3, down_window_s=0.6, up_fill=0.2, up_burn=0.5,
                down_fill=0.05, down_occupancy=0.2, up_cooldown_s=0.05, down_cooldown_s=0.2)
    base.update(over)
    return S.AutoscalePolicy(**base)


def _journal(autoscaler, reasons=True):
    return [(e["t"], e["decision"], e["reason"] if reasons else None, e["from_replicas"], e["to_replicas"])
            for e in autoscaler.journal()]


def _both(scenario, *args):
    return {name: scenario(pkg, *args) for name, pkg in PKGS.items()}


def _kmeans_pair(model_zoo):
    """model_zoo's JAX KMeans model, the port's copy of it, and its rows."""
    jax_model, X = model_zoo("kmeans")
    attrs = {k: (np.asarray(v) if isinstance(v, (list, tuple)) else v)
             for k, v in jax_model._get_model_attributes().items()}
    return {"jax": jax_model, "port": convert.kmeans_model_from_reference(attrs)}, X


# -- carve_device_slices: the group-aware fixed-granularity carve ------------


def test_carve_device_slices_group_aware(monkeypatch):
    """Simulated 2 x 4 topology, shuffled device list: every fixed-size slice
    lands inside one host group; a slice wider than a group falls back to
    the group-major contiguous carve; leftovers are stranded, never glued
    across the boundary.  The same carve on both packages (JAX: SRML_TOPO;
    the port: devs_per_host)."""
    import jax

    from spark_rapids_ml_tpu.parallel.mesh import carve_device_slices as ref_carve

    monkeypatch.setenv("SRML_TOPO", "2:4")
    order = (3, 7, 0, 5, 2, 6, 1, 4)
    devs = list(jax.devices())[:8]
    ref = {w: [[d.id for d in s] for s in ref_carve([devs[j] for j in order], w)] for w in (2, 3, 8)}
    port = {w: [[int(d.split(":")[1]) for d in s] for s in
                port_carve([f"cuda:{j}" for j in order], w, devs_per_host=4)] for w in (2, 3, 8)}
    assert port == ref
    assert len(port[2]) == 4 and all(len({i // 4 for i in s}) == 1 for s in port[2])
    assert len(port[3]) == 2 and len(port[8]) == 1
    for carve, d in ((ref_carve, devs), (port_carve, ["cpu"] * 8)):
        with pytest.raises(ValueError, match="slice_devices"):
            carve(d, 0)


# -- SlicePool ledger --------------------------------------------------------


def test_slicepool_allocate_release_idempotent():
    def scenario(pkg):
        pool = pkg.S.SlicePool(slice_devices=2)
        try:
            cap = pool.capacity
            assert pool.free() == cap
            a, b = pool.allocate("m-r0"), pool.allocate("m-r1")
            facts = [a.shared, b.shared, a.index != b.index, pool.free(), pool.holders()]
            pool.release(a)
            pool.release(a)  # idempotent: teardown paths may race
            facts.append(pool.free())
            c = pool.allocate("m-r2")  # the freed slice is re-leasable
            facts.append(c.index == a.index)
            for lease in (b, c):
                lease.release()
            facts.append(pool.free() == cap)
            return [cap] + facts
        finally:
            pool.close()

    got = _both(scenario)
    assert got["port"] == [4, False, False, True, 2, {"m-r0": 1, "m-r1": 1}, 3, True, True]
    assert got["port"] == got["jax"]


def test_slicepool_capacity_exhausted_is_typed():
    def scenario(pkg):
        pool = pkg.S.SlicePool(slice_devices=8)
        try:
            lease = pool.allocate("hog")
            with pytest.raises(pkg.S.CapacityExhausted, match="allow_oversubscribe"):
                pool.allocate("wants")
            pool.release(lease)
            pool.allocate("wants")  # a release frees real capacity
            return [pool.capacity, issubclass(pkg.S.CapacityExhausted, ValueError),
                    pkg.S.CapacityExhausted.retryable, pkg.P.counter("slicepool.exhausted") >= 1]
        finally:
            pool.close()

    got = _both(scenario)
    assert got["port"] == [1, True, True, True]
    assert got["port"] == got["jax"]


def test_slicepool_oversubscribe_only_by_policy():
    def scenario(pkg):
        pool = pkg.S.SlicePool(slice_devices=8, allow_oversubscribe=True)
        try:
            first = pool.allocate("a")
            over = pool.allocate("b")  # pool policy admits the overflow
            with pytest.raises(pkg.S.CapacityExhausted):
                pool.allocate("c", oversubscribe=False)  # the per-call override wins
            facts = [over.shared, len(over.devices), pkg.P.counter("slicepool.oversubscribed") >= 1]
            pool.release(over)
            pool.release(first)
            return facts + [pool.free()]
        finally:
            pool.close()

    got = _both(scenario)
    assert got["port"] == [True, 1, True, 1]
    assert got["port"] == got["jax"]


def test_slicepool_never_straddles_host_group(monkeypatch):
    """The JAX pool under a simulated 2 x 4 topology leases the slices that
    the port's carve gives with 4 devices a host group (the port's pool
    carves the one-controller device list flat; the group-aware carve is
    the same function)."""
    import jax

    monkeypatch.setenv("SRML_TOPO", "2:4")
    order = (3, 7, 0, 5, 2, 6, 1, 4)
    devs = list(jax.devices())[:8]
    pool = ref_serving.SlicePool(slice_devices=2, devices=[devs[j] for j in order])
    try:
        leases = [pool.allocate(f"m-r{i}") for i in range(pool.capacity)]
        ref = [[d.id for d in lease.devices] for lease in leases]
        for lease in leases:
            pool.release(lease)
    finally:
        pool.close()
    port = [[int(d.split(":")[1]) for d in s] for s in port_carve([f"cuda:{j}" for j in order], 2, devs_per_host=4)]
    assert port == ref
    assert all(len({i // 4 for i in s}) == 1 for s in port)


def test_slicepool_concurrent_allocate_release():
    """The ledger under contention: hammering allocate / release from many
    threads never double-grants a slice and never leaks one."""

    def scenario(pkg):
        pool = pkg.S.SlicePool(slice_devices=1)
        errors, live_lock, live = [], threading.Lock(), {}

        def worker(tid):
            try:
                for _ in range(50):
                    try:
                        lease = pool.allocate(f"w{tid}")
                    except pkg.S.CapacityExhausted:
                        continue
                    with live_lock:
                        if lease.index in live:
                            errors.append(f"slice {lease.index} granted to w{tid} while held by {live[lease.index]}")
                        live[lease.index] = f"w{tid}"
                    with live_lock:
                        live.pop(lease.index, None)
                    pool.release(lease)
            except Exception as exc:  # noqa: BLE001 - surfaced through the errors list
                errors.append(repr(exc))

        threads = [threading.Thread(target=worker, args=(i,), name=f"pool-hammer-{i}") for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        try:
            assert not any(t.is_alive() for t in threads)
            return {"errors": errors, "leaked": pool.capacity - pool.free()}
        finally:
            pool.close()

    got = _both(scenario)
    assert got["port"] == {"errors": [], "leaked": 0}
    assert got["port"] == got["jax"]


# -- router: pool-backed deployment ------------------------------------------


def test_router_shared_pool_keeps_models_disjoint():
    def scenario(pkg):
        pool = pkg.S.SlicePool(slice_devices=2)
        with pkg.S.Router(pool=pool, max_batch=8, max_wait_ms=1) as router:
            router.serve("as_a", Echo(pkg.S), replicas=2)
            router.serve("as_b", Echo(pkg.S), replicas=2)
            held = [lease.index for name in ("as_a", "as_b") for lease in router._sets[name].leases]
            out = [float(router.predict(n, np.ones(4, np.float32))["echo"][0]) for n in ("as_a", "as_b")]
        pool.close()
        return {"slices": held, "out": out}

    got = _both(scenario)
    assert len(set(got["port"]["slices"])) == 4 and got["port"]["out"] == [4.0, 4.0]
    assert got["port"] == got["jax"]


def test_router_serve_oversubscription_is_typed_not_silent():
    def scenario(pkg):
        with pkg.S.Router(max_batch=8, max_wait_ms=1) as router:
            with pytest.raises(pkg.S.CapacityExhausted, match="allow_oversubscribe"):
                router.serve("as_big", Echo(pkg.S), replicas=9)
            listed = "as_big" in router  # a failed deploy leaves no reservation
            reps = router.serve("as_big", Echo(pkg.S), replicas=9, allow_oversubscribe=True)
            leases = router._sets["as_big"].leases
            return {"listed": listed, "n": len(reps), "shared": sum(1 for lease in leases if lease.shared),
                    "single": all(len(lease.devices) == 1 for lease in leases if lease.shared),
                    "out": float(router.predict("as_big", np.ones(4, np.float32))["echo"][0])}

    got = _both(scenario)
    assert got["port"] == {"listed": False, "n": 9, "shared": 1, "single": True, "out": 4.0}
    assert got["port"] == got["jax"]


# -- router: scale_to actuation ----------------------------------------------


def test_scale_to_grows_and_shrinks_with_lease_accounting():
    def scenario(pkg):
        pool = pkg.S.SlicePool(slice_devices=1)
        facts = []
        with pkg.S.Router(pool=pool, max_batch=8, max_wait_ms=1) as router:
            router.serve("as_el", Echo(pkg.S), replicas=1)
            facts.append(pool.free())
            facts.append([r.name for r in router.scale_to("as_el", 3)])
            facts.append(pool.free())
            facts.append(float(router.predict("as_el", np.ones(4, np.float32))["echo"][0]))
            facts.append([r.name for r in router.scale_to("as_el", 1)])
            facts.append(pool.free())  # drained slices returned
            facts.append(len(router.scale_to("as_el", 1)))  # idempotent at the target
            with pytest.raises(ValueError, match="below 1"):
                router.scale_to("as_el", 0)
            facts.append([r.name for r in router.scale_to("as_el", 2)])  # the lowest free slots again
            facts.append({k: pkg.P.counter(f"router.as_el.{k}") for k in ("scaled_up", "scaled_down",
                                                                           "replicas_started")})
        pool.close()
        return facts

    got = _both(scenario)
    assert got["port"][:8] == [7, ["as_el-r0", "as_el-r1", "as_el-r2"], 5, 4.0, ["as_el-r0"], 7, 1,
                               ["as_el-r0", "as_el-r1"]]
    assert got["port"][8] == {"scaled_up": 3, "scaled_down": 2, "replicas_started": 4}
    assert got["port"] == got["jax"]


def test_scale_up_is_warm_zero_new_warmups(model_zoo):
    """Deploy a real model at max (the warm-up is paid once), trim to 1,
    grow back: the regrown replicas add zero new warm-ups and every scale
    state answers as a fixed single-replica router, on both packages; the
    packages' labels agree."""
    models, X = _kmeans_pair(model_zoo)

    def scenario(pkg):
        model = models["jax" if pkg is PKGS["jax"] else "port"]
        pool = pkg.S.SlicePool(slice_devices=1)
        with pkg.S.Router(pool=pool, max_batch=16, max_wait_ms=2) as router, \
                pkg.S.Router(max_batch=16, max_wait_ms=2) as fixed:
            fixed.serve("as_ckm", model, replicas=1)
            baseline = np.asarray(fixed.predict("as_ckm", X[:8])["prediction"])
            router.serve("as_ekm", model, replicas=3)
            same = [np.array_equal(router.predict("as_ekm", X[:8])["prediction"], baseline)]
            router.scale_to("as_ekm", 1)
            before = pkg.P.counters("precompile.")
            same.append(np.array_equal(router.predict("as_ekm", X[:8])["prediction"], baseline))
            router.scale_to("as_ekm", 3)
            states = [r.state() for r in router.replicas("as_ekm")]
            futs = [router.submit("as_ekm", X[i : i + 4]) for i in range(8)]
            shapes = [f.result(timeout=WAIT_S)["prediction"].shape for f in futs]
            same.append(np.array_equal(router.predict("as_ekm", X[:8])["prediction"], baseline))
            delta = pkg.P.counter_deltas(before, "precompile.")
            for r in router.replicas("as_ekm"):
                r.drain()
                r.assert_steady_state()
        pool.close()
        return {"same": same, "states": states, "shapes": shapes, "baseline": baseline.tolist(),
                "delta": {k: delta.get(k, 0) for k in ("precompile.compile", "precompile.fallback")}}

    got = _both(scenario)
    assert got["port"]["same"] == [True] * 3 and got["port"]["states"] == ["READY"] * 3
    assert got["port"]["delta"] == {"precompile.compile": 0, "precompile.fallback": 0}
    assert got["port"] == got["jax"]


# -- the autoscaler policy loop ----------------------------------------------


def test_autoscaler_scales_up_on_load_and_down_on_idle(clocks):
    """The hysteresis gate: the one replica's worker held inside a dispatch
    with 12 rows queued behind it drives the count up fast (fill), through
    an up-cooldown hold, to max_replicas (a pressured hold); released and
    idle, it walks back down slowly (down-window, down-cooldown).  Every
    admitted request resolves; journals and counters equal across the
    packages."""
    row = np.ones(4, np.float32)

    def scenario(pkg):
        clock = clocks["jax" if pkg is PKGS["jax"] else "port"]
        pool = pkg.S.SlicePool(slice_devices=1)
        model = Echo(pkg.S)
        with pkg.S.Router(pool=pool, inflight_depth=1, max_batch=4, max_wait_ms=1, queue_depth=16) as router:
            router.serve("as_echo", model, replicas=3)
            router.scale_to("as_echo", 1)  # trim: the autoscaler takes it from here
            autoscaler = pkg.S.Autoscaler(router, policy=_tight_policy(pkg.S))
            model.hold.set()
            first = router.submit("as_echo", row, timeout_ms=30000)
            assert model.entered.wait(WAIT_S)
            model.hold.clear()  # later dispatches (the new replicas' warm-ups) pass
            futs = [first] + [router.submit("as_echo", row, timeout_ms=30000) for _ in range(12)]
            counts = []
            for t in (1000.0, 1000.01, 1000.1, 1000.2):  # load: up, cooldown hold, up, max hold
                clock.t = t
                autoscaler.tick()
                counts.append(len(router.replicas("as_echo")))
            model.release.set()
            out = [float(f.result(timeout=WAIT_S)["echo"][0]) for f in futs]
            for r in router.replicas("as_echo"):
                assert r._batcher.wait_quiescent(WAIT_S)
            # idle: down once the ticks span 0.9 of the down-window, again
            # after the down-cooldown (binary fractions: exact differences)
            for t in (1001.0, 1001.25, 1001.5, 1001.5625, 1001.6875, 1001.8125, 1002.0):
                clock.t = t
                autoscaler.tick()
                counts.append(len(router.replicas("as_echo")))
            out.append(float(router.predict("as_echo", row)["echo"][0]))
            journal = _journal(autoscaler)
        pool.close()
        return {"counts": counts, "out": out, "journal": journal,
                "counters": {k: pkg.P.counter(f"autoscale.as_echo.{k}") for k in ("scale_up", "scale_down", "holds")}}

    got = _both(scenario)
    assert got["port"]["counts"] == [2, 2, 3, 3, 3, 3, 3, 2, 2, 1, 1], got["port"]["journal"]
    assert got["port"]["out"] == [4.0] * 14
    decisions = [e[1] for e in got["port"]["journal"]]
    assert decisions == ["scale_up", "hold", "scale_up", "hold", "scale_down", "scale_down"]
    assert all("idle" in e[2] for e in got["port"]["journal"] if e[1] == "scale_down")
    assert got["port"]["counters"]["scale_up"] == 2 and got["port"]["counters"]["scale_down"] == 2
    assert got["port"] == got["jax"]


def test_autoscaler_holds_on_cooldown_and_capacity(clocks):
    """Pressured holds are journaled with their reasons: out of slices, the
    typed CapacityExhausted becomes a hold and a counter."""

    def scenario(pkg):
        clock = clocks["jax" if pkg is PKGS["jax"] else "port"]
        pool = pkg.S.SlicePool(slice_devices=4)
        with pkg.S.Router(pool=pool, max_batch=8, max_wait_ms=1) as router:
            router.serve("as_h", Echo(pkg.S), replicas=2)  # the pool is now exhausted
            autoscaler = pkg.S.Autoscaler(router, policy=_tight_policy(pkg.S, max_replicas=4, up_cooldown_s=0.0))
            # the signal plane reads exported counters; a shed spike is the
            # fastest scale-up trigger
            pkg.P.incr_counter("router.as_h.shed", 5)
            autoscaler.tick()  # watermark tick: deltas start at zero
            pkg.P.incr_counter("router.as_h.shed", 5)
            clock.t += 0.1
            autoscaler.tick()
            n = len(router.replicas("as_h"))  # held, not oversubscribed
            journal = _journal(autoscaler, reasons=False)
            reasons = [e["reason"] for e in autoscaler.journal()]
        pool.close()
        return {"n": n, "journal": journal, "capacity": any("capacity exhausted" in r for r in reasons),
                "counters": {k: pkg.P.counter(f"autoscale.as_h.{k}") for k in ("capacity_exhausted", "holds")}}

    got = _both(scenario)
    assert got["port"]["n"] == 2 and got["port"]["capacity"]
    assert got["port"]["counters"] == {"capacity_exhausted": 1, "holds": 2}
    assert got["port"] == got["jax"]


def test_preemption_storm_is_repaired_with_zero_client_errors(model_zoo, arm, clocks, monkeypatch):
    """K = 4 replicas, restart budget 0 (a killed worker is terminal), two of
    them killed mid-burst: every admitted request resolves with a result
    (the router reroutes), and two ticks of the autoscaler (a replica must
    read UNHEALTHY twice) replace both under their slot names, re-warmed at
    zero new warm-ups; the lease ledger is intact."""
    monkeypatch.setenv("SRML_SERVE_MAX_RESTARTS", "0")
    models, X = _kmeans_pair(model_zoo)

    def scenario(pkg):
        clock = clocks["jax" if pkg is PKGS["jax"] else "port"]
        model = models["jax" if pkg is PKGS["jax"] else "port"]
        pool = pkg.S.SlicePool(slice_devices=1)
        with pkg.S.Router(pool=pool, max_batch=16, max_wait_ms=2) as router:
            reps = router.serve("as_skm", model, replicas=4)
            router.predict("as_skm", X[:3])
            autoscaler = pkg.S.Autoscaler(router, policy=_tight_policy(pkg.S, min_replicas=4, max_replicas=4))
            arm("serving.dispatch:tag=as_skm-r1:call=1:action=kill;serving.dispatch:tag=as_skm-r3:call=1:action=kill")
            before = pkg.P.counters("precompile.")
            futs, dead = [], {reps[1], reps[3]}
            while not all(r.state() == pkg.S.UNHEALTHY for r in dead) and len(futs) < 400:
                burst = [router.submit("as_skm", X[i : i + 2]) for i in range(16)]  # spread over the replicas
                for f in burst:
                    f.result(timeout=WAIT_S)
                futs += burst
            shapes = {f.result(timeout=WAIT_S)["prediction"].shape for f in futs}  # zero client-visible errors
            assert until(lambda: all(r.state() == pkg.S.UNHEALTHY for r in dead))
            for _ in range(2):
                clock.t += 0.1
                autoscaler.tick()
            now = router.replicas("as_skm")
            out = np.asarray(router.predict("as_skm", X[:5])["prediction"]).tolist()
            delta = pkg.P.counter_deltas(before, "precompile.")
            facts = {"shapes": shapes, "names": sorted(r.name for r in now), "replaced": not dead & set(now),
                     "states": [r.state() for r in now], "out": out,
                     "journal": _journal(autoscaler, reasons=False),
                     "rewarmed": all("re-warmed" in e["reason"] for e in autoscaler.journal()),
                     "counters": [pkg.P.counter("autoscale.as_skm.repairs"),
                                  pkg.P.counter("router.as_skm.replicas_replaced")],
                     "delta": {k: delta.get(k, 0) for k in ("precompile.compile", "precompile.fallback")}}
        facts["ledger"] = pool.free() == pool.capacity  # every lease back after shutdown
        pool.close()
        return facts

    got = _both(scenario)
    assert got["port"]["shapes"] == {(2,)} and got["port"]["replaced"] and got["port"]["rewarmed"]
    assert got["port"]["names"] == ["as_skm-r0", "as_skm-r1", "as_skm-r2", "as_skm-r3"]
    assert got["port"]["states"] == ["READY"] * 4 and got["port"]["counters"] == [2, 2]
    assert [e[1] for e in got["port"]["journal"]] == ["repair", "repair"]
    assert got["port"]["delta"] == {"precompile.compile": 0, "precompile.fallback": 0}
    assert got["port"] == got["jax"]


def test_autoscale_gauges_and_prometheus_families():
    def scenario(pkg):
        pool = pkg.S.SlicePool(slice_devices=1)
        with pkg.S.Router(pool=pool, max_batch=8, max_wait_ms=1) as router:
            router.serve("as_g", Echo(pkg.S), replicas=2)
            m = router.health()["models"]["as_g"]
            gauges = pkg.P.export_metrics()["gauges"]
            text = pkg.P.render_prometheus()
            facts = {"fill": 0.0 <= m["fill_fraction"] <= 1.0, "occupancy": m["occupancy"] >= 0.0,
                     "gauges": [k in gauges for k in ("router.as_g.fill_fraction", "router.as_g.occupancy",
                                                      "slicepool.free")],
                     "families": [s in text for s in ('srml_router{name="router.as_g.fill_fraction"}',
                                                      'srml_router{name="router.as_g.occupancy"}',
                                                      'srml_elastic{name="slicepool.free"}')]}
        pool.close()
        return facts

    got = _both(scenario)
    assert got["port"] == {"fill": True, "occupancy": True, "gauges": [True] * 3, "families": [True] * 3}
    assert got["port"] == got["jax"]


def test_aggregate_occupancy_policy_unit():
    class _Stub:
        def __init__(self, depth, queued, outstanding):
            self._d, self._q, self._o = depth, queued, outstanding

        def queue_depth(self):
            return self._d

        def queued_rows(self):
            return self._q

        def outstanding(self):
            return self._o

    for sch in (ref_scheduler, port_scheduler):
        busy = _Stub(depth=8, queued=0, outstanding=6)
        assert sch.aggregate_fill([busy]) == 0.0  # fill is blind to in-flight work
        assert sch.aggregate_occupancy([busy]) == pytest.approx(0.75)
        assert sch.aggregate_occupancy([]) == 0.0
        assert sch.aggregate_occupancy([_Stub(8, 0, 6), _Stub(8, 0, 0)]) == pytest.approx(0.375)


def test_autoscale_policy_from_env_matches_jax(monkeypatch):
    """The SRML_AUTOSCALE_* knobs read the same policy in both packages."""
    assert port_serving.AutoscalePolicy.from_env() == port_serving.AutoscalePolicy()
    for env, value in (("SRML_AUTOSCALE_MIN", "2"), ("SRML_AUTOSCALE_MAX", "6"), ("SRML_AUTOSCALE_WINDOW_S", "1.5"),
                       ("SRML_AUTOSCALE_UP_FILL", "0.3"), ("SRML_AUTOSCALE_DOWN_COOLDOWN_S", "4")):
        monkeypatch.setenv(env, value)
    ref = ref_serving.AutoscalePolicy.from_env()
    port = port_serving.AutoscalePolicy.from_env()
    assert (port.min_replicas, port.max_replicas, port.window_s, port.up_fill, port.down_cooldown_s) == (2, 6, 1.5, 0.3,
                                                                                                       4.0)
    assert vars(port) == vars(ref)


def test_terminal_worker_death_strands_no_request(arm, monkeypatch):
    """A depth-2 server whose worker dies with its restart budget spent: the
    assembly thread's in-hand batch and the staged one are failed with the
    retryable ServerRecovering (a router reroutes them), none is left
    behind the dead worker, and a late submit is refused, not queued.  (The
    JAX engine stages the in-hand batch after the drain of the pipe and
    never resolves it: ROADMAP C; this is the port's departure.)"""
    monkeypatch.setenv("SRML_SERVE_MAX_RESTARTS", "0")
    arm("serving.dispatch:tag=as_strand:call=2:action=kill")
    model = Echo(port_serving)
    srv = port_serving.ModelServer("as_strand", model, max_batch=1, max_wait_ms=1, inflight_depth=2)
    try:
        model.hold.set()
        futs = [srv.submit(np.ones(4, np.float32))]
        assert model.entered.wait(WAIT_S)  # batch 1 on the card; batches 2 and 3 staged and in hand
        model.hold.clear()
        futs.append(srv.submit(np.ones(4, np.float32)))
        assert until(lambda: srv._pipe.full())
        futs.append(srv.submit(np.ones(4, np.float32)))
        assert until(lambda: srv._batcher.queued_requests() == 0)
        model.release.set()  # batch 2's dispatch is the killed one
        out = []
        for f in futs:
            try:
                out.append(float(f.result(timeout=WAIT_S)["echo"][0]))
            except port_serving.ServerRecovering:
                out.append("ServerRecovering")
        assert out == [4.0, "ServerRecovering", "ServerRecovering"]
        assert srv.state() == port_serving.UNHEALTHY
        with pytest.raises((port_serving.ServerUnhealthy, port_serving.ServerDraining)):
            srv.submit(np.ones(4, np.float32))
        assert srv.outstanding() == 0
    finally:
        t0 = time.monotonic()
        srv.shutdown(drain=False)
    assert time.monotonic() - t0 < 10.0  # no thread left parked on a full pipe
