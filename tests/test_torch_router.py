# The port's router plane (spark_rapids_ml_tpu_torch.serving.Router, the
# scheduler and the slice pool underneath) against the JAX package's, on
# the CPU.  Router scenarios run on the echo stub of tests/test_router.py
# over 8 CPU devices (the JAX package's 8 forced host devices, the port's
# use_device(["cpu"] * 8)), once on each package, and the deterministic
# parts of what they observe must be equal: replica names, outputs,
# admission and shedding verdicts, failover and reroute facts, swap counts,
# health states and the gauge families.  Then the port alone: the mesh
# slicing rules, a one-device pool's shared leases, the chaos re-admit and a
# rolling swap of a real model at zero new warm-ups.
import threading
import time

import numpy as np
import pytest

import spark_rapids_ml_tpu.serving as ref_serving
from spark_rapids_ml_tpu import profiling as ref_profiling
from spark_rapids_ml_tpu.parallel import faults as ref_faults
from spark_rapids_ml_tpu.serving import scheduler as ref_scheduler

import spark_rapids_ml_tpu_torch as port
import spark_rapids_ml_tpu_torch.serving as port_serving
from spark_rapids_ml_tpu_torch import profiling
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.parallel import faults as port_faults
from spark_rapids_ml_tpu_torch.parallel.mesh import carve_device_slices, slice_meshes
from spark_rapids_ml_tpu_torch.serving import scheduler as port_scheduler

WAIT_S = 30.0


class Pkg:
    def __init__(self, S, P, sch):
        self.S, self.P, self.sch = S, P, sch


PKGS = {"jax": Pkg(ref_serving, ref_profiling, ref_scheduler), "port": Pkg(port_serving, profiling, port_scheduler)}


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


@pytest.fixture(autouse=True)
def _eight_cpu_devices():
    with use_device(["cpu"] * 8):
        yield


class Echo:
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


def value(fut):
    try:
        return float(fut.result(timeout=WAIT_S)["echo"][0])
    except Exception as exc:  # noqa: BLE001 - the scenario records it
        return type(exc).__name__


# -- scenarios ---------------------------------------------------------------------


def sc_serves_and_routes(pkg, arm):
    with pkg.S.Router(replicas=2, max_batch=8, max_wait_ms=1) as router:
        reps = router.serve("rt_echo", Echo(pkg.S))
        names = [r.name for r in reps]
        out = router.predict("rt_echo", np.ones(4, np.float32))["echo"].tolist()
        errors = []
        for call in (lambda: router.serve("rt_echo", Echo(pkg.S)),
                     lambda: router.submit("rt_nope", np.ones(4, np.float32)),
                     lambda: router.serve("rt_echo2", Echo(pkg.S), priority="junk"),
                     lambda: router.submit("rt_echo", np.ones(4, np.float32), priority="junk")):
            try:
                call()
                errors.append(None)
            except (KeyError, ValueError) as exc:
                errors.append(type(exc).__name__)
        listed = (router.names(), "rt_echo2" in router)
        counts = {k: pkg.P.counter(f"router.rt_echo.{k}") for k in ("admitted", "dispatched", "replicas_started")}
    return {"names": names, "out": out, "errors": errors, "listed": listed, "counts": counts}


def sc_spreads_least_outstanding(pkg, arm):
    model = Echo(pkg.S)
    with pkg.S.Router(replicas=2, inflight_depth=1, max_batch=4, max_wait_ms=1) as router:
        reps = router.serve("rt_spread", model)
        model.hold.set()
        first = router.submit("rt_spread", np.ones(4, np.float32))  # parks one replica's worker
        assert model.entered.wait(WAIT_S)
        model.hold.clear()
        rest = [router.submit("rt_spread", np.ones(4, np.float32)) for _ in range(3)]
        model.release.set()
        out = [value(f) for f in [first] + rest]
        dispatched = [pkg.P.percentiles(f"serve.{r.name}.dispatch").get("count", 0) > 0 for r in reps]
    return {"out": out, "both_dispatched": dispatched}


def sc_sheds_batch_class_first(pkg, arm):
    model = Echo(pkg.S)
    with pkg.S.Router(replicas=2, inflight_depth=1, max_batch=4, max_wait_ms=1, queue_depth=8) as router:
        router.serve("rt_shed", model)
        reps = router.replicas("rt_shed")
        model.hold.set()
        parked = [reps[0].submit(np.ones(4, np.float32)), reps[1].submit(np.ones(4, np.float32))]
        assert until(lambda: all(r.outstanding() and not r.queued_rows() for r in reps))
        model.hold.clear()
        queued = [r.submit(np.ones((4, 4), np.float32)) for r in reps]  # 8 of 16 rows queued: fill 0.5
        fill = pkg.sch.aggregate_fill(reps)
        verdicts, admitted = {}, []
        for klass in ("batch", "standard", "interactive"):
            try:
                admitted.append(router.submit("rt_shed", np.ones(4, np.float32), priority=klass))
                verdicts[klass] = "admitted"
            except pkg.S.RequestShed as exc:
                verdicts[klass] = ("shed", exc.retryable)
        model.release.set()
        out = [value(f) for f in parked + queued + admitted]
    return {"fill": fill, "verdicts": verdicts, "out": out,
            "shed_batch": pkg.P.counter("router.rt_shed.shed_batch")}


def sc_degraded_and_no_replica(pkg, arm):
    S = pkg.S
    with S.Router(replicas=2, max_batch=8, max_wait_ms=1) as router:
        router.serve("rt_deg", Echo(S))
        orig = S.ModelServer.effective_state
        try:
            S.ModelServer.effective_state = lambda self: S.DEGRADED
            out = router.predict("rt_deg", np.ones(4, np.float32))["echo"].tolist()
            in_rotation = router.health()["models"]["rt_deg"]["in_rotation"]
            S.ModelServer.effective_state = lambda self: S.UNHEALTHY
            fut = router.submit("rt_deg", np.ones(4, np.float32))
            try:
                fut.result(timeout=WAIT_S)
                err = None
            except S.NoReplicaAvailable as exc:
                err = ("NoReplicaAvailable", exc.retryable)
        finally:
            S.ModelServer.effective_state = orig
    return {"out": out, "in_rotation": in_rotation, "err": err,
            "degraded_mode": pkg.P.counter("router.rt_deg.degraded_mode") >= 1,
            "no_replica": pkg.P.counter("router.rt_deg.no_replica") >= 1}


def sc_replica_death_rerouted(pkg, arm):
    arm("serving.dispatch:tag=rt_chaos-r0:call=1:action=kill")
    with pkg.S.Router(replicas=2, max_batch=4, max_wait_ms=2) as router:
        reps = router.serve("rt_chaos", Echo(pkg.S))
        futs = [router.submit("rt_chaos", np.ones(4, np.float32)) for _ in range(12)]
        out = [value(f) for f in futs]
        back = until(lambda: reps[0].state() == pkg.S.READY
                     and pkg.P.counter("serving.rt_chaos-r0.restarts") >= 1)
        n0 = pkg.P.percentiles("serve.rt_chaos-r0.dispatch").get("count", 0)
        for _ in range(8):
            router.predict("rt_chaos", np.ones(4, np.float32))
        readmitted = pkg.P.percentiles("serve.rt_chaos-r0.dispatch").get("count", 0) > n0
    return {"out": out, "back": back, "readmitted": readmitted,
            "rerouted": pkg.P.counter("router.rt_chaos.rerouted") >= 1,
            "deaths": pkg.P.counter("serving.rt_chaos-r0.worker_deaths")}


def sc_draining_replica_fails_over(pkg, arm):
    with pkg.S.Router(replicas=2, max_batch=8, max_wait_ms=1) as router:
        reps = router.serve("rt_drace", Echo(pkg.S))
        reps[0]._batcher.begin_drain()
        try:
            reps[0].submit(np.ones(4, np.float32))
            bare = None
        except pkg.S.ServerDraining as exc:
            bare = type(exc).__name__
        out = router.predict("rt_drace", np.ones(4, np.float32))["echo"].tolist()
    return {"bare": bare, "out": out, "failover": pkg.P.counter("router.rt_drace.failover") >= 1}


def sc_swap_under_load(pkg, arm):
    with pkg.S.Router(replicas=2, max_batch=8, max_wait_ms=1) as router:
        router.serve("rt_sw", Echo(pkg.S))
        stop, failures, ok = threading.Event(), [], [0]

        def pump():
            while not stop.is_set():
                try:
                    router.predict("rt_sw", np.ones((2, 4), np.float32), timeout_ms=10_000)
                    ok[0] += 1
                except Exception as exc:  # noqa: BLE001 - the scenario counts these
                    failures.append(exc)

        t = threading.Thread(target=pump)
        t.start()
        try:
            assert until(lambda: ok[0] > 5)
            swapped = router.swap("rt_sw", Echo(pkg.S, out_col="echo"))
            n = ok[0]
            assert until(lambda: ok[0] > n + 5)
        finally:
            stop.set()
            t.join(timeout=WAIT_S)
        try:
            router.swap("rt_sw", Echo(pkg.S, n_cols=6))
            bad = None
        except ValueError as exc:
            bad = "n_cols 4 -> 6" in str(exc)
        same = router.replicas("rt_sw") == swapped
        state = router.health()["models"]["rt_sw"]["state"]
    return {"failures": len(failures), "bad": bad, "same": same, "state": state, "alive": t.is_alive(),
            "replica_swaps": pkg.P.counter("router.rt_sw.replica_swaps"),
            "swaps": pkg.P.counter("router.rt_sw.swaps")}


def sc_health_rollup(pkg, arm):
    S = pkg.S
    with S.Router(replicas=2, max_batch=8, max_wait_ms=1) as router:
        reps = router.serve("rt_hrr", Echo(S))
        h = router.health()
        first = (h["state"], h["models"]["rt_hrr"]["replicas"], h["models"]["rt_hrr"]["in_rotation"],
                 sorted(h["models"]["rt_hrr"]["models"]))
        orig = S.ModelServer.effective_state
        try:
            S.ModelServer.effective_state = lambda self: S.UNHEALTHY if self is reps[0] else orig(self)
            m = router.health()["models"]["rt_hrr"]
            one_out = (m["state"], m["in_rotation"])
            S.ModelServer.effective_state = lambda self: S.UNHEALTHY
            h = router.health()
            all_out = (h["models"]["rt_hrr"]["state"], h["state"])
        finally:
            S.ModelServer.effective_state = orig
    return {"first": first, "one_out": one_out, "all_out": all_out}


def sc_prometheus_families(pkg, arm):
    arm("serving.dispatch:tag=rt_prom-r1:call=1:action=kill")
    with pkg.S.Router(replicas=2, max_batch=4, max_wait_ms=2) as router:
        reps = router.serve("rt_prom", Echo(pkg.S))
        futs = [router.submit("rt_prom", np.ones(4, np.float32)) for _ in range(6)]
        out = [value(f) for f in futs]
        back = until(lambda: reps[1].state() == pkg.S.READY
                     and router.health()["models"]["rt_prom"]["restarts"] == 1)
        gauges = pkg.P.export_metrics()["gauges"]
        keys = sorted(k for k in gauges if k.startswith(("router.rt_prom.", "health.rt_prom")))
        text = pkg.P.render_prometheus()
        snap = router.telemetry()
        stats = router.stats()["rt_prom"]
        facts = {"replicas": gauges["router.rt_prom.replicas"], "r1_restarts": gauges["health.rt_prom-r1.restarts"],
                 "router_line": 'srml_router{name="router.rt_prom.replicas"} 2.0' in text,
                 "health_line": 'srml_health{name="health.rt_prom-r1.restarts"} 1.0' in text,
                 "admitted": snap.counters.get("router.rt_prom.admitted", 0),
                 "replica_stats": sorted(stats["replicas"])}
    gone = not any(k.startswith("router.rt_prom.") for k in pkg.P.export_metrics()["gauges"])
    return {"out": out, "back": back, "keys": keys, "facts": facts, "gone": gone}


SCENARIOS = {name[3:]: fn for name, fn in sorted(globals().items()) if name.startswith("sc_")}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_router_scenario_matches_jax(scenario, arm):
    got = {}
    for name, pkg in PKGS.items():
        pkg.P.reset_counters("router.rt_")
        pkg.P.reset_counters("serving.rt_")
        pkg.P.reset_durations("serve.rt_")
        got[name] = SCENARIOS[scenario](pkg, arm)
    assert got["port"] == got["jax"]


# -- the port alone ----------------------------------------------------------------


def test_slice_meshes_disjoint_and_oversubscribed():
    devs = [f"cuda:{i}" for i in range(8)]
    slices = slice_meshes(2, devices=devs)
    assert [len(m.devices) for m in slices] == [4, 4]
    assert not set(slices[0].devices) & set(slices[1].devices)
    over = slice_meshes(11, devices=devs)
    assert all(m.size == 1 for m in over) and over[8].devices == over[0].devices
    one_card = slice_meshes(2, devices=["cuda:0"])
    assert [m.devices for m in one_card] == [one_card[0].devices] * 2  # shared leases of the one card
    with pytest.raises(ValueError, match="n_slices"):
        slice_meshes(0)
    assert [m.size for m in slice_meshes(4)] == [2, 2, 2, 2]  # the device list: ["cpu"] * 8


def test_slice_meshes_topology_aware_never_straddles_host_group():
    devs = [f"cuda:{i}" for i in (3, 7, 0, 5, 2, 6, 1, 4)]
    for n in (2, 4):
        for m in slice_meshes(n, devices=devs, devs_per_host=4):
            assert len({d.index // 4 for d in m.devices}) == 1
    groups = carve_device_slices(devs, 3, devs_per_host=4)
    assert len(groups) == 2 and all(len({d.index // 4 for d in map(__import__("torch").device, g)}) == 1
                                    for g in groups)
    assert len(carve_device_slices(devs, 3)) == 2  # flat: two contiguous runs, 2 stranded


def test_one_device_router_needs_oversubscription_for_two_replicas():
    with use_device("cpu"), port_serving.Router(replicas=2, max_batch=8, max_wait_ms=1) as router:
        with pytest.raises(port_serving.CapacityExhausted, match="allow_oversubscribe"):
            router.serve("rt_one", Echo(port_serving))
        assert "rt_one" not in router
        reps = router.serve("rt_one", Echo(port_serving), allow_oversubscribe=True)
        assert [r._entry.device for r in reps] == [None, None]
        assert router.predict("rt_one", np.ones(4, np.float32))["echo"][0] == 4.0
        assert profiling.counter("slicepool.oversubscribed") >= 1


@pytest.fixture(scope="module")
def kmeans_pair():
    X = np.random.default_rng(5).standard_normal((96, 5)).astype(np.float32)
    with use_device("cpu"):
        a = port.KMeans(k=3, maxIter=4, seed=1).fit(port.DataFrame.from_numpy(X))
        b = port.KMeans(k=3, maxIter=4, seed=9).fit(port.DataFrame.from_numpy(X + 1.0))
    return a, b, X


def test_chaos_readmit_is_warm_zero_new_warmups(kmeans_pair, arm):
    model, _other, X = kmeans_pair
    with port_serving.Router(replicas=2, max_batch=16, max_wait_ms=2) as router:
        reps = router.serve("rt_ckm", model)
        router.predict("rt_ckm", X[:3])
        arm("serving.dispatch:tag=rt_ckm-r0:call=1:action=kill")
        before = profiling.counters("precompile.")
        futs = [router.submit("rt_ckm", X[i : i + 2]) for i in range(10)]
        for f in futs:
            assert f.result(timeout=WAIT_S)["prediction"].shape == (2,)
        assert until(lambda: reps[0].state() == port_serving.READY
                     and profiling.counter("serving.rt_ckm-r0.restarts") >= 1)
        assert router.predict("rt_ckm", X[:3])["prediction"].shape == (3,)
        assert profiling.counter_deltas(before, "precompile.") == {}
        for r in router.replicas("rt_ckm"):
            r.drain()
            r.assert_steady_state()


def test_rolling_swap_of_a_real_model_cuts_over_at_zero_new_warmups(kmeans_pair):
    model, other, X = kmeans_pair
    want_new = other.transform(port.DataFrame.from_numpy(X[:8])).partitions[0]["prediction"]
    with port_serving.Router(replicas=2, max_batch=16, max_wait_ms=2) as router:
        router.serve("rt_swkm", model)
        before = profiling.counters("precompile.")
        swapped = router.swap("rt_swkm", other)
        assert profiling.counter_deltas(before, "precompile.") == {}
        assert router.replicas("rt_swkm") == swapped
        for _ in range(4):
            np.testing.assert_array_equal(router.predict("rt_swkm", X[:8])["prediction"], want_new)
        for r in swapped:
            r.drain()
            r.assert_steady_state()
