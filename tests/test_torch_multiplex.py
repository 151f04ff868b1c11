# The port's multiplexed serving (spark_rapids_ml_tpu_torch.serving
# MultiplexServer over the models' _lane_entry hooks) against the JAX
# package's, on the CPU: every case of tests/test_multiplex.py, run on both
# packages.  The variant zoo is tests/test_multiplex.py's (integer
# coefficients, centers and components; integer-valued float32 rows), so
# every sum is exact and the gates are bit for bit: per family and tenant,
# multiplexed outputs equal the dedicated server's on each package and
# equal across the packages (the logistic probabilities, a softmax of equal
# scores, within rtol = atol = 1e-5 there: torch's and XLA's float32 exp
# differ in the last bit).  Paging keeps them equal and adds zero new
# warm-ups; the page wait converts to the typed ServerOverloaded; the
# contract errors, per-tenant counters, registry.multiplex and
# router.serve_multiplex behave as the JAX package's, with equal counters
# where both packages count the same events.
import numpy as np
import pytest

import spark_rapids_ml_tpu.serving as ref_serving
from spark_rapids_ml_tpu import profiling as ref_profiling
from spark_rapids_ml_tpu.models.kmeans import KMeansModel as RefKMeansModel
from spark_rapids_ml_tpu.models.linear_regression import LinearRegressionModel as RefLinearRegressionModel
from spark_rapids_ml_tpu.models.logistic_regression import LogisticRegressionModel as RefLogisticRegressionModel
from spark_rapids_ml_tpu.models.pca import PCAModel as RefPCAModel
from spark_rapids_ml_tpu.models.umap import UMAPModel as RefUMAPModel

import spark_rapids_ml_tpu_torch.serving as port_serving
from spark_rapids_ml_tpu_torch import profiling as port_profiling
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.models.kmeans import KMeansModel
from spark_rapids_ml_tpu_torch.models.linear_regression import LinearRegressionModel
from spark_rapids_ml_tpu_torch.models.logistic_regression import LogisticRegressionModel
from spark_rapids_ml_tpu_torch.models.pca import PCAModel
from spark_rapids_ml_tpu_torch.models.umap import UMAPModel

D = 5  # feature width shared by the variant zoo
WAIT_S = 60
RTOL = ATOL = 1e-5  # tests/test_torch_serving.py's, for the logistic probabilities across packages


class Pkg:
    def __init__(self, S, P, kmeans, linreg, logreg, pca, umap):
        self.S, self.P = S, P
        self.KMeansModel, self.LinearRegressionModel = kmeans, linreg
        self.LogisticRegressionModel, self.PCAModel, self.UMAPModel = logreg, pca, umap


PKGS = {
    "jax": Pkg(ref_serving, ref_profiling, RefKMeansModel, RefLinearRegressionModel, RefLogisticRegressionModel,
               RefPCAModel, RefUMAPModel),
    "port": Pkg(port_serving, port_profiling, KMeansModel, LinearRegressionModel, LogisticRegressionModel, PCAModel,
                UMAPModel),
}


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


def _linreg(pkg, rng, i):
    return pkg.LinearRegressionModel(coef_=rng.randint(-3, 4, size=D).astype(np.float64), intercept_=float(i % 3),
                                     n_cols=D, dtype="float32")


def _logreg(pkg, rng, i):
    return pkg.LogisticRegressionModel(coef_=rng.randint(-2, 3, size=(3, D)).astype(np.float64),
                                       intercept_=rng.randint(-2, 3, size=3).astype(np.float64),
                                       classes_=np.array([0.0, 1.0, 2.0]), n_cols=D, dtype="float32")


def _kmeans(pkg, rng, i):
    return pkg.KMeansModel(cluster_centers_=rng.randint(-5, 6, size=(4, D)).astype(np.float64), n_cols=D,
                           dtype="float32")


def _pca(pkg, rng, i):
    return pkg.PCAModel(mean_=np.zeros(D), components_=rng.randint(-2, 3, size=(2, D)).astype(np.float64),
                        explained_variance_=np.array([4.0, 1.0]), explained_variance_ratio_=np.array([0.8, 0.2]),
                        singular_values_=np.array([2.0, 1.0]), n_cols=D, dtype="float32")


FAMILIES = {"linreg": _linreg, "logreg": _logreg, "kmeans": _kmeans, "pca": _pca}


def _variants(pkg, family, k, seed=0):
    rng = np.random.RandomState(seed)
    return {f"m{i}": FAMILIES[family](pkg, rng, i) for i in range(k)}


def _int_X(n, seed=1):
    # integer-valued f32: exactly representable, every reduction order exact
    return np.random.RandomState(seed).randint(-4, 5, size=(n, D)).astype(np.float32)


def _host(out):
    return {c: np.asarray(v) for c, v in out.items()}


def _dedicated_outputs(pkg, models, X):
    out = {}
    for mid, m in models.items():
        with pkg.S.ModelServer(f"mx_ded-{mid}-{id(m):x}", m) as srv:
            out[mid] = _host(srv.predict(X))
    return out


def _both(scenario):
    return {name: scenario(pkg) for name, pkg in PKGS.items()}


def _assert_same_outputs(a, b, what, across=False):
    """Bit for bit; across the packages the logistic probabilities within
    rtol = atol = 1e-5 (torch's and XLA's float32 exp differ in the last
    bit; scores and labels stay exact)."""
    assert sorted(a) == sorted(b), what
    for mid in a:
        assert sorted(a[mid]) == sorted(b[mid]), (what, mid)
        for c in a[mid]:
            if across and c == "probability":
                np.testing.assert_allclose(a[mid][c], b[mid][c], rtol=RTOL, atol=ATOL, err_msg=f"{what}: {mid}/{c}")
            else:
                np.testing.assert_array_equal(a[mid][c], b[mid][c], err_msg=f"{what}: {mid}/{c}")


def _compile_delta(pkg, before):
    delta = pkg.P.counter_deltas(before, "precompile.")
    return {k: delta.get(k, 0) for k in ("precompile.compile", "precompile.fallback")}


# -- per-tenant bitwise parity ------------------------------------------------


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_multiplex_matches_dedicated_bitwise(family):
    X = _int_X(7)

    def scenario(pkg):
        models = _variants(pkg, family, 4)
        expected = _dedicated_outputs(pkg, models, X)
        with pkg.S.MultiplexServer(f"mx_{family}", models) as mux:
            got = {mid: _host(mux.predict(X, model_id=mid)) for mid in models}
            mux.drain()
            mux.assert_steady_state()
        _assert_same_outputs(got, expected, f"{family} multiplexed vs dedicated")
        return got

    got = _both(scenario)
    _assert_same_outputs(got["port"], got["jax"], f"{family} port vs jax", across=True)


def test_interleaved_tenants_share_one_dispatch_plane():
    X = _int_X(3)

    def scenario(pkg):
        models = _variants(pkg, "linreg", 4)
        expected = _dedicated_outputs(pkg, models, X)
        with pkg.S.MultiplexServer("mx_mixed", models, max_batch=64, max_wait_ms=5) as mux:
            before = pkg.P.counters("precompile.")
            futs = [(mid, mux.submit(X, model_id=mid)) for _ in range(6) for mid in models]
            got = [(mid, _host(f.result(timeout=WAIT_S))) for mid, f in futs]
            delta = _compile_delta(pkg, before)
            mux.drain()
            mux.assert_steady_state()
        for mid, out in got:
            np.testing.assert_array_equal(out["prediction"], expected[mid]["prediction"], err_msg=mid)
        return {"delta": delta, "got": [(mid, out["prediction"].tolist()) for mid, out in got]}

    got = _both(scenario)
    assert got["port"]["delta"] == {"precompile.compile": 0, "precompile.fallback": 0}
    assert got["port"] == got["jax"]


def test_single_variant_defaults_model_id():
    X = _int_X(4)

    def scenario(pkg):
        models = _variants(pkg, "linreg", 1)
        expected = _dedicated_outputs(pkg, models, X)
        with pkg.S.MultiplexServer("mx_one", models) as mux:
            got = mux.predict(X)["prediction"]  # no model_id: the single variant is implied
        np.testing.assert_array_equal(np.asarray(got), expected["m0"]["prediction"])
        return np.asarray(got).tolist()

    got = _both(scenario)
    assert got["port"] == got["jax"]


# -- lane paging --------------------------------------------------------------


def test_paging_parity_and_zero_new_warmups():
    """8 registered variants on a 2-lane budget: every request pages its
    variant in on demand, outputs stay bit for bit the dedicated servers'
    across page-in / eviction churn, the paged stream adds zero new
    warm-ups, and the paging counts equal the JAX package's."""
    X = _int_X(5, seed=4)

    def scenario(pkg):
        models = _variants(pkg, "linreg", 8, seed=3)
        expected = _dedicated_outputs(pkg, models, X)
        with pkg.S.MultiplexServer("mx_paged", models, resident_lanes=2) as mux:
            assert mux.lanes()["n_lanes"] == 2
            before = pkg.P.counters("precompile.")
            for _ in range(2):  # two full walks: eviction and re-page-in
                for mid in models:
                    got = mux.predict(X, model_id=mid)
                    np.testing.assert_array_equal(np.asarray(got["prediction"]), expected[mid]["prediction"],
                                                  err_msg=mid)
            delta = _compile_delta(pkg, before)
            snap = mux.lanes()
            mux.drain()
            mux.assert_steady_state()
        assert snap["page_in_latency"]["count"] == snap["page_in"]
        return {"delta": delta, **{k: snap[k] for k in ("n_lanes", "registered", "resident", "resident_models",
                                                        "hits", "page_in", "evictions")}}

    got = _both(scenario)
    assert got["port"]["delta"] == {"precompile.compile": 0, "precompile.fallback": 0}
    assert got["port"]["page_in"] >= 14 and got["port"]["evictions"] >= 12, got["port"]
    assert got["port"] == got["jax"]


def test_page_wait_timeout_is_typed_overload(monkeypatch):
    """Every lane pinned by in-flight traffic and a page-in request for a
    spilled variant: the bounded wait converts to the typed retryable
    ServerOverloaded."""
    monkeypatch.setenv("SRML_SERVE_PAGE_WAIT_S", "0.2")
    X = _int_X(2)

    def scenario(pkg):
        models = _variants(pkg, "linreg", 3)
        with pkg.S.MultiplexServer("mx_pin", models, resident_lanes=1, max_batch=16, max_wait_ms=2000) as mux:
            fut = mux.submit(X, model_id="m0")  # pins the only lane in the coalesce window
            with pytest.raises(pkg.S.ServerOverloaded, match="resident lanes") as ei:
                mux.submit(X, model_id="m1")
            out = np.asarray(fut.result(timeout=WAIT_S)["prediction"]).tolist()
            mux.drain()
        return {"error": str(ei.value), "retryable": ei.value.retryable, "out": out}

    got = _both(scenario)
    assert got["port"] == got["jax"]


# -- contract errors ----------------------------------------------------------


def test_unknown_model_id_is_keyerror():
    def scenario(pkg):
        with pkg.S.MultiplexServer("mx_err", _variants(pkg, "linreg", 2)) as mux:
            with pytest.raises(KeyError, match="no registered variant") as ei:
                mux.submit(_int_X(1), model_id="nope")
        return str(ei.value)

    got = _both(scenario)
    assert got["port"] == got["jax"]


def test_missing_model_id_with_many_variants_is_valueerror():
    def scenario(pkg):
        with pkg.S.MultiplexServer("mx_noid", _variants(pkg, "linreg", 2)) as mux:
            with pytest.raises(ValueError, match="requires model_id") as ei:
                mux.submit(_int_X(1))
        return str(ei.value)

    got = _both(scenario)
    assert got["port"] == got["jax"]


def test_signature_mismatch_rejected():
    def scenario(pkg):
        rng = np.random.RandomState(0)
        a = _linreg(pkg, rng, 0)
        wide = pkg.LinearRegressionModel(coef_=np.arange(D + 1, dtype=np.float64), intercept_=0.0, n_cols=D + 1,
                                         dtype="float32")
        errors = []
        for name, other in (("mx_sig", wide), ("mx_cls", _kmeans(pkg, rng, 0))):  # width, then class
            with pytest.raises(ValueError, match="lane_signature") as ei:
                pkg.S.MultiplexServer(name, {"a": a, "b": other})
            errors.append(str(ei.value))
        return errors

    got = _both(scenario)
    assert got["port"] == got["jax"]


def test_unmultiplexable_model_gives_actionable_error():
    class _NoLanes:
        pass

    def scenario(pkg):
        errors = []
        umap = pkg.UMAPModel(embedding_=np.zeros((4, 2), np.float32), raw_data_=np.zeros((4, 3), np.float32),
                             n_cols=3, dtype="float32")
        for model in (_NoLanes(), umap):  # UMAP has no lane path in either package
            with pytest.raises(TypeError, match="not multiplexable") as ei:
                pkg.S.lane_entry_for(model)
            errors.append(str(ei.value))
        return errors

    got = _both(scenario)
    assert got["port"] == got["jax"]


def test_lane_signature_distinguishes_logistic_classes():
    def scenario(pkg):
        rng = np.random.RandomState(0)
        a = _logreg(pkg, rng, 0)
        b = _logreg(pkg, rng, 1)
        c = pkg.LogisticRegressionModel(coef_=np.asarray(a.coef_), intercept_=np.asarray(a.intercept_),
                                        classes_=np.array([10.0, 20.0, 30.0]), n_cols=D, dtype="float32")
        sig = {k: pkg.S.lane_signature(pkg.S.lane_entry_for(m)) for k, m in (("a", a), ("b", b), ("c", c))}
        assert sig["a"] == sig["b"]
        assert sig["a"] != sig["c"]  # a different label vocabulary
        return sig

    got = _both(scenario)
    assert got["port"] == got["jax"]


# -- observability ------------------------------------------------------------


def test_per_tenant_counters_and_stats():
    X = _int_X(3)

    def scenario(pkg):
        models = _variants(pkg, "linreg", 2)
        with pkg.S.MultiplexServer("mx_obs", models) as mux:
            for _ in range(3):
                mux.predict(X, model_id="m0")
            mux.predict(X, model_id="m1")
            stats = mux.stats()
            ids = mux.model_ids()
            mux.drain()
        lat = pkg.P.percentiles("serve.mx_obs.tenant.m0.latency")
        assert lat["count"] == 3 and lat["p50"] > 0
        ns = "serving.mx_obs"
        return {"lanes": {k: stats["lanes"][k] for k in ("registered", "resident", "hits", "page_in", "evictions")},
                "ids": ids, "info": stats["info"],
                "counters": {k: pkg.P.counter(f"{ns}.tenant.{k}") for k in
                             ("m0.requests", "m0.rows", "m1.requests", "m1.rows", "m0.errors")}}

    got = _both(scenario)
    assert got["port"]["counters"] == {"m0.requests": 3, "m0.rows": 9, "m1.requests": 1, "m1.rows": 3,
                                       "m0.errors": 0}
    assert got["port"] == got["jax"]


# -- registry / router deployment ---------------------------------------------


def test_registry_multiplex_lifecycle():
    X = _int_X(4)

    def scenario(pkg):
        models = _variants(pkg, "linreg", 3)
        expected = _dedicated_outputs(pkg, models, X)
        with pkg.S.ModelRegistry() as reg:
            srv = reg.multiplex("mx_fleet", models, resident_lanes=2)
            assert isinstance(srv, pkg.S.MultiplexServer)
            assert "mx_fleet" in reg and reg.get("mx_fleet") is srv
            errors = []
            for call in (lambda: reg.multiplex("mx_fleet", models), lambda: reg.register("mx_fleet", models["m0"])):
                with pytest.raises(ValueError, match="already registered") as ei:
                    call()
                errors.append(str(ei.value))
            got = reg.get("mx_fleet").predict(X, model_id="m2")
            np.testing.assert_array_equal(np.asarray(got["prediction"]), expected["m2"]["prediction"])
            state = reg.health()["models"]["mx_fleet"]["state"]
            assert state == pkg.S.READY
            reg.unregister("mx_fleet")
            assert "mx_fleet" not in reg
        return {"errors": errors, "state": state, "out": np.asarray(got["prediction"]).tolist()}

    got = _both(scenario)
    assert got["port"] == got["jax"]


def test_registry_multiplex_failed_init_releases_name():
    def scenario(pkg):
        rng = np.random.RandomState(0)
        bad = {"a": _linreg(pkg, rng, 0), "b": _kmeans(pkg, rng, 0)}
        with pkg.S.ModelRegistry() as reg:
            with pytest.raises(ValueError, match="lane_signature"):
                reg.multiplex("mx_doomed", bad)
            listed = "mx_doomed" in reg
            srv = reg.multiplex("mx_doomed", _variants(pkg, "linreg", 2))  # the name is free again
            return {"listed_after_failure": listed, "served": srv.model_ids()}

    got = _both(scenario)
    assert got["port"] == {"listed_after_failure": False, "served": ["m0", "m1"]}
    assert got["port"] == got["jax"]


def test_router_serves_multiplexed_set():
    X = _int_X(4)

    def scenario(pkg):
        models = _variants(pkg, "linreg", 3)
        expected = _dedicated_outputs(pkg, models, X)
        router = pkg.S.Router(replicas=1)
        try:
            reps = router.serve_multiplex("mx_tenants", models)
            out = {}
            for mid in models:
                got = router.predict("mx_tenants", X, model_id=mid)
                np.testing.assert_array_equal(np.asarray(got["prediction"]), expected[mid]["prediction"])
                out[mid] = np.asarray(got["prediction"]).tolist()
            # client errors resolve the routed future (typed, no failover loop)
            errors = []
            for kw, exc, match in (({"model_id": "nope"}, KeyError, "no registered variant"),
                                   ({}, ValueError, "requires model_id")):
                fut = router.submit("mx_tenants", X, **kw)
                with pytest.raises(exc, match=match) as ei:
                    fut.result(timeout=WAIT_S)
                errors.append(str(ei.value))
            names = [r.name for r in reps]
            kinds = [type(r).__name__ for r in reps]
        finally:
            router.shutdown()
        return {"out": out, "errors": errors, "names": names, "kinds": kinds}

    got = _both(scenario)
    assert got["port"]["kinds"] == ["MultiplexServer"]
    assert got["port"] == got["jax"]
