# The port's per-bucket warm cache (spark_rapids_ml_tpu_torch.ops.precompile)
# on the CPU: a dispatch repeated on a warmed key adds zero warm-ups, an
# unwarmed bucket counts exactly one, a first kernel-library load counts one
# (ops/_build.load), a server built without its warm-up breaches the
# steady-state gate, and a server of the same model on the same device
# reuses the process-wide registry.
import ctypes

import numpy as np
import pytest

import spark_rapids_ml_tpu_torch as port
import spark_rapids_ml_tpu_torch.serving as serving
from spark_rapids_ml_tpu_torch import profiling
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.ops import _build, precompile


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


@pytest.fixture(scope="module")
def kmeans_model():
    X = np.random.default_rng(11).standard_normal((64, 6)).astype(np.float32)
    with use_device("cpu"):
        return port.KMeans(k=3, maxIter=3, seed=2).fit(port.DataFrame.from_numpy(X)), X


def test_repeat_dispatch_adds_zero_and_a_new_key_counts_one():
    key = precompile.warm_key("serve.test_wc", 16, np.dtype(np.float32), "cpu")
    before = profiling.counter("precompile.compile")
    assert precompile.dispatch(key) is False
    assert profiling.counter("precompile.compile") == before + 1
    for _ in range(5):
        assert precompile.dispatch(key) is True
    assert profiling.counter("precompile.compile") == before + 1
    assert precompile.is_warm(key) and precompile.warmed([key])
    other = precompile.warm_key("serve.test_wc", 32, np.dtype(np.float32), "cpu")
    assert not precompile.warmed([key, other])
    assert precompile.warm_cache_stats()["entries"] >= 1


def test_kernel_entry_registers_its_buckets(kmeans_model):
    model, X = kmeans_model
    entry = model._serving_entry()
    keys = entry.warm([16, 32])
    assert keys == [precompile.warm_key("serve.kmeans", b, np.dtype(np.float32), "cpu") for b in (16, 32)]
    for b in (16, 32):
        entry.call(np.zeros((b, X.shape[1]), np.float32))
    assert precompile.warmed(keys)
    before = profiling.counter("precompile.compile")
    out = entry.call(np.vstack([X[:5], np.zeros((11, X.shape[1]), np.float32)]))
    assert profiling.counter("precompile.compile") == before
    np.testing.assert_array_equal(out["prediction"][:5], model.transform(
        port.DataFrame.from_numpy(X[:5])).partitions[0]["prediction"])


def test_server_without_warmup_breaches_the_steady_state(kmeans_model):
    model, X = kmeans_model
    # a bucket no other server of this suite warms: max_batch 2048
    srv = serving.ModelServer("wc_cold", model, max_batch=2048, max_wait_ms=1, warm=False)
    try:
        srv._warmed = True  # the dispatch watermark is checked from here on
        key = precompile.warm_key("serve.kmeans", 2048, np.dtype(np.float32), "cpu")
        cold = not precompile.is_warm(key)
        srv.predict(np.tile(X, (32, 1)))  # 2048 rows: the 2048 bucket
        if cold:
            with pytest.raises(AssertionError, match="warm-cache miss"):
                srv.assert_steady_state()
            assert profiling.counter("serving.wc_cold.steady_compiles") == 1
        srv.predict(np.tile(X, (32, 1)))
        assert profiling.counter("serving.wc_cold.steady_compiles") == (1 if cold else 0)
    finally:
        srv.shutdown()


def test_second_server_of_the_same_model_warms_no_new_key(kmeans_model):
    model, X = kmeans_model
    with serving.ModelServer("wc_a", model, max_batch=32, max_wait_ms=1):
        pass
    before = profiling.counter("precompile.compile")
    with serving.ModelServer("wc_b", model, max_batch=32, max_wait_ms=1) as srv:
        srv.predict(X[:4])
        srv.assert_steady_state()
    assert profiling.counter("precompile.compile") == before
    assert profiling.counter("serving.wc_b.warmed_buckets") == 2


def test_first_library_load_counts_one(monkeypatch):
    monkeypatch.setattr(_build, "build", lambda names: {n: 0.0 for n in names})
    monkeypatch.setattr(ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(_build, "_libs", {})
    before = profiling.counter("precompile.compile")
    lib = _build.load("min_dist_argmin")
    assert profiling.counter("precompile.compile") == before + 1
    assert _build.load("min_dist_argmin") is lib
    assert profiling.counter("precompile.compile") == before + 1


@pytest.mark.parametrize("n,lo,hi,want", [(1, 16, 256, 16), (17, 16, 256, 32), (300, 16, 256, 256),
                                          (0, 64, 1 << 30, 64), (65, 64, 1 << 30, 128), (5, 1, 4, 4)])
def test_shape_bucket_fixed_points(n, lo, hi, want):
    assert precompile.shape_bucket(n, lo, hi) == want
