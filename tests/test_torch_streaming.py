# The port's streaming engines and session (spark_rapids_ml_tpu_torch/stream)
# against the JAX package's, on the CPU: the chunk updates, streamed against
# batch fits, the kmeans and logistic engines from a shared start, the
# loud failures, the counters, the control-plane merge and the session.
#
# Tolerances:
#   - bit for bit on the exact family (integer features, pow2 chunks): the
#     linreg / PCA / kmeans chunk partials against the JAX kernels, the
#     streamed linreg and PCA models against the port's own batch fit, the
#     kmeans sums and counts after a shared init anchor, and every merge;
#   - the streamed linreg model against the JAX package's within 1e-5 of max
#     |coef| (chip_smoke.py's LINREG_RTOL), PCA within the JAX package's PCA
#     test gates (mean atol 1e-4, |components| atol 1e-3, ratio atol 1e-4,
#     singular values rtol 1e-3, signs equal), the kmeans chunk cost rtol
#     1e-6 (difference form, summed in other orders);
#   - the logistic warm fit of one chunk within the port's logistic
#     tolerance (2e-3 absolute, tests/test_torch_logistic_regression.py);
#   - the quality gates of the JAX package's own streaming tests (inertia
#     within 10% of a batch fit, accuracy within 0.03 of it).
import json
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import spark_rapids_ml_tpu as ref
from spark_rapids_ml_tpu.ops import glm as ref_glm
from spark_rapids_ml_tpu.ops import kmeans as ref_kmeans
from spark_rapids_ml_tpu.ops import linalg as ref_linalg
from spark_rapids_ml_tpu.ops import logistic as ref_logistic
from spark_rapids_ml_tpu.parallel.context import LocalControlPlane

import spark_rapids_ml_tpu_torch as port
from spark_rapids_ml_tpu_torch import profiling
from spark_rapids_ml_tpu_torch.dataframe import stream_chunk_ids
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.ops import glm, kmeans, linalg, logistic
from spark_rapids_ml_tpu_torch.stream import (
    StreamingKMeans,
    StreamingLinearRegression,
    StreamingLogisticRegression,
    StreamingPCA,
    StreamingSession,
    allgather_merge,
    streaming_fit,
)
from spark_rapids_ml_tpu_torch.stream.engines import chunk_bucket

CHUNK = 128
LINREG_RTOL = 1e-5
LOGISTIC_ATOL = 2e-3


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


@pytest.fixture(scope="module")
def exact_data():
    rng = np.random.default_rng(3)
    n, d = 512, 8
    X = rng.integers(-4, 5, size=(n, d)).astype(np.float32)
    y = (X @ np.arange(1.0, d + 1.0)).astype(np.float64)
    return X, y, stream_chunk_ids(n, CHUNK, seed=5)


@pytest.fixture(scope="module")
def clustered_data():
    """The JAX tests' clustered rows."""
    rng = np.random.default_rng(11)
    n, d, k = 1024, 8, 4
    centers = rng.standard_normal((k, d)) * 8
    X = (centers[rng.integers(0, k, n)] + rng.standard_normal((n, d))).astype(np.float32)
    return X, stream_chunk_ids(n, 256, seed=7), k


@pytest.fixture(scope="module")
def integer_blobs():
    """Well separated integer blobs: every chunk sum is exact in float32 and
    no row sits near a boundary between two centers."""
    rng = np.random.default_rng(21)
    n, d, k = 2048, 8, 4
    centers = rng.integers(-40, 41, size=(k, d)) * 4
    X = (centers[rng.integers(0, k, n)] + rng.integers(-3, 4, size=(n, d))).astype(np.float32)
    return X, stream_chunk_ids(n, 256, seed=2), k


def _stream(engine, X, cid, y=None, chunks=None):
    for c in range(int(cid.max()) + 1) if chunks is None else chunks:
        m = cid == c
        engine.partial_fit(X[m], y=None if y is None else y[m])
    return engine


# -- the chunk updates against the JAX kernels ------------------------------


@pytest.mark.parametrize("pad", [0, 77], ids=["full", "padded"])
@pytest.mark.parametrize("kernel", ["linreg", "pca"])
def test_chunk_partials_equal_jax_kernels_bit_for_bit(exact_data, kernel, pad):
    X, y, _ = exact_data
    Xc, yc = X[:CHUNK].copy(), y[:CHUNK].astype(np.float32)
    w = np.ones(CHUNK, np.float32)
    if pad:  # a staged chunk's zero rows of weight 0
        Xc, yc = np.concatenate([Xc, np.zeros((pad, 8), np.float32)]), np.concatenate([yc, np.zeros(pad, np.float32)])
        w = np.concatenate([w, np.zeros(pad, np.float32)])
    if kernel == "linreg":
        got = glm.stream_linreg_chunk_kernel(torch.from_numpy(Xc), torch.from_numpy(yc), torch.from_numpy(w))
        want = ref_glm.stream_linreg_chunk_kernel(jnp.asarray(Xc), jnp.asarray(yc), jnp.asarray(w))
    else:
        got = linalg.stream_moments_chunk_kernel(torch.from_numpy(Xc), torch.from_numpy(w))
        want = ref_linalg.stream_moments_chunk_kernel(jnp.asarray(Xc), jnp.asarray(w))
    want = jax.device_get(want)  # one fetch, before the loop
    assert len(got) == len(want)
    for g, r in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == tuple(r.shape)
        np.testing.assert_array_equal(g.numpy(), r)


def test_kmeans_chunk_partials_equal_jax_kernel(integer_blobs):
    X, _, k = integer_blobs
    Xc = X[:300]
    w = np.ones(len(Xc), np.float32)
    C = (X[[0, 700, 1400, 2000]] + 0.25).astype(np.float32)
    sums, counts, cost = kmeans.stream_kmeans_chunk_kernel(torch.from_numpy(Xc), torch.from_numpy(w), torch.from_numpy(C))
    rs, rc, rcost = ref_kmeans.stream_kmeans_chunk_kernel(jnp.asarray(Xc), jnp.asarray(w), jnp.asarray(C))
    np.testing.assert_array_equal(sums.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rc))
    np.testing.assert_allclose(float(cost), float(rcost), rtol=1e-6)


# -- streamed against batch -------------------------------------------------


@pytest.mark.parametrize(
    "params", [dict(), dict(regParam=0.1), dict(regParam=0.1, elasticNetParam=0.5, standardization=False)],
    ids=["ols", "ridge", "enet"],
)
def test_streamed_linreg_equals_port_batch_bit_for_bit(exact_data, params):
    X, y, cid = exact_data
    batch = port.LinearRegression(maxIter=20, **params).fit(port.DataFrame.from_numpy(X, y, num_partitions=2))
    streamed = _stream(port.LinearRegression(maxIter=20, **params).streaming(), X, cid, y).finalize()
    assert isinstance(streamed, port.LinearRegressionModel)
    np.testing.assert_array_equal(streamed.coef_, batch.coef_)
    assert streamed.intercept_ == batch.intercept_
    assert (streamed.n_cols, streamed.dtype) == (batch.n_cols, batch.dtype)
    # and against the JAX package's streamed model
    want = _stream(ref.LinearRegression(maxIter=20, **params).streaming(), X, cid, y).finalize()
    scale = np.abs(want.coef_).max()
    assert np.abs(streamed.coef_ - want.coef_).max() <= LINREG_RTOL * scale
    assert abs(streamed.intercept_ - want.intercept_) <= LINREG_RTOL * scale


def test_streamed_pca_equals_port_batch_bit_for_bit(exact_data):
    X, _, cid = exact_data
    batch = port.PCA(k=3).setInputCol("features").fit(port.DataFrame.from_numpy(X, num_partitions=2))
    streamed = _stream(port.PCA(k=3).setInputCol("features").streaming(), X, cid).finalize()
    for name in ("components_", "mean_", "explained_variance_", "explained_variance_ratio_", "singular_values_"):
        np.testing.assert_array_equal(getattr(streamed, name), getattr(batch, name), err_msg=name)
    want = _stream(ref.PCA(k=3).setInputCol("features").streaming(), X, cid).finalize()
    np.testing.assert_allclose(streamed.mean_, want.mean_, atol=1e-4)
    np.testing.assert_allclose(np.abs(streamed.components_), np.abs(want.components_), atol=1e-3)
    np.testing.assert_array_equal(np.sign(streamed.components_), np.sign(want.components_))
    np.testing.assert_allclose(streamed.explained_variance_ratio_, want.explained_variance_ratio_, atol=1e-4)
    np.testing.assert_allclose(streamed.singular_values_, want.singular_values_, rtol=1e-3)


def test_streamed_model_transforms_and_persists(exact_data, tmp_path):
    X, y, cid = exact_data
    model = _stream(port.LinearRegression(maxIter=20).streaming(), X, cid, y).finalize()
    df = port.DataFrame.from_numpy(X, y)
    model.save(str(tmp_path / "lin"))
    loaded = port.load(str(tmp_path / "lin"))
    np.testing.assert_array_equal(loaded.transform(df).partitions[0]["prediction"],
                                  model.transform(df).partitions[0]["prediction"])


# -- kmeans from a shared anchor --------------------------------------------


def test_kmeans_adopts_jax_anchor_then_matches_jax(integer_blobs):
    """The JAX engine ingests chunk 0 (its init and Lloyd); the port engine
    adopts that state, and both ingest chunks 1..n: sums and counts bit for
    bit, the running cost within 1e-6, the finalized centers equal."""
    X, cid, k = integer_blobs
    jax_eng = ref.KMeans(k=k, maxIter=10, seed=1).setFeaturesCol("features").streaming()
    jax_eng.partial_fit(X[cid == 0])
    port_eng = port.KMeans(k=k, maxIter=10, seed=1).setFeaturesCol("features").streaming()
    port_eng.merge(jax_eng.state_dict())
    np.testing.assert_array_equal(port_eng.state.arrays["init_centers"], jax_eng.state.arrays["init_centers"])
    rest = range(1, int(cid.max()) + 1)
    _stream(jax_eng, X, cid, chunks=rest)
    _stream(port_eng, X, cid, chunks=rest)
    for name in ("sums", "counts", "init_centers"):
        np.testing.assert_array_equal(port_eng.state.arrays[name], jax_eng.state.arrays[name], err_msg=name)
    np.testing.assert_allclose(port_eng.state.arrays["cost"], jax_eng.state.arrays["cost"], rtol=1e-6)
    got, want = port_eng.finalize(), jax_eng.finalize()
    assert isinstance(got, port.KMeansModel)
    np.testing.assert_array_equal(got.cluster_centers_, want.cluster_centers_)


def _inertia(centers, X):
    d2 = ((X[:, None, :] - centers[None]) ** 2).sum(-1)
    return float(d2.min(axis=1).sum())


def test_streamed_kmeans_inertia_quality(clustered_data):
    X, cid, k = clustered_data
    batch = port.KMeans(k=k, maxIter=20, seed=1).fit(port.DataFrame.from_numpy(X, num_partitions=2))
    streamed = _stream(port.KMeans(k=k, maxIter=20, seed=1).streaming(), X, cid).finalize()
    bi, si = _inertia(batch.cluster_centers_, X), _inertia(streamed.cluster_centers_, X)
    assert si <= 1.10 * bi, (si, bi)
    assert streamed.n_cols == batch.n_cols and streamed.n_iter_ == int(cid.max()) + 1
    assert streamed.predict(X[0]) in range(k)


# -- logistic ---------------------------------------------------------------


@pytest.mark.parametrize("k,l1_ratio", [(1, 0.0), (1, 0.5), (3, 0.0)], ids=["binary", "binary_enet", "multinomial"])
def test_logistic_warm_fit_matches_jax(k, l1_ratio):
    rng = np.random.default_rng(5 + k)
    X = rng.standard_normal((256, 8)).astype(np.float32)
    Xc = X
    margin = Xc @ rng.standard_normal((X.shape[1], max(k, 2)))
    y = (margin[:, 0] > np.median(margin[:, 0])).astype(np.int32) if k == 1 else np.argmax(margin, 1).astype(np.int32)
    w = np.ones(len(Xc), np.float32)
    W0 = (0.01 * rng.standard_normal((k, X.shape[1]))).astype(np.float32)
    b0 = (0.01 * rng.standard_normal(k)).astype(np.float32)
    reg, tol = 0.05, 1e-7
    W, b, n_iter, converged, _ = logistic.logistic_warm_fit_kernel(
        torch.from_numpy(Xc), torch.from_numpy(y.astype(np.int64)), torch.from_numpy(w), torch.from_numpy(W0),
        torch.from_numpy(b0), reg, l1_ratio, tol, k=k, fit_intercept=True, max_iter=300, use_owlqn=l1_ratio > 0,
    )
    rW, rb, _, r_conv = ref_logistic.logistic_warm_fit_kernel(
        jnp.asarray(Xc), jnp.asarray(y), jnp.asarray(w), jnp.asarray(W0), jnp.asarray(b0),
        jnp.asarray(reg, jnp.float32), jnp.asarray(l1_ratio, jnp.float32), jnp.asarray(tol, jnp.float32),
        k=k, fit_intercept=True, max_iter=300, use_owlqn=l1_ratio > 0,
    )
    assert converged and bool(r_conv) and W.shape == (k, X.shape[1])
    np.testing.assert_allclose(W.numpy(), np.asarray(rW), atol=LOGISTIC_ATOL)
    np.testing.assert_allclose(b.numpy(), np.asarray(rb), atol=LOGISTIC_ATOL)


def test_streamed_logreg_metric_quality(clustered_data):
    X, cid, _ = clustered_data
    rng = np.random.default_rng(5)
    margin = X @ rng.standard_normal(X.shape[1])
    y = (margin > np.median(margin)).astype(np.float64)
    df = port.DataFrame.from_numpy(X, y, num_partitions=2)

    def acc(model):
        preds = np.concatenate([p["prediction"] for p in model.transform(df).partitions])
        return float((preds == y).mean())

    batch = port.LogisticRegression(maxIter=30).fit(df)
    streamed = _stream(port.LogisticRegression(maxIter=30).streaming(), X, cid, y).finalize()
    assert acc(streamed) >= acc(batch) - 0.03, (acc(streamed), acc(batch))
    np.testing.assert_array_equal(streamed.classes_, batch.classes_)
    declared = _stream(port.LogisticRegression(maxIter=30).streaming(classes=[1.0, 0.0]), X, cid, y).finalize()
    np.testing.assert_array_equal(declared.coef_, streamed.coef_)


# -- loud failures ----------------------------------------------------------


def test_chunk_length_mismatches_fail(exact_data):
    X, y, _ = exact_data
    eng = port.LinearRegression(maxIter=20).streaming()
    with pytest.raises(ValueError, match="chunk y has 50 rows but X has 100"):
        eng.partial_fit(X[:100], y=y[:50])
    with pytest.raises(ValueError, match="chunk weight has"):
        eng.partial_fit(X[:100], y=y[:100], weight=np.ones(99))
    with pytest.raises(ValueError, match="need labels"):
        eng.partial_fit(X[:100])
    with pytest.raises(ValueError, match="2-D"):
        eng.partial_fit(X[0])
    with pytest.raises(ValueError, match="y/weight only with numpy"):
        eng.partial_fit(port.DataFrame.from_numpy(X[:8], y[:8]), y=y[:8])
    eng.partial_fit(X[:100], y=y[:100])
    with pytest.raises(ValueError, match="stream width"):
        eng.partial_fit(X[:100, :4], y=y[:100])
    assert eng.rows_ingested == 100 and eng.chunks_ingested == 1


def test_logreg_label_failures(clustered_data):
    X, cid, _ = clustered_data
    m0 = cid == 0
    y0 = (X[m0, 0] > 0).astype(np.float64)
    eng = port.LogisticRegression(maxIter=5).streaming()
    with pytest.raises(ValueError, match="single label class"):
        eng.partial_fit(X[m0], y=np.ones(int(m0.sum())))
    eng.partial_fit(X[m0], y=y0)
    m1 = cid == 1
    with pytest.raises(ValueError, match="outside the stream's class set"):
        eng.partial_fit(X[m1], y=np.full(int(m1.sum()), 7.0))
    with pytest.raises(RuntimeError, match="no chunks"):
        port.LogisticRegression().streaming().state
    with pytest.raises(TypeError, match="no streaming engine"):
        streaming_fit(port.RandomForestClassifier())


def test_engines_raise_without_cuda(monkeypatch, exact_data):
    X, y, _ = exact_data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with use_device(None):
        for est, labels in ((port.LinearRegression(), y), (port.PCA(k=2), None), (port.KMeans(k=2), None),
                            (port.LogisticRegression(), (X[:, 0] > 0).astype(np.float64))):
            with pytest.raises(RuntimeError, match="use_device"):
                est.streaming().partial_fit(X[:64], y=None if labels is None else labels[:64])


# -- frames, counters, merges -----------------------------------------------


def test_frame_chunks_and_counters(exact_data):
    import pandas as pd

    X, y, cid = exact_data
    m = cid == 0
    profiling.reset_counters("stream.")
    eng_np = port.LinearRegression(maxIter=20).streaming().partial_fit(X[m], y=y[m])
    eng_df = port.LinearRegression(maxIter=20).streaming().partial_fit(port.DataFrame.from_numpy(X[m], y[m], num_partitions=2))
    eng_pd = port.LinearRegression(maxIter=20).streaming().partial_fit(pd.DataFrame({"features": list(X[m]), "label": y[m]}))
    assert eng_np.state == eng_df.state == eng_pd.state
    counts = profiling.counters("stream.")
    bucket = chunk_bucket(int(m.sum()))
    assert counts["stream.h2d_transfers"] == 9  # X, y and w, three engines
    assert counts["stream.bytes"] == 3 * bucket * 4 * (X.shape[1] + 2)
    assert counts["stream.rows"] == 3 * int(m.sum()) and counts["stream.chunks"] == 3
    assert "stream.update" in profiling.phase_times()


@pytest.mark.parametrize("lo", [1, 64, 256])
def test_bucket_lo_option_keeps_the_state(exact_data, lo):
    X, y, cid = exact_data
    assert chunk_bucket(100, lo) == max(lo, 128) and chunk_bucket(300, lo) == 512
    default = _stream(port.LinearRegression().streaming(), X, cid, y)
    other = _stream(port.LinearRegression().streaming(bucket_lo=lo), X, cid, y)
    assert other.state == default.state
    with pytest.raises(ValueError, match="bucket_lo"):
        port.LinearRegression().streaming(bucket_lo=0)


@pytest.mark.parametrize("kind", ["linreg", "pca", "logreg"])
def test_device_fold_equals_the_jax_host_fold(exact_data, kind, monkeypatch):
    """The port folds in float64 on the device the chunks run on, the JAX
    package reads each chunk's partials back and folds them in numpy: the
    same state bit for bit on the exact family (linear, PCA), staging
    buffers filled by the thread pool included.  The logistic running
    average is the state's float64 quotient, as the JAX engine's."""
    from spark_rapids_ml_tpu_torch.stream import engines

    monkeypatch.setattr(engines, "_PARALLEL_FILL_BYTES", 1024)
    X, y, cid = exact_data
    if kind == "logreg":
        yl = (X[:, 0] > 0).astype(np.float64)
        eng = _stream(port.LogisticRegression(maxIter=10).streaming(), X, cid, yl)
        st = eng.state.arrays
        wsum = max(float(st["wsum"]), 1e-30)
        model = eng.finalize()
        np.testing.assert_array_equal(model.coef_, st["WS"] / wsum)
        np.testing.assert_array_equal(model.intercept_, st["bs"] / wsum)
        return
    make = {"linreg": lambda pkg: pkg.LinearRegression().streaming(),
            "pca": lambda pkg: pkg.PCA(k=3).setInputCol("features").streaming()}[kind]
    labels = y if kind == "linreg" else None
    got, want = (_stream(make(pkg), X, cid, labels).state for pkg in (port, ref))
    for name, a in want.arrays.items():
        np.testing.assert_array_equal(got.arrays[name], a, err_msg=name)


def test_two_rank_merge_equals_single_stream(exact_data):
    X, y, cid = exact_data
    r0 = _stream(port.LinearRegression().streaming(), X, cid, y, chunks=[0, 1])
    r1 = _stream(port.LinearRegression().streaming(), X, cid, y, chunks=[2, 3])
    solo = _stream(port.LinearRegression().streaming(), X, cid, y)
    merged = r0.merge(json.loads(json.dumps(r1.state_dict())))
    assert merged.rows_ingested == r0.rows_ingested and merged.state == solo.state
    np.testing.assert_array_equal(merged.finalize().coef_, solo.finalize().coef_)


@pytest.mark.parametrize("kind", ["linreg", "logreg", "kmeans", "pca"])
def test_fresh_engine_adopts_peer_state(exact_data, kind):
    X, y, cid = exact_data
    est, labels = {
        "linreg": (lambda: port.LinearRegression(), y),
        "logreg": (lambda: port.LogisticRegression(maxIter=10), (X[:, 0] > 0).astype(np.float64)),
        "kmeans": (lambda: port.KMeans(k=3, maxIter=5, seed=1), None),
        "pca": (lambda: port.PCA(k=2), None),
    }[kind]
    peer = _stream(est().streaming(), X, cid, labels)
    fresh = est().streaming().merge(peer)
    assert fresh.state == peer.state and fresh.rows_ingested == peer.rows_ingested
    a, b = fresh.finalize(), peer.finalize()
    for name, v in b._get_model_attributes().items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(a._get_model_attributes()[name], v, err_msg=name)


def test_allgather_merge_over_a_control_plane(exact_data):
    """Two ranks through a stub control plane: this rank's state and a JAX
    rank's wire form, folded in rank order."""
    X, y, cid = exact_data
    mine = _stream(port.LinearRegression().streaming(), X, cid, y, chunks=[0, 1])
    peer = _stream(ref.LinearRegression().streaming(), X, cid, y, chunks=[2, 3])

    class TwoRanks:
        def allGather(self, msg):
            return [msg, json.dumps(peer.state_dict())]

    merged = allgather_merge(TwoRanks(), mine.state)
    assert merged == _stream(port.LinearRegression().streaming(), X, cid, y).state
    assert allgather_merge(LocalControlPlane(), mine.state) == mine.state  # one controller: identity


# -- the session --------------------------------------------------------------


def test_session_staleness_and_refresh_accounting(clustered_data):
    X, cid, k = clustered_data
    session = StreamingSession(port.KMeans(k=k, maxIter=5, seed=1).streaming())
    session.partial_fit(X[cid == 0])
    assert session.staleness_rows == int((cid == 0).sum()) and session.staleness_chunks == 1
    assert session.staleness_seconds is None
    model = session.refresh()
    assert isinstance(model, port.KMeansModel) and model.cluster_centers_.shape == (k, X.shape[1])
    assert session.staleness_rows == 0 and session.stats()["refreshes"] == 1
    session.partial_fit(X[cid == 1])
    assert session.staleness_rows == int((cid == 1).sum()) and session.staleness_seconds >= 0.0
    with pytest.raises(ValueError, match="model name"):
        StreamingSession(session.engine, registry=object())


def test_session_ingest_refresh_every_rows(clustered_data):
    X, cid, k = clustered_data
    session = StreamingSession(port.KMeans(k=k, maxIter=5, seed=1).streaming())
    before = profiling.counters("stream.refreshes").get("stream.refreshes", 0)
    session.ingest(iter([X[cid == c] for c in range(int(cid.max()) + 1)]), refresh_every_rows=512)
    assert session.stats()["refreshes"] == 2 and session.rows_ingested == len(X)
    assert profiling.counters("stream.refreshes")["stream.refreshes"] - before == 2


def test_session_registers_then_swaps(clustered_data):
    """The first refresh registers the snapshot in a port ModelRegistry and
    serves it on a port Router, every later one swaps it in; the served
    labels are the snapshot's."""
    from spark_rapids_ml_tpu_torch.serving import ModelRegistry, Router

    X, cid, k = clustered_data
    with ModelRegistry() as registry, Router(replicas=1) as router:
        session = StreamingSession(port.KMeans(k=k, maxIter=5, seed=1).streaming(), name="km", registry=registry,
                                   router=router, max_batch=32, max_wait_ms=1)
        session.partial_fit(X[cid == 0])
        first = session.refresh()
        assert registry.names() == ["km"] and router.names() == ["km"]
        session.partial_fit(X[cid == 1])
        second = session.refresh()
        assert first is not second
        assert registry.get("km").model is second and router.replicas("km")[0].model is second
        assert profiling.counters("serving.km.swaps")["serving.km.swaps"] >= 1
        assert profiling.counters("router.km.swaps")["router.km.swaps"] >= 1
        want = second.transform(port.DataFrame.from_numpy(X[:16])).partitions[0]["prediction"]
        np.testing.assert_array_equal(registry.get("km").predict(X[:16])["prediction"], want)
        np.testing.assert_array_equal(router.predict("km", X[:16])["prediction"], want)


def test_session_refreshes_serialize(clustered_data):
    """Concurrent refresh() calls do not interleave their swaps: one
    register, then one swap each."""
    from spark_rapids_ml_tpu_torch.serving import ModelRegistry

    X, cid, k = clustered_data
    with ModelRegistry(max_batch=16, max_wait_ms=1) as registry:
        session = StreamingSession(port.KMeans(k=k, maxIter=5, seed=1).streaming(), name="km_ser",
                                   registry=registry)
        session.partial_fit(X[cid == 0])
        before = profiling.counters("serving.km_ser.swaps").get("serving.km_ser.swaps", 0)
        threads = [threading.Thread(target=session.refresh) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert profiling.counters("serving.km_ser.swaps")["serving.km_ser.swaps"] - before == 3
        assert registry.names() == ["km_ser"] and session.stats()["refreshes"] == 4
        assert registry.get("km_ser").model is session._model


def test_engine_classes(exact_data):
    for est, cls in ((port.PCA(), StreamingPCA), (port.LinearRegression(), StreamingLinearRegression),
                     (port.KMeans(), StreamingKMeans), (port.LogisticRegression(), StreamingLogisticRegression)):
        assert type(est.streaming()) is cls and type(streaming_fit(est)) is cls
