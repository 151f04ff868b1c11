# The port's srml-stream state (spark_rapids_ml_tpu_torch/stream/state.py)
# and stream_chunk_ids against the JAX package's, on the CPU: the wire form
# both ways, the merge algebra, the anchor and schema failures, and merges
# of a port state with a JAX state.
#
# Tolerances: none.  The states are float64 host arrays of exact float32
# partials (integer-valued data, pow2 chunks), so every comparison is bit
# for bit (np.array_equal), as the JAX package's own merge gates are.
import json

import numpy as np
import pytest

import spark_rapids_ml_tpu as ref
from spark_rapids_ml_tpu.dataframe import stream_chunk_ids as ref_stream_chunk_ids
from spark_rapids_ml_tpu.stream import StreamState as RefStreamState
from spark_rapids_ml_tpu.stream import merge_all as ref_merge_all

import spark_rapids_ml_tpu_torch as port
from spark_rapids_ml_tpu_torch.convert import stream_state_from_reference
from spark_rapids_ml_tpu_torch.dataframe import stream_chunk_ids
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.stream import StreamState, allgather_merge, merge_all
from spark_rapids_ml_tpu_torch.stream.state import KINDS, WIRE_SCHEMA

CHUNK = 128


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


@pytest.fixture(scope="module")
def exact_data():
    """The JAX tests' exact family: small integers, pow2 rows."""
    rng = np.random.default_rng(3)
    n, d = 512, 8
    X = rng.integers(-4, 5, size=(n, d)).astype(np.float32)
    y = (X @ np.arange(1.0, d + 1.0)).astype(np.float64)
    return X, y, stream_chunk_ids(n, CHUNK, seed=5)


def _engines(pkg, kind):
    """A configured estimator's engine of `kind` in package `pkg`."""
    return {
        "linreg": lambda: pkg.LinearRegression(maxIter=20).streaming(),
        "pca": lambda: pkg.PCA(k=3).setInputCol("features").streaming(),
        "kmeans": lambda: pkg.KMeans(k=3, maxIter=5, seed=1).setFeaturesCol("features").streaming(),
        "logreg": lambda: pkg.LogisticRegression(maxIter=10).streaming(),
    }[kind]()


def _labels(kind, X, y):
    if kind == "linreg":
        return y
    if kind == "logreg":
        return (X[:, 0] > 0).astype(np.float64)
    return None


def _ingest(engine, kind, X, y, cid, chunks):
    labels = _labels(kind, X, y)
    for c in chunks:
        m = cid == c
        engine.partial_fit(X[m], y=None if labels is None else labels[m])
    return engine


@pytest.mark.parametrize("kind", ["linreg", "pca", "kmeans", "logreg"])
def test_wire_round_trips_both_ways(exact_data, kind):
    X, y, cid = exact_data
    jax_eng = _ingest(_engines(ref, kind), kind, X, y, cid, [0])
    jax_dict = json.loads(json.dumps(jax_eng.state_dict()))
    from_jax = StreamState.from_dict(jax_dict)
    assert from_jax.kind == kind and set(from_jax.arrays) == set(jax_eng.state.arrays)
    for name, a in jax_eng.state.arrays.items():
        np.testing.assert_array_equal(from_jax.arrays[name], a)
    assert from_jax.to_dict() == jax_dict  # the same sorted layout, byte for byte
    assert json.dumps(from_jax.to_dict()) == json.dumps(jax_eng.state_dict())
    assert stream_state_from_reference(jax_dict) == from_jax

    port_eng = _ingest(_engines(port, kind), kind, X, y, cid, [0])
    port_dict = json.loads(json.dumps(port_eng.state_dict()))
    assert port_dict["schema"] == WIRE_SCHEMA == "srml-stream/v1"
    in_jax = RefStreamState.from_dict(port_dict)
    for name, a in port_eng.state.arrays.items():
        np.testing.assert_array_equal(in_jax.arrays[name], a)
    assert in_jax.to_dict() == port_dict


@pytest.mark.parametrize("kind", ["linreg", "pca"])
def test_merge_commutative_associative(exact_data, kind):
    X, y, cid = exact_data
    a, b, c = (_ingest(_engines(port, kind), kind, X, y, cid, [i]).state for i in range(3))
    ab_c = a.merge(b).merge(c)
    assert ab_c == a.merge(b.merge(c)) == b.merge(a).merge(c) == c.merge(b).merge(a)
    assert merge_all([a, b, c]) == ab_c
    assert StreamState.from_dict(json.loads(json.dumps(ab_c.to_dict()))) == ab_c
    # merge is pure: its operands are unchanged
    assert a == _ingest(_engines(port, kind), kind, X, y, cid, [0]).state


@pytest.mark.parametrize("kind", ["linreg", "pca", "logreg"])
def test_port_state_merges_with_jax_state_as_jax_merges(exact_data, kind):
    """Rank 0 runs the JAX package, rank 1 the port, on their own chunks:
    the port's merge of the two equals the JAX package's merge of its own
    two ranks, array for array."""
    X, y, cid = exact_data
    j0 = _ingest(_engines(ref, kind), kind, X, y, cid, [0, 1]).state
    j1 = _ingest(_engines(ref, kind), kind, X, y, cid, [2, 3]).state
    p1 = _ingest(_engines(port, kind), kind, X, y, cid, [2, 3]).state
    if kind != "logreg":  # chunk partials are exact: the port's rank equals the JAX rank
        for name, a in j1.arrays.items():
            np.testing.assert_array_equal(p1.arrays[name], a, err_msg=name)
    want = ref_merge_all([j0, j1 if kind != "logreg" else RefStreamState.from_dict(p1.to_dict())])
    got = stream_state_from_reference(j0.to_dict()).merge(p1)
    for name, a in want.arrays.items():
        np.testing.assert_array_equal(got.arrays[name], a, err_msg=name)
    # and the JAX package takes the port's merged state back
    back = RefStreamState.from_dict(got.to_dict())
    assert set(back.arrays) == set(want.arrays)


def test_jax_state_merges_into_a_port_engine(exact_data):
    """The port engine folds a JAX engine's state_dict: the merged engine
    finalizes as one port engine that saw every chunk."""
    X, y, cid = exact_data
    jax_half = _ingest(_engines(ref, "linreg"), "linreg", X, y, cid, [0, 1])
    port_half = _ingest(_engines(port, "linreg"), "linreg", X, y, cid, [2, 3])
    solo = _ingest(_engines(port, "linreg"), "linreg", X, y, cid, range(4))
    merged = port_half.merge(jax_half.state_dict())
    assert merged.state == solo.state
    np.testing.assert_array_equal(merged.finalize().coef_, solo.finalize().coef_)


@pytest.mark.parametrize("kind,field", [("kmeans", "init_centers"), ("logreg", "classes")])
def test_anchor_mismatch_fails(exact_data, kind, field):
    X, y, cid = exact_data
    a = _ingest(_engines(port, kind), kind, X, y, cid, [0]).state
    arrays = {n: v.copy() for n, v in a.arrays.items()}
    arrays[field] = arrays[field] + 1.0
    with pytest.raises(ValueError, match=field):
        a.merge(StreamState(kind, arrays))
    with pytest.raises(ValueError, match="identity anchor"):
        a.copy().add_({field: arrays[field]})
    # a JAX state with another anchor fails the same way
    other = _ingest(_engines(ref, kind), kind, X, y, cid, [1]).state.to_dict()
    if kind == "kmeans":  # the two packages' inits draw differently
        with pytest.raises(ValueError, match=field):
            a.merge(StreamState.from_dict(other))


def test_kind_field_and_shape_mismatch_fail(exact_data):
    X, y, cid = exact_data
    lin = _ingest(_engines(port, "linreg"), "linreg", X, y, cid, [0]).state
    pca = _ingest(_engines(port, "pca"), "pca", X, y, cid, [0]).state
    with pytest.raises(ValueError, match="kind"):
        lin.merge(pca)
    narrow = _ingest(_engines(port, "linreg"), "linreg", X[:, :4], y, cid, [0]).state
    with pytest.raises(ValueError, match="shape mismatch"):
        lin.merge(narrow)
    missing = StreamState("linreg", {n: a for n, a in lin.arrays.items() if n != "y2"})
    with pytest.raises(ValueError, match="field mismatch"):
        lin.merge(missing)
    with pytest.raises(ValueError, match="kind"):
        port.PCA(k=3).setInputCol("features").streaming().merge(lin)


@pytest.mark.parametrize("bad", ["schema", "kind", "data"])
def test_unknown_schema_or_kind_fails(exact_data, bad):
    X, y, cid = exact_data
    d = _ingest(_engines(ref, "linreg"), "linreg", X, y, cid, [0]).state_dict()
    if bad == "schema":
        d["schema"] = "srml-stream/v2"
        match = "schema"
    elif bad == "kind":
        d["kind"] = "forest"
        match = "kind"
    else:
        d["arrays"]["G"]["data"] = d["arrays"]["G"]["data"][:-1]
        match = "values for shape"
    with pytest.raises(ValueError, match=match):
        stream_state_from_reference(d)
    if bad != "data":
        with pytest.raises(ValueError, match=match):
            StreamState.from_dict(d)
    assert KINDS == ("kmeans", "pca", "linreg", "logreg")


def test_merge_all_and_allgather_of_zero_or_one(exact_data):
    X, y, cid = exact_data
    s = _ingest(_engines(port, "linreg"), "linreg", X, y, cid, [0]).state
    with pytest.raises(ValueError, match="zero states"):
        merge_all([])

    class Solo:
        def allGather(self, msg):
            return [msg]

    assert allgather_merge(Solo(), s) == s


@pytest.mark.parametrize(
    "n,chunk,seed", [(1000, 256, 9), (1000, 256, 10), (22, 3, 1), (513, 256, 1), (97, 10, 1), (512, 128, 5), (0, 256, 0)]
)
def test_stream_chunk_ids_equal_jax(n, chunk, seed):
    got = stream_chunk_ids(n, chunk, seed=seed)
    want = ref_stream_chunk_ids(n, chunk, seed=seed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if n:
        sizes = np.bincount(got)
        assert sizes[:-1].tolist() == [chunk] * (len(sizes) - 1) and 0 < sizes[-1] <= chunk


def test_stream_chunk_ids_rejects_zero_rows_a_chunk():
    with pytest.raises(ValueError, match="chunk_rows"):
        stream_chunk_ids(10, 0)
