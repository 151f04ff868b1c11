# The port's random-forest scatter engine (spark_rapids_ml_tpu_torch.ops.forest
# .grow_forest), the sharding rule of the histogram kernel
# (ops/forest_hist.node_histograms_sharded) and the forest estimators on a
# mesh, against the JAX package's on the same numpy inputs, on the CPU: the
# port on use_device(["cpu"] * 8) (or 1, 2 shards), the JAX package on its 8
# forced CPU devices, its engine run as tests/test_forest_engine.py runs it
# (grow_forest(mesh=get_mesh(1)) and grow_forest(mesh=get_mesh())), its
# histogram kernel in interpret mode.
#
# Tolerances, stated per test: on integer-valued stats (one-hot classes times
# integer weights, small integer regression targets) every histogram sum is
# exact, so all five forest arrays are equal bit for bit across packages and
# shard counts (the port rounds the products XLA contracts into fused
# multiply-adds once, as XLA does); entropy impurities within 1e-6 absolute
# against the JAX package (torch's log and XLA's may round apart by an ulp).
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spark_rapids_ml_tpu as ref
from spark_rapids_ml_tpu import profiling as ref_profiling
from spark_rapids_ml_tpu.dataframe import DataFrame as RefDataFrame
from spark_rapids_ml_tpu.ops import forest as ref_forest
from spark_rapids_ml_tpu.ops import forest_hist as ref_forest_hist
from spark_rapids_ml_tpu.parallel.mesh import get_mesh as ref_get_mesh

import spark_rapids_ml_tpu_torch as port
from spark_rapids_ml_tpu_torch import profiling
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.ops import forest, forest_hist
from spark_rapids_ml_tpu_torch.parallel.mesh import Mesh, shard_rows

CPU = torch.device("cpu")
ENTROPY_ATOL = 1e-6
ARRAYS = ("features_", "thresholds_", "leaf_values_", "node_counts_", "impurities_")


def _grow_fixture(n=1024, d=6, B=16, T=3, seed=4, kind="gini"):
    """The JAX suite's engine fixture: binned Gaussian rows; two-class
    one-hot stats (gini) or small-integer regression stats (w, wy, wy^2)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    edges = ref_forest.compute_bin_edges(X, B)
    Xb = np.asarray(ref_forest.bin_features(jnp.asarray(X), jnp.asarray(edges)))
    if kind == "regression":
        y = rng.integers(0, 8, size=n).astype(np.float32)
        stats = np.stack([np.ones(n), y, y * y], axis=1).astype(np.float32)
    else:
        y = (X @ rng.standard_normal(d) > 0).astype(np.float32)
        stats = np.stack([1.0 - y, y], axis=1).astype(np.float32)
    stats_t = np.broadcast_to(stats[None], (T, n, stats.shape[1])).copy()
    return Xb, stats_t, edges


def _port_inputs(Xb, stats_t, n_dev):
    """The JAX engine's row-major (N, D) bins and (T, N, S) stats as the
    port's per-shard (D, n_loc) bins and (S, T, n_loc) stats."""
    mesh = Mesh((CPU,) * n_dev)
    bins = [b.T.contiguous() for b in shard_rows(Xb, mesh)[0]]
    stats = [s.permute(2, 1, 0).contiguous() for s in shard_rows(stats_t.transpose(1, 0, 2).copy(), mesh)[0]]
    return bins, stats


def _assert_forests_equal(got, want, impurity_atol=0.0):
    for name, a, b in zip(ARRAYS, got, want):
        if name == "impurities_" and impurity_atol:
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=impurity_atol, err_msg=name)
        else:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


ENGINE_CASES = {
    "gini_all_features": dict(kind="gini", max_features=6),
    "gini_subset": dict(kind="gini", max_features=3),
    "entropy_subset": dict(kind="entropy", max_features=2),
    "regression_subset": dict(kind="regression", max_features=4),
}


@pytest.mark.parametrize("n_dev", [1, 8])
@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_matches_the_jax_engine_node_for_node(case, n_dev):
    """Port grow_forest == JAX grow_forest (bootstrap off) on 1 and 8
    shards, feature subsets drawn bit for bit with jax.random."""
    p = ENGINE_CASES[case]
    Xb, stats_t, edges = _grow_fixture(kind="regression" if p["kind"] == "regression" else "gini")
    kw = dict(max_depth=5, n_bins=16, kind=p["kind"], max_features=p["max_features"],
              min_samples_leaf=1.0, min_impurity_decrease=0.0, seed=11)
    want = ref_forest.grow_forest(jnp.asarray(Xb), jnp.asarray(stats_t), edges,
                                  mesh=ref_get_mesh(1) if n_dev == 1 else ref_get_mesh(), **kw)
    bins, stats = _port_inputs(Xb, stats_t, n_dev)
    got = forest.grow_forest(bins, stats, edges, **kw)
    assert (got[0] >= 0).sum() > 5  # the trees split
    _assert_forests_equal(got, want, ENTROPY_ATOL if p["kind"] == "entropy" else 0.0)


def test_engine_counters_match_the_jax_engine():
    """One block dispatch and one flag read per LEVEL_BLOCK levels, one
    transfer of the forest: the JAX engine's counters at its default
    block."""
    Xb, stats_t, edges = _grow_fixture()
    kw = dict(max_depth=5, n_bins=16, kind="gini", max_features=6, min_samples_leaf=1.0,
              min_impurity_decrease=0.0, seed=3)
    r0 = ref_profiling.counters("forest")
    ref_forest.grow_forest(jnp.asarray(Xb), jnp.asarray(stats_t), edges, mesh=ref_get_mesh(), **kw)
    want = ref_profiling.counter_deltas(r0, "forest")
    c0 = profiling.counters("forest")
    forest.grow_forest(*_port_inputs(Xb, stats_t, 8), edges, **kw)
    got = profiling.counter_deltas(c0, "forest")
    for name in ("forest.levels.dispatches", "forest.level_syncs", "forest.d2h_transfers"):
        assert got.get(name) == want.get(name), name
    assert got["forest.d2h_transfers"] == 1
    assert profiling.counters("exchange.forest.hist_parts.calls")


def test_early_stop_skips_dead_level_blocks():
    """Constant features leaf every tree at the root: one block runs."""
    n, T = 256, 2
    Xb = np.zeros((n, 4), np.int8)
    y = np.zeros(n, np.float32)
    y[::2] = 1.0
    stats_t = np.broadcast_to(np.stack([1.0 - y, y], axis=1)[None], (T, n, 2)).copy()
    c0 = profiling.counters("forest")
    f, t, v, ns, imp = forest.grow_forest(*_port_inputs(Xb, stats_t, 8), np.zeros((4, 7), np.float32), max_depth=9,
                                          n_bins=8, kind="gini", max_features=4, min_samples_leaf=1.0,
                                          min_impurity_decrease=0.0, seed=0)
    assert profiling.counter_deltas(c0, "forest").get("forest.levels.dispatches") == 1
    assert (f == -1).all()
    np.testing.assert_allclose(ns[:, 0], n)


def test_engine_min_samples_and_depth_gates():
    Xb, stats_t, edges = _grow_fixture(n=512, T=2, seed=12)
    f, t, v, ns, imp = forest.grow_forest(*_port_inputs(Xb, stats_t, 8), edges, max_depth=3, n_bins=16, kind="gini",
                                          max_features=6, min_samples_leaf=40.0, min_impurity_decrease=0.0, seed=5)
    split = f >= 0
    assert ns[split].min() >= 2 * 40.0
    assert not split[:, 7:].any()


def test_wide_bins_count_every_edge():
    """bin_features_wide past 127 edges: int16 bins, each the count of the
    edges strictly below x, as the JAX package's bin_features."""
    X = np.random.default_rng(0).standard_normal((300, 5)).astype(np.float32)
    edges = ref_forest.compute_bin_edges(X, 200)
    got = forest.bin_features_wide(torch.from_numpy(X), torch.from_numpy(edges), 300)
    assert got.dtype == torch.int16
    want = np.asarray(ref_forest.bin_features(jnp.asarray(X), jnp.asarray(edges)))
    np.testing.assert_array_equal(got.numpy().T, want)


# -- the sharding rule of the histogram kernel ------------------------------------


def test_sharded_histogram_rule_matches_all_rows_and_the_jax_rule():
    """node_histograms_sharded: B3's function on each of 8 shards, one psum:
    bit for bit node_histograms over all rows (integer stats), and the JAX
    package's node_histograms_sharded (interpret mode) within its own
    test's tolerance."""
    n_dev, rows = 8, 2048
    N = n_dev * rows
    rng = np.random.default_rng(6)
    T, nodes, S, B = 2, 4, 2, 16
    sub = rng.integers(0, B, (forest_hist.F_BLOCK, N)).astype(np.int8)
    node_rel = rng.integers(0, nodes + 2, (T, N)).astype(np.int32)
    stats = rng.integers(0, 4, (T * S, N)).astype(np.float32)
    shard = lambda a: [torch.from_numpy(a[:, i * rows : (i + 1) * rows].copy()) for i in range(n_dev)]  # noqa: E731
    c0 = profiling.counters("exchange.forest.hist_parts")
    got = forest_hist.node_histograms_sharded(shard(sub), shard(node_rel), shard(stats), T, nodes, S, B)
    assert profiling.counter_deltas(c0, "exchange.forest.hist_parts").get("exchange.forest.hist_parts.calls") == 1
    assert len(got) == n_dev
    whole = forest_hist.node_histograms(torch.from_numpy(sub), torch.from_numpy(node_rel), torch.from_numpy(stats),
                                        T, nodes, S, B)
    np.testing.assert_array_equal(got[0].numpy(), whole.numpy())
    want = np.asarray(ref_forest_hist.node_histograms_sharded(
        jnp.asarray(sub), jnp.asarray(node_rel), jnp.asarray(stats), mesh=ref_get_mesh(), t_pack=T, nodes=nodes,
        s_dim=S, n_bins=B, interpret=True,
    ))
    np.testing.assert_allclose(got[0].numpy(), want, rtol=2e-2, atol=1e-3)


# -- the estimators on a mesh ------------------------------------------------------


def _cls_data(n=512, d=10, k=3, seed=1):
    from sklearn.datasets import make_classification

    X, y = make_classification(n_samples=n, n_features=d, n_informative=min(6, d - 2), n_classes=k, random_state=seed)
    return X.astype(np.float32), y.astype(np.float32)


def _int_reg_data(n=512, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype(np.float32), rng.integers(0, 8, size=n).astype(np.float32)


FIXTURES = {
    "classifier": (_cls_data, port.RandomForestClassifier, ref.RandomForestClassifier,
                   dict(numTrees=6, maxDepth=5, maxBins=16, seed=5)),
    "regressor": (_int_reg_data, port.RandomForestRegressor, ref.RandomForestRegressor,
                  dict(numTrees=4, maxDepth=5, maxBins=16, seed=2)),
}


@pytest.mark.parametrize("which", sorted(FIXTURES))
def test_estimators_on_eight_shards_equal_the_jax_estimators(which):
    """The forests of the JAX suite's mesh-parity fixtures, bootstrap off,
    on 8 shards of the port and 8 devices of the JAX package: node for
    node."""
    data, port_cls, ref_cls, kw = FIXTURES[which]
    X, y = data()
    kw = dict(kw, bootstrap=False)
    with use_device(["cpu"] * 8):
        m = port_cls(**kw).fit(port.DataFrame.from_numpy(X, y, num_partitions=2))
    m_ref = ref_cls(**kw).fit(RefDataFrame.from_numpy(X.astype(np.float64), y=y.astype(np.float64), num_partitions=2))
    _assert_forests_equal([getattr(m, a) for a in ARRAYS], [getattr(m_ref, a) for a in ARRAYS])


@pytest.mark.parametrize("strategy", ["sqrt", "onethird"])
@pytest.mark.parametrize("which", sorted(FIXTURES))
def test_bootstrapped_estimators_on_eight_shards_equal_the_jax_estimators(which, strategy):
    """Bootstrap on, as Spark's default: the port draws the JAX package's
    Poisson counts (PRNGKey(seed) split once a tree chunk, the (Tc, N) draw
    at N the JAX package's padded rows), so its forests on 8 shards equal
    the JAX package's on 8 devices node for node, here on 509 rows (not a
    multiple of 8: the padded N is the JAX package's, not the valid rows)."""
    data, port_cls, ref_cls, kw = FIXTURES[which]
    X, y = data(n=509)
    kw = dict(kw, featureSubsetStrategy=strategy)
    with use_device(["cpu"] * 8):
        m = port_cls(**kw).fit(port.DataFrame.from_numpy(X, y, num_partitions=2))
    m_ref = ref_cls(**kw).fit(RefDataFrame.from_numpy(X.astype(np.float64), y=y.astype(np.float64), num_partitions=2))
    _assert_forests_equal([getattr(m, a) for a in ARRAYS], [getattr(m_ref, a) for a in ARRAYS])


@pytest.mark.parametrize("shards,params", [(1, dict(maxDepth=12)), (2, dict(maxDepth=5))], ids=["1_shard", "2_shards"])
def test_bootstrapped_forest_is_one_forest_on_any_shard_count(shards, params):
    """Bootstrap on: the Poisson counts index global rows, so the 8-shard
    forest equals the 1-shard (maxDepth 12, past the histogram builder's
    slot budget, so both grow on the engine) and the 2-shard one bit for
    bit, all five arrays (integer class stats)."""
    X, y = _cls_data()
    kw = dict(numTrees=4, maxBins=16, seed=9, **params)
    df = port.DataFrame.from_numpy(X, y, num_partitions=2)
    with use_device(["cpu"] * 8):
        m8 = port.RandomForestClassifier(**kw).fit(df)
        acc = (np.concatenate([p["prediction"] for p in m8.transform(df).partitions]) == y).mean()
    with use_device(["cpu"] * shards):
        m = port.RandomForestClassifier(**kw).fit(df)
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(m8, name), getattr(m, name), err_msg=name)
    assert acc > 0.8


def test_mesh_forest_frees_its_feature_shards():
    """Once binned, the fit drops its feature shards and the cache slot that
    holds them."""
    from spark_rapids_ml_tpu_torch import core

    X, y = _int_reg_data(n=256)
    df = port.DataFrame.from_numpy(X, y)
    seen = []
    real = core._release_fit_features

    def spy(inputs):
        real(inputs)
        seen.append((inputs.X, core._FIT_INPUT_CACHE.get("slot")))

    import spark_rapids_ml_tpu_torch.models.random_forest as rf

    orig = rf._release_fit_features
    rf._release_fit_features = spy
    try:
        with use_device(["cpu"] * 4):
            port.RandomForestRegressor(numTrees=2, maxDepth=3, maxBins=8, seed=1).fit(df)
    finally:
        rf._release_fit_features = orig
    assert seen == [(None, None)]
