# The port's seeded draws that follow jax.random, on the CPU, against the JAX
# package and jax.random: XLA's float32 log (ops/xla_math.log_f32), the
# Gumbel and Poisson draws (ops/prng.gumbel / poisson), the KMeans inits'
# key chains (ops/kmeans.random_init / scalable_kmeans_pp_init) and what
# trains through them (KMeans, StreamingKMeans, the IVF coarse quantizer),
# and the forest's bootstrap on the histogram builder's route (the engine
# route's forests are held node for node in test_torch_forest_engine.py).
#
# Tolerances: log_f32, the float32 Gumbel and Poisson draws, the key chains
# and the inits' picks on integer data are equal bit for bit; a float64
# Gumbel draw within 2e-15 (torch's float64 log and the CPU's libm round
# a last bit apart, which the outer log carries near 0);
# fitted centres within 1e-4 (float32 sums in another order than XLA's);
# the builder's bootstrap weights bit for bit and its classification trees
# node for node against forest_mxu in interpret mode (impurities to 1e-6).
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import spark_rapids_ml_tpu as ref
from spark_rapids_ml_tpu.ann.ivfflat import train_coarse_quantizer as ref_train_coarse_quantizer
from spark_rapids_ml_tpu.compat import enable_x64
from spark_rapids_ml_tpu.dataframe import DataFrame as RefDataFrame
from spark_rapids_ml_tpu.ops import kmeans as ref_kmeans
from spark_rapids_ml_tpu.ops.forest_mxu import grow_forest_mxu

import spark_rapids_ml_tpu_torch as port
from spark_rapids_ml_tpu_torch.ann.ivfflat import train_coarse_quantizer
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.ops import forest_grow, prng
from spark_rapids_ml_tpu_torch.ops import kmeans as port_kmeans
from spark_rapids_ml_tpu_torch.ops.xla_math import log_f32
from spark_rapids_ml_tpu_torch.parallel.mesh import Mesh, shard_rows

CPU = torch.device("cpu")
CENTER_ATOL = 1e-4
SEEDS = [0, 7, 104734, 2**31 - 1]


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


def _bits(a):
    return np.asarray(a).view(np.uint32)


# -- XLA's float32 log ---------------------------------------------------------


def test_log_f32_matches_jnp_log():
    """10^6 seeded float32 over (0, 88] and [tiny, 1) (the ranges Gumbel's
    two logs, the Poisson sum and log(max(cost, 1e-30)) reach), plus the
    edges, bit for bit; NaN where jnp.log gives NaN."""
    rng = np.random.default_rng(0)
    tiny = np.finfo(np.float32).tiny
    pats = np.concatenate([
        rng.integers(1, 0x42B00001, size=500_000, dtype=np.uint32),
        rng.integers(0x00800000, 0x3F800000, size=500_000, dtype=np.uint32),
    ])
    edges = np.array([tiny, np.nextafter(np.float32(1), np.float32(0)), 1e-30, 0.0, -0.0, 1e-45, 1.0, 88.0,
                      np.inf, -1.0, np.nan, 3.4e38, 0.5, 0.70710677, 0.7071068], np.float32)
    x = np.concatenate([pats.view(np.float32), edges])
    want = np.asarray(jax.jit(jnp.log)(x))
    got = log_f32(torch.from_numpy(x)).numpy()
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(_bits(got)[~nan], _bits(want)[~nan])


# -- Gumbel and Poisson --------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(100_003,), (37, 101)], ids=["vector", "matrix"])
def test_gumbel_matches_jax(seed, shape):
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), shape))
    got = prng.gumbel(prng.prng_key(seed), shape).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_gumbel_at_and_batched_keys():
    """Chosen flat positions of one draw, and one draw a key of a batch of
    split keys, as the KMeans inits take them."""
    jk = jax.random.PRNGKey(11)
    want = np.asarray(jax.random.gumbel(jk, (5000,)))
    idx = torch.tensor([0, 1, 4098, 4999, 2500])
    np.testing.assert_array_equal(_bits(prng.gumbel_at(prng.prng_key(11), idx).numpy()), _bits(want[idx.numpy()]))
    keys = prng.split(prng.prng_key(11), 3)
    batch = prng.gumbel(keys, (777,)).numpy()
    for i, k in enumerate(jax.random.split(jk, 3)):
        np.testing.assert_array_equal(_bits(batch[i]), _bits(jax.random.gumbel(k, (777,))))


def test_float64_gumbel_within_one_ulp():
    """An x64 fit's draw: the 64-bit words exactly, torch's float64 log:
    an ulp of the inner log apart at most, most draws bit for bit."""
    with enable_x64(True):
        want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(3), (20_000,)))
    got = prng.gumbel(prng.prng_key(3), (20_000,), torch.float64).numpy()
    assert want.dtype == got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-15)
    assert (got == want).mean() > 0.99


@pytest.mark.parametrize("seed", SEEDS)
def test_poisson_matches_jax(monkeypatch, seed):
    """jax.random.poisson(key, 1.0, (T, N)) bit for bit at ~10^5 elements,
    whose largest count is 7 or more (the Knuth loop's long tail), drawn
    whole and in chunks of the flat index."""
    shape = (3, 33_334)
    want = np.asarray(jax.random.poisson(jax.random.PRNGKey(seed), 1.0, shape))
    key = prng.prng_key(seed)
    got = prng.poisson(key, 1.0, shape)
    assert got.dtype == torch.int32
    assert want.max() >= 7
    np.testing.assert_array_equal(got.numpy(), want)
    monkeypatch.setattr(prng, "POISSON_CHUNK", 25_000)
    np.testing.assert_array_equal(prng.poisson(key, 1.0, shape).numpy(), want)
    cols = torch.arange(33_334 - 700, 33_334)
    window = prng.poisson_at(key, 1.0, torch.stack([cols, 2 * 33_334 + cols]))
    np.testing.assert_array_equal(window.numpy(), want[[0, 2]][:, -700:])


def test_poisson_other_rates():
    key, jk = prng.prng_key(5), jax.random.PRNGKey(5)
    lams = (0.0, 0.3, 4.5)
    wants = jax.device_get([jax.random.poisson(jk, lam, (2000,)) for lam in lams])
    for lam, want in zip(lams, wants):
        np.testing.assert_array_equal(prng.poisson(key, lam, (2000,)).numpy(), want)
    with pytest.raises(ValueError, match="Knuth"):
        prng.poisson(key, 12.0, (4,))


def test_split_chain_matches_split_loop():
    jk = jax.random.PRNGKey(9)
    subs, rest = prng.split_chain(prng.prng_key(9), 40)
    want = []
    for _ in range(40):
        jk, sub = jax.random.split(jk)
        want.append(jax.random.key_data(sub))
    np.testing.assert_array_equal(subs.numpy(), np.stack(jax.device_get(want)))
    np.testing.assert_array_equal(rest.numpy(), np.asarray(jax.random.key_data(jk)))


# -- the KMeans inits ----------------------------------------------------------


def _int_rows(n=1001, d=6, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-8, 9, size=(n, d)).astype(np.float32)


def _shards(a, n_shards):
    return shard_rows(a, Mesh((CPU,) * n_shards))[0]


@pytest.mark.parametrize("shards", [1, 8])
@pytest.mark.parametrize("init", ["random", "k-means||"])
@pytest.mark.parametrize("seed", [0, 11])
def test_inits_pick_the_jax_rows(shards, init, seed):
    """Same seed, same rows: the port on 1 and 8 shards (the padding past
    the valid rows weighs 0) against the JAX init on the JAX package's
    staged rows (padded to a multiple of 8, the padding weighing 0)."""
    X = _int_rows(seed=seed)
    n, k = X.shape[0], 7
    n_pad = -(-n // 8) * 8
    Xj = np.zeros((n_pad, X.shape[1]), np.float32)
    Xj[:n] = X
    wj = (np.arange(n_pad) < n).astype(np.float32)
    Xs = _shards(X, shards)
    ws = [w.float() for w in _shards(np.ones(n, np.float32), shards)]
    if init == "random":
        want = ref_kmeans.random_init(jnp.asarray(Xj), jnp.asarray(wj), k, seed)
        got = port_kmeans.random_init(Xs, ws, k, seed, n_rows=n)
    else:
        want = ref_kmeans.scalable_kmeans_pp_init(jnp.asarray(Xj), jnp.asarray(wj), k, seed, 2.0, rounds=4,
                                                  round_size=2 * k)
        got = port_kmeans.scalable_kmeans_pp_init(Xs, ws, k, seed, rounds=4, round_size=2 * k, chunk=256, n_rows=n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("init", ["random", "k-means||"])
def test_inits_in_row_chunks_pick_the_jax_rows(monkeypatch, init):
    """The inits' Gumbel-max keys made 37 rows at a time (chunks that
    straddle the 8 shards' edges) pick the JAX package's rows."""
    X = _int_rows(seed=5)
    n, k = X.shape[0], 7
    n_pad = -(-n // 8) * 8
    Xj = np.zeros((n_pad, X.shape[1]), np.float32)
    Xj[:n] = X
    wj = (np.arange(n_pad) < n).astype(np.float32)
    monkeypatch.setattr(port_kmeans, "_GUMBEL_ROWS", 37)
    Xs, ws = _shards(X, 8), [w.float() for w in _shards(np.ones(n, np.float32), 8)]
    if init == "random":
        want = ref_kmeans.random_init(jnp.asarray(Xj), jnp.asarray(wj), k, 5)
        got = port_kmeans.random_init(Xs, ws, k, 5, n_rows=n)
    else:
        want = ref_kmeans.scalable_kmeans_pp_init(jnp.asarray(Xj), jnp.asarray(wj), k, 5, 2.0, rounds=4,
                                                  round_size=2 * k)
        got = port_kmeans.scalable_kmeans_pp_init(Xs, ws, k, 5, rounds=4, round_size=2 * k, chunk=100, n_rows=n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_eager_picks_rescoring_every_position_pick_the_jax_rows(monkeypatch):
    """An eager k-means++ pick rescores with XLA's log the positions whose
    torch-log score lies within the margin of the best; with a margin that
    takes in every position the picks are still the JAX package's."""
    X = _int_rows(n=600, seed=4)
    w = np.ones(len(X), np.float32)
    want = np.asarray(ref_kmeans.scalable_kmeans_pp_init(jnp.asarray(X), jnp.asarray(w), 20, 8, 2.0, rounds=4,
                                                         round_size=40))
    monkeypatch.setattr(port_kmeans, "_PICK_MARGIN", 1e9)
    got = port_kmeans.scalable_kmeans_pp_init(torch.from_numpy(X), torch.from_numpy(w), 20, 8, rounds=4,
                                              round_size=40, chunk=128)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pick_draws_span_batches(monkeypatch):
    """The k-means++ picks' Gumbel rows drawn a few picks a batch equal the
    one-batch draw: the picks are the JAX package's either way."""
    X = _int_rows(n=600, seed=3)
    w = np.ones(len(X), np.float32)
    k = 20
    want = np.asarray(ref_kmeans.scalable_kmeans_pp_init(jnp.asarray(X), jnp.asarray(w), k, 4, 2.0, rounds=4,
                                                         round_size=2 * k))
    monkeypatch.setattr(port_kmeans, "_PICK_DRAW_ELEMS", 3 * (1 + 8 * k))
    got = port_kmeans.scalable_kmeans_pp_init(torch.from_numpy(X), torch.from_numpy(w), k, 4, rounds=4,
                                              round_size=2 * k, chunk=128)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shards", [1, 8])
@pytest.mark.parametrize("distinct", [3, 9])
def test_degenerate_pool_picks_the_jax_rows(distinct, shards):
    """Fewer distinct rows than k (3): the rounds take rows of cost 0 (the
    JAX top-k's ties, lower row first) and a pick falls back to any valid
    pool position, which the port, having drawn only the positions of
    positive weight first, draws over the whole pool again; 9 distinct
    rows for k 8 leave every pick a positive cost.  The JAX package's rows
    either way, on 1 and 8 shards."""
    rng = np.random.default_rng(distinct)
    X = rng.integers(-8, 9, size=(distinct, 5)).astype(np.float32)[rng.integers(0, distinct, size=240)]
    w = np.ones(len(X), np.float32)
    want = np.asarray(ref_kmeans.scalable_kmeans_pp_init(jnp.asarray(X), jnp.asarray(w), 8, 6, 2.0, rounds=4,
                                                         round_size=16))
    got = port_kmeans.scalable_kmeans_pp_init(_shards(X, shards), [t.float() for t in _shards(w, shards)], 8, 6,
                                              rounds=4, round_size=16, chunk=64)
    np.testing.assert_array_equal(got.numpy(), want)


def _blobs(n=1200, d=8, k=6, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, size=(k, d))
    return (centers[rng.integers(0, k, size=n)] + rng.standard_normal((n, d))).astype(np.float32)


@pytest.mark.parametrize("init", ["k-means||", "random"])
def test_kmeans_fit_reaches_the_jax_centres(init):
    X = _blobs()
    kw = dict(k=6, initMode=init, maxIter=40, seed=13)
    m_ref = ref.KMeans(**kw).fit(RefDataFrame.from_numpy(X, num_partitions=2))
    m = port.KMeans(**kw).fit(port.DataFrame.from_numpy(X, num_partitions=2))
    np.testing.assert_allclose(m.cluster_centers_, m_ref.cluster_centers_, rtol=0, atol=CENTER_ATOL)
    assert m.n_iter_ == m_ref.n_iter_


def test_streaming_kmeans_reaches_the_jax_centres():
    X = _blobs(n=1500, seed=2)
    kw = dict(k=6, maxIter=30, seed=21)
    eng_ref, eng = ref.KMeans(**kw).streaming(), port.KMeans(**kw).streaming()
    for lo in range(0, len(X), 500):
        eng_ref.partial_fit(X[lo : lo + 500])
        eng.partial_fit(X[lo : lo + 500])
    np.testing.assert_allclose(eng.finalize().cluster_centers_, eng_ref.finalize().cluster_centers_, rtol=0,
                               atol=CENTER_ATOL)


@pytest.mark.parametrize("n_clusters,max_train_rows", [(16, 100_000), (8, 700)], ids=["all_rows", "sampled"])
def test_coarse_quantizer_reaches_the_jax_centroids(n_clusters, max_train_rows):
    """The IVF coarse quantizer (and so every PQ codebook, trained by the
    same function) from the same seed, on all rows and on a seeded
    sample."""
    items = _blobs(n=2000, d=16, k=12, seed=5)
    want = ref_train_coarse_quantizer(items, n_clusters, 17, max_train_rows=max_train_rows)
    got = train_coarse_quantizer(items, n_clusters, 17, max_train_rows=max_train_rows, device=CPU)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=CENTER_ATOL)


# -- the forest's bootstrap on the histogram builder -------------------------------


@pytest.mark.parametrize("strategy", ["sqrt", "onethird"])
def test_builder_bootstrap_is_the_jax_draw(monkeypatch, strategy):
    """A default (bootstrapped) one-shard classifier grows on the histogram
    builder: its w_trees are the JAX package's (weight x
    jax.random.poisson(PRNGKey((seed + 104729) & 0x7FFFFFFF), 1.0,
    (n_trees, n_pad))) bit for bit, and the trees grown from them equal
    forest_mxu's in interpret mode from the same bins, weights and seed."""
    rng = np.random.default_rng(8)
    # 9 features: sqrt and onethird both pick 3 a split, so the two cases
    # share forest_mxu's interpret-mode compile
    n, d = 2000, 9
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (X @ rng.standard_normal(d) > 0).astype(np.float32)
    seen = {}
    real = forest_grow.grow_forest

    def spy(bins_fm, base_stats, w_trees, stats3, edges, **kw):
        seen.update(bins_fm=bins_fm.clone(), base=base_stats.clone(), w_trees=w_trees.clone(),
                    edges=np.asarray(edges), kw=kw)
        seen["out"] = real(bins_fm, base_stats, w_trees, stats3, edges, **kw)
        return seen["out"]

    import spark_rapids_ml_tpu_torch.models.random_forest as rf

    monkeypatch.setattr(rf, "grow_forest", spy)
    seed, trees = 6, 2
    port.RandomForestClassifier(numTrees=trees, maxDepth=4, maxBins=16, featureSubsetStrategy=strategy,
                                seed=seed).fit(port.DataFrame.from_numpy(X, y))
    n_pad = seen["w_trees"].shape[1]
    assert n_pad == 2048
    counts = jax.random.poisson(jax.random.PRNGKey((seed + 104729) & 0x7FFFFFFF), 1.0, (trees, n_pad))
    want_w = np.asarray(counts).astype(np.float32) * (np.arange(n_pad) < n)
    np.testing.assert_array_equal(seen["w_trees"].numpy(), want_w)
    kw = seen["kw"]
    want = grow_forest_mxu(
        jnp.asarray(seen["bins_fm"].numpy()), jnp.asarray(seen["base"].numpy()), jnp.asarray(want_w), None,
        seen["edges"], y_vals=jnp.asarray(kw["y_vals"].numpy()), interpret=True, max_depth=kw["max_depth"],
        n_bins=kw["n_bins"], kind=kw["kind"], max_features=kw["max_features"],
        min_samples_leaf=kw["min_samples_leaf"], min_impurity_decrease=kw["min_impurity_decrease"], seed=kw["seed"],
    )
    got = [np.asarray(a) for a in seen["out"]]
    want = [np.asarray(a) for a in want]
    assert (got[0][:, 0] >= 0).all()
    for name, a, b in zip(("features", "thresholds", "leaf_values", "node_counts"), got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_allclose(got[4], want[4], rtol=0, atol=1e-6)
