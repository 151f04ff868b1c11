# The port's UMAP init, layout and transform (spark_rapids_ml_tpu_torch/
# ops/umap.py) against the JAX package's (spark_rapids_ml_tpu/ops/umap.py)
# on the CPU, each fed the same layout, embedding and graph: the counter-mode
# firing draws, SGD epochs against the JAX sharded step on a one-device
# mesh, the single-device reference layout, the spectral and random inits,
# whole fits, the transform staging and epochs, and the engine's counters.
#
# Tolerances: the firing draws and the random init bit for bit; 1 and 3
# epochs atol 1e-5 (XLA fuses multiply-adds and reduces in its own order).
# Early in the schedule (alpha near 1) the SGD epochs amplify one-ulp
# differences: the JAX layout's own output moves 6.6e-4 after 3 epochs from
# a start perturbed by one ulp, so there each epoch is checked from the
# JAX package's embedding and whole runs by their quality;
# the spectral init spans the JAX subspace (principal-angle cosines > 0.999:
# its normal draws agree to a few ulps); a whole fit's k=15 neighbor
# preservation within 0.01 of the JAX fit's, the JAX package's own
# tolerance between its two layouts.
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spark_rapids_ml_tpu.ops import umap as ref
from spark_rapids_ml_tpu.parallel.mesh import col_sharding, get_mesh as ref_get_mesh, padded_row_count

from spark_rapids_ml_tpu_torch import profiling
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.ops import prng
from spark_rapids_ml_tpu_torch.ops import umap as port

_A, _B = 1.577, 0.895


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


def _blob_graph(n=320, d=8, k=12, seed=0):
    rng = np.random.default_rng(seed)
    centers = 10.0 * rng.normal(size=(3, d))
    labels = rng.integers(0, 3, size=n)
    X = (centers[labels] + rng.normal(size=(n, d))).astype(np.float32)
    from sklearn.neighbors import NearestNeighbors as SkNN

    dists, ids = SkNN(n_neighbors=k).fit(X).kneighbors(X)
    return X, ids.astype(np.int64), dists.astype(np.float32)


def _fit_kwargs(n_epochs=120, seed=7, init="spectral"):
    return dict(
        n_components=2, a=_A, b=_B, n_epochs=n_epochs, learning_rate=1.0, init=init,
        set_op_mix_ratio=1.0, local_connectivity=1.0, repulsion_strength=1.0,
        negative_sample_rate=5, seed=seed,
    )


def _neighbor_preservation(X, emb, k=15):
    from sklearn.neighbors import NearestNeighbors as SkNN

    _, hi = SkNN(n_neighbors=k + 1).fit(X).kneighbors(X)
    _, lo = SkNN(n_neighbors=k + 1).fit(emb).kneighbors(emb)
    return float(np.mean([len(set(a) & set(b)) / k for a, b in zip(hi[:, 1:], lo[:, 1:])]))


def _ref_layout(ids, dists, n_epochs):
    """The JAX package's layout and spectral init of a graph (numpy)."""
    n = ids.shape[0]
    W = ref._calibrated_weights(jnp.asarray(ids.astype(np.int32)), jnp.asarray(dists), 1.0, 1.0)
    n_pad = padded_row_count(n)
    tails, w = ref.build_head_layout_device(jnp.asarray(ids.astype(np.int32)), W, n_pad, n_epochs)
    key = jax.random.PRNGKey(7)
    init = ref._spectral_scale_noise(
        ref._laplacian_eigenmap_kernel(tails, w, key, jnp.int32(n), c=2), jax.random.fold_in(key, 0x5CA1E))
    return np.asarray(tails), np.asarray(w), np.asarray(init)


def test_counter_uniform_bit_for_bit():
    P, n_pad = 12, 192
    counters = np.arange(P, dtype=np.uint32)[:, None] * np.uint32(n_pad) + np.arange(n_pad, dtype=np.uint32)[None, :]
    epochs = (0, 17)
    wants = jax.device_get([
        ref._counter_uniform(jax.random.split(jax.random.fold_in(jax.random.PRNGKey(5), e))[0], jnp.asarray(counters))
        for e in epochs
    ])
    for e, want in zip(epochs, wants):
        key = prng.split(prng.fold_in(prng.prng_key(5), e))[0]
        got = port._counter_uniform(key, torch.from_numpy(counters.astype(np.int64)))
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(port._layout_grid(P, n_pad, torch.device("cpu")).numpy(), counters)


def test_layout_grid_refuses_the_uint32_overflow():
    with pytest.raises(ValueError, match="uint32 counter space"):
        port._layout_grid(36, 1 << 27, torch.device("cpu"))


def _sharded_step(init, tails, w, n, e0, block):
    mesh = ref_get_mesh(1)
    return np.asarray(ref._layout_step_sharded(
        jnp.asarray(init), jax.device_put(jnp.asarray(tails.T), col_sharding(mesh)),
        jax.device_put(jnp.asarray(w.T), col_sharding(mesh)), jnp.int32(e0), jnp.float32(120), jnp.int32(n),
        jnp.float32(_A), jnp.float32(_B), jnp.float32(1.0), jnp.float32(1.0), jnp.float32(5.0), jnp.int32(7),
        mesh=mesh, block=block, table_size=256,
    ))


def _port_step(init, tails, w, n, e0, block):
    return port._layout_step(
        torch.from_numpy(np.array(init)), torch.from_numpy(np.ascontiguousarray(tails.T)),
        torch.from_numpy(np.ascontiguousarray(w.T)), e0, 120.0, n, _A, _B, 1.0, 1.0, 5.0, 7, block, 256,
    ).numpy()


# 3 epochs in one step late in the schedule; early, where alpha is near 1,
# the JAX layout itself moves 6.6e-4 after 3 epochs from a start perturbed
# by one ulp, so there the 3 epochs are checked one at a time, each from
# the JAX package's embedding
@pytest.mark.parametrize("block,e0", [(1, 0), (1, 60), (3, 100), (3, 117)])
def test_layout_epochs_match_the_sharded_step(block, e0):
    _, ids, dists = _blob_graph()
    n = ids.shape[0]
    tails, w, init = _ref_layout(ids, dists, 120)
    want = _sharded_step(init, tails, w, n, e0, block)
    np.testing.assert_allclose(_port_step(init, tails, w, n, e0, block), want, atol=1e-5)


def test_three_early_epochs_each_from_the_reference_embedding():
    _, ids, dists = _blob_graph()
    n = ids.shape[0]
    tails, w, emb = _ref_layout(ids, dists, 120)
    for e in range(3):
        want = _sharded_step(emb, tails, w, n, e, 1)
        np.testing.assert_allclose(_port_step(emb, tails, w, n, e, 1), want, atol=1e-5)
        emb = want


def test_reference_layout_matches():
    _, ids, dists = _blob_graph(n=256, k=10, seed=2)
    tails, w, init = _ref_layout(ids, dists, 1)
    want = ref.optimize_layout_padded(jnp.asarray(init), jnp.asarray(tails), jnp.asarray(w), _A, _B, 1, 1.0, 1.0, 5, 7)
    got = port.optimize_layout_padded(torch.from_numpy(init), torch.from_numpy(tails), torch.from_numpy(w),
                                      _A, _B, 1, 1.0, 1.0, 5, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_spectral_init_spans_the_reference_subspace():
    _, ids, dists = _blob_graph(n=320, k=12, seed=4)
    n = ids.shape[0]
    tails, w, _ = _ref_layout(ids, dists, 200)
    key = jax.random.PRNGKey(3)
    want = np.asarray(ref._laplacian_eigenmap_kernel(jnp.asarray(tails), jnp.asarray(w), key, jnp.int32(n), c=2))
    got = port._laplacian_eigenmap_kernel(torch.from_numpy(tails), torch.from_numpy(w), prng.prng_key(3), n, c=2)
    got = got.numpy().astype(np.float64)
    np.testing.assert_array_equal(got[n:], 0.0)
    q1, _ = np.linalg.qr(want[:n].astype(np.float64))
    q2, _ = np.linalg.qr(got[:n])
    cosines = np.linalg.svd(q1.T @ q2, compute_uv=False)
    assert cosines.min() > 0.999, cosines
    # the scaled init the layout starts from
    noise_key = jax.random.fold_in(key, 0x5CA1E)
    scaled_r = np.asarray(ref._spectral_scale_noise(jnp.asarray(want), noise_key))
    scaled = port._spectral_scale_noise(torch.from_numpy(want), prng.fold_in(prng.prng_key(3), 0x5CA1E))
    np.testing.assert_allclose(scaled.numpy(), scaled_r, atol=1e-6)


def test_spectral_init_host_entry_spans_the_reference_subspace():
    # the host entry (dedupe -> padded layout -> subspace iteration) on the
    # JAX package's graph-smoothness fixture
    rng = np.random.default_rng(0)
    X = np.concatenate([rng.normal(size=(60, 4)), rng.normal(size=(60, 4)) + 6.0])
    from sklearn.neighbors import NearestNeighbors as SkNN

    d, ids = SkNN(n_neighbors=8).fit(X).kneighbors(X)
    W = np.exp(-(d ** 2)).astype(np.float32)
    want = ref.spectral_init(ids, W, 2, seed=1).astype(np.float64)
    got = port.spectral_init(ids, W, 2, seed=1).astype(np.float64)
    assert got.shape == (120, 2) and np.all(np.isfinite(got))
    q1, _ = np.linalg.qr(want - want.mean(axis=0))
    q2, _ = np.linalg.qr(got - got.mean(axis=0))
    assert np.linalg.svd(q1.T @ q2, compute_uv=False).min() > 0.999


@pytest.mark.parametrize("seed,n_pad", [(0, 64), (42, 320)])
def test_random_init_bit_for_bit(seed, n_pad):
    want = np.asarray(ref._random_init(jnp.int32(seed), n_pad=n_pad, c=2))
    np.testing.assert_array_equal(port._random_init(seed, n_pad, 2, torch.device("cpu")).numpy(), want)


@pytest.mark.parametrize("init", ["spectral", "random"])
def test_fit_embedding_preservation_matches_reference(init):
    X, ids, dists = _blob_graph()
    kwargs = _fit_kwargs(init=init)
    want = ref.umap_fit_embedding(ids, dists, mesh=ref_get_mesh(1), **kwargs)
    got = port.umap_fit_embedding(ids, dists, **kwargs)
    assert got.shape == (ids.shape[0], 2) and np.all(np.isfinite(got))
    s_port, s_ref = _neighbor_preservation(X, got), _neighbor_preservation(X, want)
    assert abs(s_port - s_ref) < 0.01, (s_port, s_ref)


def test_fit_counters_uploads_and_dispatches():
    X, ids, dists = _blob_graph(n=128, k=8, seed=9)
    profiling.reset_counters("umap.")
    port.umap_fit_embedding(ids, dists, epoch_block=40, **_fit_kwargs(n_epochs=100))
    c = profiling.counters("umap.")
    assert c["umap.h2d_transfers"] == 2
    assert c["umap.h2d_bytes"] == ids.size * 4 + dists.size * 4
    assert c["umap.layout.dispatches"] == math.ceil(100 / 40)
    profiling.reset_counters("umap.")
    y = np.random.default_rng(0).integers(0, 3, size=len(X)).astype(np.float64)
    port.umap_fit_embedding(ids, dists, y=y, **_fit_kwargs(n_epochs=20))
    c = profiling.counters("umap.")
    assert c["umap.h2d_transfers"] == 3
    assert c["umap.layout.dispatches"] == 1
    assert {"umap.graph", "umap.init", "umap.layout"} <= set(profiling.phase_times())


def test_fit_is_deterministic_and_block_independent():
    _, ids, dists = _blob_graph(n=128, k=8, seed=10)
    e1 = port.umap_fit_embedding(ids, dists, **_fit_kwargs(n_epochs=30))
    e2 = port.umap_fit_embedding(ids, dists, epoch_block=7, **_fit_kwargs(n_epochs=30))
    np.testing.assert_array_equal(e1, e2)


def _transform_inputs(nr=300, nq=100, k=8, seed=2):
    rng = np.random.default_rng(seed)
    train_emb = rng.normal(size=(nr, 2)).astype(np.float32)
    q_ids = rng.integers(0, nr, size=(nq, k))
    q_dists = np.sort(rng.random(size=(nq, k)).astype(np.float32) + 0.05, axis=1)
    bucket = 128
    ids_p = np.pad(q_ids, ((0, bucket - nq), (0, 0))).astype(np.int32)
    dists_p = np.pad(q_dists, ((0, bucket - nq), (0, 0)))
    return train_emb, q_ids, q_dists, ids_p, dists_p


def _ref_transform_epoch(emb, train_emb, ids_p, weights, e):
    """One refinement epoch of the JAX package's transform (numpy)."""
    return np.asarray(ref._transform_step(
        jnp.asarray(emb), jnp.asarray(train_emb), jnp.asarray(ids_p), jnp.asarray(weights), jnp.int32(e),
        jnp.float32(32), jnp.float32(_A), jnp.float32(_B), jnp.float32(1.0), jnp.float32(1.0), jnp.int32(5),
        block=1, negative_sample_rate=5,
    ))


def test_transform_prepare_and_step_match_reference():
    train_emb, _, _, ids_p, dists_p = _transform_inputs()
    init_r, w_r = ref._transform_prepare(jnp.asarray(ids_p), jnp.asarray(dists_p), jnp.asarray(train_emb),
                                         jnp.int32(100), jnp.float32(1.0))
    init, w = port._transform_prepare(torch.from_numpy(ids_p), torch.from_numpy(dists_p),
                                      torch.from_numpy(train_emb), 100, 1.0)
    np.testing.assert_allclose(init.numpy(), np.asarray(init_r), atol=1e-5)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_r), atol=1e-6)
    # one epoch, then 3 checked one at a time from the JAX embedding (the
    # refinement at alpha near 1 amplifies one-ulp differences as the
    # layout does)
    emb, w_host = np.asarray(init_r), np.asarray(w_r)
    for e in range(3):
        want = _ref_transform_epoch(emb, train_emb, ids_p, w_host, e)
        got = port._transform_step(
            torch.from_numpy(emb), torch.from_numpy(train_emb), torch.from_numpy(ids_p),
            torch.from_numpy(w_host), e, 32.0, _A, _B, 1.0, 1.0, 5, 1, 5,
        )
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
        emb = want


def test_transform_embedding_blocks_and_determinism():
    train_emb, q_ids, q_dists, _, _ = _transform_inputs()
    kwargs = dict(local_connectivity=1.0, a=_A, b=_B, n_epochs=96, seed=5)
    profiling.reset_counters("umap.transform")
    e1 = port.umap_transform_embedding(q_ids, q_dists, train_emb, epoch_block=16, **kwargs)
    assert profiling.counters("umap.transform")["umap.transform.dispatches"] == 2  # 32 epochs
    e2 = port.umap_transform_embedding(q_ids, q_dists, train_emb, **kwargs)
    np.testing.assert_array_equal(e1, e2)
    assert e1.shape == (100, 2) and np.all(np.isfinite(e1))
    # 3 refinement epochs (n_epochs 9) through the whole entry
    few = dict(kwargs, n_epochs=9)
    np.testing.assert_allclose(
        port.umap_transform_embedding(q_ids, q_dists, train_emb, **few),
        ref.umap_transform_embedding(q_ids, q_dists, train_emb, **few), atol=1e-4)
    no_refine = port.umap_transform_embedding(q_ids, q_dists, train_emb, local_connectivity=1.0)
    np.testing.assert_allclose(
        no_refine, ref.umap_transform_embedding(q_ids, q_dists, train_emb, local_connectivity=1.0), atol=1e-5)
