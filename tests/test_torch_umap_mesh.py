# The port's UMAP layout on a mesh (spark_rapids_ml_tpu_torch/ops/umap.py:
# optimize_layout_sharded, the column-sharded head blocks with one
# exchange.umap.layout_rows all-gather an epoch; models/umap on
# get_mesh(num_workers), its IVF-Flat self-join searched on the mesh) against
# the one-shard layout and against the JAX package's sharded layout on the
# forced 8 CPU devices of tests/conftest.py.
#
# Tolerances:
#   - the port on 1, 2 and 8 shards against its one-shard optimize_layout:
#     bit for bit (a head's update reads only the epoch-start embedding and
#     reduces over the P axis alone, in a fixed order);
#   - single epochs and 3 late epochs against the JAX _layout_step_sharded on
#     get_mesh(): atol 1e-5 (tests/test_torch_umap_layout.py's gate: XLA
#     fuses multiply-adds and reduces in its own order);
#   - whole fits on 8 shards against the JAX fit on get_mesh(): atol 1e-4,
#     the JAX package's own mesh gate, over 5 epochs from the random init
#     (bit for bit in both) and 1 epoch from the spectral init (its normal
#     draws agree to a few ulps); early epochs (alpha near 1) amplify
#     one-ulp differences, so longer fits are held by their k=15 neighbor
#     preservation, within 0.01 of the JAX fit's.
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spark_rapids_ml_tpu.ops import umap as ref
from spark_rapids_ml_tpu.parallel.mesh import col_sharding, get_mesh as ref_get_mesh, padded_row_count

import spark_rapids_ml_tpu_torch as port_pkg
from spark_rapids_ml_tpu_torch import profiling
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.models.umap import UMAP
from spark_rapids_ml_tpu_torch.ops import umap as port
from spark_rapids_ml_tpu_torch.parallel.mesh import Mesh

_A, _B = 1.577, 0.895
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


def _mesh(n):
    return Mesh((CPU,) * n)


@pytest.fixture(scope="module")
def graph():
    """A 3-blob kNN graph and the JAX package's padded layout and spectral
    init of it (numpy)."""
    from sklearn.neighbors import NearestNeighbors as SkNN

    rng = np.random.default_rng(0)
    centers = 10.0 * rng.normal(size=(3, 8))
    X = (centers[rng.integers(0, 3, size=320)] + rng.normal(size=(320, 8))).astype(np.float32)
    dists, ids = SkNN(n_neighbors=12).fit(X).kneighbors(X)
    ids, dists = ids.astype(np.int64), dists.astype(np.float32)
    n = ids.shape[0]
    W = ref._calibrated_weights(jnp.asarray(ids.astype(np.int32)), jnp.asarray(dists), 1.0, 1.0)
    tails, w = ref.build_head_layout_device(jnp.asarray(ids.astype(np.int32)), W, padded_row_count(n), 120)
    key = jax.random.PRNGKey(7)
    init = ref._spectral_scale_noise(
        ref._laplacian_eigenmap_kernel(tails, w, key, jnp.int32(n), c=2), jax.random.fold_in(key, 0x5CA1E))
    return X, ids, dists, np.asarray(tails), np.asarray(w), np.asarray(init)


def _fit_kwargs(n_epochs, init="spectral"):
    return dict(
        n_components=2, a=_A, b=_B, n_epochs=n_epochs, learning_rate=1.0, init=init,
        set_op_mix_ratio=1.0, local_connectivity=1.0, repulsion_strength=1.0,
        negative_sample_rate=5, seed=7,
    )


def _layout_args(graph):
    X, ids, _, tails, w, init = graph
    return torch.from_numpy(init.copy()), torch.from_numpy(tails.copy()), torch.from_numpy(w.copy()), ids.shape[0]


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_sharded_layout_is_the_one_shard_layout_bitwise(graph, n_dev):
    """optimize_layout_sharded on 1, 2 and 8 shards gives optimize_layout's
    bits; one all-gather an epoch, its payload a shard's rows."""
    emb, tails, w, n = _layout_args(graph)
    args = (_A, _B, 30, 1.0, 1.0, 5, 7)
    want = port.optimize_layout(emb, tails, w, n, *args, epoch_block=8)
    profiling.reset_counters("exchange.umap.")
    profiling.reset_counters("umap.layout")
    got = port.optimize_layout_sharded(emb, tails, w, n, _mesh(n_dev), *args, epoch_block=8)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.numpy().view(np.uint32))
    c = profiling.counters("exchange.umap.layout_rows")
    assert c["exchange.umap.layout_rows.calls"] == 30
    assert c["exchange.umap.layout_rows.bytes"] == 30 * (tails.shape[0] // n_dev) * 2 * 4
    assert profiling.counters("umap.layout")["umap.layout.dispatches"] == math.ceil(30 / 8)


def _jax_step(init, tails, w, n, e0, block):
    mesh = ref_get_mesh()
    return np.asarray(ref._layout_step_sharded(
        jnp.asarray(init), jax.device_put(jnp.asarray(tails.T), col_sharding(mesh)),
        jax.device_put(jnp.asarray(w.T), col_sharding(mesh)), jnp.int32(e0), jnp.float32(120), jnp.int32(n),
        jnp.float32(_A), jnp.float32(_B), jnp.float32(1.0), jnp.float32(1.0), jnp.float32(5.0), jnp.int32(7),
        mesh=mesh, block=block, table_size=256,
    ))


@pytest.mark.parametrize("block,e0", [(1, 0), (1, 60), (3, 117)])
def test_epochs_match_the_jax_step_on_eight_devices(graph, block, e0):
    """The port's sharded step on 8 shards against the JAX package's on its
    8 forced devices, from the same embedding."""
    emb, tails, w, n = _layout_args(graph)
    mesh = _mesh(8)
    embs = [emb] * 8
    got = port._layout_step_sharded(embs, port._layout_shards(tails, w, mesh), mesh, e0, 120.0, n, _A, _B, 1.0,
                                    1.0, 5.0, 7, block, 256)
    assert len(got) == 8 and all(g is got[0] for g in got)
    np.testing.assert_allclose(got[0].numpy(), _jax_step(graph[5], graph[3], graph[4], n, e0, block), atol=1e-5)


@pytest.mark.parametrize("init,n_epochs", [("random", 5), ("spectral", 1)])
def test_whole_fit_on_eight_shards_matches_the_jax_fit(graph, init, n_epochs):
    _, ids, dists = graph[:3]
    kwargs = _fit_kwargs(n_epochs, init)
    want = ref.umap_fit_embedding(ids, dists, mesh=ref_get_mesh(), **kwargs)
    got = port.umap_fit_embedding(ids, dists, mesh=_mesh(8), **kwargs)
    np.testing.assert_allclose(got, want, atol=1e-4)
    one = port.umap_fit_embedding(ids, dists, mesh=_mesh(1), **kwargs)
    np.testing.assert_array_equal(got, one)


def _neighbor_preservation(X, emb, k=15):
    from sklearn.neighbors import NearestNeighbors as SkNN

    _, hi = SkNN(n_neighbors=k + 1).fit(X).kneighbors(X)
    _, lo = SkNN(n_neighbors=k + 1).fit(emb).kneighbors(emb)
    return float(np.mean([len(set(a) & set(b)) / k for a, b in zip(hi[:, 1:], lo[:, 1:])]))


def test_long_fit_on_eight_shards_preserves_as_jax(graph):
    X, ids, dists = graph[:3]
    kwargs = _fit_kwargs(120)
    want = ref.umap_fit_embedding(ids, dists, mesh=ref_get_mesh(), **kwargs)
    got = port.umap_fit_embedding(ids, dists, mesh=_mesh(8), **kwargs)
    np.testing.assert_array_equal(got, port.umap_fit_embedding(ids, dists, mesh=_mesh(1), **kwargs))
    s_port, s_ref = _neighbor_preservation(X, got), _neighbor_preservation(X, want)
    assert abs(s_port - s_ref) < 0.01, (s_port, s_ref)


def test_sharded_layout_refusals(graph):
    emb, tails, w, n = _layout_args(graph)
    with pytest.raises(ValueError, match="column blocks"):
        port.optimize_layout_sharded(emb, tails, w, n, _mesh(3), _A, _B, 1, 1.0, 1.0, 5, 7)
    big = torch.zeros((1, 1), dtype=torch.int32).expand(1 << 27, 36)
    with pytest.raises(ValueError, match="uint32 counter space"):
        port.optimize_layout_sharded(emb, big, big, n, _mesh(2), _A, _B, 1, 1.0, 1.0, 5, 7)


def test_ivfflat_graph_fit_on_eight_shards_equals_one_device(graph):
    """The estimator's IVF-Flat self-join searches on the fit's mesh (the
    probe merge runs) and the layout is column-sharded: the embedding is
    the one-device fit's."""
    X = np.round(graph[0]).astype(np.float64)
    df = port_pkg.DataFrame.from_numpy(X, num_partitions=2)

    def fit(**kw):
        est = UMAP(n_neighbors=10, random_state=3, n_epochs=30, **kw)
        est.setEngineOptions(graph="ivfflat", ann_nlist=16, ann_nprobe=8)
        return est.fit(df)

    one = fit(num_workers=1)
    profiling.reset_counters("exchange.")
    with use_device(["cpu"] * 8):
        eight = fit()
    c = profiling.counters("exchange.")
    assert c["exchange.ann.probe_merge.calls"] >= 2 and c["exchange.umap.layout_rows.calls"] == 30
    np.testing.assert_array_equal(eight.embedding_, one.embedding_)
