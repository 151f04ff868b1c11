# The port's approximate nearest neighbours (spark_rapids_ml_tpu_torch/ann,
# models/approximate_nn) against the JAX package's, on the CPU, on the same
# seeded numpy inputs.  The two packages' k-means draw the same threefry
# inits, so the build tests train the port's own centroids and codebooks
# from the same seed (both packages' training rounded to quarter steps, so
# float32 sums in another order cannot move them) and hold the whole packed
# payload against the JAX package's; the search tests search the JAX
# package's packed payload, the index the JAX tests search; the port's own
# fit is held by the JAX package's recall gates.
#
# Tolerances:
#   - exact (bit for bit) on quarter-step data: every product and partial
#     sum of a distance is exact in float32, so assignment, list order, PQ
#     codes, ADC scalars (host float64 in both), probe selection and the
#     probed results cannot depend on the summation order;
#   - on Gaussian data: squared distances within rtol 1e-5 plus 1e-6 of the
#     largest squared norm (the expanded form ||q||^2 - 2 q.x + ||x||^2
#     rounds at the scale of the norms, and the two packages sum in other
#     orders), and ids equal except at near-ties (a differing id whose
#     distance lies within that tolerance of the k-th, or of the distance at
#     which the other package holds it).
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spark_rapids_ml_tpu as ref
import spark_rapids_ml_tpu.ann.pq as ref_pq_mod
from spark_rapids_ml_tpu.ann.ivfflat import (
    build_ivfflat_packed as ref_build_flat,
    index_from_packed as ref_index_flat,
    ivfflat_search_prepared as ref_search_flat,
    select_probes as ref_select_probes,
)
from spark_rapids_ml_tpu.ann.pq import (
    build_ivfpq_packed as ref_build_pq,
    index_from_packed_pq as ref_index_pq,
    ivfpq_search_prepared as ref_search_pq,
)
from spark_rapids_ml_tpu.dataframe import DataFrame as RefDataFrame
from spark_rapids_ml_tpu.ops.knn import lex_topk as ref_lex_topk
from spark_rapids_ml_tpu.parallel.mesh import get_mesh

import spark_rapids_ml_tpu_torch as port
from spark_rapids_ml_tpu_torch.ann import ivfflat, pq
from spark_rapids_ml_tpu_torch.ann.ivfflat import recall_at_k
from spark_rapids_ml_tpu_torch.convert import approximate_nearest_neighbors_model_from_reference
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.ops import knn as port_knn
from spark_rapids_ml_tpu_torch.ops import knn_kernels as kk

CPU = torch.device("cpu")
RTOL = 1e-5
NORM_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


def _clustered(n=2500, d=16, n_blobs=24, seed=0):
    """The JAX tests' clustered items, with their non-contiguous ids."""
    rng = np.random.default_rng(seed)
    centers = 20.0 * rng.normal(size=(n_blobs, d))
    lab = rng.integers(0, n_blobs, size=n)
    X = (centers[lab] + rng.normal(size=(n, d))).astype(np.float32)
    return X, np.arange(n, dtype=np.int64) * 7 + 3


def _quarter(x):
    return (np.round(np.asarray(x) * 4) / 4).astype(np.float32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _assert_same_up_to_ties(got_d, got_i, want_d, want_i, scale):
    """Distances within the module's tolerance in squared form; ids equal
    except at near-ties."""
    assert got_i.shape == want_i.shape and got_i.dtype == np.int64 and got_d.dtype == np.float32
    tol = RTOL * np.asarray(want_d, np.float64) ** 2 + NORM_ATOL * scale
    g2, w2 = np.asarray(got_d, np.float64) ** 2, np.asarray(want_d, np.float64) ** 2
    fin = np.isfinite(w2)
    assert (np.isfinite(g2) == fin).all()
    assert (np.abs(g2 - w2)[fin] <= tol[fin]).all(), np.abs(g2 - w2)[fin].max()
    kth = w2[:, -1:]
    for r, c in zip(*np.nonzero(got_i != want_i)):
        at = np.flatnonzero(want_i[r] == got_i[r, c])
        near_kth = abs(w2[r, c] - kth[r, 0]) <= 2 * tol[r, c]
        near_other = at.size and abs(w2[r, at[0]] - w2[r, c]) <= 2 * tol[r, c]
        assert near_kth or near_other, (r, c, got_i[r], want_i[r])


# -- build: assignment, layout, codes, scalars ---------------------------------


def _quarter_training(monkeypatch):
    """Both packages' quantizer training, rounded to quarter steps."""
    real = ref_pq_mod.train_coarse_quantizer
    monkeypatch.setattr("spark_rapids_ml_tpu.ann.ivfflat.train_coarse_quantizer",
                        lambda *a, **k: _quarter(real(*a, **k)))
    monkeypatch.setattr(ref_pq_mod, "train_coarse_quantizer", lambda *a, **k: _quarter(real(*a, **k)))
    mine = ivfflat.train_coarse_quantizer
    monkeypatch.setattr(ivfflat, "train_coarse_quantizer", lambda *a, **k: _quarter(mine(*a, **k)))
    monkeypatch.setattr(pq, "train_coarse_quantizer", lambda *a, **k: _quarter(mine(*a, **k)))


def test_list_assignment_and_layout_equal_jax_given_its_centroids(monkeypatch):
    """The port trains its own centroids from the JAX build's seed: the
    same centroids, assignment and lists."""
    X, ids = _clustered(n=2000)
    X = _quarter(X)
    _quarter_training(monkeypatch)
    want = ref_build_flat(X, ids, 40, seed=3)
    from spark_rapids_ml_tpu.ann.ivfflat import assign_nearest as ref_assign

    got = ivfflat.build_ivfflat_packed(X, ids, 40, seed=3, device=CPU)
    np.testing.assert_array_equal(got.centroids, want.centroids)
    assert got.n_lists == want.n_lists
    assign = ivfflat.assign_nearest(X, got.centroids, CPU)
    np.testing.assert_array_equal(assign, ref_assign(X, want.centroids))
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.items, want.items)
    assert got.counts.dtype == np.int64 and got.ids.dtype == np.int64


@pytest.mark.parametrize("n_bits", [8, 4])
def test_pq_codes_and_scalars_equal_jax_given_its_codebooks(monkeypatch, n_bits):
    """The port trains its own centroids and codebooks from the JAX build's
    seed: the same codebooks, codes and scalars."""
    X, ids = _clustered(n=1500)
    X = _quarter(X)
    _quarter_training(monkeypatch)
    want = ref_build_pq(X, ids, 16, m_sub=4, n_bits=n_bits, seed=2)
    got = pq.build_ivfpq_packed(X, ids, 16, m_sub=4, n_bits=n_bits, seed=2, device=CPU)
    np.testing.assert_array_equal(got.centroids, want.centroids)
    np.testing.assert_array_equal(got.codebooks, want.codebooks)
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_array_equal(_bits(got.scalars), _bits(want.scalars))
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.items, want.items)
    assert got.codes.dtype == np.uint8


def test_reconstruct_and_geometry_equal_jax():
    X, ids = _clustered(n=600, d=12)
    want = ref_build_pq(X, ids, 8, m_sub=3, n_bits=4, seed=1, opq=True)
    got = _port_packed_pq(want)
    np.testing.assert_array_equal(pq.reconstruct(got), ref_pq_mod.reconstruct(want))
    for d in (3, 12, 16, 100, 256, 1000):
        assert pq.default_m_sub(d) == ref_pq_mod.default_m_sub(d)
        for m in (1, 3, 8, 32):
            assert pq.pq_geometry(d, m) == ref_pq_mod.pq_geometry(d, m)
    for n in (1, 100, 400_000, 10**7):
        assert ivfflat.default_nlist(n) == ref.ann.default_nlist(n)
        assert ivfflat.default_nprobe(ivfflat.default_nlist(n)) == ref.ann.default_nprobe(ref.ann.default_nlist(n))


# -- search parity given the JAX payload ---------------------------------------


def _port_packed_flat(p):
    return ivfflat.PackedIVF(p.items, p.ids, p.counts, p.centroids, p.n_lists, p.n_items)


def _port_packed_pq(p):
    return pq.PackedPQ(p.codes, p.scalars, p.ids, p.items, p.counts, p.centroids, p.codebooks, p.n_lists,
                       p.n_items, p.dim, p.m_sub, p.n_bits, rotation=p.rotation)


def test_probe_selection_equals_jax_on_tied_data():
    """Duplicated centroids tie exactly on quarter-step data: both packages
    take the lower list id (jax.lax.top_k's rule), and the probe distances
    agree."""
    rng = np.random.default_rng(4)
    c = _quarter(rng.normal(size=(24, 8)) * 3)
    c[12:] = c[:12]
    q = _quarter(rng.normal(size=(50, 8)) * 3)
    cn = (c.astype(np.float64) ** 2).sum(1).astype(np.float32)
    _qn, want_d, want_p = ref_select_probes(jnp.asarray(q), jnp.asarray(c), jnp.asarray(cn), 7, 24, get_mesh(1))[:3]
    _qn, got_d, got_p = ivfflat.select_probes(torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(cn), 7)
    order = np.argsort(np.asarray(want_p), axis=1, kind="stable")
    np.testing.assert_array_equal(got_p.numpy(), np.take_along_axis(np.asarray(want_p), order, 1))
    np.testing.assert_array_equal(_bits(got_d), _bits(np.take_along_axis(np.asarray(want_d), order, 1)))
    # a duplicate is probed only with its lower twin: ties go to the lower id
    for row in got_p.numpy():
        assert all(p - 12 in row for p in row if p >= 12)


@pytest.mark.parametrize("k", [10, 700])
def test_probe_merge_equals_lex_topk_bitwise(k):
    """The fused merge over the ascending-probe pool is the lexicographic
    (d2, position) top k of the port's and the JAX package's lex_topk, ties
    (quarter-step data) and k past the pool included."""
    X, ids = _clustered(n=1200, d=8, n_blobs=6)
    X = _quarter(X)
    index = ivfflat.index_from_packed(ivfflat.build_ivfflat_packed(X, ids, 12, seed=1, device=CPU), CPU)
    q = torch.from_numpy(X[:40])
    vals, pos = ivfflat.probe_pool(index, q, 3, ivfflat._flat_block_scorer, 40)
    dist, fpos = kk.knn_fused_merge(vals, pos, k)[:2]
    fpos = torch.where(torch.isinf(dist), port_knn.LEX_POS_SENTINEL, fpos)
    d2, lpos = port_knn.lex_topk(-vals.view(40, -1), pos.view(40, -1), k)
    np.testing.assert_array_equal(_bits(dist), _bits(kk.sqrt_clamped(d2)))
    np.testing.assert_array_equal(fpos.numpy(), lpos.numpy())
    rd, rp = ref_lex_topk(jnp.asarray((-vals).view(40, -1).numpy()), jnp.asarray(pos.view(40, -1).numpy()), k)
    np.testing.assert_array_equal(_bits(d2), _bits(rd))
    np.testing.assert_array_equal(lpos.numpy(), np.asarray(rp))
    assert (np.isinf(dist.numpy()) == (fpos.numpy() == port_knn.LEX_POS_SENTINEL)).all()


def test_flat_search_equals_jax_bitwise_on_quarter_step_data(monkeypatch):
    """Each package searches its own build (quarter-step training)."""
    X, ids = _clustered(n=2000)
    X = _quarter(X)
    _quarter_training(monkeypatch)
    packed = ref_build_flat(X, ids, 40, seed=1)
    mine = ivfflat.build_ivfflat_packed(X, ids, 40, seed=1, device=CPU)
    np.testing.assert_array_equal(mine.centroids, packed.centroids)
    mesh = get_mesh(1)
    want_d, want_i = ref_search_flat(ref_index_flat(packed, mesh), X[:300], 10, 10, mesh)
    got_d, got_i = ivfflat.ivfflat_search_prepared(ivfflat.index_from_packed(mine, CPU), X[:300], 10, 10)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(_bits(got_d), _bits(want_d))


@pytest.mark.parametrize(
    "build,refine_ratio",
    [
        (None, 1),
        (dict(m_sub=4, n_bits=8), 1),
        (dict(m_sub=4, n_bits=8), 4),
        (dict(m_sub=8, n_bits=4, opq=True), 1),
        (dict(m_sub=8, n_bits=4, opq=True), 8),
    ],
    ids=["flat", "pq8_adc", "pq8_refined", "pq4_opq_adc", "pq4_opq_refined"],
)
def test_search_matches_jax_given_its_payload(build, refine_ratio):
    X, ids = _clustered()
    mesh = get_mesh()
    Q = X[:256]
    scale = 2 * float((X.astype(np.float64) ** 2).sum(1).max())
    if build is None:
        packed = ref_build_flat(X, ids, 50, seed=1)
        want = ref_search_flat(ref_index_flat(packed, mesh), Q, 10, 12, mesh)
        got = ivfflat.ivfflat_search_prepared(ivfflat.index_from_packed(_port_packed_flat(packed), CPU), Q, 10, 12)
    else:
        packed = ref_build_pq(X, ids, 50, seed=1, **build)
        kw = dict(refine_items=packed.items, refine_ratio=refine_ratio)
        want = ref_search_pq(ref_index_pq(packed, mesh), Q, 10, 12, mesh, **kw)
        got = pq.ivfpq_search_prepared(pq.index_from_packed_pq(_port_packed_pq(packed), CPU), Q, 10, 12, **kw)
    _assert_same_up_to_ties(got[0], got[1], np.asarray(want[0]), np.asarray(want[1]), scale)


def test_probing_every_list_equals_the_exact_engine():
    X, ids = _clustered(n=1500, d=8, n_blobs=10)
    index = ivfflat.index_from_packed(ivfflat.build_ivfflat_packed(X, ids, 16, seed=0, device=CPU), CPU)
    d_ann, i_ann = ivfflat.ivfflat_search_prepared(index, X[:100], 10, index.nlist_pad)
    d_ex, i_ex = port_knn.knn_search_prepared(port_knn.prepare_items(X, ids, CPU), X[:100], 10)
    assert recall_at_k(i_ann, i_ex) == 1.0
    _assert_same_up_to_ties(d_ann, i_ann, d_ex, i_ex, 2 * float((X.astype(np.float64) ** 2).sum(1).max()))


@pytest.mark.parametrize("algo", ["flat", "pq8", "pq4"])
def test_several_blocks_equal_one_block_on_quarter_step_data(monkeypatch, algo):
    """Pool and tile budgets shrunk so the sweep takes many query blocks and
    scores few rows at once: the same bits (every sum exact)."""
    X, ids = _clustered(n=1500)
    X = _quarter(X)
    _quarter_training(monkeypatch)
    if algo == "flat":
        index = ivfflat.index_from_packed(ivfflat.build_ivfflat_packed(X, ids, 20, seed=1, device=CPU), CPU)

        def search():
            return ivfflat.ivfflat_search_prepared(index, X[:200], 15, 6)
    else:
        packed = pq.build_ivfpq_packed(X, ids, 20, m_sub=4, n_bits=8 if algo == "pq8" else 4, seed=1, device=CPU)
        index = pq.index_from_packed_pq(packed, CPU)

        def search():
            return pq.ivfpq_search_prepared(index, X[:200], 15, 6)
    d1, i1 = search()
    monkeypatch.setattr(ivfflat, "_POOL_BYTES", 8 * 6 * index.l_pad * 7)
    monkeypatch.setattr(ivfflat, "_TILE_BYTES", 3 * 4 * 6 * index.l_pad * (X.shape[1] + 3))
    assert ivfflat.sweep_geometry(200, 6 * index.l_pad, 4 * 6 * index.l_pad * (X.shape[1] + 3)) == (7, 3)
    d2, i2 = search()
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(_bits(d1), _bits(d2))


# -- the port's own fit meets the JAX package's gates --------------------------


def _model_recall(algorithm, params, X, n_queries, k=10, partitions=2):
    df = port.DataFrame.from_numpy(X, num_partitions=partitions)
    qdf = port.DataFrame.from_numpy(X[:n_queries], num_partitions=2)
    model = port.ApproximateNearestNeighbors(k=k, algorithm=algorithm, algoParams=params).fit(df)
    knn = model.kneighbors(qdf)[2]
    i_ann = np.concatenate([p["indices"] for p in knn.partitions])
    d_ann = np.concatenate([p["distances"] for p in knn.partitions])
    model.setExactSearch(True)
    i_ex = np.concatenate([p["indices"] for p in model.kneighbors(qdf)[2].partitions])
    model.setExactSearch(False)
    return model, recall_at_k(i_ann, i_ex), i_ann, d_ann


def test_port_fit_flat_recall_gate():
    """tests/test_ann_engine.py:92: recall@10 >= 0.95 at the default nprobe,
    the self match first."""
    X, _ = _clustered(n=4000)
    _, r, i_ann, d_ann = _model_recall("ivfflat", {}, X, 512)
    assert r >= 0.95
    np.testing.assert_array_equal(i_ann[:, 0], np.arange(512))
    assert (np.diff(d_ann, axis=1) >= 0).all()


@pytest.mark.parametrize(
    "params,n,gate",
    [({}, 2500, 0.9), ({"nlist": 16, "nprobe": 8, "M": 8, "n_bits": 4, "opq": True, "refine_ratio": 8}, 2000, 0.9)],
    ids=["pq8_defaults", "pq4_opq"],
)
def test_port_fit_pq_recall_gates(params, n, gate):
    """tests/test_pq_engine.py:156 (refined recall@10 >= 0.9 at the
    defaults) and :431 (4-bit + OPQ, refine x8)."""
    X, _ = _clustered(n=n, seed=13 if params else 0)
    model, r, i_ann, _ = _model_recall("ivfpq", params, X, 256)
    assert r >= gate
    assert np.mean(i_ann[:, 0] == np.arange(256)) >= 0.95
    assert model.pq_codes_.dtype == np.uint8 and (model.pq_rotation_ is not None) == bool(params.get("opq"))


# -- model surface --------------------------------------------------------------


@pytest.mark.parametrize(
    "algorithm,params",
    [("ivfflat", {"nlist": 8, "nprobe": 3}), ("ivfpq", {"nlist": 8, "nprobe": 3, "M": 4, "n_bits": 4})],
)
def test_jax_saved_model_loads_and_answers_as_jax(tmp_path, algorithm, params):
    X, _ = _clustered(n=800, d=8, n_blobs=8, seed=1)
    jax_model = ref.ApproximateNearestNeighbors(k=6, algorithm=algorithm, algoParams=params).setFeaturesCol(
        "features").fit(RefDataFrame.from_numpy(X, num_partitions=2))
    jax_model.save(str(tmp_path / "m"))
    pdf = jax_model.kneighbors(RefDataFrame.from_numpy(X[:60], num_partitions=1))[2].toPandas()
    want_i, want_d = np.stack(pdf["indices"].to_numpy()), np.stack(pdf["distances"].to_numpy())
    loaded = port.load(str(tmp_path / "m"))
    assert type(loaded) is port.ApproximateNearestNeighborsModel
    assert loaded.getAlgorithm() == algorithm and loaded.getAlgoParams() == params and loaded.getK() == 6
    knn = loaded.kneighbors(port.DataFrame.from_numpy(X[:60]))[2]
    got_i, got_d = knn.partitions[0]["indices"], knn.partitions[0]["distances"]
    _assert_same_up_to_ties(got_d, got_i, want_d.astype(np.float32), want_i.astype(np.int64),
                            2 * float((X.astype(np.float64) ** 2).sum(1).max()))
    conv = approximate_nearest_neighbors_model_from_reference(
        {k: v for k, v in jax_model._get_model_attributes().items()}, {"k": 6, "algoParams": params})
    assert conv.getAlgorithm() == algorithm
    c = conv.kneighbors(port.DataFrame.from_numpy(X[:60]))[2].partitions[0]
    np.testing.assert_array_equal(c["indices"], got_i)
    np.testing.assert_array_equal(_bits(c["distances"]), _bits(got_d))


@pytest.mark.parametrize(
    "algorithm,params",
    [("ivfflat", {"nlist": 8, "nprobe": 4}), ("ivfpq", {"nlist": 8, "nprobe": 4, "M": 4, "opq": True}),
     ("ivfpq", {"nlist": 8, "nprobe": 4, "M": 4, "n_bits": 4, "opq": True})],
)
def test_save_load_in_the_port(tmp_path, algorithm, params):
    X, _ = _clustered(n=700, d=8, n_blobs=8, seed=2)
    model = port.ApproximateNearestNeighbors(k=5, algorithm=algorithm, algoParams=params).fit(
        port.DataFrame.from_numpy(X, num_partitions=2))
    qdf = port.DataFrame.from_numpy(X[:40], num_partitions=2)
    want = model.kneighbors(qdf)[2]
    model.save(str(tmp_path / "m"))
    with np.load(tmp_path / "m" / "model_arrays.npz") as npz:
        assert npz["packed_ids_"].dtype == np.int64 and npz["list_counts_"].dtype == np.int64
        assert (npz["pq_codes_"].dtype == np.uint8) if algorithm == "ivfpq" else "pq_codes_" not in npz.files
    loaded = port.load(str(tmp_path / "m"))
    if algorithm == "ivfflat":
        assert loaded.pq_codes_ is None and loaded.pq_n_bits is None
    got = loaded.kneighbors(qdf)[2]
    for a, b in zip(got.partitions, want.partitions):
        np.testing.assert_array_equal(a["indices"], b["indices"])
        np.testing.assert_array_equal(_bits(a["distances"]), _bits(b["distances"]))
        np.testing.assert_array_equal(a["query_unique_id"], b["query_unique_id"])


@pytest.mark.parametrize(
    "algorithm,params",
    [("ivfflat", {"nlist": 30, "nprobe": 12}), ("ivfpq", {"nlist": 30, "nprobe": 12, "M": 8, "n_bits": 4, "opq": True})],
)
def test_tiered_search_is_bitwise_the_resident_one(algorithm, params):
    X, _ = _clustered(n=2000)
    model = port.ApproximateNearestNeighbors(k=10, algorithm=algorithm, algoParams=params).fit(
        port.DataFrame.from_numpy(X))
    qdf = port.DataFrame.from_numpy(X[:300])
    want = model.kneighbors(qdf)[2].partitions[0]
    model.setAlgoParams(dict(params, hot_fraction=0.5))
    got = model.kneighbors(qdf)[2].partitions[0]
    np.testing.assert_array_equal(got["indices"], want["indices"])
    np.testing.assert_array_equal(_bits(got["distances"]), _bits(want["distances"]))
    staged = (model._staged_pq if algorithm == "ivfpq" else model._staged_index)[1]
    stats = staged.tier.stats()
    assert stats["misses"] > 0 and stats["page_bytes"] > 0 and stats["hot_lists"] == 16
    res = model.index_residency()
    assert res["hbm_bytes_per_item"] > 0 and res["host_bytes_per_item"] > 0 and res["items_per_device"] >= 1


def test_small_pool_tiers_page_and_evict():
    """A pool of 3 slots forces the planner to split the queries and the
    pager to evict: still the resident search's bits."""
    X, ids = _clustered(n=1500)
    packed = ivfflat.build_ivfflat_packed(X, ids, 24, seed=1, device=CPU)
    want = ivfflat.ivfflat_search_prepared(ivfflat.index_from_packed(packed, CPU), X[:200], 8, 3)
    tiered = ivfflat.tiered_index_from_packed(packed, 0.25, CPU, pool_slots=3)
    got = ivfflat.ivfflat_search_prepared(tiered, X[:200], 8, 3)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
    assert tiered.tier.stats()["evictions"] > 0
    with pytest.raises(ValueError, match="pool"):
        ivfflat.ivfflat_search_prepared(ivfflat.tiered_index_from_packed(packed, 0.0, CPU, pool_slots=2),
                                         X[:5], 8, 8)


def test_unfillable_slots_carry_minus_one_as_in_jax():
    rng = np.random.default_rng(0)
    X = np.concatenate([rng.normal(size=(16, 4)), 100.0 + rng.normal(size=(16, 4))]).astype(np.float32)
    ids = np.arange(32, dtype=np.int64)
    mesh = get_mesh()
    flat = ref_build_flat(X, ids, 2, seed=5)
    want_d, want_i = ref_search_flat(ref_index_flat(flat, mesh), X[:4], 30, 1, mesh)
    mine = ivfflat.build_ivfflat_packed(X, ids, 2, seed=5, device=CPU)
    np.testing.assert_array_equal(mine.counts, flat.counts)
    got_d, got_i = ivfflat.ivfflat_search_prepared(ivfflat.index_from_packed(mine, CPU), X[:4], 30, 1)
    np.testing.assert_array_equal(got_i == -1, np.asarray(want_i) == -1)
    assert (got_i == -1).any() and np.isinf(got_d[got_i == -1]).all() and (got_i[:, :10] >= 0).all()
    packed = pq.build_ivfpq_packed(X, ids, 8, m_sub=2, n_bits=4, seed=5, device=CPU)
    index = pq.index_from_packed_pq(packed, CPU)
    for kw in ({}, {"refine_items": packed.items, "refine_ratio": 2}):
        d, i = pq.ivfpq_search_prepared(index, X[:4], 30, 1, **kw)
        assert d.shape == (4, 30) and (i == -1).any() and np.isinf(d[i == -1]).all() and (i[:, 0] >= 0).all()
    # k past the item count clamps to the item count
    d, i = pq.ivfpq_search_prepared(index, X[:4], 64, index.nlist_pad, refine_items=packed.items, refine_ratio=2)
    assert d.shape == (4, 32) and (i >= 0).all()
    model = port.ApproximateNearestNeighbors(k=40, algoParams={"nlist": 2, "nprobe": 1}).fit(
        port.DataFrame.from_numpy(X))
    knn = model.kneighbors(port.DataFrame.from_numpy(X[:3]))[2].partitions[0]
    assert knn["indices"].shape == (3, 32) and (knn["indices"] == -1).any()


@pytest.mark.parametrize(
    "algorithm,params,match",
    [
        ("ivfflat", {"nprobes": 3}, "unknown algoParams"),
        ("ivfflat", {"M": 4}, "unknown algoParams"),
        ("ivfpq", {"nlist": 4, "refine_ratio": 0}, "refine_ratio"),
        ("ivfpq", {"nlist": 4, "refine_ratio": -2}, "refine_ratio"),
        ("ivfflat", {"nlist": 4, "hot_fraction": 1.5}, "hot_fraction"),
        ("ivfpq", {"nlist": 4, "hot_fraction": -0.1}, "hot_fraction"),
        ("ivfpq", {"nlist": 4, "n_bits": 9}, "n_bits"),
        ("hnsw", {}, "not supported"),
    ],
)
def test_typed_errors(algorithm, params, match):
    X, _ = _clustered(n=100, d=4, n_blobs=4)
    df = port.DataFrame.from_numpy(X)
    with pytest.raises(ValueError, match=match):
        port.ApproximateNearestNeighbors(algorithm=algorithm, algoParams=params).fit(df)
    with pytest.raises(ValueError, match=match):
        ref.ApproximateNearestNeighbors(algorithm=algorithm, algoParams=params).setFeaturesCol("features").fit(
            RefDataFrame.from_numpy(X))


def test_model_surface_partitions_ids_and_unported_hooks():
    X, _ = _clustered(n=300, d=8, n_blobs=6, seed=29)
    model = port.ApproximateNearestNeighbors(k=4, algoParams={"nlist": 4, "nprobe": 4}).setIdCol("rid").fit(
        port.DataFrame([{"features": X[:200], "rid": np.arange(200) + 1000},
                        {"features": X[200:], "rid": np.arange(100) + 5000}]))
    qdf = port.DataFrame([{"features": X[:6]}, {"features": X[:0]}])
    item_df, qdf2, knn = model.kneighbors(qdf)
    assert item_df is not None and len(knn.partitions) == 2 and len(knn.partitions[1]["indices"]) == 0
    assert knn.partitions[1]["indices"].shape == (0, 4)
    np.testing.assert_array_equal(knn.partitions[0]["indices"][:, 0], np.arange(6) + 1000)
    np.testing.assert_array_equal(knn.partitions[0]["query_rid"], np.arange(6))
    with pytest.warns(UserWarning, match="usePrecomputedTables"):
        port.ApproximateNearestNeighbors(algorithm="ivfpq", algoParams={"nlist": 4, "usePrecomputedTables": True}
                                         ).fit(port.DataFrame.from_numpy(X))
    # the live-mutation hooks (ROADMAP A12) work now
    # (tests/test_torch_mutable_index.py): a holder, then frozen back
    holder = model.mutable_index()
    assert holder.n_items == 300 and model.freeze_mutations() is model and model.n_items == 300
    assert model.index_bytes_per_item() > 0
