# The port's UMAP estimator and model (spark_rapids_ml_tpu_torch) against
# the JAX package's (spark_rapids_ml_tpu) on the same numpy rows, on the
# CPU: the estimator cases of tests/test_umap.py held to the same gates in
# both packages, persistence across packages, precomputed and IVF-Flat
# graphs, supervised fits, and a fit on an 8-shard CPU mesh.
#
# Tolerances: the JAX package's own quality gates (centroid separation,
# trustworthiness > 0.85, transform agreement > 0.9), and the port's score
# within 0.02 of the JAX package's on the same rows; the IVF-Flat graph's
# k=15 neighbor preservation within 0.01 of the exact graph's (the JAX
# package's gate); a JAX-saved model's transform of integer rows atol 1e-4
# at one refinement epoch (n_epochs 3): the refinement amplifies one-ulp
# differences epoch after epoch, as the layout does; the mesh fit equal to
# the one-device fit on integer rows, where every distance is exact.
import numpy as np
import pytest

import spark_rapids_ml_tpu as ref
from spark_rapids_ml_tpu.core import load as ref_load
from spark_rapids_ml_tpu.dataframe import DataFrame as RefDataFrame

import spark_rapids_ml_tpu_torch as port
from spark_rapids_ml_tpu_torch import profiling
from spark_rapids_ml_tpu_torch.convert import umap_model_from_reference
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.models.umap import UMAP, UMAPModel


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


def _blob_data(n=300, d=10, k=3, seed=0):
    rng = np.random.default_rng(seed)
    centers = 10.0 * rng.normal(size=(k, d))
    labels = rng.integers(0, k, size=n)
    X = centers[labels] + rng.normal(size=(n, d))
    return X.astype(np.float64), labels


def _frames(X, y=None, num_partitions=2):
    return (port.DataFrame.from_numpy(X, y, num_partitions=num_partitions),
            RefDataFrame.from_numpy(X, y=y, num_partitions=num_partitions))


def _embedding(out_df):
    return np.concatenate([p["embedding"] for p in out_df.partitions])


def _separation(emb, labels, k=3):
    cents = np.stack([emb[labels == c].mean(axis=0) for c in range(k)])
    intra = np.mean([np.linalg.norm(emb[labels == c] - cents[c], axis=1).mean() for c in range(k)])
    inter = np.mean([np.linalg.norm(cents[i] - cents[j]) for i in range(k) for j in range(i + 1, k)])
    return intra, inter


def _neighbor_preservation(X, emb, k=15):
    from sklearn.neighbors import NearestNeighbors as SkNN

    _, hi = SkNN(n_neighbors=k + 1).fit(X).kneighbors(X)
    _, lo = SkNN(n_neighbors=k + 1).fit(emb).kneighbors(emb)
    return float(np.mean([len(set(a) & set(b)) / k for a, b in zip(hi[:, 1:], lo[:, 1:])]))


def test_default_params_match_reference():
    um, rm = UMAP(), ref.UMAP()
    assert um.tpu_params == rm.tpu_params
    assert um.getOrDefault("outputCol") == "embedding" and um.getSampleFraction() == 1.0
    um = UMAP(n_neighbors=10, n_components=3, random_state=1)
    assert um.tpu_params["n_neighbors"] == 10
    assert um.getOrDefault("n_components") == 3
    assert "UMAP" in port.__all__ and "UMAPModel" in port.__all__


def test_preserves_clusters():
    X, labels = _blob_data()
    df, rdf = _frames(X, num_partitions=3)
    model = UMAP(n_neighbors=10, random_state=0, n_epochs=150).fit(df)
    emb = model.embedding
    assert emb.shape == (300, 2) and np.all(np.isfinite(emb))
    intra, inter = _separation(emb, labels)
    assert inter > 2.0 * intra, (intra, inter)
    r_intra, r_inter = _separation(ref.UMAP(n_neighbors=10, random_state=0, n_epochs=150).fit(rdf).embedding, labels)
    assert inter / intra > 0.5 * r_inter / r_intra, (inter / intra, r_inter / r_intra)


def test_trustworthiness_matches_reference():
    from sklearn.manifold import trustworthiness

    X, _ = _blob_data(n=250, d=8)
    df, rdf = _frames(X)
    t = trustworthiness(X, UMAP(n_neighbors=12, random_state=3, n_epochs=150).fit(df).embedding, n_neighbors=10)
    t_ref = trustworthiness(X, ref.UMAP(n_neighbors=12, random_state=3, n_epochs=150).fit(rdf).embedding, n_neighbors=10)
    assert t > 0.85, t
    assert abs(t - t_ref) < 0.02, (t, t_ref)


def test_transform_lands_near_the_fit():
    X, labels = _blob_data(n=200)
    df, _ = _frames(X)
    model = UMAP(n_neighbors=10, random_state=1, n_epochs=100).fit(df)
    emb = _embedding(model.transform(df))
    assert emb.shape == (200, 2) and emb.dtype == np.float64
    fit_emb = model.embedding
    cents = np.stack([fit_emb[labels == c].mean(axis=0) for c in range(3)])
    assign = np.argmin(np.linalg.norm(emb[:, None, :] - cents[None], axis=2), axis=1)
    want = np.argmin(np.linalg.norm(fit_emb[:, None, :] - cents[None], axis=2), axis=1)
    assert (assign == want).mean() > 0.9


def test_sample_fraction_and_random_init():
    X, _ = _blob_data(n=200)
    df, rdf = _frames(X)
    kw = dict(n_neighbors=8, init="random", random_state=2, n_epochs=80, sample_fraction=0.5)
    model = UMAP(**kw).fit(df)
    r_model = ref.UMAP(**kw).fit(rdf)
    # the same rows are sampled: np.random.default_rng(seed) in both
    np.testing.assert_array_equal(np.asarray(model.raw_data_), np.asarray(r_model.raw_data_))
    assert model.raw_data_.shape[0] < 200
    assert model.embedding.shape[0] == model.raw_data_.shape[0]


def test_persistence_and_params(tmp_path):
    X, _ = _blob_data(n=150)
    df, _ = _frames(X)
    model = UMAP(n_neighbors=8, random_state=4, n_epochs=60).fit(df)
    e1 = _embedding(model.transform(df))
    model.save(str(tmp_path / "umap"))
    loaded = port.load(str(tmp_path / "umap"))
    assert isinstance(loaded, UMAPModel)
    np.testing.assert_array_equal(loaded.embedding_, model.embedding_)
    np.testing.assert_array_equal(loaded.raw_data_, np.asarray(model.raw_data_))
    np.testing.assert_array_equal(_embedding(loaded.transform(df)), e1)
    um = UMAP()
    um2 = um.copy({um.getParam("n_neighbors"): 30})
    assert um2.tpu_params["n_neighbors"] == 30
    um._set_params(min_dist=0.4)
    assert um._tpu_params["min_dist"] == 0.4 and um.getOrDefault("min_dist") == 0.4


def test_precomputed_knn_and_its_mismatch_message():
    from sklearn.neighbors import NearestNeighbors as SkNN

    X, _ = _blob_data(n=60)
    df, rdf = _frames(X)
    k = 10
    dists, ids = SkNN(n_neighbors=k).fit(X.astype(np.float32)).kneighbors(X.astype(np.float32))
    m = UMAP(n_neighbors=k, precomputed_knn=(ids, dists), random_state=5, n_epochs=60).fit(df)
    assert m.embedding_.shape == (60, 2)
    bad_ids = np.tile(np.arange(5), (40, 1))
    bad_d = np.abs(np.random.default_rng(0).random((40, 5))).cumsum(axis=1)
    for est, frame in ((UMAP, df), (ref.UMAP, rdf)):
        with pytest.raises(ValueError, match=r"precomputed_knn has 40 rows.*60"):
            est(n_neighbors=5, precomputed_knn=(bad_ids, bad_d), random_state=0).fit(frame)


def test_supervised_tightens_classes():
    X, labels = _blob_data(n=240, d=8, k=3, seed=7)
    X += np.random.default_rng(1).normal(scale=8.0, size=X.shape)
    df, _ = _frames(X, labels.astype(np.float64))

    def score(emb):
        intra, inter = _separation(emb, labels)
        return inter / max(intra, 1e-9)

    sup = UMAP(n_neighbors=10, random_state=0, n_epochs=150).setLabelCol("label").fit(df)
    unsup = UMAP(n_neighbors=10, random_state=0, n_epochs=150).fit(df)
    assert sup.embedding.shape == (240, 2)
    assert score(sup.embedding) > 1.5 * score(unsup.embedding)


def test_supervised_nan_labels_and_unset_label_col():
    X, labels = _blob_data(n=120, d=6)
    y = labels.astype(np.float64)
    y[::5] = np.nan
    df, _ = _frames(X, y)
    profiling.reset_counters("umap.h2d")
    m = UMAP(n_neighbors=8, random_state=1, n_epochs=60).setLabelCol("label").fit(df)
    assert m.embedding.shape == (120, 2) and np.all(np.isfinite(m.embedding))
    # ids, dists and the label codes
    assert profiling.counters("umap.h2d")["umap.h2d_transfers"] == 3
    # a label column present but labelCol unset: unsupervised
    df_y, _ = _frames(X, labels.astype(np.float64))
    df_x, _ = _frames(X)
    m1 = UMAP(n_neighbors=8, random_state=3, n_epochs=60).fit(df_y)
    m2 = UMAP(n_neighbors=8, random_state=3, n_epochs=60).fit(df_x)
    np.testing.assert_array_equal(m1.embedding_, m2.embedding_)


def test_empty_sample_raises():
    X, _ = _blob_data(n=20)
    df, _ = _frames(X, num_partitions=1)
    with pytest.raises(RuntimeError, match="0 rows"):
        UMAP(n_neighbors=3, sample_fraction=1e-9, random_state=0).fit(df)


def test_ivfflat_graph_preserves_quality():
    rng = np.random.default_rng(0)
    centers = 10.0 * rng.normal(size=(4, 8))
    labels = rng.integers(0, 4, size=640)
    X = (centers[labels] + rng.normal(size=(640, 8))).astype(np.float32)
    df, _ = _frames(X)
    # the two routes find the same ids, and their expanded-form distances
    # leave different small positive self distances (the self slot then
    # counts toward rho), so each seed's fit moves by the layout's own
    # noise: one seed's score spreads by ~0.01-0.02 at n = 640 (the JAX
    # package's gaps at seeds 7, 8, 9 are 0.009, 0.004, 0.007).  The gate is
    # on the mean over three seeds.
    s_exact, s_ann = [], []
    for seed in (7, 8, 9):
        est = UMAP(n_neighbors=12, n_epochs=120, random_state=seed)
        s_exact.append(_neighbor_preservation(X, est.fit(df).embedding_))
        s_ann.append(_neighbor_preservation(X, est.copy().setEngineOptions(graph="ivfflat").fit(df).embedding_))
    assert abs(np.mean(s_ann) - np.mean(s_exact)) < 0.01, (s_ann, s_exact)
    with pytest.raises(ValueError, match="not supported"):
        UMAP().setEngineOptions(graph="hnsw")
    with pytest.raises(ValueError, match="unknown UMAP engine options"):
        UMAP().setEngineOptions(nlist=4)
    # the same options as keywords of the fit function
    with pytest.raises(ValueError, match="not supported"):
        UMAP()._get_tpu_fit_func(df, graph="hnsw")


def test_reference_saved_model_loads_and_transforms(tmp_path):
    # integer rows: every expanded-form distance is exact in both packages'
    # kNN, so both transforms start from the same graph (on real-valued rows
    # the two kNN routes round the distances ~1e-4 apart, and a training
    # row's own nonzero residual becomes rho)
    rng = np.random.default_rng(3)
    centers = rng.integers(-30, 30, size=(3, 8))
    X = (centers[rng.integers(0, 3, size=260)] + rng.integers(-3, 4, size=(260, 8))).astype(np.float64)
    _, rdf_fit = _frames(X[:200])
    df, rdf = _frames(X[200:])
    r_model = ref.UMAP(n_neighbors=10, random_state=2, n_epochs=3).fit(rdf_fit)
    r_model.save(str(tmp_path / "ref_umap"))
    loaded = port.load(str(tmp_path / "ref_umap"))
    assert isinstance(loaded, UMAPModel)
    np.testing.assert_array_equal(loaded.embedding_, r_model.embedding_)
    want = np.stack(r_model.transform(rdf).toPandas()["embedding"].to_numpy())
    got = _embedding(loaded.transform(df))
    np.testing.assert_allclose(got, want, atol=1e-4)
    converted = umap_model_from_reference(ref_load(str(tmp_path / "ref_umap"))._get_model_attributes())
    converted._set_params(n_neighbors=10, random_state=2, n_epochs=3)
    np.testing.assert_array_equal(_embedding(converted.transform(df)), got)


def test_spark_hooks_name_their_roadmap_items():
    # the Spark single-task fit (ROADMAP A14c-2) is the JAX package's class
    # attribute, which the adapter reads (tests/test_torch_spark_barrier_fit.py)
    assert UMAP._cluster_fit_single_task is True and ref.UMAP._cluster_fit_single_task is True
    assert UMAP._supports_multicontroller_fit is False and ref.UMAP._supports_multicontroller_fit is False
    model = UMAPModel(np.zeros((4, 2), np.float32), np.zeros((4, 3), np.float32), 3, "float32")
    # neither package's UMAPModel has cpu()
    assert not hasattr(model, "cpu") and not hasattr(ref.UMAPModel, "cpu")
    # UMAP has no serving entry in either package: the base hook's error
    ref_model = ref.UMAPModel(embedding_=np.zeros((4, 2), np.float32), raw_data_=np.zeros((4, 3), np.float32),
                              n_cols=3, dtype="float32")
    errors = []
    for m in (model, ref_model):
        with pytest.raises(NotImplementedError, match="has no serving entry") as ei:
            m._serving_entry()
        errors.append(str(ei.value))
    assert errors[0] == errors[1]
    assert not hasattr(model, "_lane_entry") and not hasattr(ref_model, "_lane_entry")


def test_mesh_fit_equals_one_device_fit():
    rng = np.random.default_rng(4)
    centers = rng.integers(-40, 40, size=(3, 6))
    X = (centers[rng.integers(0, 3, size=256)] + rng.integers(-4, 5, size=(256, 6))).astype(np.float64)
    df, _ = _frames(X)
    one = UMAP(n_neighbors=10, random_state=6, n_epochs=40, num_workers=1).fit(df)
    with use_device(["cpu"] * 8):
        est = UMAP(n_neighbors=10, random_state=6, n_epochs=40)
        assert est.num_workers == 8
        eight = est.fit(df)
    np.testing.assert_array_equal(eight.embedding_, one.embedding_)
