# The port's multi-controller layer on the CPU (spark_rapids_ml_tpu_torch/
# parallel/runner.py, context.py, mesh.py, exchange.py): two real OS
# processes, each with use_device(["cpu"] * 4), bootstrap torch.distributed
# (gloo, by the backend rule) through TpuContext over a FileControlPlane and
# fit through one DistributedFitSession on the data of JAX
# tests/test_multicontroller.py:41-70 (N 4,096, D 12).  Gates:
#
#   - an even split (2,048 rows a rank): every model attribute of KMeans,
#     PCA, LinearRegression (OLS and ridge), LogisticRegression (binary and
#     3-class with the labels 1, 3, 5) and both forests equals the port's
#     one-process fit on use_device(["cpu"] * 8), bit for bit;
#   - the same fits within the JAX test's own tolerances of the JAX
#     package's single-process 8-device fit (KMeans: its 2-rank gate, the
#     centers within 1e-5, the two packages drawing one init from the same
#     threefry keys, and its other rule, inertia within 5%; linear
#     coefficients: the JAX test's
#     rtol 2e-4 and atol 1e-4, the atol scaled by max(1, max |coef|) as the
#     port's linear-regression tests scale it, since the two packages'
#     float32 normal equations each land ~1e-4 off a float64 solve here;
#     the forests, with bootstrap (both packages draw the JAX package's
#     Poisson counts) and without: the JAX test's prediction-agreement and
#     accuracy / RMSE gates);
#   - an uneven split (3,000 / 1,096) and a rank with zero rows: within the
#     same tolerances of the JAX package's fit, but for the linear
#     coefficients: each rank pads inside its share, so the float32 sums run
#     over another layout, and the gate is UNEVEN_LINEAR_ATOL of both the
#     JAX fit and a float64 least-squares solve;
#   - SRML_FAULTS killing rank 1 at runner.fit: rank 0 raises a typed error
#     (RemoteRankError or ControlPlaneTimeout) within 30 s, and both
#     processes end;
#   - UMAP raises the JAX package's message.
#
# The file doubles as its worker script:
#     python tests/test_torch_multicontroller.py <rank> <nranks> <job dir>
# A worker imports the port only (never jax).  Every subprocess runs under a
# timeout of its own (180 s); the scenarios' processes run concurrently.
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NRANKS = 2
DEVS_PER_RANK = 4
N, D = 4096, 12
WORKER_TIMEOUT_S = 180
KILL_DETECT_S = 30.0


def _make_data():
    """JAX tests/test_multicontroller.py's data."""
    rng = np.random.default_rng(7)
    X = rng.standard_normal((N, D)).astype(np.float32)
    X *= (1.25 ** -np.arange(D, dtype=np.float32))[None, :]
    X[: N // 2] += 3.0
    true_w = rng.standard_normal(D).astype(np.float32)
    y = (X @ true_w + 0.1 * rng.standard_normal(N)).astype(np.float32)
    margin = X @ true_w
    y_bin = (margin > 0).astype(np.float32)
    y_multi = (np.digitize(margin, np.quantile(margin, [1 / 3, 2 / 3])) * 2.0 + 1.0).astype(np.float32)
    return X, y, y_bin, y_multi


def _estimators(pkg):
    """The JAX test's estimators, in either package."""
    return {
        "kmeans": pkg.KMeans(k=4, maxIter=15, seed=11),
        "pca": pkg.PCA(k=3),
        "linreg": pkg.LinearRegression(),
        "ridge": pkg.LinearRegression(regParam=0.05),
        "logreg_bin": pkg.LogisticRegression(maxIter=60, regParam=0.01, labelCol="y_bin"),
        "logreg_multi": pkg.LogisticRegression(maxIter=60, regParam=0.01, labelCol="y_multi"),
        "rf_clf": pkg.RandomForestClassifier(numTrees=8, maxDepth=4, maxBins=16, seed=3, labelCol="y_multi"),
        "rf_reg": pkg.RandomForestRegressor(numTrees=8, maxDepth=4, maxBins=16, seed=3),
        # the forests without bootstrap
        "rf_clf_nb": pkg.RandomForestClassifier(numTrees=8, maxDepth=4, maxBins=16, seed=3, labelCol="y_multi",
                                                bootstrap=False),
        "rf_reg_nb": pkg.RandomForestRegressor(numTrees=8, maxDepth=4, maxBins=16, seed=3, bootstrap=False),
    }


def _partition(rows):
    X, y, y_bin, y_multi = _make_data()
    return {"features": X[rows], "label": y[rows], "y_bin": y_bin[rows], "y_multi": y_multi[rows]}


FITS_ALL = ["kmeans", "pca", "linreg", "ridge", "logreg_bin", "logreg_multi", "rf_clf", "rf_reg", "rf_clf_nb",
            "rf_reg_nb"]
# the fits held against the JAX package's
JAX_COMPARED = FITS_ALL
# scenario -> (rows of each rank, the fits, SRML_FAULTS)
SCENARIOS = {
    "even": ([np.arange(0, N // 2), np.arange(N // 2, N)], FITS_ALL, ""),
    "uneven": ([np.arange(0, 3000), np.arange(3000, N)], ["kmeans", "pca", "linreg", "logreg_multi", "rf_reg_nb"], ""),
    "empty": ([np.arange(0, N), np.arange(0)], ["kmeans", "linreg", "logreg_bin"], ""),
    "kill": ([np.arange(0, N // 2), np.arange(N // 2, N)], ["linreg"], "runner.fit:rank=1:action=die"),
}


COLLECTIVE_SHAPE = (3, 5)
RING_SHIFTS = (1, -1, 3)


def _shard_blocks(n_shards, dtype):
    """Global shard g's block: distinct values a shard (integers, so every
    sum is exact in any order)."""
    import torch

    return [torch.arange(15, dtype=dtype).reshape(COLLECTIVE_SHAPE) + 100 * g for g in range(n_shards)]


def _run_collectives(xs):
    """Every DeviceSection collective over the sharded value xs (this
    rank's shards, or every shard on one process)."""
    from spark_rapids_ml_tpu_torch.parallel.exchange import device_collective

    sec = device_collective("test.collectives")
    out = {
        "allgather_rows": sec.allgather_rows(xs)[0],
        "gather_stack": sec.gather_stack(xs)[-1],
        "gather_to_first": sec.gather_to_first(xs),
        "psum": sec.psum(xs)[0],
        "psum_merge": sec.psum_merge(xs)[0],
        "psum_bool": sec.psum([(x > 250).to(float) for x in xs])[0],
        "gather_bool": sec.gather_stack([x > 250 for x in xs])[0],
    }
    for shift in RING_SHIFTS:
        for i, block in enumerate(sec.ring_shift(xs, shift)):
            out[f"ring_{shift}_{i}"] = block
    return {k: v.cpu().numpy() for k, v in out.items()}


def _collectives(mesh, rank):
    """The collectives of this rank's local shards across the processes."""
    import torch

    from spark_rapids_ml_tpu_torch.parallel.mesh import process_scope

    blocks = _shard_blocks(mesh.size, torch.float32)
    local = blocks[mesh.shard_offset : mesh.shard_offset + mesh.local_size]
    with process_scope(mesh):
        return _run_collectives(local)


def _worker(rank: int, nranks: int, root: str) -> int:
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    import spark_rapids_ml_tpu_torch as port
    from spark_rapids_ml_tpu_torch.device import use_device
    from spark_rapids_ml_tpu_torch.parallel.context import ControlPlaneTimeout, RemoteRankError
    from spark_rapids_ml_tpu_torch.parallel.runner import distributed_session, make_control_plane

    with open(os.path.join(root, "job.json")) as f:
        job = json.load(f)
    use_device(["cpu"] * job["devices"])
    part = _partition(np.asarray(job["rows"][rank], dtype=np.int64))
    ests = _estimators(port)
    cp = make_control_plane(os.path.join(root, "cp"), rank, nranks, timeout=60.0)
    out, meta = {}, {}
    t0 = time.monotonic()
    try:
        with distributed_session(rank, nranks, cp) as session:
            meta = {"rank": rank, "local_shards": session.mesh.local_size, "global_shards": session.mesh.size,
                    **session.context.phases}
            for name in job["fits"]:
                t0 = time.monotonic()
                out[name] = session.fit(ests[name], [part])
            if job.get("collectives"):
                np.savez(os.path.join(root, f"collectives_rank{rank}.npz"), **_collectives(session.mesh, rank))
    except (RemoteRankError, ControlPlaneTimeout) as exc:
        with open(os.path.join(root, f"error_rank{rank}.json"), "w") as f:
            json.dump({"type": type(exc).__name__, "message": str(exc), "seconds": time.monotonic() - t0}, f)
        return 3
    with open(os.path.join(root, f"meta_rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    if rank == 0:
        with open(os.path.join(root, "attrs.json"), "w") as f:
            json.dump(out, f)
    return 0


def _launch(root, rows, fits, faults):
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "job.json"), "w") as f:
        json.dump({"devices": DEVS_PER_RANK, "rows": [r.tolist() for r in rows], "fits": fits,
                   "collectives": fits == FITS_ALL}, f)
    env = {k: v for k, v in os.environ.items() if k not in ("SRML_FAULTS", "XLA_FLAGS")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", SRML_FAULTS=faults)
    return [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(NRANKS), root], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(NRANKS)
    ]


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Every scenario's two processes, started together; {scenario: (root,
    return codes, outputs, wall seconds)}."""
    base = tmp_path_factory.mktemp("torch_mc")
    started = {}
    for name, (rows, fits, faults) in SCENARIOS.items():
        root = str(base / name)
        started[name] = (root, time.monotonic(), _launch(root, rows, fits, faults))
    done = {}
    for name, (root, t0, procs) in started.items():
        outs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            outs.append(out)
        done[name] = (root, [p.returncode for p in procs], outs, time.monotonic() - t0)
    return done


def _attrs(jobs, scenario):
    from spark_rapids_ml_tpu_torch.core import TELEMETRY_ATTR
    from spark_rapids_ml_tpu_torch.parallel.runner import decode_attrs

    root, rcs, outs, _ = jobs[scenario]
    assert rcs == [0, 0], f"{scenario}: return codes {rcs}\n" + "\n".join(outs)
    with open(os.path.join(root, "attrs.json")) as f:
        payload = json.load(f)
    out = {}
    for name, results in payload.items():
        assert len(results) == 1
        attrs = decode_attrs(results[0])
        assert TELEMETRY_ATTR in attrs
        attrs.pop(TELEMETRY_ATTR)
        out[name] = attrs
    return out


_ONE_PROCESS: dict = {}
_JAX: dict = {}


def _one_process(name):
    """The port's one-process fit on use_device(["cpu"] * 8) (the same 8
    global shards, 512 rows each)."""
    if name not in _ONE_PROCESS:
        import torch

        import spark_rapids_ml_tpu_torch as port
        from spark_rapids_ml_tpu_torch.device import use_device

        df = port.DataFrame([_partition(np.arange(0, N // 2)), _partition(np.arange(N // 2, N))])
        # the workers' one CPU thread: a float32 product's blocking, and so
        # its bits, may follow the thread count
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            with use_device(["cpu"] * 8):
                _ONE_PROCESS[name] = _estimators(port)[name].fit(df)
        finally:
            torch.set_num_threads(threads)
        port.clear_fit_cache()
    return _ONE_PROCESS[name]


def _jax(name):
    """The JAX package's single-process fit on its 8 CPU devices."""
    if name not in _JAX:
        import pandas as pd

        import spark_rapids_ml_tpu as ref
        from spark_rapids_ml_tpu.dataframe import DataFrame as RefDataFrame

        X, y, y_bin, y_multi = _make_data()
        pdf = pd.DataFrame({"features": list(X), "label": y, "y_bin": y_bin, "y_multi": y_multi})
        _JAX[name] = _estimators(ref)[name].fit(RefDataFrame.from_pandas(pdf, num_partitions=NRANKS))
    return _JAX[name]


def _model(name, attrs):
    import spark_rapids_ml_tpu_torch as port

    est = _estimators(port)[name]
    return est._materialize_model(dict(attrs))


def _predict(model, X):
    import spark_rapids_ml_tpu_torch as port
    from spark_rapids_ml_tpu_torch.device import use_device

    with use_device("cpu"):
        out = model.transform(port.DataFrame.from_numpy(X))
    return np.concatenate([p["prediction"] for p in out.partitions]).astype(np.float64)


def _jax_predict(model, X):
    from spark_rapids_ml_tpu.dataframe import DataFrame as RefDataFrame

    return model.transform(RefDataFrame.from_numpy(X)).toPandas()["prediction"].to_numpy(np.float64)


# an uneven split's linear coefficients: the float32 normal equations of a
# padding layout other than the one-process one, measured 3.6e-4 off a
# float64 solve of this data (the JAX 8-device fit 1.1e-4, the port's
# one-process fit 1.5e-4), against the JAX fit and the float64 solve
UNEVEN_LINEAR_ATOL = 5e-4


def _float64_least_squares():
    X, y, _, _ = _make_data()
    sol = np.linalg.lstsq(np.c_[X.astype(np.float64), np.ones(N)], y.astype(np.float64), rcond=None)[0]
    return sol[:-1], sol[-1]


def _within_jax_tolerances(name, attrs, uneven=False):
    """The JAX test's gates (tests/test_multicontroller.py:221-343) of a
    multi-process fit against the JAX package's 8-device fit (module
    header); `uneven` takes UNEVEN_LINEAR_ATOL for the linear
    coefficients."""
    b = _jax(name)
    X, y, _, y_multi = _make_data()
    if name == "kmeans":
        assert attrs["cluster_centers_"].shape == (4, D)
        assert float(attrs["inertia_"]) <= float(np.asarray(b.inertia_)) * 1.05
        if not uneven:
            np.testing.assert_allclose(attrs["cluster_centers_"], np.asarray(b.cluster_centers_), rtol=1e-5, atol=1e-5)
    elif name == "pca":
        np.testing.assert_allclose(attrs["mean_"], np.asarray(b.mean_), atol=1e-5)
        np.testing.assert_allclose(attrs["components_"], np.asarray(b.components_), atol=1e-4)
        np.testing.assert_allclose(attrs["explained_variance_"], np.asarray(b.explained_variance_), rtol=1e-4)
    elif name in ("linreg", "ridge"):
        # the JAX test's rtol 2e-4 and atol 1e-4, the atol times max(1,
        # max |coef|) as the port's linear-regression tests scale it: both
        # packages solve float32 normal equations, each ~1e-4 off a float64
        # solve on this data's weakest column
        scale = max(1.0, float(np.abs(np.asarray(b.coef_)).max()))
        if uneven:
            coef64, intercept64 = _float64_least_squares()
            np.testing.assert_allclose(attrs["coef_"], np.asarray(b.coef_), rtol=0, atol=UNEVEN_LINEAR_ATOL)
            np.testing.assert_allclose(attrs["coef_"], coef64, rtol=0, atol=UNEVEN_LINEAR_ATOL)
            np.testing.assert_allclose(attrs["intercept_"], intercept64, rtol=0, atol=UNEVEN_LINEAR_ATOL)
        else:
            np.testing.assert_allclose(attrs["coef_"], np.asarray(b.coef_), rtol=2e-4, atol=1e-4 * scale)
        np.testing.assert_allclose(attrs["intercept_"], np.asarray(b.intercept_), rtol=2e-4, atol=1e-4 * scale)
    elif name.startswith("logreg"):
        np.testing.assert_array_equal(attrs["classes_"], np.asarray(b.classes_))
        np.testing.assert_allclose(attrs["coef_"], np.asarray(b.coef_), rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(attrs["intercept_"], np.asarray(b.intercept_), rtol=2e-2, atol=2e-2)
    elif name in ("rf_clf", "rf_clf_nb"):
        model = _model(name, attrs)
        np.testing.assert_array_equal(model.classes_, b.classes_)
        p_mc, p_sc = _predict(model, X), _jax_predict(b, X)
        assert (p_mc == p_sc).mean() >= 0.98
        assert (p_mc == y_multi).mean() >= 0.70
    elif name in ("rf_reg", "rf_reg_nb"):
        p_mc, p_sc = _predict(_model(name, attrs), X), _jax_predict(b, X)
        assert float(np.sqrt(((p_mc - p_sc) ** 2).mean())) < 0.05 * float(p_sc.std())


def test_processes_bootstrap_gloo_on_one_global_mesh(jobs):
    root, rcs, outs, seconds = jobs["even"]
    assert rcs == [0, 0], "\n".join(outs)
    for r in range(NRANKS):
        with open(os.path.join(root, f"meta_rank{r}.json")) as f:
            meta = json.load(f)
        assert meta["backend"] == "gloo"  # the rule: CPU ranks
        assert meta["device_identities"] == [["cpu"] * DEVS_PER_RANK] * NRANKS
        assert (meta["local_shards"], meta["global_shards"]) == (DEVS_PER_RANK, NRANKS * DEVS_PER_RANK)
        assert meta["bootstrap_s"] < 60.0


@pytest.mark.parametrize("name", FITS_ALL)
def test_even_split_is_bitwise_the_one_process_8_shard_fit(jobs, name):
    attrs = _attrs(jobs, "even")[name]
    single = _one_process(name)
    for key, value in attrs.items():
        want = getattr(single, key)
        if isinstance(value, np.ndarray):
            assert value.dtype == np.asarray(want).dtype and value.shape == np.asarray(want).shape, key
            np.testing.assert_array_equal(value, np.asarray(want), err_msg=f"{name}.{key}")
        else:
            assert value == want, f"{name}.{key}: {value} != {want}"


@pytest.mark.parametrize("name", JAX_COMPARED)
def test_even_split_within_the_jax_tests_tolerances(jobs, name):
    _within_jax_tolerances(name, _attrs(jobs, "even")[name])


@pytest.mark.parametrize("scenario", ["uneven", "empty"])
def test_uneven_and_empty_rank_within_the_jax_tests_tolerances(jobs, scenario):
    attrs = _attrs(jobs, scenario)
    assert set(attrs) == set(SCENARIOS[scenario][1])
    for name, a in attrs.items():
        _within_jax_tolerances(name, a, uneven=True)


def test_cross_process_collectives_equal_one_process(jobs):
    """Every DeviceSection collective across the 2 x 4 shards gives what the
    one-process 8-shard mesh gives: the gathers, psum in global shard
    order, bool blocks, and ring_shift by 1, -1 and 3 (hops inside a rank
    and send/recv across ranks)."""
    import torch

    from spark_rapids_ml_tpu_torch.device import use_device

    root, rcs, outs, _ = jobs["even"]
    assert rcs == [0, 0], "\n".join(outs)
    ranks = [dict(np.load(os.path.join(root, f"collectives_rank{r}.npz"))) for r in range(NRANKS)]
    with use_device("cpu"):
        want = _run_collectives(_shard_blocks(NRANKS * DEVS_PER_RANK, torch.float32))
    for key in ("allgather_rows", "gather_stack", "gather_to_first", "psum", "psum_merge", "psum_bool", "gather_bool"):
        for r in range(NRANKS):
            assert ranks[r][key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(ranks[r][key], want[key], err_msg=key)
    for shift in RING_SHIFTS:
        for r in range(NRANKS):
            for i in range(DEVS_PER_RANK):
                np.testing.assert_array_equal(ranks[r][f"ring_{shift}_{i}"],
                                              want[f"ring_{shift}_{r * DEVS_PER_RANK + i}"], err_msg=f"{shift} {r} {i}")


def test_killed_rank_is_a_typed_error_on_rank_0(jobs):
    root, rcs, outs, seconds = jobs["kill"]
    assert rcs[1] == 17, outs[1]  # faults.DIE_EXIT_CODE: died by injection
    assert rcs[0] == 3, outs[0]
    with open(os.path.join(root, "error_rank0.json")) as f:
        err = json.load(f)
    assert err["type"] in ("RemoteRankError", "ControlPlaneTimeout")
    assert "rank 1" in err["message"] or "[1]" in err["message"]
    assert err["seconds"] < KILL_DETECT_S
    assert not os.path.exists(os.path.join(root, "error_rank1.json"))


def test_umap_raises_the_jax_message(tmp_path):
    import spark_rapids_ml_tpu as ref
    from spark_rapids_ml_tpu.parallel.runner import DistributedFitSession as RefSession

    import spark_rapids_ml_tpu_torch as port
    from spark_rapids_ml_tpu_torch.device import use_device
    from spark_rapids_ml_tpu_torch.parallel.runner import DistributedFitSession, FileControlPlane

    with use_device(["cpu"] * 2):
        session = DistributedFitSession(0, 2, FileControlPlane(str(tmp_path / "cp"), 0, 2))
        with pytest.raises(NotImplementedError) as ours:
            session.fit(port.UMAP(), [_partition(np.arange(8))])
    with pytest.raises(NotImplementedError) as theirs:
        RefSession(0, 2, FileControlPlane(str(tmp_path / "cp_ref"), 0, 2)).fit(ref.UMAP(), [])
    assert str(ours.value) == str(theirs.value)
    assert "multi-process (barrier) training" in str(ours.value)


if __name__ == "__main__":
    sys.exit(_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]))
