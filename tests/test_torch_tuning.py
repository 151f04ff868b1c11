# The port's model selection (spark_rapids_ml_tpu_torch.tuning: the
# CrossValidator's fold loop and batched sweep, ParamGridBuilder,
# CrossValidatorModel) against the JAX package's on the same numpy inputs,
# on the CPU, and the port's two routes against each other.
#
# Data: integer-valued features and targets (every sum of the statistics
# pass is exact, so summation order cannot matter) and, for the logistic
# fits, margin-separated labels (no row's score is within 1 of 0, so the
# last-bit differences the lane-batched L-BFGS may have cannot flip a
# prediction): the data on which the JAX package gates its own routes.
#
# Tolerances: fold membership bit for bit; port batched == port sequential
# bit for bit for the linear models (coefficients, intercepts, avgMetrics),
# logistic avgMetrics exactly and coefficients to 5e-3 absolute (the lanes'
# L-BFGS reduces in another order than a solo fit), one staged dataset a
# batched CV.  Port against JAX: the best index equal, accuracy exactly,
# rmse to 1e-6 relative, linear coefficients to 1e-4 and logistic ones to
# 2e-3 absolute (the tolerances of the port's single fits against the JAX
# package's).
import numpy as np
import pytest
import torch

import spark_rapids_ml_tpu as ref
from spark_rapids_ml_tpu import tuning as ref_tuning
from spark_rapids_ml_tpu.core import clear_fit_cache as ref_clear_fit_cache
from spark_rapids_ml_tpu.dataframe import DataFrame as RefDataFrame
from spark_rapids_ml_tpu.dataframe import random_split_ids as ref_random_split_ids
from spark_rapids_ml_tpu.evaluation import MulticlassClassificationEvaluator as RefMCE
from spark_rapids_ml_tpu.evaluation import RegressionEvaluator as RefRE

import spark_rapids_ml_tpu_torch as port
from spark_rapids_ml_tpu_torch import profiling
from spark_rapids_ml_tpu_torch.dataframe import random_split_ids
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.ops import glm

LR, LG = port.LinearRegression, port.LogisticRegression


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield
    port.clear_fit_cache()


def _int_reg(n=300, d=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
    c = rng.integers(-2, 3, size=d).astype(np.float32)
    y = (X @ c + rng.integers(-2, 3, size=n)).astype(np.float32)
    return X, y


def _int_cls(n=300, d=6, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.integers(-3, 4, size=(int(n * 1.5), d)).astype(np.float32)
    c = rng.integers(-2, 3, size=d).astype(np.float32)
    X = X[X @ c != 0][:n]
    assert len(X) == n
    return X, (X @ c > 0).astype(np.float32)


def _lin_grid(cls):
    return ParamGrid(cls).add("regParam", [0.0, 0.1]).add("elasticNetParam", [0.0, 0.5]).build()


def _log_grid(cls):
    return ParamGrid(cls).add("regParam", [0.01, 1.0]).add("elasticNetParam", [0.0, 0.5]).build()


class ParamGrid:
    """One grid for either package: ParamGridBuilder over `cls`'s params."""

    def __init__(self, cls):
        self.cls, self.axes = cls, []

    def add(self, name, values):
        self.axes.append((name, values))
        return self

    def build(self):
        tuning = port.tuning if self.cls.__module__.startswith("spark_rapids_ml_tpu_torch") else ref_tuning
        builder = tuning.ParamGridBuilder()
        for name, values in self.axes:
            builder.addGrid(getattr(self.cls, name), values)
        return builder.build()


def _port_cv(df, est, grid, eva, batched=True, **kw):
    port.clear_fit_cache()
    cv = port.CrossValidator(estimator=est, estimatorParamMaps=grid, evaluator=eva, **kw)
    c0 = profiling.counters("ingest.")
    model = cv._fit(df, batched=batched)
    c1 = profiling.counters("ingest.")
    return model, {k: v - c0.get(k, 0) for k, v in c1.items()}, cv


def _ref_cv(df, est, grid, eva, batched, monkeypatch, **kw):
    monkeypatch.setenv("SRML_SWEEP_BATCH", "1" if batched else "0")
    ref_clear_fit_cache()
    return ref_tuning.CrossValidator(estimator=est, estimatorParamMaps=grid, evaluator=eva, **kw).fit(df)


@pytest.mark.parametrize("n,weights,seed", [(300, 3, 5), (1001, [1.0, 2.0, 0.5], 7), (24, 8, 1)])
def test_random_split_ids_match_reference_bit_for_bit(n, weights, seed):
    np.testing.assert_array_equal(random_split_ids(n, weights, seed), ref_random_split_ids(n, weights, seed))


def test_random_split_frames_match_reference():
    X, y = _int_reg(n=101, d=3, seed=2)
    ours = port.DataFrame.from_numpy(X, y, num_partitions=4).randomSplit([1.0, 1.0, 1.0], seed=9)
    theirs = RefDataFrame.from_numpy(X, y=y, num_partitions=4).randomSplit([1.0, 1.0, 1.0], seed=9)
    for a, b in zip(ours, theirs):
        pdf = b.toPandas()
        assert [len(p) for p in a.partitions] == [len(p) for p in b.partitions]
        np.testing.assert_array_equal(np.concatenate([p["features"] for p in a.partitions]), np.stack(pdf["features"]))
        np.testing.assert_array_equal(np.concatenate([p["label"] for p in a.partitions]), pdf["label"].to_numpy())


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "fold_loop"])
def test_linear_cv_matches_reference(batched, monkeypatch):
    X, y = _int_reg()
    kw = dict(numFolds=3, seed=5, collectSubModels=True)
    ours, _, _ = _port_cv(port.DataFrame.from_numpy(X, y, num_partitions=4), LR(standardization=False),
                          _lin_grid(LR), port.RegressionEvaluator(), batched, **kw)
    theirs = _ref_cv(RefDataFrame.from_numpy(X, y=y, num_partitions=4),
                     ref.LinearRegression(standardization=False, num_workers=1), _lin_grid(ref.LinearRegression),
                     RefRE(), batched, monkeypatch, **kw)
    assert int(np.argmin(ours.avgMetrics)) == int(np.argmin(theirs.avgMetrics))
    np.testing.assert_allclose(ours.avgMetrics, theirs.avgMetrics, rtol=1e-6)
    for f in range(3):
        for i in range(4):
            a, b = ours.subModels[f][i], theirs.subModels[f][i]
            np.testing.assert_allclose(a.coef_, np.asarray(b.coef_), atol=1e-4)
            np.testing.assert_allclose(a.intercept_, float(b.intercept_), atol=1e-4)
    np.testing.assert_allclose(ours.bestModel.coef_, np.asarray(theirs.bestModel.coef_), atol=1e-4)


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "fold_loop"])
def test_logistic_cv_matches_reference(batched, monkeypatch):
    X, y = _int_cls()
    kw = dict(numFolds=3, seed=7, collectSubModels=True)
    ours, _, _ = _port_cv(port.DataFrame.from_numpy(X, y, num_partitions=3), LG(maxIter=200), _log_grid(LG),
                          port.MulticlassClassificationEvaluator(metricName="accuracy"), batched, **kw)
    theirs = _ref_cv(RefDataFrame.from_numpy(X, y=y, num_partitions=3),
                     ref.LogisticRegression(maxIter=200, num_workers=1), _log_grid(ref.LogisticRegression),
                     RefMCE(metricName="accuracy"), batched, monkeypatch, **kw)
    assert ours.avgMetrics == theirs.avgMetrics
    assert int(np.argmax(ours.avgMetrics)) == int(np.argmax(theirs.avgMetrics))
    for f in range(3):
        for i in range(4):
            np.testing.assert_allclose(ours.subModels[f][i].coef_, np.asarray(theirs.subModels[f][i].coef_), atol=2e-3)


def test_linear_batched_equals_fold_loop_bit_for_bit():
    X, y = _int_reg()
    df = port.DataFrame.from_numpy(X, y, num_partitions=4)
    kw = dict(numFolds=3, seed=5, collectSubModels=True)
    seq, d_seq, _ = _port_cv(df, LR(standardization=False), _lin_grid(LR), port.RegressionEvaluator(), False, **kw)
    bat, d_bat, cv = _port_cv(df, LR(standardization=False), _lin_grid(LR), port.RegressionEvaluator(), True, **kw)
    assert bat.avgMetrics == seq.avgMetrics and bat.stdMetrics == seq.stdMetrics
    for f in range(3):
        for i in range(4):
            s, b = seq.subModels[f][i], bat.subModels[f][i]
            np.testing.assert_array_equal(s.coef_, b.coef_)
            assert s.intercept_ == b.intercept_
            assert s.getOrDefault("regParam") == b.getOrDefault("regParam")
    np.testing.assert_array_equal(seq.bestModel.coef_, bat.bestModel.coef_)
    # the batched CV staged the dataset once; its scoring and its refit
    # found it cached
    assert d_bat.get("ingest.staged") == 1 and d_bat.get("ingest.cache_hit") == 2, d_bat
    assert d_seq.get("ingest.staged") == 4, d_seq  # three folds and the refit
    assert {"tuning.sweep.ingest", "tuning.sweep.stats", "tuning.sweep.solve", "tuning.sweep.cd",
            "tuning.sweep.score", "tuning.sweep.refit", "tuning.sweep"} <= set(cv._last_fit_phase_times)


def test_logistic_batched_equals_fold_loop():
    X, y = _int_cls()
    df = port.DataFrame.from_numpy(X, y, num_partitions=3)
    eva = port.MulticlassClassificationEvaluator(metricName="accuracy")
    kw = dict(numFolds=3, seed=7, collectSubModels=True)
    seq, _, _ = _port_cv(df, LG(maxIter=200), _log_grid(LG), eva, False, **kw)
    bat, d_bat, _ = _port_cv(df, LG(maxIter=200), _log_grid(LG), eva, True, **kw)
    assert bat.avgMetrics == seq.avgMetrics and bat.stdMetrics == seq.stdMetrics
    for f in range(3):
        for i in range(4):
            np.testing.assert_allclose(bat.subModels[f][i].coef_, seq.subModels[f][i].coef_, atol=5e-3)
    assert d_bat.get("ingest.staged") == 1, d_bat


def test_batched_sweep_is_deterministic():
    X, y = _int_cls(n=240, seed=4)
    df = port.DataFrame.from_numpy(X, y, num_partitions=3)
    grid = ParamGrid(LG).add("regParam", [0.01, 0.5, 2.0]).build()
    eva = port.MulticlassClassificationEvaluator(metricName="accuracy")
    runs = [_port_cv(df, LG(maxIter=100), grid, eva, numFolds=2, seed=3, collectSubModels=True)[0] for _ in range(2)]
    assert runs[0].avgMetrics == runs[1].avgMetrics
    for f in range(2):
        for i in range(3):
            np.testing.assert_array_equal(runs[0].subModels[f][i].coef_, runs[1].subModels[f][i].coef_)


def test_single_candidate_grid_takes_the_batched_route():
    X, y = _int_reg(n=200, seed=11)
    df = port.DataFrame.from_numpy(X, y, num_partitions=4)
    grid = ParamGrid(LR).add("regParam", [0.1]).build()
    models = {}
    for batched in (False, True):
        c0 = profiling.counters("tuning.").get("tuning.candidates", 0)
        models[batched] = _port_cv(df, LR(standardization=False), grid, port.RegressionEvaluator(), batched,
                                   numFolds=3, seed=6)[0]
        routed = profiling.counters("tuning.").get("tuning.candidates", 0) - c0
        assert routed == (1 if batched else 0)
    assert models[True].avgMetrics == models[False].avgMetrics
    np.testing.assert_array_equal(models[True].bestModel.coef_, models[False].bestModel.coef_)


def test_many_small_folds():
    # 24 rows in 8 folds: 3-row validation folds, near-rank-deficient trains
    X, y = _int_reg(n=24, d=4, seed=13)
    df = port.DataFrame.from_numpy(X, y, num_partitions=2)
    grid = ParamGrid(LR).add("regParam", [0.0, 1.0]).build()
    seq, bat = (_port_cv(df, LR(standardization=False), grid, port.RegressionEvaluator(), b, numFolds=8, seed=1)[0]
                for b in (False, True))
    assert bat.avgMetrics == seq.avgMetrics and bat.stdMetrics == seq.stdMetrics


def test_sparse_input_and_other_params_decline_the_batched_route():
    import scipy.sparse as sp

    X, y = _int_reg(n=120, seed=8)
    df = port.DataFrame.from_numpy(X, y, num_partitions=2)
    eva = port.RegressionEvaluator()
    plain = ParamGrid(LR).add("regParam", [0.0, 0.1]).build()
    mixed = ParamGrid(LR).add("regParam", [0.0, 0.1]).add("fitIntercept", [True, False]).build()
    Xs = sp.random(150, 8, density=0.3, random_state=1, dtype=np.float32, format="csr")
    sparse_df = port.DataFrame.from_numpy(Xs, np.asarray(Xs @ np.arange(8.0), np.float32), num_partitions=2)
    assert LR()._supportsBatchedSweep(df, plain, eva)
    assert not LR()._supportsBatchedSweep(df, mixed, eva)
    assert not LR()._supportsBatchedSweep(sparse_df, plain, eva)
    assert not LR()._supportsBatchedSweep(df, plain, port.MulticlassClassificationEvaluator())
    # the sparse frame's CV runs the fold loop, end to end
    c0 = profiling.counters("tuning.").get("tuning.candidates", 0)
    model = _port_cv(sparse_df, LR(), plain, eva, numFolds=2, seed=4)[0]
    assert len(model.avgMetrics) == 2 and profiling.counters("tuning.").get("tuning.candidates", 0) == c0


def test_failing_batched_sweep_raises(monkeypatch):
    X, y = _int_reg(n=120, seed=3)
    df = port.DataFrame.from_numpy(X, y, num_partitions=2)
    est = LR()

    def broken(*args, **kwargs):
        raise RuntimeError("sweep failed")

    monkeypatch.setattr(est, "_fitBatchedSweep", broken)
    folds = []
    monkeypatch.setattr(port.CrossValidator, "_fit_folds", lambda *a, **k: folds.append(1))
    with pytest.raises(RuntimeError, match="sweep failed"):
        port.CrossValidator(estimator=est, estimatorParamMaps=ParamGrid(LR).add("regParam", [0.0, 0.1]).build(),
                            evaluator=port.RegressionEvaluator()).fit(df)
    assert folds == []


def test_cd_lanes_share_one_runner_and_keep_their_own_values():
    # a repeat sweep at the same shape with another grid builds no new CD
    # runner (on the card: captures no new graph), and lanes with other
    # alphas give other coefficients (each lane's values reach the sweep)
    X, y = _int_reg(n=200, d=5, seed=21)
    df = port.DataFrame.from_numpy(X, y, num_partitions=2)

    def run(alphas):
        grid = ParamGrid(LR).add("regParam", alphas).add("elasticNetParam", [0.5]).build()
        return _port_cv(df, LR(standardization=False), grid, port.RegressionEvaluator(), numFolds=3, seed=2,
                        collectSubModels=True)[0]

    first = run([0.05, 0.5])
    runners = dict(glm._CD_RUNNERS)
    second = run([0.1, 1.0])
    assert dict(glm._CD_RUNNERS) == runners
    lanes = [m.coef_ for models in (first.subModels[0], second.subModels[0]) for m in models]
    assert all(not np.array_equal(a, b) for i, a in enumerate(lanes) for b in lanes[i + 1:])


def test_parallel_folds_match_serial():
    X, y = _int_reg(n=200, seed=5)
    df = port.DataFrame.from_numpy(X, y, num_partitions=4)
    grid = ParamGrid(LR).add("regParam", [0.0, 1.0]).build()
    serial = _port_cv(df, LR(standardization=False), grid, port.RegressionEvaluator(), False, seed=3)[0]
    threads = _port_cv(df, LR(standardization=False), grid, port.RegressionEvaluator(), False, seed=3, parallelism=3)[0]
    assert serial.avgMetrics == threads.avgMetrics


def test_collect_sub_models_copy_and_persistence(tmp_path):
    X, y = _int_reg(n=150, seed=6)
    df = port.DataFrame.from_numpy(X, y, num_partitions=2)
    grid = ParamGrid(LR).add("regParam", [0.0, 0.5]).build()
    eva = port.RegressionEvaluator()
    cv = port.CrossValidator(estimator=LR(), estimatorParamMaps=grid, evaluator=eva, numFolds=2, collectSubModels=True)
    cp = cv.copy()
    assert cp.getNumFolds() == 2 and cp.getEstimator() is not cv.getEstimator()
    assert cp.getEvaluator() is not eva and cp.getEstimatorParamMaps() == grid
    assert cp.getEstimatorParamMaps() is not cv.getEstimatorParamMaps()
    model = cp.fit(df)
    assert len(model.subModels) == 2 and len(model.subModels[0]) == 2
    model.save(str(tmp_path / "cv"))
    loaded = port.load(str(tmp_path / "cv"))
    assert isinstance(loaded, port.CrossValidatorModel)
    assert loaded.avgMetrics == model.avgMetrics and loaded.stdMetrics == model.stdMetrics
    p1 = np.concatenate([p["prediction"] for p in model.transform(df).partitions])
    p2 = np.concatenate([p["prediction"] for p in loaded.transform(df).partitions])
    np.testing.assert_array_equal(p1, p2)


def test_reference_saved_cv_and_pipeline_models_load(tmp_path):
    X, y = _int_cls(n=200, d=5, seed=9)
    ref_df = RefDataFrame.from_numpy(X, y=y, num_partitions=2)
    df = port.DataFrame.from_numpy(X, y, num_partitions=2)
    cv = ref_tuning.CrossValidator(
        estimator=ref.LogisticRegression(maxIter=50, num_workers=1),
        estimatorParamMaps=_log_grid(ref.LogisticRegression),
        evaluator=RefMCE(metricName="accuracy"), numFolds=2,
    )
    ref_cv_model = cv.fit(ref_df)
    ref_cv_model.save(str(tmp_path / "cv"))
    loaded = port.load(str(tmp_path / "cv"))
    assert isinstance(loaded, port.CrossValidatorModel) and loaded.avgMetrics == ref_cv_model.avgMetrics
    want = ref_cv_model.transform(ref_df).toPandas()["prediction"].to_numpy()
    np.testing.assert_array_equal(np.concatenate([p["prediction"] for p in loaded.transform(df).partitions]), want)

    pca = ref.PCA(k=3).setInputCol("features").setOutputCol("pca_features")
    lr = ref.LinearRegression(regParam=0.1, num_workers=1).setFeaturesCol("pca_features")
    ref_pm = ref.Pipeline([pca, lr]).fit(ref_df)
    ref_pm.save(str(tmp_path / "pm"))
    pm = port.load(str(tmp_path / "pm"))
    assert isinstance(pm, port.PipelineModel) and [type(s).__name__ for s in pm.stages] == ["PCAModel",
                                                                                             "LinearRegressionModel"]
    want = ref_pm.transform(ref_df).toPandas()["prediction"].to_numpy()
    got = np.concatenate([p["prediction"] for p in pm.transform(df).partitions])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_cv_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _int_reg(n=60, seed=1)
    df = port.DataFrame.from_numpy(X, y)
    grid = ParamGrid(LR).add("regParam", [0.0, 0.1]).build()
    for batched in (True, False):
        cv = port.CrossValidator(estimator=LR(), estimatorParamMaps=grid, evaluator=port.RegressionEvaluator())
        with use_device(None), pytest.raises(RuntimeError, match="use_device"):
            cv._fit(df, batched=batched)
