# The opt-in whole-fit trace (profiling.maybe_trace, the JAX package's
# SRML_PROFILE capture, here torch.profiler): a fit under SRML_PROFILE=<dir>
# writes one Chrome trace into <dir>/<Estimator>, a fit without it writes
# none, and a multi-process fit's rank writes its own under
# <dir>/<Estimator>-rank<r>.
import json
import os

import numpy as np
import pytest

import spark_rapids_ml_tpu_torch as port
from spark_rapids_ml_tpu_torch import profiling
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.parallel import runner


@pytest.fixture(autouse=True)
def _cpu():
    with use_device("cpu"):
        yield


def _data():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((200, 4)).astype(np.float32)
    return X, (X @ np.arange(1.0, 5.0, dtype=np.float32)).astype(np.float32)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("name", ["KMeans", "LinearRegression"])
def test_a_fit_under_srml_profile_writes_one_trace(monkeypatch, tmp_path, name):
    X, y = _data()
    df = port.DataFrame.from_numpy(X, y)
    est = port.KMeans(k=3, maxIter=5, seed=1) if name == "KMeans" else port.LinearRegression()
    monkeypatch.delenv(profiling.PROFILE_ENV, raising=False)
    est.fit(df)
    assert _files(tmp_path) == []
    monkeypatch.setenv(profiling.PROFILE_ENV, str(tmp_path))
    est.fit(df)
    files = _files(tmp_path)
    assert len(files) == 1 and files[0].startswith(f"{name}{os.sep}") and files[0].endswith(".pt.trace.json")
    with open(tmp_path / files[0]) as f:
        trace = json.load(f)
    assert trace["traceEvents"]


def test_maybe_trace_is_a_no_op_without_the_variable(monkeypatch, tmp_path):
    monkeypatch.delenv(profiling.PROFILE_ENV, raising=False)
    monkeypatch.chdir(tmp_path)
    with profiling.maybe_trace("region"):
        pass
    assert _files(tmp_path) == []


def test_a_ranks_fit_writes_its_own_trace(monkeypatch, tmp_path):
    X, _ = _data()
    monkeypatch.setenv(profiling.PROFILE_ENV, str(tmp_path))
    attrs = runner.run_distributed_fit(port.KMeans(k=3, maxIter=5, seed=1), [{"features": X}], 0, 1)
    assert "cluster_centers_" in runner.decode_attrs(attrs[0])
    files = _files(tmp_path)
    assert len(files) == 1 and files[0].startswith(f"KMeans-rank0{os.sep}")
