# Rules of the PyTorch port (spark_rapids_ml_tpu_torch) and of chip_smoke.py:
# they import neither jax nor the JAX package, the port's main path needs no
# pandas, and without a CUDA device the entry points refuse to run unless the
# caller asked for the CPU.
import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import spark_rapids_ml_tpu_torch as port

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "spark_rapids_ml_tpu_torch"
SMOKE = REPO / "chip_smoke.py"


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name, extra=()):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "spark_rapids_ml_tpu", *extra)


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")), ids=lambda p: str(p.relative_to(REPO))
)
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert bad == [], f"{path} imports {bad}"


def test_chip_smoke_imports_no_jax_and_no_pandas():
    bad = [m for m in _imported_modules(SMOKE) if _forbidden(m, ("pandas",))]
    assert bad == [], f"chip_smoke.py imports {bad}"


_MAIN_PATH = """
import json, sys, tempfile
sys.modules["pandas"] = None          # any import of pandas now fails
import numpy as np
import spark_rapids_ml_tpu_torch as port
from spark_rapids_ml_tpu_torch.device import use_device

use_device("cpu")
X = np.random.default_rng(0).standard_normal((200, 4)).astype(np.float32)
df = port.DataFrame.from_numpy(X, num_partitions=2)
model = port.KMeans(k=3, maxIter=5, seed=1).fit(df)
with tempfile.TemporaryDirectory() as d:
    model.save(d)
    labels = port.load(d).transform(df).partitions[0]["prediction"]
y = (X[:, 0] > 0).astype(np.float32)
df_y = port.DataFrame.from_numpy(X, y, num_partitions=2)
forest = port.RandomForestClassifier(numTrees=2, maxDepth=8, maxBins=16, seed=1).fit(df_y)
with tempfile.TemporaryDirectory() as d:
    forest.save(d)
    probs = port.load(d).transform(df_y).partitions[1]["probability"]
reg = port.RandomForestRegressor(numTrees=2, maxDepth=3, seed=1).fit(df_y)
preds = reg.transform(df_y).partitions[0]["prediction"]
items = np.random.default_rng(1).standard_normal((1500, 4)).astype(np.float32)
nn = port.NearestNeighbors(k=3).fit(port.DataFrame.from_numpy(items, num_partitions=2))
knn = nn.kneighbors(df)[2]
ann = {}
for algo, params in (("ivfflat", {"nlist": 8}), ("ivfpq", {"nlist": 8, "M": 2, "n_bits": 4})):
    approx = port.ApproximateNearestNeighbors(k=3, algorithm=algo, algoParams=params).fit(
        port.DataFrame.from_numpy(items, num_partitions=2))
    with tempfile.TemporaryDirectory() as d:
        approx.save(d)
        ann[algo] = list(port.load(d).kneighbors(df)[2].partitions[0]["indices"].shape)
print(json.dumps({
    "n_labels": int(len(labels)),
    "forest": [list(probs.shape), int(len(preds))],
    "knn": [list(knn.partitions[1]["indices"].shape), str(knn.partitions[1]["distances"].dtype)],
    "ann": ann,
    "loaded": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "spark_rapids_ml_tpu")),
}))
"""


def test_main_path_runs_without_jax_and_pandas():
    # a fresh interpreter: this test process has jax loaded already
    out = subprocess.run(
        [sys.executable, "-c", _MAIN_PATH],
        cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO)},
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result == {"n_labels": 100, "forest": [[100, 2], 100], "knn": [[100, 3], "float32"],
                      "ann": {"ivfflat": [100, 3], "ivfpq": [100, 3]}, "loaded": []}


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.random.default_rng(1).standard_normal((20, 3)).astype(np.float32)
    df = port.DataFrame.from_numpy(X)
    with pytest.raises(RuntimeError, match="use_device"):
        port.KMeans(k=2).fit(df)
    with port.device.use_device("cpu"):
        model = port.KMeans(k=2, maxIter=3).fit(df)
    with pytest.raises(RuntimeError, match="use_device"):
        model.transform(df)
    with pytest.raises(RuntimeError, match="use_device"):
        model.predict(X[0])
    y = (X[:, 0] > 0).astype(np.float32)
    df_y = port.DataFrame.from_numpy(X, y)
    for est in (port.RandomForestClassifier(numTrees=2, maxDepth=3), port.RandomForestRegressor(numTrees=2, maxDepth=3)):
        with pytest.raises(RuntimeError, match="use_device"):
            est.fit(df_y)
        with port.device.use_device("cpu"):
            forest = est.fit(df_y)
        with pytest.raises(RuntimeError, match="use_device"):
            forest.transform(df_y)
        with pytest.raises(RuntimeError, match="use_device"):
            forest.predict(X[0])
    nn = port.NearestNeighbors(k=2).fit(df)  # fit only captures the frame
    with pytest.raises(RuntimeError, match="use_device"):
        nn.kneighbors(df)
    with port.device.use_device("cpu"):
        assert nn.kneighbors(df)[2].partitions[0]["indices"].shape == (20, 2)
    approx = port.ApproximateNearestNeighbors(k=2, algoParams={"nlist": 2})
    with pytest.raises(RuntimeError, match="use_device"):
        approx.fit(df)
    with port.device.use_device("cpu"):
        approx_model = approx.fit(df)
    with pytest.raises(RuntimeError, match="use_device"):
        approx_model.kneighbors(df)


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    if alone:
        shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
        cwd, script = tmp_path, tmp_path / "chip_smoke.py"
    else:
        cwd, script = REPO, SMOKE
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, str(script)],
        cwd=cwd,
        env={**env, "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
