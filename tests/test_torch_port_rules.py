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
print(json.dumps({
    "n_labels": int(len(labels)),
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
    assert result == {"n_labels": 100, "loaded": []}


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
