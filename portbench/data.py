#
# The benchmark's inputs: rows as a Spark executor would hand them to the
# port, pageable host numpy float32, made from seeds.
#
# The rows are drawn on the run's device with a torch.Generator, a chunk of
# rows at a time, and copied into one host array: the card draws 12 GB in
# well under a second where numpy's threads take ~10 s, and the copies
# into the pageable array run on threads.  A configuration
# names its generator and its parameters under "data" (and "queries");
# GENERATORS maps the name to the function.  Every input, and an
# estimator's seed, is drawn from the run's seed.  Recipes as
# chip_smoke.py's (blobs: BlobsDataGen's Gaussian blobs; normal).
#

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor, wait
from typing import Callable, Dict, Optional

import numpy as np
import torch

CHUNK_ROWS = 65536
COPY_THREADS = 8


def derive(seed: int, *tags: int) -> int:
    """A 63-bit seed for one input of a run, from the run's seed and tags
    naming the input: distinct inputs draw from distinct streams."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF, *tags]
    state = np.random.SeedSequence(words).generate_state(2, dtype=np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    return g


def _fill(rows: int, cols: int, device, chunk: Callable[[int, int], torch.Tensor]) -> np.ndarray:
    """A (rows, cols) host array filled chunk by chunk from the device:
    each chunk comes back into one of two pinned buffers and threads copy
    it into the (pageable) array while the next chunk is drawn."""
    X = np.empty((rows, cols), np.float32)
    if torch.device(device).type == "cpu":
        for lo in range(0, rows, CHUNK_ROWS):
            hi = min(lo + CHUNK_ROWS, rows)
            torch.from_numpy(X[lo:hi]).copy_(chunk(lo, hi))
        return X
    stages = [torch.empty((CHUNK_ROWS, cols), dtype=torch.float32, pin_memory=True) for _ in range(2)]
    pending: list = [[], []]
    with ThreadPoolExecutor(COPY_THREADS) as pool:
        for i, lo in enumerate(range(0, rows, CHUNK_ROWS)):
            hi = min(lo + CHUNK_ROWS, rows)
            wait(pending[i % 2])
            stage = stages[i % 2][: hi - lo]
            stage.copy_(chunk(lo, hi))
            src = stage.numpy()
            cuts = np.linspace(0, hi - lo, COPY_THREADS + 1, dtype=int)
            pending[i % 2] = [pool.submit(np.copyto, X[lo + a : lo + b], src[a:b]) for a, b in zip(cuts, cuts[1:])]
        wait(pending[0] + pending[1])
    return X


def blobs(rows: int, cols: int, seed: int, device, centers: int, cluster_std: float = 1.0,
          center_box: float = 10.0, **_: object) -> np.ndarray:
    """Gaussian blobs: `centers` means uniform in [-center_box,
    center_box], each row one mean (uniform) plus cluster_std noise."""
    g = _generator(seed, device)
    means = (torch.rand((centers, cols), generator=g, device=device) * 2.0 - 1.0) * center_box
    assign = torch.randint(0, centers, (rows,), generator=g, device=device)

    def chunk(lo, hi):
        return torch.randn((hi - lo, cols), generator=g, device=device).mul_(cluster_std).add_(means[assign[lo:hi]])

    return _fill(rows, cols, device, chunk)


def normal(rows: int, cols: int, seed: int, device, **_: object) -> np.ndarray:
    """Standard normal rows."""
    g = _generator(seed, device)

    def chunk(lo, hi):
        return torch.randn((hi - lo, cols), generator=g, device=device)

    return _fill(rows, cols, device, chunk)


GENERATORS: Dict[str, Callable[..., np.ndarray]] = {"blobs": blobs, "normal": normal}


def make(spec: Dict, run_seed: int, tag: int, device, rows: Optional[int] = None) -> np.ndarray:
    """The rows a generator spec ({"generator": name, "rows": n, "cols": d,
    ...}) describes in a run of `run_seed`; `tag` names the input."""
    args = {k: v for k, v in spec.items() if k not in ("generator", "partitions")}
    if rows is not None:
        args["rows"] = rows
    return GENERATORS[spec["generator"]](seed=derive(run_seed, tag), device=device, **args)


ESTIMATOR_SEED_TAG = 5


def estimator_seed(run_seed: int) -> int:
    """The seed an estimator takes in a run of `run_seed` (31 bits, the
    range the port's estimators use)."""
    return derive(run_seed, ESTIMATOR_SEED_TAG) & 0x7FFFFFFF
