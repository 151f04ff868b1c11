"""A run with the timed path broken underneath must come out not correct:
each fault that a cell can have, planted in the port on the CPU at a small
size (the harness's look for a chip skipped)."""

import time

import pytest
import torch

from portbench import harness
from portbench.entries.kneighbors import sample_rows
from portbench.tests.small import SMALL
from spark_rapids_ml_tpu_torch.models import kmeans as kmeans_model
from spark_rapids_ml_tpu_torch.ops import knn as knn_ops
from spark_rapids_ml_tpu_torch.ops import knn_kernels

SEED = 2**32 + 41


def run(workload):
    return harness.run_cell(workload, SEED, 0.2, False, "cpu", time.perf_counter(), SMALL[workload])


def test_sound_runs_are_correct():
    assert run("kmeans-fit")["correct"] and run("knn-exact-online")["correct"]


def _shards(X):
    return list(X) if isinstance(X, (list, tuple)) else [X]


KMEANS_FAULTS = {
    # Lloyd returns its state unchanged: the init's centers
    "state_unchanged": lambda real: lambda X, w, c0, max_iter, tol, chunk: real(X, w, c0, 0, tol, chunk),
    # half of the rows left out, the means taken over the rest
    "half_the_rows": lambda real: lambda X, w, c0, max_iter, tol, chunk: real(
        [x[: x.shape[0] // 2] for x in _shards(X)], [v[: v.shape[0] // 2] for v in _shards(w)], c0, max_iter, tol,
        chunk),
    # one center altered where the solver produces it: the second center
    # in the first's place
    "answer_altered": lambda real: lambda *a: (lambda out: (torch.cat([out[0][1:2], out[0][1:]]), *out[1:]))(
        real(*a)),
}


@pytest.mark.parametrize("fault", sorted(KMEANS_FAULTS))
def test_kmeans_fault_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(kmeans_model, "lloyd_iterations", KMEANS_FAULTS[fault](kmeans_model.lloyd_iterations))
    r = run("kmeans-fit")
    assert r["failed"] == 0 and not r["correct"]


def test_knn_half_the_items_left_out(monkeypatch):
    real = knn_kernels.knn_candidates

    def half(items, norm, valid, queries, m):
        valid = valid.clone()
        valid[valid.shape[0] // 2 :] = False
        return real(items, norm, valid, queries, m)

    half.launches = real.launches  # the wrapper counts through its module's name
    monkeypatch.setattr(knn_kernels, "knn_candidates", half)
    r = run("knn-exact-online")
    assert r["failed"] == 0 and not r["correct"]


def test_knn_answer_altered(monkeypatch):
    real = knn_ops._ids_of
    mix = {"rows_per_call": 64, "check_rows_per_frame": 64}
    row = int(sample_rows(mix, SEED)[0])

    def altered(prepared, dist, pos):
        ids = real(prepared, dist, pos)
        ids[row, 0] = (ids[row, 0] + 1) % prepared.n_items
        return ids

    monkeypatch.setattr(knn_ops, "_ids_of", altered)
    r = run("knn-exact-online")
    assert r["failed"] == 0 and not r["correct"]
    assert r["checks"]["rows_off_band"]["value"] >= 1
