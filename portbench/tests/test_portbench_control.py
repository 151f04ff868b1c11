"""On the card, at a size a test run holds: sound runs of each cell come
out correct, and the control (the plain reference in TF32, the next
precision below the configurations' float32) put in the program's place
fails at least one of the cell's limits on three seeds, while a sound
float32 computation arranged otherwise passes them all."""

import time

import pytest

from portbench import control, harness

SIZES = {
    "kmeans-fit": {"config": {"data": {"rows": 100_000}}},
    "knn-exact-batch": {"config": {"data": {"rows": 100_000}},
                        "traffic": {"rows_per_call": 2048, "check_rows_per_frame": 512}},
    "knn-exact-online": {"config": {"data": {"rows": 100_000}}},
}
SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13)


def fails(readings, limits):
    return any(readings[name] > limit for name, limit in limits.items() if name in readings)


@pytest.mark.card
@pytest.mark.parametrize("workload", sorted(SIZES))
def test_control_is_refused_and_sound_runs_pass(card, workload):
    for seed in SEEDS:
        r = control.readings(workload, seed, card, SIZES[workload])
        assert fails(r["control"], r["limits"]), r
        assert not fails(r["sibling"], r["limits"]), r
    run = harness.run_cell(workload, SEEDS[0], 2.0, False, card, time.perf_counter(), SIZES[workload])
    assert run["correct"], run["checks"]
