"""The window's loops on a stand-in entry: the closed loop calls back to
back and goes on past a failed call; the open loop starts no call before
its arrival, drawn from the seed, and times each from its arrival."""

import time

import numpy as np

from portbench import cell


class Entry:
    """Calls that take `service` seconds; call `fail_at` raises."""

    def __init__(self, service, fail_at=None):
        self.service, self.fail_at, self.kept, self.began = service, fail_at, [], []

    def call(self, state, i):
        self.began.append(time.perf_counter())
        if i == self.fail_at:
            raise RuntimeError("planted")
        time.sleep(self.service)
        return {"rows": 4}, i

    def keep(self, state, i, out):
        self.kept.append(out)


def test_closed_loop_calls_back_to_back_past_a_failure():
    entry, t0 = Entry(0.002, fail_at=3), time.perf_counter()
    calls = cell.loop("closed_loop").run(entry, None, {}, 0.1, t0, 7)
    assert calls[-1]["end"] >= 0.1 > calls[-2]["end"]
    assert [c["ok"] for c in calls].count(False) == 1 and not calls[3]["ok"] and calls[3]["rows"] == 0
    assert entry.kept == [i for i in range(len(calls)) if i != 3]
    assert all(b["start"] >= a["end"] for a, b in zip(calls, calls[1:]))


def test_open_loop_follows_its_arrivals():
    open_loop = cell.loop("open_loop")
    mix = {"rate_per_s": 200.0}
    entry, t0 = Entry(0.001), time.perf_counter()
    calls = open_loop.run(entry, None, mix, 0.3, t0, 2**40 + 3)
    due = open_loop.arrivals(200.0, 0.3, 2**40 + 3)
    assert [c["start"] for c in calls] == list(due[: len(calls)])
    assert all(b - t0 >= c["start"] for b, c in zip(entry.began, calls))
    assert all(c["end"] - c["start"] >= 0.001 for c in calls) and calls[-1]["end"] >= 0.3
    assert (open_loop.arrivals(200.0, 0.3, 2**40 + 3) == due).all()
    assert not np.array_equal(open_loop.arrivals(200.0, 0.3, 5)[:10], due[:10])
