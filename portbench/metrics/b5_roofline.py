"""b5_roofline (%, device trace): B5, the candidate-pool kernel
(csrc/knn_topm.cu, knn_topm_tile_kernel): its least time over its device
time in the traced window.  A launch over Q queries and n items of d
columns needs 2 Q n d float32 operations, and reads its inputs once and
writes its (Q, ceil(n / 1024), m) values and positions once; its least
time is the larger of operations over the float32 peak and bytes over the
memory rate (chip_smoke.py's pool_bound, frozen here).  m is the port's
per-group candidate count for k among n (mean + 6 sigma of a group's
Binomial(k, 1024 / n) share, + 4).  A window's launches split its calls'
query rows evenly.  Nothing when the trace lost a counted launch."""

import math

from portbench import peaks

SYMBOL = "knn_topm_tile_kernel"
GROUP = 1024


def candidates(k, n):
    lam = k * GROUP / max(n, 1)
    return max(4, int(math.ceil(lam + 6.0 * math.sqrt(lam) + 4.0)))


def pool_bound_s(q, n, d, m):
    ng = -(-n // GROUP)
    nbytes = 4.0 * (q * d + n * d + q + n) + 8.0 * q * ng * m
    return max(2.0 * q * n * d / peaks.FP32_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)


def read(run):
    t = run.trace
    if t is None or not t.complete or not t.port_events.get(SYMBOL):
        return None
    times = t.port_events[SYMBOL]
    n, d = run.config["data"]["rows"], run.config["data"]["cols"]
    m = candidates(run.config["params"]["k"], n)
    rows = sum(c["rows"] for c in run.calls if c["ok"])
    q = rows / len(times)
    return 100.0 * len(times) * pool_bound_s(q, n, d, m) / (sum(times) / 1e6)
