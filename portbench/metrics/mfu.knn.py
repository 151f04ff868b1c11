"""mfu.knn (%, host clock): the distance products exact search needs,
2 Q n d operations a call of Q query rows against n items of d columns,
summed over the window's calls, over the window's seconds, against the
float32 peak."""

from portbench import peaks


def read(run):
    n, d = run.config["data"]["rows"], run.config["data"]["cols"]
    ops = sum(2.0 * c["rows"] * n * d for c in run.calls if c["ok"])
    return 100.0 * ops / run.window_s / peaks.FP32_FLOPS if ops else None
