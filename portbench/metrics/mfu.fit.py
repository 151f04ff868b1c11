"""mfu.fit (%, host clock): the Lloyd assignment products a fit needs,
2 N D K operations an iteration times the model's n_iter_, summed over the
window's fits, over the window's seconds, against the float32 peak."""

from portbench import peaks


def read(run):
    n, d = run.config["data"]["rows"], run.config["data"]["cols"]
    k = run.config["params"]["k"]
    ops = sum(2.0 * n * d * k * c["n_iter"] for c in run.calls if c["ok"])
    return 100.0 * ops / run.window_s / peaks.FP32_FLOPS if ops else None
