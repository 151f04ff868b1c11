"""kneighbors_rows_per_s (rows/s, host clock): query rows answered over the
window's seconds."""


def read(run):
    rows = sum(c["rows"] for c in run.calls if c["ok"])
    return rows / run.window_s if rows else None
