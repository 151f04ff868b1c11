"""ingest_s.fit (s, program span): seconds inside the port's core.ingest
range a fit, from the traced window (core._TpuCaller._build_fit_inputs:
the rows' host-to-device staging)."""


def read(run):
    if run.trace is None:
        return None
    spans = run.trace.range_us("core.ingest")
    fits = sum(c.get("fits", 0) for c in run.calls if c["ok"])
    return sum(spans) / 1e6 / fits if spans and fits else None
