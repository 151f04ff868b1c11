"""fit_s (s, host clock): time to a model, the window's seconds over the
fits completed in it."""


def read(run):
    fits = sum(c.get("fits", 0) for c in run.calls if c["ok"])
    return run.window_s / fits if fits else None
