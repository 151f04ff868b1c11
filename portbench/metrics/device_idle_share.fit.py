"""The device's idle share (%, device trace): the share of the traced
window in which no kernel, copy or memset ran on the card.  Nothing when
the trace lost a launch the port's wrappers counted."""


def read(run):
    t = run.trace
    if t is None or not t.complete or t.window_us <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us / t.window_us)
