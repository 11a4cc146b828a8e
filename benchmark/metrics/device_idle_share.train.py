"""The share of the traced window in which nothing ran on the card: 100
minus the union of every kernel, copy and fill interval (two streams
that overlap count once), in %."""


def read(m):
    trace = m.get("trace")
    if trace is None or trace.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
