"""The share of the traced window in which nothing ran on the card:
1 - (union of device activity) / (the traced datapoints' wall time).  The
profiler's own host cost is in the wall time, so the share reads high."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.window_s <= 0:
        return None
    return 1.0 - tr.busy_s / tr.window_s
