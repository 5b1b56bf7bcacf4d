"""Microseconds of device activity a frame inside phase 1's frames (after
its set-up) of the traced datapoints: the union of the card's kernel, copy
and set intervals within those stages, over their frames."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["traced_frames"] or tr.phase1_busy_s <= 0:
        return None
    return 1e6 * tr.phase1_busy_s / ctx["traced_frames"]
