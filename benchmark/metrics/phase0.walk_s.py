"""Phase 0's visibility walk, seconds a datapoint over every camera
(``stage_times["phase0.walk"]``): the native rays, their retries and the
recheck; the mean over the untraced window's datapoints, None where the
program writes no such key."""

KEY = "phase0.walk"


def read(ctx):
    vals = [t[KEY] for t in ctx["stages"] if KEY in t]
    return sum(vals) / len(vals) if vals else None
