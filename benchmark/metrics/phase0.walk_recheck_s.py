"""The walk's recheck, seconds a datapoint over every camera
(``stage_times["phase0.walk_recheck"]``): the nodes no native ray owned,
recast by the watertight test; the mean over the untraced window's
datapoints, None where the program writes no such key."""

KEY = "phase0.walk_recheck"


def read(ctx):
    vals = [t[KEY] for t in ctx["stages"] if KEY in t]
    return sum(vals) / len(vals) if vals else None
