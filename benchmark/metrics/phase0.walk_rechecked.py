"""Nodes the walk's recheck recast a datapoint, over every camera
(``stage_times["phase0.walk_rechecked"]``); the mean over the untraced
window's datapoints, None where the program writes no such key."""

KEY = "phase0.walk_rechecked"


def read(ctx):
    vals = [t[KEY] for t in ctx["stages"] if KEY in t]
    return sum(vals) / len(vals) if vals else None
