"""Phase 2's seconds a datapoint (``stage_times["phase2"]``: the frame
statistics, the coverage and the delta-Cp conversion), the mean over the
untraced window's datapoints."""


def read(ctx):
    st = ctx["stages"]
    return sum(t["phase2"] for t in st) / len(st) if st else None
