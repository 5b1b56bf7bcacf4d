"""Phase 0's seconds a datapoint (``stage_times["phase0"]``), the mean
over the untraced window's datapoints: the grid, the native visibility
walk over every node and camera, the patch operators, the templates."""


def read(ctx):
    st = ctx["stages"]
    return sum(t["phase0"] for t in st) / len(st) if st else None
