"""Phase 1's set-up seconds a datapoint (``stage_times["phase1_setup"]``:
``phase1_params`` and ``make_chunk_processor``, before the first frame),
the mean over the untraced window's datapoints."""


def read(ctx):
    st = ctx["stages"]
    return sum(t["phase1_setup"] for t in st) / len(st) if st else None
