"""Phase 1's frames a second after its set-up: every frame of the
untraced window's datapoints over the sum of their
``phase1 - phase1_setup`` seconds (ingest from the video files, the chunk
loop and the frame program)."""


def read(ctx):
    st = ctx["stages"]
    s = sum(t["phase1"] - t["phase1_setup"] for t in st)
    return ctx["frames"] * len(st) / s if st and s > 0 else None
