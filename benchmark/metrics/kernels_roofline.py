"""The hand-written kernels' share of their roofline, in percent: the sum
of each kernel's least time (``benchmark/kernels/``: the operations and
bytes the traced datapoints' frames need, against the H100 SXM's
published peaks) over the sum of its device time in the trace.  Only the
kernels the trace shows count; none shown, no reading."""


def read(ctx):
    ks = ctx.get("kernels") or {}
    least = sum(v[0] for v in ks.values())
    spent = sum(v[1] for v in ks.values())
    return 100.0 * least / spent if spent > 0 and least > 0 else None
