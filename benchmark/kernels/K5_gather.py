"""K5, ``gather_kernel`` (csrc/gather.cu): the best-view node gather with
the skip mask and the supersession, in model order.

One call a frame batch: each node reads its pixel in each frame and
writes its value (4 bytes), and the plan (12 bytes a node) is read once a
call; one multiply a read."""

NAMES = ("gather_kernel",)


def work(w):
    n, b = w["nodes"], w["frame_batch"]
    calls = -(-w["frames"] // b)
    return w["frames"] * n, w["frames"] * n * (w["elem"] + 4) + calls * n * 12
