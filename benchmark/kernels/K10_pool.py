"""K10, ``pool_kernel`` (csrc/fftreg.cu): the phase correlation's k x k
pooling, fft start only.

Every frame and camera once and each camera's template once in set-up:
the frame read once, the pooled image written once; per pooled pixel
2k^2 + k - 1 operations (chip_smoke.py's ``pool_flops``)."""

NAMES = ("pool_kernel",)


def work(w):
    if w["warm_start"] != "fft":
        return 0, 0
    k = w["decimate"]
    images = w["frames"] * w["cameras"] + w["cameras"]
    pooled = (w["height"] // k) * (w["width"] // k)
    return (2 * k * k + k - 1) * pooled * images, (4 * w["px"] + 4 * pooled) * images
