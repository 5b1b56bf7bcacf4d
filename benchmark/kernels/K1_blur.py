"""K1, ``blur_kernel`` (csrc/ecc.cu): the ECC's 5-tap Gaussian pre-blur.

A datapoint blurs every frame of every camera once, and each camera's
template once in set-up.  Per pixel 18 operations (a 5-tap pass, 9, twice);
each pixel read once and written once (chip_smoke.py's FLOPS and bytes)."""

NAMES = ("blur_kernel",)


def work(w):
    images = w["frames"] * w["cameras"] + w["cameras"]
    return 18 * w["px"] * images, 2 * w["elem"] * w["px"] * images
