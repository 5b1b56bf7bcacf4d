"""K4, ``warp_filter_kernel`` (csrc/ecc.cu): the final warp and the
deck's 3-tap Gaussian in one pass, with the pre-filter warped image.

Once a frame and camera; 46 operations a pixel (K2's 36 and a 3-tap pass,
5, twice); the frame read once, two images written."""

NAMES = ("warp_filter_kernel",)


def work(w):
    images = w["frames"] * w["cameras"]
    return 46 * w["px"] * images, 3 * w["elem"] * w["px"] * images
