"""K6, ``hot_scan_kernel`` and ``hot_repair_kernel`` (csrc/ecc.cu): the
hot-pixel repair of every frame of every camera.

Two compares a pixel; a float32 frame read once and written once."""

NAMES = ("hot_scan_kernel", "hot_repair_kernel")


def work(w):
    images = w["frames"] * w["cameras"]
    return 2 * w["px"] * images, 8 * w["px"] * images
