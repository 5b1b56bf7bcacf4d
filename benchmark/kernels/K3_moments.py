"""K3, ``moments_kernel`` and ``moments_reduce_kernel`` (csrc/ecc.cu):
the statistics of a Gauss-Newton step.

One pass a step over the warped image and the template; 61 operations a
pixel (chip_smoke.py's count), the 128 statistics written once."""

NAMES = ("moments_kernel", "moments_reduce_kernel")


def work(w):
    steps = w["gn_steps"]
    return 61 * w["px"] * steps, (2 * w["elem"] * w["px"] + 128 * 4) * steps
