"""K9, ``gn_fused_kernel`` (csrc/ecc.cu): K2 and K3 of a Gauss-Newton step
in one kernel.  No datapoint path launches it today; were one to, it would
take K2 and K3's work: 97 operations a pixel, the image and the template
read once, the statistics written once."""

NAMES = ("gn_fused_kernel",)


def work(w):
    steps = w["gn_steps"]
    return 97 * w["px"] * steps, (2 * w["elem"] * w["px"] + 128 * 4) * steps
