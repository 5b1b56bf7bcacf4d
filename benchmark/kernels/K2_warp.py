"""K2, ``warp_kernel`` (csrc/ecc.cu): the warp of a Gauss-Newton step.

One warp of the blurred frame a step: the fft start takes two steps a
frame and camera, the identity start as many as its while loop runs (the
reference's count of these inputs).  Per pixel 36 operations (four tent
taps 9, the second-order shear term 27); read once, written once."""

NAMES = ("warp_kernel",)


def work(w):
    return 36 * w["px"] * w["gn_steps"], 2 * w["elem"] * w["px"] * w["gn_steps"]
