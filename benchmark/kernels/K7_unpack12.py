"""K7, ``unpack12_kernel`` (csrc/unpack.cu): 12-bit packed video bytes to
float32 frames on the card.

Integer work only; 1.5 bytes a pixel read, 4 written."""

NAMES = ("unpack12_kernel",)


def work(w):
    if w["video_bits"] != 12:
        return 0, 0
    return 0, w["px"] * w["frames"] * w["cameras"] * 11 // 2
