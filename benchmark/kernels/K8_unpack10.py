"""K8, ``unpack10_kernel`` (csrc/unpack.cu): 10-bit packed video bytes
through the 10->12-bit LUT to float32 frames on the card.

Integer work only; 1.25 bytes a pixel read, 4 written, the 4 KB LUT once
a chunk."""

NAMES = ("unpack10_kernel",)


def work(w):
    if w["video_bits"] != 10:
        return 0, 0
    chunks = -(-w["frames"] // w["frames_per_chunk"])
    return 0, w["px"] * w["frames"] * w["cameras"] * 21 // 4 + 4096 * chunks
