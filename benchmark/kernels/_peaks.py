"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates) that
the kernels' least times use: every kernel computes in float32 on the CUDA
cores, so operations count against the f32 rate."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def least_s(flops: float, nbytes: float) -> float:
    """The least time of the work: the larger of its bytes over the HBM
    rate and its operations over the f32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
