"""upsp_tpu_torch — the uPSP engine on PyTorch and an NVIDIA H100.

A port of :mod:`upsp_tpu` (JAX on a TPU), which stays beside it as the
reference.  The layout mirrors the JAX package, so each module names its
counterpart:

- :mod:`upsp_tpu_torch.ops`       — per-frame image ops; ``ecc_kernels``
  binds the hand-written Hopper kernels (``csrc/ecc.cu``) and their twins;
  the device BVH walk (``raycast``), target detection and localization
- :mod:`upsp_tpu_torch.camera`    — pinhole + Brown distortion camera model,
  visibility, and external calibration (RANSAC PnP, bundle adjustment)
- :mod:`upsp_tpu_torch.pipeline`  — phase 0/1/2 and the datapoint driver
- :mod:`upsp_tpu_torch.state`     — the JAX phase-0 state as port tensors
- :mod:`upsp_tpu_torch.io`, :mod:`upsp_tpu_torch.geometry` — file formats
  and surface models (numpy)

The modules of ``upsp_tpu`` that need no jax and that the port uses
(``io``, ``geometry``, ``native``, ``pipeline.config``,
``pipeline.interpolate``, ``processing.context``, ``camera.tunnel``,
``camera.matching``, ``camera.internal``, ``ops.detection``) are copied
here at the same relative paths.  This package imports ``torch`` and never ``jax``,
nor anything of ``upsp_tpu``.
"""

import torch

# Phase 2's detrend and the patch operators are f32 matmuls; TF32 keeps
# about three decimal digits, so it stays off for the whole package.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
