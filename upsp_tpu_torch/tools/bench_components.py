"""Device ms a frame of each phase-1 op at 1 MP (port of
``tools/bench_components.py``).

    python -m upsp_tpu_torch.tools.bench_components [--hw 1024,1024]
        [--batch 8] [--chain 16] [--nodes 20480] [--device cuda|cpu]

Chained-K method, as the JAX tool: an op is applied K times to a batch
of ``--batch`` frames, and :func:`benchlib.chained_cost` differences the
chains of K and of 0 applications (each stream ended by
``torch.cuda.synchronize()``), so the launch floor and the final wait
cancel; cost a frame = that difference / K / batch.  An op whose output
is an image takes the previous application's output; the others take the
same frames each time (PyTorch runs every call, so the JAX tool's 1e-30
feedback, which kept XLA from folding the chain, is not needed).

The inputs are the JAX tool's (:func:`make_inputs`); each op is the
frame program's form of it:

- ``fix_hot_pixels``: K6 (``ecc_kernels.fix_hot_pixels_kernel``);
- ``apply_filter gaussian 3``: K1 with the deck filter's taps (in the
  frame program the filter runs inside K4, after the final warp);
- ``gaussian_blur 5 (ECC pre-blur)``: K1 (``registration.ecc_blur``);
- ``warp_validity_mask`` and the 20k-node projection gather
  (``x[:, idx] * wt``, summed): torch ops, as in the JAX tool;
- ``fft phase-correlation init``: ``fftreg.correlate`` (K10 pooling,
  then cuFFT) against a template of frame 0;
- ``ecc 1 GN step (incl blur+stats)``: ``registration.ecc_affine(...,
  max_iters=1, unroll=True, return_iters=True)`` of the batch against
  frame 0 on the kernel route (K1, K2, K3; the JAX tool's per-lane
  templates take the dense route here).

``warp_affine_mxu`` (an MXU workaround of the TPU's compiler) is not
ported by design; its line says so.  Ends with one JSON line: the ms a
frame of each op under its label, the configuration, ``device`` and
``card``.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from upsp_tpu_torch.tools import benchlib
from upsp_tpu_torch.tools.bench import parse_pair

# the JAX tool's labels (tools/bench_components.py:66-112), in its order
LABELS = ("fix_hot_pixels", "warp_affine_mxu", "apply_filter gaussian 3",
          "gaussian_blur 5 (ECC pre-blur)", "warp_validity_mask",
          "projection gather (20k nodes)", "fft phase-correlation init",
          "ecc 1 GN step (incl blur+stats)")
NOT_PORTED = {"warp_affine_mxu": "not ported by design (warp_affine_mxu)"}
WARP = ((1.0, 1e-4, 0.3), (-1e-4, 1.0, -0.2))


def make_inputs(hw, batch: int, nodes: int, device):
    """The JAX tool's inputs (tools/bench_components.py:55-62): frames
    N(2000, 200), one sub-pixel warp with a small rotation for every
    frame, ``nodes`` pixel indices and weights, from ``default_rng(0)``."""
    h, w = hw
    rng = np.random.default_rng(0)
    img = rng.normal(2000, 200, (batch, h, w)).astype(np.float32)
    warp = np.broadcast_to(np.array(WARP, np.float32), (batch, 2, 3))
    idx = rng.integers(0, h * w, nodes).astype(np.int32)
    wt = rng.random(nodes).astype(np.float32)
    return (torch.from_numpy(img).to(device),
            torch.from_numpy(np.ascontiguousarray(warp)).to(device),
            torch.from_numpy(idx).to(device).long(), torch.from_numpy(wt).to(device))


def ops(img, warp, idx, wt) -> Dict[str, Tuple[Callable, bool]]:
    """Label -> (one application, whether it maps an image to an image)."""
    from upsp_tpu_torch.ops import ecc_kernels as K
    from upsp_tpu_torch.ops.fftreg import correlate, default_decimate, prepare_template
    from upsp_tpu_torch.ops.registration import ecc_affine, ecc_blur
    from upsp_tpu_torch.ops.warp import warp_validity_mask

    b, h, w = img.shape
    taps3 = K.filter_taps("gaussian", 3)
    tmpl = prepare_template(img[0], default_decimate(h, w))
    ref = img[0].clone()

    def gather(x):
        return (x.reshape(b, -1)[:, idx] * wt).sum()

    def gn_step(x):
        return ecc_affine(ref, x, max_iters=1, unroll=True, return_iters=True)

    return {
        "fix_hot_pixels": (K.fix_hot_pixels_kernel, True),
        "apply_filter gaussian 3": (lambda x: K.blur(x, taps3), True),
        "gaussian_blur 5 (ECC pre-blur)": (lambda x: ecc_blur(x, 5), True),
        "warp_validity_mask": (lambda x: warp_validity_mask((h, w), warp), False),
        "projection gather (20k nodes)": (gather, False),
        "fft phase-correlation init": (lambda x: correlate(tmpl, x), False),
        "ecc 1 GN step (incl blur+stats)": (gn_step, False),
    }


def chain(op: Callable, maps_image: bool, k: int) -> Callable:
    """``k`` applications of ``op``: each on the last one's output when it
    is an image, else on the frames again."""

    def fn(x):
        out = x
        for _ in range(k):
            out = op(out if maps_image else x)
        return out

    return fn


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hw", default="1024,1024")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--chain", type=int, default=16)
    ap.add_argument("--nodes", type=int, default=20480)
    ap.add_argument("--trials", type=int, default=3)
    benchlib.add_device_arg(ap)
    return ap


def run(argv=None) -> dict:
    args = parser().parse_args(argv)
    device = benchlib.resolve_device(args.device)
    hw = parse_pair(args.hw)
    b, k = args.batch, args.chain
    img, warp, idx, wt = make_inputs(hw, b, args.nodes, device)
    inputs = [img, img + 1e-3, img + 2e-3]
    print(f"{b} x {hw[0]}x{hw[1]} f32, chain={k}", flush=True)
    table = ops(img, warp, idx, wt)
    ms = {}
    for label in LABELS:
        if label in NOT_PORTED:
            print(f"{label:44s} {NOT_PORTED[label]}", flush=True)
            continue
        op, maps_image = table[label]
        cost = benchlib.chained_cost(lambda n: chain(op, maps_image, n), inputs, 0, k,
                                     trials=args.trials)
        ms[label] = cost / b * 1e3
        print(f"{label:44s} {ms[label]:7.3f} ms/frame", flush=True)
    return {
        "config": {"hw": list(hw), "batch": b, "chain": k, "nodes": args.nodes},
        "ms_per_frame": {key: round(v, 5) for key, v in ms.items()},
        "not_ported": NOT_PORTED,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "card": benchlib.card(),
    }


def main(argv=None) -> None:
    print(json.dumps(run(argv)), flush=True)


if __name__ == "__main__":
    main()
