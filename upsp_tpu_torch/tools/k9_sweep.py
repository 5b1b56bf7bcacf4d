#!/usr/bin/env python3
"""Time the port's K9 (fused Gauss-Newton step) on one NVIDIA GPU.

    python upsp_tpu_torch/tools/k9_sweep.py --tree DIR      # K9 and K2 then K3 of a checkout
    python upsp_tpu_torch/tools/k9_sweep.py [VARIANT ...]   # variants of this checkout's K9

``--tree DIR`` imports ``upsp_tpu_torch`` and ``chip_smoke`` from the
checkout at DIR (the parent commit unpacked with ``git archive``, say),
builds its kernels and prints, per dtype and ``chip_smoke.ECC_SHAPES``,
K9's ``ms`` and ``device_ms`` as ``chip_smoke.py`` times them, beside K2
then K3 (``split_ms``, ``split_device_ms``) and K9's largest relative
error against its twin and against the pair.

Without ``--tree`` it builds variants of this checkout's
``upsp_tpu_torch/csrc/ecc.cu`` -- each a few regular-expression
replacements in K9, listed in VARIANTS -- with the ``-Xptxas -v``
report of K9's registers and spills, and prints each variant's f32
device ms at both shapes, twice, in turns (``base`` is the source as it
is).  The ablations (``nosep``,
``nowarp``, ``nostats``) skip one of K9's three stages, so their
statistics are wrong by design; they split K9's time by stage.
"""

import ctypes
import json
import os
import re
import subprocess
import sys

GN_LOOP = r"for \(int ly = 2 \* wid \+ half; ly < c\.n;"
WARP_LOOP = r"for \(int i = \(k == 0 \? 0 : 2\) \+ wid; i < c\.n \+ 2;"
BLOCKS = r"constexpr int GN_BLOCKS_PER_SM = \d+;"
FRAME_BLOCKS = r"constexpr int GN_FRAME_BLOCKS = [^;]*;"
TY = r"constexpr int GN_TY = \d+;"
# name -> [(pattern, replacement)], re.sub on ecc.cu; each pattern must match
VARIANTS = {
    "base": [],
    # two, three or four blocks an SM (the compiler's register cap follows)
    "blocks2": [(BLOCKS, "constexpr int GN_BLOCKS_PER_SM = 2;")],
    "blocks3": [(BLOCKS, "constexpr int GN_BLOCKS_PER_SM = 3;")],
    # f32 head and tail elements of the staged windows loaded and stored
    # (as bf16 ones are) instead of copied by 4-byte cp.async
    "edgesync": [(r"if constexpr \(sizeof\(T\) == 4\) \{", "if constexpr (sizeof(T) == 0) {")],
    # 24-row chunks, with three and with four blocks an SM
    "ty24_blocks3": [(TY, "constexpr int GN_TY = 24;"),
                     (BLOCKS, "constexpr int GN_BLOCKS_PER_SM = 3;")],
    "ty24_blocks4": [(TY, "constexpr int GN_TY = 24;"),
                     (BLOCKS, "constexpr int GN_BLOCKS_PER_SM = 4;")],
    # taller chunks, two blocks an SM
    "ty40": [(TY, "constexpr int GN_TY = 40;")],
    "ty48": [(TY, "constexpr int GN_TY = 48;")],
    # three blocks an SM and more, shorter bands: about 2 and 4 waves
    "fb98_blocks3": [(BLOCKS, "constexpr int GN_BLOCKS_PER_SM = 3;"),
                     (FRAME_BLOCKS, "constexpr int GN_FRAME_BLOCKS = 98;")],
    "fb195_blocks3": [(BLOCKS, "constexpr int GN_BLOCKS_PER_SM = 3;"),
                      (FRAME_BLOCKS, "constexpr int GN_FRAME_BLOCKS = 195;")],
    # ablations: one stage skipped
    "nosep": [(r"srow, scol, c\.ns, nxs,", "srow, scol, 0, nxs,")],
    "nowarp": [(WARP_LOOP, "for (int i = c.n + 2 + wid; i < c.n + 2;")],
    "nostats": [(GN_LOOP, "for (int ly = c.n + 2 * wid + half; ly < c.n;")],
}


def time_tree(root):
    sys.path.insert(0, root)
    import torch

    import chip_smoke as C
    from upsp_tpu_torch.ops import cuda_lib
    from upsp_tpu_torch.ops import ecc_kernels as K

    cuda_lib.build_all()
    for dtype in (torch.float32, torch.bfloat16):
        for h, w in C.ECC_SHAPES:
            imgs, tmpl, warps, mask, _ = C.ecc_inputs(h, w, dtype)

            def fused():
                return K.ecc_gn_fused(imgs, tmpl, warps, mask)

            def split():
                return K.ecc_gn_moments(K.warp_affine_banded(imgs, warps), tmpl,
                                        warps, mask)

            got = fused()
            print(json.dumps(dict(
                tree=root, dtype=str(dtype), shape=(h, w),
                rel_twin=C.stats_err(got, K.gn_fused_plain(imgs, tmpl, warps, mask))[1],
                rel_split=C.stats_err(got, split())[1],
                ms=C.cuda_time(fused), device_ms=C.cuda_time(fused, graph=True),
                split_ms=C.cuda_time(split),
                split_device_ms=C.cuda_time(split, graph=True))), flush=True)


def sweep(names):
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, repo)
    import torch

    import chip_smoke as C
    from upsp_tpu_torch.ops import cuda_lib
    from upsp_tpu_torch.ops import ecc_kernels as K

    csrc = os.path.join(repo, "upsp_tpu_torch", "csrc")
    out_dir = os.path.join(cuda_lib.BUILD_DIR, "k9_sweep")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(csrc, "ecc.cu")) as fh:
        source = fh.read()
    nvcc = cuda_lib.nvcc()
    procs = {}
    for name in names:
        text = source
        for pattern, repl in VARIANTS[name]:
            text, n = re.subn(pattern, repl, text)
            if n == 0:
                raise SystemExit(f"variant {name}: {pattern!r} not in ecc.cu")
        cu = os.path.join(csrc, f"_k9_sweep_{name}.cu")  # beside its headers
        with open(cu, "w") as fh:
            fh.write(text)
        so = os.path.join(out_dir, f"{name}.so")
        procs[name] = (so, cu, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports = {}
    for name, (so, cu, proc) in procs.items():  # every build ends, then
        reports[name] = proc.communicate()[0]  # its variant source goes
        os.remove(cu)
    libs = {}
    for name, (so, cu, proc) in procs.items():
        report = reports[name]
        if proc.returncode:
            raise SystemExit(f"variant {name} did not build:\n{report[-3000:]}")
        lines = report.splitlines()
        for i, line in enumerate(lines):
            if "gn_fused_kernel" in line and "Compiling" in line:
                kind = "bf16" if "bfloat16" in line else "f32"
                print(name, kind, lines[i + 2].strip(), "|", lines[i + 3].strip())
        libs[name] = so
    inputs = {hw: C.ecc_inputs(*hw, torch.float32) for hw in C.ECC_SHAPES}
    for rep in range(2):
        for name, so in libs.items():
            lib = ctypes.CDLL(so)
            K._bind(lib)
            K.LIBRARY._handle = lib
            row = dict(variant=name, rep=rep, registers_local_bytes=K.gn_fused_attrs())
            for hw, (imgs, tmpl, warps, mask, _) in inputs.items():
                def fused():
                    return K.ecc_gn_fused(imgs, tmpl, warps, mask)
                rel = C.stats_err(fused(), K.gn_fused_plain(imgs, tmpl, warps, mask))[1]
                row[f"{hw[0]}x{hw[1]}"] = dict(device_ms=C.cuda_time(fused, graph=True),
                                              rel_twin=rel)
                if rep == 0 and name == names[0]:
                    def split():
                        return K.ecc_gn_moments(K.warp_affine_banded(imgs, warps), tmpl,
                                                warps, mask)
                    row[f"{hw[0]}x{hw[1]}"]["split_device_ms"] = C.cuda_time(
                        split, graph=True)
            print(json.dumps(row), flush=True)


def main():
    args = sys.argv[1:]
    if args[:1] == ["--tree"]:
        time_tree(os.path.abspath(args[1]))
    else:
        unknown = [a for a in args if a not in VARIANTS]
        if unknown:
            raise SystemExit(f"unknown variants {unknown}; known: {sorted(VARIANTS)}")
        sweep(args or ["base", "blocks3", "nosep", "nowarp", "nostats"])


if __name__ == "__main__":
    main()
