"""Readings that the correctness limits are set from, on the card.

    python3 -m benchmark.control --workload <name> --seeds <n> [<n> ...] \
        [--dtype float32|bfloat16] [--fault NAME] [--out FILE]

For each seed, one run of the cell that checks and does not time: the
datapoint written from the seed, one datapoint through the program's
``run_datapoint`` in ``--dtype`` (the configuration's own, or the
control, ``bfloat16``: the nearest precision below the configuration's
float32, a path the program has), with ``--fault`` one of
``benchmark/faults.py``'s faults planted underneath, and the comparison
with the plain reference.  Prints one JSON line a seed, {"workload",
"seed", "dtype", "fault", "checks"}, and appends it to ``--out``.  The benchmark's own runs never run this.
"""

import argparse
import contextlib
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from benchmark import cells
    from benchmark.faults import patched
    from benchmark.harness import run_cell

    if not torch.cuda.is_available():
        print("the readings need a CUDA device", file=sys.stderr)
        return 2
    cell = cells.cell(args.workload, cells.load_benchmark())
    for seed in args.seeds:
        with patched(args.fault) if args.fault else contextlib.nullcontext():
            r = run_cell(cell, seed, 0.0, False, device="cuda",
                         compute_dtype=args.dtype, warm=False)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "dtype": args.dtype or cell["config"]["compute_dtype"],
                           "fault": args.fault,
                           "checks": {k: v["value"] for k, v in r["checks"].items()}})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
