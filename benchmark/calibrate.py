"""The control's readings that the check's limits are set from, on the
card, in one process per cell (the program's own readings are those of
the cell's runs, each printed on its result line):

    python3 benchmark/calibrate.py --workload gowalla-train --control 21 22 23

On each seed, the loop's ``control``: the reference put in the
program's place in the precision below the configuration's (and, for
training, with half of each batch left out), judged as the program is.
One JSON line each, also appended to ``--out``.
"""

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if sys.path[0] != root:
        sys.path.insert(0, root)
    from benchmark import harness

    ap = argparse.ArgumentParser(prog="benchmark/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    drv = cell.loop

    def emit(line: dict) -> None:
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")

    for seed in args.control:
        inputs = drv.make_inputs(cell.cfg, cell.traffic, seed, "cuda:0")
        for kind, readings in drv.control(cell.cfg, cell.traffic, inputs, seed,
                                          "cuda:0").items():
            emit({"workload": cell.name, "seed": seed, "kind": kind, "checks": readings})
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
