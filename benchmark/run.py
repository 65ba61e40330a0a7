"""Entry point: run one cell of ``BENCHMARK.json`` once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m benchmark.run ...``) from the root of a checkout; see
`benchmark.harness`."""

import os
import sys

if __name__ == "__main__":
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if sys.path[0] != root:
        sys.path.insert(0, root)
    from benchmark.harness import main

    sys.exit(main())
