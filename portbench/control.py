"""Read the check's numbers of a cell over many seeds in one process: the
control's (the reference, with the configuration's guarantee broken, in the
program's place) or, with ``--program``, the program's::

    python3 -m portbench.control --workload <cell> --seconds <s> --seeds <n> [<n> ...] [--program]

One JSON line per seed on standard output: the seed, ``correct`` and each
compared number.  The control has to come out not correct on every seed.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench.run import set_cache_dirs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m portbench.control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--program", action="store_true")
    args = parser.parse_args(argv)

    set_cache_dirs()
    import torch

    from portbench import harness

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        harness.log("no CUDA device")
        return 2
    for seed in args.seeds:
        out, _ = harness.run_cell(args.workload, seed, args.seconds, False,
                                  control=not args.program)
        print(json.dumps({"seed": seed, "control": not args.program, "correct": out["correct"],
                          "attempted": out["attempted"],
                          "checks": {k: v["value"] for k, v in out["checks"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
