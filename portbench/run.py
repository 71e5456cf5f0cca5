"""Run one cell of the benchmark once and print its result as the last line of
standard output::

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It runs on the machine it is started on and needs as many CUDA devices as
the cell asks for; without them it exits with 2 and prints no result.  It
exits with 3, and prints no result, if JAX or the JAX package was loaded.
``--rate`` (requests/s) replaces an open-loop mix's rate, to find the knee;
no measured run uses it.
"""

from __future__ import annotations

import os
import pathlib
import sys

_ROOT = pathlib.Path(__file__).resolve().parent.parent


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout, set
    before torch starts CUDA (the program's own kernels build into
    build/csgn_tpu_torch/ under the checkout)."""
    for var, name in (("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv"),
                      ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(_ROOT / "build" / "portbench" / name)


def main(argv=None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(prog="python3 -m portbench.run")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--rate", type=float, default=None)
    args = parser.parse_args(argv)

    set_cache_dirs()
    import torch

    from portbench import harness

    torch.set_num_threads(1)
    chips = harness.cell_files(args.workload)["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"cell {args.workload} needs {chips} CUDA device(s); torch finds "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    out, lines = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                  rate=args.rate)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"loaded in this process, which the benchmark forbids: {', '.join(bad)}")
        return 3
    for line in lines:
        harness.log(line)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
