"""Solver dispatcher: `python -m rapidcfd_tpu_torch [solver] -case DIR
[-precision fp32|fp64] [-device cuda|cpu]`.

Without an explicit solver name, reads `application` from
system/controlDict (the reference's convention). The device defaults to
cuda and is never swapped for another: without a card, `-device cuda`
raises.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys

#: ported solvers: name -> module with run(case_dir, *, device, dtype, write)
SOLVERS = {
    "icoFoam": "rapidcfd_tpu_torch.solvers.icofoam",
}


def main(argv=None):
    from rapidcfd_tpu.utils.dictionary import parse_file

    from . import resolve_device, solver_dtype
    ap = argparse.ArgumentParser(prog="rapidcfd_tpu_torch")
    ap.add_argument("solver", nargs="?", default=None,
                    help="solver name (default: controlDict application)")
    ap.add_argument("-case", dest="case", default=".")
    ap.add_argument("-noWrite", action="store_true")
    ap.add_argument("-precision", choices=["fp32", "fp64"], default=None,
                    help="override the solver's default float width")
    ap.add_argument("-device", default="cuda",
                    help="torch device to run on (cuda or cpu)")
    args = ap.parse_args(argv)

    name = args.solver
    if name is None:
        cd = parse_file(os.path.join(args.case, "system", "controlDict"))
        name = cd.word("application")
    if name not in SOLVERS:
        sys.exit(f"solver '{name}' is not ported. Available: "
                 f"{', '.join(sorted(SOLVERS))}")
    device = resolve_device(args.device)
    mod = importlib.import_module(SOLVERS[name])
    mod.run(args.case, device=device,
            dtype=solver_dtype(name, args.precision),
            write=not args.noWrite)


if __name__ == "__main__":
    main()
