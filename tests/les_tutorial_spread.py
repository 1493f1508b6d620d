"""How far the shift-MAC kernel moves the LES tutorial case from the CPU,
over several seeds: chip_smoke.py phase 43's comparison at each seed.

    python tests/les_tutorial_spread.py [--seeds 1792 7 23 101]
        [--repeats 2] [--main]

Needs a CUDA card. For each seed (`u_seed` of the case's nonuniform start
and of the fixed inlet draw) and each repeat, runs the LES tutorial case
at scale 1 in fp64 for 5 pisoFoam steps on cuda with the kernel and on
the cpu, and prints each field's and the probes file's largest difference
relative to its largest magnitude, then the largest over all runs beside
the limits phase 43 holds them to (LES_TUTORIAL_SPREAD,
LES_TUTORIAL_UP_SPREAD). --main then runs phase 44, the x16 tutorial
through the dispatcher, as the smoke does. Imports nothing of JAX;
pytest does not collect it.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[1792, 7, 23, 101])
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--main", action="store_true",
                    help="also run phase 44 (the x16 tutorial)")
    args = ap.parse_args(argv)
    import chip_smoke as smoke
    smi = smoke.phase_setup()
    smoke.phase_build()
    worst = {}
    with tempfile.TemporaryDirectory() as tmp:
        for seed in args.seeds:
            for rep in range(args.repeats):
                t0 = time.perf_counter()
                errs, shape, its_ok = smoke.les_tutorial_errors(
                    tmp, seed, runs=("cuda", "cpu"))["cuda"]
                for k, v in errs.items():
                    worst[k] = max(worst.get(k, 0.0), v)
                print(f"[spread] seed {seed} run {rep + 1}: " + ", ".join(
                    f"{k} {v:.3e}" for k, v in errs.items())
                    + f"; probes {shape[0]} lines; counts within one: "
                    f"{its_ok} ({time.perf_counter() - t0:.1f} s)",
                    flush=True)
        print("[spread] largest over "
              f"{len(args.seeds) * args.repeats} runs (limit): " + ", ".join(
                  f"{k} {v:.3e} ("
                  f"{smoke.LES_TUTORIAL_SPREAD.get(k, smoke.LES_TUTORIAL_UP_SPREAD):g})"
                  for k, v in worst.items()) + f" (card: {smi})")
        if args.main:
            smoke._timed(smoke.phase_les_tutorial_main, tmp, smi)


if __name__ == "__main__":
    main()
