"""pimpleFoam on the T-junction of utils/casegen.tjunction_case in the JAX
package (fp64, CPU) and in the port, step by step.

    python tests/crosscheck_tjunction.py [--section 32 --leg 160 --bar 128
        --depth 32] [--steps 3] [--port-device cuda|cpu] [--port-dtype
        fp64|fp32]

Writes the case (the mesh as ascii), runs `--steps` adaptive timesteps of
each package on it and prints, per step and package, dt, the Courant
number (mean, max), the continuity errors (local, global) and the
iterations of every solve; then the port's largest field differences from
the JAX fields relative to their largest magnitude, and the JAX readings
as the (dt, Courant max, local continuity error) tuples chip_smoke.py
holds its fp32 run to. Like the test_torch_*.py files beside it, it
imports both packages; pytest does not collect it.
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
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--section", type=int, default=32)
    ap.add_argument("--leg", type=int, default=160)
    ap.add_argument("--bar", type=int, default=128)
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--port-device", default="cpu")
    ap.add_argument("--port-dtype", choices=["fp32", "fp64"], default="fp64")
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    import torch

    from rapidcfd_tpu.solvers import pimplefoam as jpimple
    from rapidcfd_tpu.utils import logging as jlogging
    from rapidcfd_tpu_torch.solvers import pimplefoam as tpimple
    from rapidcfd_tpu_torch.solvers.case import Case
    from rapidcfd_tpu_torch.utils.casegen import tjunction_case
    from rapidcfd_tpu_torch.utils.logging import captured

    jlogging.Info.enabled = False
    d = tempfile.mkdtemp(prefix="crosscheck_tjunction_")
    t0 = time.perf_counter()
    pm = tjunction_case(d, section=args.section, leg=args.leg, bar=args.bar,
                        depth=args.depth)
    print(f"T-junction section {args.section}, leg {args.leg}, bar "
          f"{args.bar}: {pm.n_cells} cells, written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # the JAX run, each step's dt and stats recorded
    record = []
    orig = jpimple.make_step

    def make_step(*a, **kw):
        step = orig(*a, **kw)

        def recorded(U, p, phi, ts, dt):
            if U.old is None:
                # give the first inputs the old time levels the outputs
                # carry (one compile in place of two; the levels are
                # overwritten or unread)
                U = U.store_old()
                ts = {k: v.store_old() for k, v in ts.items()}
            t = time.perf_counter()
            out = step(U, p, phi, ts, dt)
            st = out[4]
            record.append(dict(
                dt=float(dt), co=tuple(float(x) for x in st["co"]),
                cont=tuple(float(x) for x in st["cont"]),
                p=[int(pf[2]) for pf in st["p_perf"]],
                u=[int(pf[2]) for pf in st["u_perf"]],
                turb={k: int(pf[2]) for k, pf in st["turb"].items()},
                seconds=time.perf_counter() - t))
            return out
        return recorded
    jpimple.make_step = make_step
    t0 = time.perf_counter()
    jcase, jU, jp, jphi, jts = jpimple.run(d, write=False,
                                           max_steps=args.steps)
    jpimple.make_step = orig
    print(f"JAX: {'gdia' if jcase.mesh.gdia is not None else 'ELL'}, "
          f"{time.perf_counter() - t0:.1f} s with set-up", flush=True)
    for i, r in enumerate(record, 1):
        print(f"step {i} jax : dt {r['dt']:.9g}; Courant mean {r['co'][0]:.9g}"
              f" max {r['co'][1]:.9g}; continuity local {r['cont'][0]:.9g} "
              f"global {r['cont'][1]:.9g}; U {r['u']} p {r['p']} turb "
              f"{r['turb']} ({r['seconds']:.1f} s)", flush=True)

    dtype = {"fp64": torch.float64, "fp32": torch.float32}[args.port_dtype]
    dev = torch.device(args.port_device)
    with captured():
        t0 = time.perf_counter()
        case = Case(d, device=dev, dtype=dtype)
        case, U, p, phi, ts = tpimple.run(d, device=dev, dtype=dtype,
                                          write=False, max_steps=args.steps,
                                          case=case)
    print(f"port ({args.port_dtype} on {dev}): "
          f"{'gdia' if case.mesh.gdia is not None else 'ELL'}, "
          f"{time.perf_counter() - t0:.1f} s with set-up", flush=True)
    for i, (r, s) in enumerate(zip(case.step_log, case.step_seconds), 1):
        print(f"step {i} port: dt {r['dt']:.9g}; Courant mean {r['co'][0]:.9g}"
              f" max {r['co'][1]:.9g}; continuity local {r['cont'][0]:.9g} "
              f"global {r['cont'][1]:.9g}; {r['iterations']} ({s:.1f} s)",
              flush=True)
    errs = {}
    for name, a, b in (("U", U, jU), ("p", p, jp),
                       *((k, ts[k], jts[k]) for k in sorted(jts))):
        x = case.maps.cells_to_file(a.data.double().cpu().numpy())
        y = jcase.maps.cells_to_file(np.asarray(b.data))
        errs[name] = np.abs(x - y).max() / np.abs(y).max()
    print("port vs jax after the last step, relative max|d|: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()), flush=True)
    print("reference (dt, Courant max, local continuity error): ("
          + ", ".join(f"({r['dt']!r}, {r['co'][1]!r}, {r['cont'][0]!r})"
                      for r in record) + ")", flush=True)


if __name__ == "__main__":
    main()
