"""sonicFoam on the Mach-3 forward step of utils/casegen.forward_step_case
in the JAX package (fp64, CPU) and in the port, step by step.

    python tests/crosscheck_compressible.py [--scale 16] [--steps 3]
        [--jax-xla optimized,unoptimized] [--port-device cuda|cpu]
        [--port-dtype fp64|fp32]

Writes the case at bench_compressible.py's time step (0.0005/scale s),
runs `--steps` steps of the JAX package once per `--jax-xla` entry (its
jitted step as XLA optimises it by default, and with
jax_disable_most_optimizations, which rounds as op-by-op evaluation
does) and of the port, and prints per step and run the Courant number
(mean, max), the continuity errors (local, global), max Mach, the
iterations of every solve and the local continuity error in units of
eps * sum(rho V)/dt (its rounding scale); then the largest field
differences between the runs relative to their largest magnitude, and the
first JAX run's readings as the (Courant max, max Mach, local continuity
error) tuples chip_smoke.py holds its runs to.

The limited schemes' r is set by rounding wherever a field is uniform
(the 1e-30 guard on psiN - psiO), and this case starts uniform, so the
two JAX runs differ from each other by much more than rounding
(--scale 1: 1e-3 in p after one step); their spread is the agreement the
port can be held to. Like the test_torch_*.py files beside it, it imports
both packages; pytest does not collect it.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def _rounding_scale(rho, V, dt, eps) -> float:
    """eps * sum(rho V)/dt: the size of the ddt(rho) terms whose rounding
    the continuity error cannot get below."""
    import numpy as np
    return eps * float(np.sum(np.abs(rho) * V)) / dt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=16)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--jax-xla", default="optimized,unoptimized")
    ap.add_argument("--port-device", default="cpu")
    ap.add_argument("--port-dtype", choices=["fp32", "fp64"], default="fp64")
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    import torch

    from rapidcfd_tpu.solvers import sonicfoam as jsonic
    from rapidcfd_tpu.utils import logging as jlogging
    from rapidcfd_tpu_torch.solvers import sonicfoam as tsonic
    from rapidcfd_tpu_torch.solvers.case import Case
    from rapidcfd_tpu_torch.utils.casegen import forward_step_case
    from rapidcfd_tpu_torch.utils.logging import captured

    jlogging.Info.enabled = False
    d = tempfile.mkdtemp(prefix="crosscheck_compressible_")
    dt = 0.0005 / args.scale
    t0 = time.perf_counter()
    forward_step_case(d, scale=args.scale, delta_t=dt, end_time=1e9)
    print(f"forward step scale {args.scale}, dt {dt!r}: written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    runs = {}
    for mode in [m for m in args.jax_xla.split(",") if m]:
        record = []
        orig = jsonic.make_step

        def make_step(*a, _record=record, _orig=orig, **kw):
            step = _orig(*a, **kw)
            V = np.asarray(a[0].mesh.V)

            def recorded(U, p, T, rho, phi, dt_):
                if U.old is None:
                    # the outputs carry old levels: one compile, not two
                    U, p, T, rho = (f.store_old() for f in (U, p, T, rho))
                t = time.perf_counter()
                out = step(U, p, T, rho, phi, dt_)
                st = out[-1]
                jax.block_until_ready(out[0].data)
                _record.append(dict(
                    co=tuple(float(x) for x in st["co"]),
                    cont=tuple(float(x) for x in st["cont"]),
                    mach=float(st["mach_max"]),
                    iterations=[*(int(pf[2]) for pf in st["u_perf"]),
                                int(st["e_perf"][0][2]),
                                *(int(pf[2]) for pf in st["p_perf"])],
                    scale=_rounding_scale(np.asarray(out[3].old.data), V,
                                          float(dt_),
                                          np.finfo(np.float64).eps),
                    seconds=time.perf_counter() - t))
                return out
            return recorded
        jsonic.make_step = make_step
        old = jax.config.read("jax_disable_most_optimizations")
        jax.config.update("jax_disable_most_optimizations",
                          mode == "unoptimized")
        try:
            t0 = time.perf_counter()
            jcase, U, p, T, rho, phi = jsonic.run(d, write=False,
                                                  max_steps=args.steps)
        finally:
            jsonic.make_step = orig
            jax.config.update("jax_disable_most_optimizations", old)
        print(f"JAX ({mode} XLA): "
              f"{'gdia' if jcase.mesh.gdia is not None else 'ELL'}, "
              f"{time.perf_counter() - t0:.1f} s with set-up", flush=True)
        runs[f"jax {mode}"] = (jcase, dict(U=U, p=p, T=T, rho=rho), record)

    dtype = {"fp64": torch.float64, "fp32": torch.float32}[args.port_dtype]
    dev = torch.device(args.port_device)
    with captured():
        t0 = time.perf_counter()
        # the mesh as written, which the JAX runs read too (the ascii
        # points are rounded; with the in-memory mesh the readings move by
        # ~1e-7 through the limiters)
        case = Case(d, device=dev, dtype=dtype)
        case, U, p, T, rho, phi = tsonic.run(d, device=dev, dtype=dtype,
                                             write=False,
                                             max_steps=args.steps, case=case)
    print(f"port ({args.port_dtype} on {dev}): "
          f"{'gdia' if case.mesh.gdia is not None else 'ELL'}, "
          f"{time.perf_counter() - t0:.1f} s with set-up", flush=True)
    eps = float(torch.finfo(dtype).eps)
    rho_v = float((rho.data.double().abs() * case.mesh.V.double()).sum())
    record = [dict(co=r["co"], cont=r["cont"], mach=r["mach"],
                   iterations=[n for _, n in r["iterations"]],
                   scale=eps * rho_v / dt, seconds=s)
              for r, s in zip(case.step_log, case.step_seconds)]
    runs[f"port {args.port_dtype}"] = (case, dict(U=U, p=p, T=T, rho=rho),
                                       record)

    for name, (_, _, rec) in runs.items():
        for i, r in enumerate(rec, 1):
            print(f"step {i} {name}: Courant mean {r['co'][0]!r} max "
                  f"{r['co'][1]!r}; continuity local {r['cont'][0]!r} "
                  f"global {r['cont'][1]!r} ({r['cont'][0] / r['scale']:.3g}"
                  f" eps sum(rho V)/dt); max Mach {r['mach']!r}; iterations "
                  f"(Ux Uy Uz e p...) {r['iterations']} "
                  f"({r['seconds']:.2f} s)", flush=True)
    names = list(runs)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            (ca, fa, _), (cb, fb, _) = runs[a], runs[b]
            errs = {}
            for k in fa:
                x = ca.maps.cells_to_file(_np(fa[k].data))
                y = cb.maps.cells_to_file(_np(fb[k].data))
                errs[k] = np.abs(x - y).max() / np.abs(y).max()
            print(f"{a} vs {b} after step {args.steps}, relative max|d|: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()),
                  flush=True)
            ra, rb = runs[a][2], runs[b][2]
            dev_ = [max(abs(x - y) / abs(y) for x, y in (
                (s["co"][1], t["co"][1]), (s["mach"], t["mach"])))
                for s, t in zip(ra, rb)]
            print(f"{a} vs {b}, largest relative difference of Courant max "
                  f"and max Mach per step: {[f'{v:.3e}' for v in dev_]}",
                  flush=True)
    first = runs[names[0]][2]
    print(f"reference from {names[0]} (Courant max, max Mach, local "
          f"continuity error): ("
          + ", ".join(f"({r['co'][1]!r}, {r['mach']!r}, {r['cont'][0]!r})"
                      for r in first) + ")", flush=True)


def _np(x):
    import numpy as np
    if hasattr(x, "detach"):
        return x.detach().double().cpu().numpy()
    return np.asarray(x)


if __name__ == "__main__":
    main()
