"""rhoCentralFoam on the Mach-3 forward step of
utils/casegen.rhocentral_forward_step_case in the JAX package (fp64, CPU)
and in the port, step by step.

    python tests/crosscheck_rhocentral.py [--scale 16] [--steps 3]
        [--viscous] [--port-device cuda|cpu] [--port-dtype fp64|fp32]

Writes the case (deltaT 0.002/scale), runs `--steps` steps of the JAX
package (its jitted step as XLA optimises it by default) and of the port,
and prints per step the dt, Courant max and max Mach of both, then the
largest field differences relative to their largest magnitude, and the
JAX run's readings as the (Courant max, max Mach) tuples chip_smoke.py
holds its runs to (RC_REFERENCE). Like the test_torch_*.py files beside
it, it imports both packages; pytest does not collect it.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


class _RecordingJax:
    """The jax module for the JAX rhoCentralFoam's run, whose jit records
    each step's dt, Courant max and max Mach."""

    def __init__(self, jax, record):
        self._jax, self.record = jax, record

    def __getattr__(self, name):
        return getattr(self._jax, name)

    def jit(self, fn, **kw):
        jitted = self._jax.jit(fn, **kw)

        def recorded(*a):
            out = jitted(*a)
            st = out[-1]
            self.record.append((float(a[4]), float(st["co_max"]),
                                float(st["mach_max"])))
            return out
        return recorded


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=16)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--viscous", action="store_true")
    ap.add_argument("--port-device", default="cpu")
    ap.add_argument("--port-dtype", choices=["fp32", "fp64"], default="fp64")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory(prefix="crosscheck_rhocentral_") as d:
        _crosscheck(args, d)


def _crosscheck(args, d):
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    import torch

    from rapidcfd_tpu.solvers import rhocentralfoam as jrc
    from rapidcfd_tpu.utils import logging as jlogging
    from rapidcfd_tpu_torch.solvers import rhocentralfoam as trc
    from rapidcfd_tpu_torch.solvers.case import Case
    from rapidcfd_tpu_torch.utils.casegen import rhocentral_forward_step_case
    from rapidcfd_tpu_torch.utils.logging import captured

    jlogging.Info.enabled = False
    t0 = time.perf_counter()
    rhocentral_forward_step_case(d, scale=args.scale, viscous=args.viscous,
                                 end_time=1e9)
    print(f"forward step scale {args.scale} (viscous {args.viscous}): "
          f"written in {time.perf_counter() - t0:.1f} s", flush=True)

    record = []
    jrc.jax = _RecordingJax(jax, record)
    t0 = time.perf_counter()
    jcase, jU, jp, jT, _ = jrc.run(d, write=False, max_steps=args.steps)
    print(f"JAX (fp64, CPU, XLA optimised): {args.steps} steps in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    dev = torch.device(args.port_device)
    dtype = dict(fp32=torch.float32, fp64=torch.float64)[args.port_dtype]
    t0 = time.perf_counter()
    with captured():
        case = Case(d, device=dev, dtype=dtype)
        case, U, p, T, _ = trc.run(d, device=dev, dtype=dtype, write=False,
                                   max_steps=args.steps, case=case)
    print(f"port ({args.port_dtype}, {args.port_device}): {args.steps} "
          f"steps in {time.perf_counter() - t0:.1f} s")
    for i, ((dt, co, mach), t) in enumerate(zip(record, case.step_log), 1):
        print(f"step {i}: dt {dt!r} / {t['dt']!r}; Courant max {co!r} / "
              f"{t['co']!r} ({abs(t['co'] - co) / co:.3e}); max Mach "
              f"{mach!r} / {t['mach']!r} ({abs(t['mach'] - mach) / mach:.3e})"
              f"; iterations {t['iterations']}")
    for name, a, b in (("U", U, jU), ("p", p, jp), ("T", T, jT)):
        a = case.maps.cells_to_file(a.data.double().cpu().numpy())
        b = jcase.maps.cells_to_file(np.asarray(b.data))
        print(f"{name}: relative max|d| "
              f"{np.abs(a - b).max() / np.abs(b).max():.3e}")
    print("RC_REFERENCE = (" + ",\n                ".join(
        f"({co!r}, {mach!r})" for _, co, mach in record) + ")")


if __name__ == "__main__":
    main()
