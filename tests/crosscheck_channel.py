"""The polyhedral channel of bench_unstructured.py, or its curved duct, in
the JAX package and in the port side by side, iteration by iteration, in
fp64.

    python tests/crosscheck_channel.py [--dims 64 32 32] [--iterations 10]
        [--curve 1.2 --grade 4.0] [--device cpu|cuda]

Builds the case as bench_unstructured.py does (perturb 0.12, merge
fraction 0.04, seed 3; the merged-cell gdia lattice, or the padded ELL
for the curved or graded duct, which is not a lattice) in both packages
from the same generated mesh (the JAX package on the CPU, the port on
`--device`), runs `--iterations` SIMPLE iterations of
each and prints, per iteration and package, the iterations of each
linear solve (Ux, Uy, Uz, p per corrector, k, omega), the local
continuity error and max
|U|, then the port's largest difference from the JAX fields (U, p, phi,
k, omega, nut) relative to their largest magnitude. Like the
test_torch_*.py files beside it, it imports both packages; pytest does
not collect it.
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
    ap.add_argument("--dims", type=int, nargs=3, default=(64, 32, 32),
                    metavar=("NX", "NY", "NZ"))
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--curve", type=float, default=0.0)
    ap.add_argument("--grade", type=float, default=1.0)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    import torch

    from rapidcfd_tpu.models.transport import \
        SinglePhaseTransportModel as JTransport
    from rapidcfd_tpu.models.turbulence import make_ras_model as jras
    from rapidcfd_tpu.ops import fvc as jfvc
    from rapidcfd_tpu.solvers import simplefoam as jsimple
    from rapidcfd_tpu.solvers.case import Case as JCase
    from rapidcfd_tpu.solvers.controls import SimpleControl as JControl
    from rapidcfd_tpu.utils import logging as jlogging
    from rapidcfd_tpu.utils.unstructured import unstructured_channel_case
    from rapidcfd_tpu_torch.solvers.simplefoam import iteration_counts
    from rapidcfd_tpu_torch.utils.logging import captured
    from rapidcfd_tpu_torch.utils.unstructured import channel_stepper

    jlogging.Info.enabled = False
    nx, ny, nz = args.dims
    geometry = dict(curve=args.curve, grade=args.grade)
    lattice = args.curve == 0.0 and args.grade == 1.0
    d = tempfile.mkdtemp(prefix="crosscheck_channel_")
    jlat = {} if lattice else None
    t0 = time.perf_counter()
    jpm = unstructured_channel_case(
        d, nx=nx, ny=ny, nz=nz, end_time=10 ** 9, perturb=0.12,
        merge_fraction=0.04, seed=3, write_mesh=False, lattice_out=jlat,
        **geometry)
    jcase = JCase(d, pmesh=jpm, lattice=jlat)
    U, p = jcase.read_field("U"), jcase.read_field("p")
    phi = jfvc.flux(jcase.mesh, U)
    jturb = jras(jcase, U)
    ts = jturb.init_state(U)
    jstep = jsimple.make_step(
        jcase, JTransport(jcase.transport_properties()), jturb,
        JControl(jcase))
    print(f"{'x'.join(map(str, args.dims))} {geometry}: {jpm.n_cells} "
          f"cells, {'gdia' if jcase.mesh.gdia is not None else 'ELL'}; "
          f"JAX set-up {time.perf_counter() - t0:.1f} s", flush=True)
    with captured():
        t0 = time.perf_counter()
        case, (tU, tp, tphi, tts), tstep, _ = channel_stepper(
            d, nx=nx, ny=ny, nz=nz, device=torch.device(args.device),
            dtype=torch.float64, **geometry)
        print(f"port set-up {time.perf_counter() - t0:.1f} s", flush=True)
        for it in range(1, args.iterations + 1):
            t0 = time.perf_counter()
            U, p, phi, ts, jst = jstep(U, p, phi, ts)
            jax.block_until_ready((U.data, ts))
            tj = time.perf_counter() - t0
            t0 = time.perf_counter()
            tU, tp, tphi, tts, tst = tstep(tU, tp, tphi, tts)
            tt = time.perf_counter() - t0
            for who, st, u, sec in (("jax ", jst, U, tj),
                                    ("port", tst, tU, tt)):
                its = " ".join(f"{n} {i}" for n, i in iteration_counts(st))
                print(f"iteration {it} {who}: {its}; continuity "
                      f"{float(st['cont'][0]):.6g}; max |U| "
                      f"{float(abs(u.data).max()):.6g} "
                      f"({sec:.1f} s)", flush=True)
            rel = {}
            for name, a, b in (("U", tU, U), ("p", tp, p), ("phi", tphi, phi),
                               *((k, tts[k], ts[k]) for k in sorted(ts))):
                x, y = a.data.cpu().numpy(), np.asarray(b.data)
                if name == "phi":
                    nf = case.maps.n_file_faces
                    x = case.maps.faces_to_file(x)
                    y = jcase.maps.faces_to_file(y)[:nf]
                else:
                    x = case.maps.cells_to_file(x)
                    y = jcase.maps.cells_to_file(y)
                rel[name] = np.abs(x - y).max() / np.abs(y).max()
            print(f"iteration {it} port vs jax, relative max|d|: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in rel.items()),
                  flush=True)


if __name__ == "__main__":
    main()
