"""Where the time of the port's solver step goes, on the card.

    python tools/profile_torch_step.py [--case pitz|cavity|simple]
        [--scale 5] [--ell] [--n 384] [--steps 3] [--out FILE]

Builds the case in fp32 and its step (make_step), runs one warm-up step,
then traces `--steps` steps with torch.profiler (CPU + CUDA activity) and
reports: host ms/step, device busy time (sum of kernel times) and its
share of the wall time, kernel launches per step, the top kernels by
device time and the top host operators by their own CPU time; before the
traced steps, as many untraced ones give the ms/step without the
profiler's overhead (iterations per step are listed for both), and as
many again with each linear solve on its own clock (host time per field's
solves, synchronised around each; the rest of the step is assembly and
field updates).

- `--case pitz` (default): an icoFoam PISO step of pitz_daily_ico_case
  at `--scale`, on the gdia lattice path, or with `--ell` on the
  padded-ELL path (gdia_auto=False);
- `--case simple`: a simpleFoam SIMPLE iteration of pitz_daily_case
  (kEpsilon, GAMG p) at `--scale`, gdia or `--ell` likewise;
- `--case cavity`: the lid-driven cavity at `--n` x `--n` in bench.py's
  default setup (PCG with a GAMG preconditioner for p, PBiCGStab/DILU U,
  dt = 0.005*20/n*0.5), with the host seconds of its set-up.

On gdia meshes it also times the shift-MAC kernel and its plain torch
version on the case's own Gauss planes, per call, in both forms (C = 3
and C = 1). Prints the numbers; `--out FILE` also writes them as JSON.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402


def _kernels(prof):
    """[(name, device_us_total, calls)] of the CUDA kernels in a trace."""
    out = []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if dev > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.key, float(dev), int(e.count)))
    return sorted(out, key=lambda t: -t[1])


def _traced(fn, activities=(ProfilerActivity.CPU, ProfilerActivity.CUDA)):
    torch.cuda.synchronize()
    with profile(activities=list(activities)) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


def _host_ops(prof, top=10):
    """[(name, self CPU ms total, calls)] of the host operators."""
    ops = [(e.key, e.self_cpu_time_total / 1e3, int(e.count))
           for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU]
    return sorted(ops, key=lambda t: -t[1])[:top]


def _make_stepper(args, d):
    """(case, advance): advance(state) runs one step of --case on the
    state dict and appends that step's iteration counts to state["its"]
    ([p solves..., U] for icoFoam, [p, U, epsilon, k] for simpleFoam)."""
    from rapidcfd_tpu_torch.fields.field import Dimensioned
    from rapidcfd_tpu_torch.ops import fvc
    from rapidcfd_tpu_torch.solvers import icofoam, simplefoam
    from rapidcfd_tpu_torch.solvers.case import Case
    from rapidcfd_tpu_torch.utils.casegen import (cavity_case,
                                                  pitz_daily_case,
                                                  pitz_daily_ico_case)
    dev, f32 = torch.device("cuda"), torch.float32
    if args.case == "simple":
        from rapidcfd_tpu_torch.models.transport import \
            SinglePhaseTransportModel
        from rapidcfd_tpu_torch.models.turbulence import make_ras_model
        from rapidcfd_tpu_torch.solvers.controls import SimpleControl
        pitz_daily_case(d, scale=args.scale)
        case = Case(d, device=dev, dtype=f32, gdia_auto=not args.ell)
        U = case.read_field("U")
        turb = make_ras_model(case, U)
        step = simplefoam.make_step(
            case, SinglePhaseTransportModel(case.transport_properties()),
            turb, SimpleControl(case))
        state = {"U": U, "p": case.read_field("p"),
                 "phi": fvc.flux(case.mesh, U),
                 "turb": turb.init_state(U), "its": []}

        def advance(s):
            s["U"], s["p"], s["phi"], s["turb"], st = step(
                s["U"], s["p"], s["phi"], s["turb"])
            s["its"].append([int(st["p_perf"][0][2]),
                             int(st["u_perf"][0][2]),
                             int(st["turb"]["epsilon"][2]),
                             int(st["turb"]["k"][2])])
        return case, state, advance
    if args.case == "pitz":
        pitz_daily_ico_case(d, scale=args.scale)
        case = Case(d, device=dev, dtype=f32, gdia_auto=not args.ell)
        dt = case.time.delta_t
    else:
        dt = 0.005 * 20 / args.n * 0.5
        pmesh = cavity_case(d, n=args.n, delta_t=dt, end_time=1e9,
                            write_mesh=False, p_solver="PCG",
                            p_precond="GAMG", u_solver="PBiCGStab",
                            u_precond="DILU")
        case = Case(d, device=dev, dtype=f32, pmesh=pmesh)
    nu = Dimensioned.from_entry(
        case.transport_properties().lookup("nu", required=True), "nu")
    piso = case.algo_dict("PISO")
    step = icofoam.make_step(case, nu, int(piso.scalar("nCorrectors", 1)),
                             int(piso.scalar("nNonOrthogonalCorrectors", 0)),
                             int(piso.scalar("pRefCell", 0)),
                             float(piso.scalar("pRefValue", 0.0)))
    U = case.read_field("U")
    state = {"U": U, "p": case.read_field("p"),
             "phi": fvc.flux(case.mesh, U), "its": []}

    def advance(s):
        s["U"], s["p"], s["phi"], st = step(s["U"], s["p"], s["phi"], dt)
        s["its"].append([int(x[2]) for x in st["p_perf"]]
                        + [int(st["u_perf"][0][2])])
    return case, state, advance


def _clocked_solves():
    """Wrap `solve` where the solvers call it so each solve's host time
    (synchronised before and after) is summed per field; returns the dict
    of seconds and a function that restores the originals."""
    from rapidcfd_tpu_torch.models import turbulence
    from rapidcfd_tpu_torch.solvers import icofoam, simplefoam
    secs: dict[str, float] = {}
    mods = (icofoam, simplefoam, turbulence)
    originals = [mod.solve for mod in mods]

    def timed(orig):
        def solve(mesh, m, controls, env=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(mesh, m, controls, env)
            torch.cuda.synchronize()
            secs[m.psi.name] = secs.get(m.psi.name, 0.0) \
                + time.perf_counter() - t0
            return out
        return solve
    for mod, orig in zip(mods, originals):
        mod.solve = timed(orig)

    def restore():
        for mod, orig in zip(mods, originals):
            mod.solve = orig
    return secs, restore


def _mac_times(mesh, x):
    """Device us per call of the shift-MAC kernel and of its plain
    version on the mesh's Gauss planes, C = 3 and C = 1 (50 calls each)."""
    from rapidcfd_tpu_torch.ops import gdia_mac as gm
    planes = mesh.gauss
    out = {}
    for tag, coeffs in (("c3", planes.coeffs), ("c1", planes.coeffs_i[0])):
        for name, fn in (("shift_mac", gm.shift_mac_cols),
                         ("plain", gm.shift_mac_cols_plain)):
            def go(fn=fn, coeffs=coeffs):
                for _ in range(50):
                    fn(x, coeffs, planes.offsets)
            kern = _kernels(_traced(go)[0])
            out[f"{name}_{tag}_device_us_per_call"] = \
                sum(k[1] for k in kern) / 50
            if name == "plain":
                out[f"plain_{tag}_launches_per_call"] = \
                    sum(k[2] for k in kern) / 50
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--case", choices=("pitz", "cavity", "simple"),
                    default="pitz")
    ap.add_argument("--scale", type=int, default=5)
    ap.add_argument("--ell", action="store_true")
    ap.add_argument("--n", type=int, default=384)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")

    from rapidcfd_tpu_torch.ops import gdia_mac as gm
    from rapidcfd_tpu_torch.utils.logging import Info

    Info.enabled = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    with tempfile.TemporaryDirectory() as d:
        case, state, advance = _make_stepper(args, d)
        mesh = case.mesh
        advance(state)                              # warm-up step
        state["its"].clear()

        def steps():
            for _ in range(args.steps):
                advance(state)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps()                                     # untraced
        torch.cuda.synchronize()
        untraced = time.perf_counter() - t0
        # as many steps again, each linear solve on its own clock
        secs, restore = _clocked_solves()
        t0 = time.perf_counter()
        steps()
        torch.cuda.synchronize()
        clocked = time.perf_counter() - t0
        restore()
        gm.reset_launches()
        prof, wall = _traced(steps)
        mac_launches = {f"C={c}": n / args.steps
                        for c, n in sorted(gm.LAUNCHES_BY_C.items())}
        kern = _kernels(prof)
        busy_us = sum(k[1] for k in kern)
        launches = sum(k[2] for k in kern)
        mac = {} if mesh.gauss is None else \
            _mac_times(mesh, state["p"].data.contiguous())

    res = {
        "card": smi, "case": args.case,
        "size": args.n if args.case == "cavity" else args.scale,
        "layout": "ELL" if mesh.gdia is None else "gdia",
        "cells": mesh.n_cells, "setup_seconds": case.setup_seconds,
        "steps": args.steps,
        "untraced_ms_per_step": 1e3 * untraced / args.steps,
        "clocked_ms_per_step": 1e3 * clocked / args.steps,
        "solve_ms_per_step": {k: 1e3 * v / args.steps
                              for k, v in secs.items()},
        "outside_solves_ms_per_step":
            1e3 * (clocked - sum(secs.values())) / args.steps,
        "host_ms_per_step": 1e3 * wall / args.steps,
        "device_busy_ms_per_step": busy_us / 1e3 / args.steps,
        "device_busy_share": busy_us / 1e6 / wall,
        "kernel_launches_per_step": launches / args.steps,
        "shift_mac_launches_per_step": mac_launches,
        "iterations_per_step": state["its"],
        "top_kernels": [{"name": k[0][:120], "device_ms": k[1] / 1e3,
                         "calls": k[2]} for k in kern[:12]],
        "top_host_ops": [{"name": k[0][:80], "self_cpu_ms": k[1],
                          "calls": k[2]} for k in _host_ops(prof)],
        **mac,
    }
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items()
                      if k not in ("top_kernels", "top_host_ops")}))
    for k in res["top_kernels"]:
        print(f"  {k['device_ms']:9.3f} ms  {k['calls']:7d}  {k['name']}")
    for k in res["top_host_ops"]:
        print(f"  {k['self_cpu_ms']:9.3f} ms  {k['calls']:7d}  {k['name']}"
              " (host)")


if __name__ == "__main__":
    main()
