"""Where the time of the port's icoFoam step goes, on the card.

    python tools/profile_torch_step.py [--case pitz|cavity] [--scale 5]
        [--ell] [--n 384] [--steps 3] [--out FILE]

Builds the case in fp32 and its step (make_step), runs one warm-up PISO
step, then traces `--steps` steps with torch.profiler (CPU + CUDA
activity) and reports: host ms/step, device busy time (sum of kernel
times) and its share of the wall time, kernel launches per step, the top
kernels by device time and the top host operators by their own CPU time;
before the traced steps, as many untraced ones give the ms/step without
the profiler's overhead (iterations per step are listed for both).

- `--case pitz` (default): pitz_daily_ico_case at `--scale`, on the gdia
  lattice path, or with `--ell` on the padded-ELL path (gdia_auto=False);
  on gdia also the device time per call of the shift-MAC kernel and of
  its plain torch version on the case's own Gauss planes;
- `--case cavity`: the lid-driven cavity at `--n` x `--n` in bench.py's
  default setup (PCG with a GAMG preconditioner for p, PBiCGStab/DILU U,
  dt = 0.005*20/n*0.5), with the host seconds of its set-up.

Prints the numbers; `--out FILE` also writes them as JSON. Needs a CUDA
card.
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


def _make_case(args, d):
    """(case, dt) for --case."""
    from rapidcfd_tpu_torch.solvers.case import Case
    from rapidcfd_tpu_torch.utils.casegen import (cavity_case,
                                                  pitz_daily_ico_case)
    dev, f32 = torch.device("cuda"), torch.float32
    if args.case == "pitz":
        pitz_daily_ico_case(d, scale=args.scale)
        case = Case(d, device=dev, dtype=f32, gdia_auto=not args.ell)
        return case, case.time.delta_t
    dt = 0.005 * 20 / args.n * 0.5
    pmesh = cavity_case(d, n=args.n, delta_t=dt, end_time=1e9,
                        write_mesh=False, p_solver="PCG", p_precond="GAMG",
                        u_solver="PBiCGStab", u_precond="DILU")
    return Case(d, device=dev, dtype=f32, pmesh=pmesh), dt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--case", choices=("pitz", "cavity"), default="pitz")
    ap.add_argument("--scale", type=int, default=5)
    ap.add_argument("--ell", action="store_true")
    ap.add_argument("--n", type=int, default=384)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")

    from rapidcfd_tpu_torch.fields.field import Dimensioned
    from rapidcfd_tpu_torch.ops import fvc
    from rapidcfd_tpu_torch.ops import gdia_mac as gm
    from rapidcfd_tpu_torch.solvers.icofoam import make_step
    from rapidcfd_tpu_torch.utils.logging import Info

    Info.enabled = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    with tempfile.TemporaryDirectory() as d:
        case, dt = _make_case(args, d)
        mesh = case.mesh
        nu = Dimensioned.from_entry(
            case.transport_properties().lookup("nu", required=True), "nu")
        piso = case.algo_dict("PISO")
        step = make_step(case, nu, int(piso.scalar("nCorrectors", 1)),
                         int(piso.scalar("nNonOrthogonalCorrectors", 0)),
                         int(piso.scalar("pRefCell", 0)),
                         float(piso.scalar("pRefValue", 0.0)))
        U, p = case.read_field("U"), case.read_field("p")
        phi = fvc.flux(mesh, U)
        U, p, phi, _ = step(U, p, phi, dt)          # warm-up step
        state = {"U": U, "p": p, "phi": phi, "its": []}

        def steps():
            for _ in range(args.steps):
                s = state
                s["U"], s["p"], s["phi"], st = step(s["U"], s["p"],
                                                    s["phi"], dt)
                s["its"].append([int(x[2]) for x in st["p_perf"]]
                                + [int(st["u_perf"][0][2])])

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps()                                     # untraced
        torch.cuda.synchronize()
        untraced = time.perf_counter() - t0
        prof, wall = _traced(steps)
        kern = _kernels(prof)
        busy_us = sum(k[1] for k in kern)
        launches = sum(k[2] for k in kern)

        mac = {}
        if mesh.gauss is not None:
            x = state["p"].data.contiguous()
            planes = mesh.gauss

            def calls(fn, n=50):
                def go():
                    for _ in range(n):
                        fn(x, planes.coeffs, planes.offsets)
                return go
            kprof, _ = _traced(calls(gm.shift_mac_cols))
            pprof, _ = _traced(calls(gm.shift_mac_cols_plain))
            plain_kern = _kernels(pprof)
            mac = {
                "shift_mac_device_us_per_call":
                    sum(k[1] for k in _kernels(kprof)) / 50,
                "plain_device_us_per_call":
                    sum(k[1] for k in plain_kern) / 50,
                "plain_launches_per_call":
                    sum(k[2] for k in plain_kern) / 50,
            }

    res = {
        "card": smi, "case": args.case,
        "size": args.n if args.case == "cavity" else args.scale,
        "layout": "ELL" if mesh.gdia is None else "gdia",
        "cells": mesh.n_cells, "setup_seconds": case.setup_seconds,
        "steps": args.steps,
        "untraced_ms_per_step": 1e3 * untraced / args.steps,
        "host_ms_per_step": 1e3 * wall / args.steps,
        "device_busy_ms_per_step": busy_us / 1e3 / args.steps,
        "device_busy_share": busy_us / 1e6 / wall,
        "kernel_launches_per_step": launches / args.steps,
        "iterations_per_step_p1_p2_U": state["its"],
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
