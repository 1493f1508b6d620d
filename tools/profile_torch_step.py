"""Where the time of the port's icoFoam step goes, on the card.

    python tools/profile_torch_step.py [--scale 5] [--steps 3] [--out FILE]

Builds pitz_daily_ico_case at the given scale (fp32), runs one warm-up
PISO step, then traces `--steps` steps with torch.profiler (CPU + CUDA
activity) and reports: host ms/step, device busy time (sum of kernel
times) and its share of the wall time, kernel launches per step, the top
kernels by device time, and the device time per call of the shift-MAC
kernel and of its plain torch version on the case's own Gauss planes.
Writes the numbers as JSON to --out (default
chiprun_out/profile_torch_step.json). Needs a CUDA card.
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=5)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(
        _REPO, "chiprun_out", "profile_torch_step.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")

    from rapidcfd_tpu_torch.fields.field import Dimensioned
    from rapidcfd_tpu_torch.ops import fvc
    from rapidcfd_tpu_torch.ops import gdia_mac as gm
    from rapidcfd_tpu_torch.solvers.case import Case
    from rapidcfd_tpu_torch.solvers.icofoam import make_step
    from rapidcfd_tpu_torch.utils.casegen import pitz_daily_ico_case
    from rapidcfd_tpu_torch.utils.logging import Info

    Info.enabled = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    with tempfile.TemporaryDirectory() as d:
        pitz_daily_ico_case(d, scale=args.scale)
        case = Case(d, device=torch.device("cuda"), dtype=torch.float32)
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
        dt = case.time.delta_t
        U, p, phi, _ = step(U, p, phi, dt)          # warm-up step
        state = {"U": U, "p": p, "phi": phi, "its": []}

        def steps():
            for _ in range(args.steps):
                s = state
                s["U"], s["p"], s["phi"], st = step(s["U"], s["p"],
                                                    s["phi"], dt)
                s["its"].append([int(x[2]) for x in st["p_perf"]]
                                + [int(st["u_perf"][0][2])])

        prof, wall = _traced(steps)
        kern = _kernels(prof)
        busy_us = sum(k[1] for k in kern)
        launches = sum(k[2] for k in kern)

        x = state["p"].data.contiguous()
        planes = mesh.gauss

        def calls(fn, n=50):
            def go():
                for _ in range(n):
                    fn(x, planes.coeffs, planes.offsets)
            return go
        kprof, _ = _traced(calls(gm.shift_mac_cols))
        pprof, _ = _traced(calls(gm.shift_mac_cols_plain))
        k_us = sum(k[1] for k in _kernels(kprof)) / 50
        plain_kern = _kernels(pprof)
        p_us = sum(k[1] for k in plain_kern) / 50
        p_launch = sum(k[2] for k in plain_kern) / 50

    res = {
        "card": smi, "scale": args.scale, "slots": mesh.n_cells,
        "steps": args.steps, "host_ms_per_step": 1e3 * wall / args.steps,
        "device_busy_ms_per_step": busy_us / 1e3 / args.steps,
        "device_busy_share": busy_us / 1e6 / wall,
        "kernel_launches_per_step": launches / args.steps,
        "iterations_per_step_p1_p2_U": state["its"],
        "top_kernels": [{"name": k[0][:120], "device_ms": k[1] / 1e3,
                         "calls": k[2]} for k in kern[:12]],
        "shift_mac_device_us_per_call": k_us,
        "plain_device_us_per_call": p_us,
        "plain_launches_per_call": p_launch,
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items() if k != "top_kernels"}))
    for k in res["top_kernels"]:
        print(f"  {k['device_ms']:9.3f} ms  {k['calls']:7d}  {k['name']}")


if __name__ == "__main__":
    main()
