"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. setup: torch, the card, its power limit, nvcc, whether triton imports;
   a CUDA card is required;
2. build the shift-MAC kernel (csrc/shift_mac.cu) from the checkout;
3. the kernel against its plain torch version on the card, fp32 and fp64,
   at the pitzDaily x5 slice shape (C = 3 and C = 1), a 3-D offset set and
   an odd n; tolerance max|d| <= 1e-13 max|out| (fp64), 1e-5 (fp32) —
   FMA contraction is the only difference; then both timed at the slice
   shape: device time per call (torch.profiler) and wall time per call
   back to back (CUDA events);
4. the icoFoam slice in fp64 at pitzDaily x1 (every solve to 1e-12) for
   10 steps on cuda and on cpu: U, p, phi agree to 1e-8 relative to their
   largest magnitude, iteration counts within one per solve;
5. the main path: icofoam.run in fp32 at pitzDaily x5 (106,000 live cells)
   for 20 steps; fields finite, the kernel launched at least 3 times per
   step (launch count reset just before the run);
6. a JSON line of kernel results, the card's name and power limit, and
   the result line {"ok": true, "device": {...}} last.

It imports nothing of JAX.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

_ITER_RE = re.compile(r"Solving for (\w+),.*No Iterations (\d+)")
SLICE_OFFSETS = (-560, -1, 0, 1, 560)       # pitzDaily x5 lattice: nx = 560
SLICE_N = 560 * 200


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def run_cmd(cmd) -> str:
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return (res.stdout or res.stderr).strip()


def phase_setup() -> str:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    from rapidcfd_tpu_torch.ops import gdia_mac
    smi = run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]).splitlines()[0]
    print(f"[1] torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"python {sys.version.split()[0]}")
    print(f"[1] device: {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()})")
    print(f"[1] nvidia-smi: {smi}")
    print(f"[1] nvcc: {run_cmd([gdia_mac._nvcc(), '--version']).splitlines()[-1]}")
    try:
        import triton
        print(f"[1] triton {triton.__version__} imports")
    except ImportError as e:
        print(f"[1] triton does not import ({e})")
    return smi


def phase_build():
    from rapidcfd_tpu_torch.ops import gdia_mac
    t0 = time.perf_counter()
    lib = gdia_mac.build()
    gdia_mac._load()
    print(f"[2] built {lib} in {time.perf_counter() - t0:.2f} s")


def _time_ms(fn, reps=200) -> float:
    """Wall time per call of back-to-back calls (CUDA events): includes
    the host side of each call (wrapper, allocation, launch)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps=50) -> float:
    """Device time per call: the CUDA kernels' own time, traced by
    torch.profiler (CUPTI)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total", 0.0)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    check(total_us > 0, "the profiler recorded no device time")
    return total_us / reps / 1e3


def phase_kernel() -> dict:
    from rapidcfd_tpu_torch.ops import gdia_mac as gm
    cases = [(5, 3, SLICE_N, SLICE_OFFSETS),
             (5, 1, SLICE_N, SLICE_OFFSETS),
             (7, 3, 40 * 30 * 20, (-1200, -40, -1, 0, 1, 40, 1200)),
             (5, 3, 100003, (-317, -1, 0, 1, 317))]
    g = torch.Generator().manual_seed(1234)
    slice_err = ms = plain_ms = None
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-13)):
        for K, C, n, offs in cases:
            x = torch.randn(n, generator=g, dtype=dtype).cuda()
            coeffs = torch.randn(K, C, n, generator=g, dtype=dtype).cuda()
            ref = gm.shift_mac_cols_plain(x, coeffs, offs)
            out = gm.shift_mac_cols(x, coeffs, offs)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            scale = ref.abs().max().item()
            print(f"[3] {str(dtype)[6:]} K={K} C={C} n={n}: max|d| = "
                  f"{err:.3e} (limit {tol * scale:.3e})")
            check(out.shape == (C, n) and err <= tol * scale,
                  f"kernel disagrees with plain version ({dtype}, K={K}, "
                  f"C={C}, n={n}): {err} > {tol * scale}")
            if dtype == torch.float32 and (K, C, n) == (5, 3, SLICE_N):
                slice_err = err

                def kernel():
                    return gm.shift_mac_cols(x, coeffs, offs)

                def plain():
                    return gm.shift_mac_cols_plain(x, coeffs, offs)
                ms, plain_ms = _device_ms(kernel), _device_ms(plain)
                print(f"[3] fp32 slice shape, device time per call: kernel "
                      f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us")
                print(f"[3] fp32 slice shape, wall time per call back to "
                      f"back: kernel {_time_ms(kernel) * 1e3:.2f} us, plain "
                      f"{_time_ms(plain) * 1e3:.2f} us")
    return dict(max_abs_err=slice_err, ms=ms, plain_ms=plain_ms)


def _logged(fn, *args, **kw):
    from rapidcfd_tpu_torch.utils.logging import captured
    with captured() as buf:
        out = fn(*args, **kw)
    return out, [(m.group(1), int(m.group(2)))
                 for m in _ITER_RE.finditer(buf.getvalue())], buf.getvalue()


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def phase_fp64_agreement(tmp: str):
    from rapidcfd_tpu_torch.solvers import icofoam
    from rapidcfd_tpu_torch.utils.casegen import pitz_daily_ico_case
    d = f"{tmp}/pitz1"
    pitz_daily_ico_case(d, scale=1, tight_tol=True)
    outs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        outs[dev] = _logged(icofoam.run, d, device=torch.device(dev),
                            dtype=torch.float64, write=False, max_steps=10)
        print(f"[4] fp64 pitzDaily x1, 10 steps on {dev}: "
              f"{time.perf_counter() - t0:.2f} s")
    (gc, gU, gp, gphi), g_its, _ = outs["cuda"]
    (cc, cU, cp, cphi), c_its, _ = outs["cpu"]
    maps = cc.maps
    errs = {
        "U": _rel(maps.cells_to_file(gU.data.cpu().numpy()),
                  maps.cells_to_file(cU.data.numpy())),
        "p": _rel(maps.cells_to_file(gp.data.cpu().numpy()),
                  maps.cells_to_file(cp.data.numpy())),
        "phi": _rel(maps.faces_to_file(gphi.data.cpu().numpy()),
                    maps.faces_to_file(cphi.data.numpy())),
    }
    print(f"[4] cuda vs cpu, relative max|d|: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    check(all(v <= 1e-8 for v in errs.values()),
          f"fp64 cuda and cpu runs disagree: {errs}")
    check(len(g_its) == len(c_its) == 50, "unexpected number of solves")
    diffs = [(i, a, b) for i, (a, b) in enumerate(zip(g_its, c_its))
             if a != b]
    for i, a, b in diffs:
        print(f"[4] solve {i} ({a[0]}): cuda {a[1]} iterations, cpu {b[1]}")
    check(all(a[0] == b[0] and abs(a[1] - b[1]) <= 1 for _, a, b in diffs),
          "iteration counts differ by more than one")
    print(f"[4] iteration counts: {len(diffs)} of {len(g_its)} solves "
          f"differ (by one)")


def phase_main_path(tmp: str, smi: str) -> int:
    from rapidcfd_tpu_torch.ops import gdia_mac
    from rapidcfd_tpu_torch.solvers import icofoam
    from rapidcfd_tpu_torch.utils.casegen import pitz_daily_ico_case
    d = f"{tmp}/pitz5"
    t0 = time.perf_counter()
    pitz_daily_ico_case(d, scale=5)
    print(f"[5] pitzDaily x5 case written in {time.perf_counter() - t0:.2f} s")
    steps = 20
    gdia_mac.LAUNCHES = 0
    t0 = time.perf_counter()
    (case, U, p, phi), its, log = _logged(
        icofoam.run, d, device=torch.device("cuda"), dtype=torch.float32,
        write=False, max_steps=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = gdia_mac.LAUNCHES
    live = int(case.maps.cell_primary.sum())
    print(f"[5] fp32 pitzDaily x5: {case.mesh.n_cells} slots, {live} live "
          f"cells, {len(case.step_seconds)} steps, {wall:.2f} s with setup")
    check(len(case.step_seconds) == steps, "run stopped early")
    check(live == 106000, f"expected 106000 live cells, got {live}")
    for f in (U, p, phi):
        check(bool(torch.isfinite(f.data).all()), f"{f.name} not finite")
    check(U.data.shape == (case.mesh.n_cells, 3)
          and p.data.shape == (case.mesh.n_cells,), "unexpected shapes")
    # the run stays bounded. In fp32 the p solves end where the solvers'
    # stall guard stops them (as in the JAX package), so continuity errors
    # of 1e-4..1e-2 m^3/s and Courant numbers up to ~5 are expected; a
    # diverging run passes 0.1 and 10 within a few steps (sum local 3.3
    # and Courant 2.8e7 the step before NaN, pitzDaily x5 from rest)
    cont = [float(c) for c in re.findall(r"sum local = ([-0-9.e+]+)", log)]
    co = [float(c) for c in re.findall(r"Courant Number mean: \S+ max: (\S+)",
                                       log)]
    check(len(cont) == len(co) == steps, "missing log lines")
    check(max(cont) < 0.1 and max(co) < 10.0,
          f"run not bounded: continuity {max(cont)}, Courant {max(co)}")
    check(launches >= 3 * steps,
          f"shift-MAC kernel launched {launches} times in {steps} steps")
    st = case.step_seconds
    steady = sorted(st[1:])[len(st[1:]) // 2]
    p_its = [n for f, n in its if f == "p"]
    print(f"[5] kernel launches in the run: {launches}; p iterations per "
          f"solve: mean {np.mean(p_its):.1f}, max {max(p_its)}; max "
          f"continuity error {max(cont):.3e}, max Courant {max(co):.3f}")
    print(f"[5] ms/step: first {st[0] * 1e3:.1f}, median of steps 2-{steps} "
          f"{steady * 1e3:.1f}, mean {np.mean(st[1:]) * 1e3:.1f} "
          f"(card: {smi})")
    return launches


def main():
    smi = phase_setup()
    phase_build()
    k = phase_kernel()
    with tempfile.TemporaryDirectory() as tmp:
        phase_fp64_agreement(tmp)
        launches = phase_main_path(tmp, smi)
    print(json.dumps({"kernels": [{
        "name": "shift_mac", "route": "cuda",
        "source": "rapidcfd_tpu_torch/csrc/shift_mac.cu",
        "replaces": "rapidcfd_tpu/ops/pallas_gdia.py:67",
        "launches": launches, "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
