"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. setup: torch, the card, its power limit, nvcc, whether triton imports;
   a CUDA card is required;
2. build the shift-MAC kernel (csrc/shift_mac.cu) from the checkout and
   print ptxas's registers, shared memory and spills for every kernel;
3. the kernel and the baseline kernel (as first written) against its
   plain torch version on the card, fp32 and fp64, at the pitzDaily x5
   slice shape (C = 3, the Gauss gradient, and C = 1, the divergence
   contraction) and at the edges the launcher must handle (n % 4 != 0,
   misaligned views, |off| >= n, K = 1, tiny n, 3-D offsets, the generic
   kernel); tolerance max|d| <= 1e-13 max|out| (fp64), 1e-5 (fp32) — FMA
   contraction is the only difference; then, for both forms at the slice
   shape, the wall time per call back to back (CUDA events) beside a
   torch.add of the same length, then device time per call
   (torch.profiler) of the kernel, the baseline, the plain version and the
   cuSPARSE CSR product of the same operator, cold (rotating over 75 MB or
   68 MB of input sets, as the solvers' calls find their inputs) and warm
   (one input set, in L2), the baseline and the kernel in turns, beside the
   least time the card could take and the device time of a one-element
   torch kernel (the floor of any launch);
4. the icoFoam gdia slice in fp64 at pitzDaily x1 (every solve to 1e-12)
   for 10 steps on cuda and on cpu: U, p, phi agree to 1e-8 relative to
   their largest magnitude, iteration counts within one per solve;
5. the gdia main path: icofoam.run in fp32 at pitzDaily x5 (106,000 live
   cells) for 20 steps; fields finite and bounded, the kernel launched at
   least 3 times per step (launch count reset just before the run);
6. the padded-ELL cavity in fp64, 10 steps each on cuda and on cpu, the
   same agreement checks as phase 4: the 20x20 tutorial setup (PCG/DIC p,
   smoothSolver U) and the 48x48 bench setup (PCG with a GAMG
   preconditioner for p, PBiCGStab/DILU U), every solve to 1e-12;
7. the ELL main path as bench.py drives the cavity: 384x384 (147,456
   cells), fp32, bench setup, make_chained_step with a chain of 10, one
   warm-up window and two timed ones; fields finite, continuity error
   below 0.1 and Courant number below 10; setup seconds, ms/step,
   cell-updates/s and iterations per solve beside the card;
8. simpleFoam pitzDaily x1 (kEpsilon, wall functions, GAMG p on the
   structured multigrid) in fp64, 3 SIMPLE iterations each on cuda and on
   cpu, every solve to 1e-12: U, p, phi, k, epsilon and nut agree to 1e-8
   relative, iteration counts within one per solve;
9. the simpleFoam main path as bench.py --case pitz drives it: pitzDaily
   x5 (106,000 live cells), fp32, one warm-up iteration, then two timed
   windows of 5; fields finite, k and epsilon positive, continuity error
   below 0.1; ms/step, cell-updates/s over live cells, iterations per
   solve, set-up seconds and the kernel launches by C (both forms must
   launch) beside the card;
10. a JSON line of kernel results (the kernel's two forms: cold times of
   the kernel, the baseline, the plain version and cuSPARSE as `ms`,
   `baseline_ms`, `plain_ms` and `library_ms`, held against `bound_ms`,
   and their warm times as `*warm_ms`, with their launches on the
   simpleFoam path and on each other path), the card's name and power
   limit, and the result line
   {"ok": true, "device": {...}} last.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

_ITER_RE = re.compile(r"Solving for (\w+),.*No Iterations (\d+)")
SLICE_OFFSETS = (-560, -1, 0, 1, 560)       # pitzDaily x5 lattice: nx = 560
SLICE_N = 560 * 200
# the cavity as bench.py runs it by default: p by PCG with a GAMG
# preconditioner, U by PBiCGStab/DILU
CAVITY_BENCH = dict(p_solver="PCG", p_precond="GAMG", u_solver="PBiCGStab",
                    u_precond="DILU")
CAVITY_N = 384
CAVITY_CHAIN = 10
# published H100 SXM peaks (NVIDIA data sheet, at 700 W): HBM bytes/s and
# float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


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


def _ptxas_table(report: str) -> list[str]:
    """One line per kernel instantiation from nvcc -Xptxas -v: registers,
    shared memory, stack and spills."""
    rows, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            rows[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            rows[name].update(stack=m.group(1), spill=f"{m.group(2)}/"
                              f"{m.group(3)}")
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            rows[name].update(regs=m.group(1),
                              smem=smem.group(1) if smem else "0")
    names = list(rows)
    demangled = run_cmd(["c++filt", *names]).splitlines()
    if len(demangled) != len(names):
        demangled = names
    out = []
    for mangled, pretty in zip(names, demangled):
        pretty = re.sub(r"^void |\(anonymous namespace\)::", "", pretty)
        pretty = pretty.split("(")[0]
        r = rows[mangled]
        out.append(f"{pretty}: {r.get('regs', '?')} registers, "
                   f"{r.get('smem', '?')} B static smem, stack "
                   f"{r.get('stack', '?')} B, spill stores/loads "
                   f"{r.get('spill', '?')} B")
    return out


def phase_build():
    from rapidcfd_tpu_torch.ops import gdia_mac
    t0 = time.perf_counter()
    lib = gdia_mac.build()
    gdia_mac._load()
    print(f"[2] built {lib} in {time.perf_counter() - t0:.2f} s")
    rows = _ptxas_table(gdia_mac.build_report())
    check(rows, "no ptxas report")
    for row in rows:
        print(f"[2] {row}")


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


OFFSETS_3D = (-1200, -40, -1, 0, 1, 40, 1200)       # a 40x30x20 lattice
OFFSETS_ODD = (-317, -1, 0, 1, 317)
OFFSETS_SMALL = (-10, -1, 0, 1, 10)
# the kernel against its plain version: (what, K, C, n, offsets, storage
# offset of x and coeffs). The slice shapes first, then the edges the
# kernel's launcher must handle: n % 4 in {1, 2, 3} (no 16-byte rows in
# fp32; n % 2 == 0 keeps them in fp64), views at storage offset 1
# (misaligned pointers), |off| >= n, K = 1 with C = 2, n under one block or
# one pack, the 3-D K = 7 sets, and K and C of the generic kernel only
KERNEL_CASES = [
    ("slice", 5, 3, SLICE_N, SLICE_OFFSETS, 0),
    ("slice", 5, 1, SLICE_N, SLICE_OFFSETS, 0),
    ("3-D K=7", 7, 3, 40 * 30 * 20, OFFSETS_3D, 0),
    ("3-D K=7", 7, 1, 40 * 30 * 20, OFFSETS_3D, 0),
    ("3-D +-4096", 7, 3, 64 * 64 * 16, (-4096, -64, -1, 0, 1, 64, 4096), 0),
    ("n % 4 = 1", 5, 1, 100001, OFFSETS_ODD, 0),
    ("n % 4 = 2", 5, 3, 100002, OFFSETS_ODD, 0),
    ("n % 4 = 3", 5, 3, 100003, OFFSETS_ODD, 0),
    ("storage offset 1", 5, 1, SLICE_N, SLICE_OFFSETS, 1),
    ("storage offset 1", 5, 3, SLICE_N, SLICE_OFFSETS, 1),
    ("|off| >= n", 5, 3, 1000, (-5000, -1000, -1, 0, 1001), 0),
    ("K=1 C=2", 1, 2, 5000, (3,), 0),
    ("n under a block", 5, 1, 100, OFFSETS_SMALL, 0),
    ("n under a pack", 5, 3, 1, OFFSETS_SMALL, 0),
    ("n under a pack", 5, 1, 6, OFFSETS_SMALL, 0),
    ("generic K=8 C=5", 8, 5, 3001, (-50, -7, -2, -1, 0, 1, 2, 50), 0),
    ("generic K=8 C=5", 8, 5, 3000, (-50, -7, -2, -1, 0, 1, 2, 50), 0),
]


def _kernel_inputs(K, C, n, shift, dtype, g):
    """x (n,) and coeffs (K, C, n) on the card, as contiguous views at
    storage offset `shift`."""
    x = torch.randn(n + shift, generator=g, dtype=dtype, device="cuda")
    c = torch.randn(K * C * n + shift, generator=g, dtype=dtype,
                    device="cuda")
    return x[shift:], c[shift:].view(K, C, n)


def _library_matrix(coeffs, offsets):
    """The same operator as a CSR matrix (rows c*n + s, columns s +
    offsets[k] inside [0, n), int32 indices) for torch.mv, i.e. cuSPARSE:
    the yardstick the port never calls."""
    import warnings
    K, C, n = coeffs.shape
    order = sorted(range(K), key=lambda k: offsets[k])    # ascending columns
    off = torch.tensor([offsets[k] for k in order], device=coeffs.device)
    cols = torch.arange(n, device=coeffs.device)[:, None] + off    # (n, K)
    keep = (cols >= 0) & (cols < n)
    vals = coeffs[order].permute(1, 2, 0)[:, keep]                # (C, nnz)
    counts = keep.sum(1).repeat(C)
    crow = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return torch.sparse_csr_tensor(
            crow.int(), cols[keep].repeat(C).int(), vals.reshape(-1),
            size=(C * n, n))


def phase_kernel(smi: str) -> dict:
    from rapidcfd_tpu_torch.ops import gdia_mac as gm
    g = torch.Generator(device="cuda").manual_seed(1234)
    errs = {}               # C -> max|d| of the kernel at the fp32 slice
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-13)):
        for what, K, C, n, offs, shift in KERNEL_CASES:
            x, coeffs = _kernel_inputs(K, C, n, shift, dtype, g)
            ref = gm.shift_mac_cols_plain(x, coeffs, offs)
            scale = ref.abs().max().item()
            worst = []
            for impl in ("kernel", "baseline"):
                out = (gm.shift_mac_cols(x, coeffs, offs) if impl == "kernel"
                       else gm.shift_mac_cols_baseline(x, coeffs, offs))
                torch.cuda.synchronize()
                err = (out - ref).abs().max().item()
                check(out.shape == (C, n) and err <= tol * scale,
                      f"{impl} kernel disagrees with the plain version "
                      f"({dtype}, {what}, K={K}, C={C}, n={n}): {err} > "
                      f"{tol * scale}")
                worst.append(f"{impl} {err:.2e}")
                if (impl == "kernel" and dtype == torch.float32
                        and what == "slice"):
                    errs[C] = err
            print(f"[3] {str(dtype)[6:]} {what}, K={K} C={C} n={n}: max|d| "
                  f"{', '.join(worst)} (limit {tol * scale:.2e})")
    res = {}
    for C in (3, 1):
        x, coeffs = _kernel_inputs(5, C, SLICE_N, 0, torch.float32, g)
        res[C] = dict(
            max_abs_err=errs[C],
            wall_ms=_time_ms(lambda: gm.shift_mac_cols(x, coeffs,
                                                       SLICE_OFFSETS)),
            plain_wall_ms=_time_ms(lambda: gm.shift_mac_cols_plain(
                x, coeffs, SLICE_OFFSETS)),
            add_wall_ms=_time_ms(lambda: torch.add(x, x)))
        print(f"[3] fp32 slice shape C={C}, wall time per call back to back:"
              f" kernel {res[C]['wall_ms'] * 1e3:.2f} us, plain "
              f"{res[C]['plain_wall_ms'] * 1e3:.2f} us, torch.add of n "
              f"values {res[C]['add_wall_ms'] * 1e3:.2f} us (card: {smi})")
    # the wall times above come before any profiler session of the process
    one = torch.zeros(1, device="cuda")
    floor = _device_ms(lambda: one.add_(1.0))
    print(f"[3] device time of a one-element torch kernel: "
          f"{floor * 1e3:.2f} us (card: {smi})")
    for C in (3, 1):
        res[C].update(_time_form(gm, C, smi), floor_ms=floor)
    return res


def _time_form(gm, C: int, smi: str) -> dict:
    """Device time per call at the fp32 slice shape of the kernel, the
    baseline kernel, the plain version and the cuSPARSE product: cold
    (calls rotating over enough input sets to exceed the 50 MB L2) and
    warm (50 calls on one input set, which stays in L2); the baseline and
    the kernel in turns (baseline, kernel, kernel, baseline)."""
    K, n, offs = 5, SLICE_N, SLICE_OFFSETS
    g = torch.Generator(device="cuda").manual_seed(99 + C)
    nbytes = (n + K * C * n + C * n) * 4       # inputs once, output once
    n_sets = {1: 24, 3: 8}[C]                  # 75 MB and 68 MB of inputs
    sets = [_kernel_inputs(K, C, n, 0, torch.float32, g)
            for _ in range(n_sets)]
    mats = [_library_matrix(c, offs) for _, c in sets]
    x0, c0 = sets[0]
    ref = gm.shift_mac_cols_plain(x0, c0, offs)
    lib = torch.mv(mats[0], x0).view(C, n)
    torch.cuda.synchronize()
    lib_err = (lib - ref).abs().max().item()
    check(lib_err <= 1e-5 * ref.abs().max().item(),
          f"cuSPARSE product disagrees with the plain version: {lib_err}")
    fns = {
        "kernel": lambda i: gm.shift_mac_cols(*sets[i], offs),
        "baseline": lambda i: gm.shift_mac_cols_baseline(*sets[i], offs),
        "plain": lambda i: gm.shift_mac_cols_plain(*sets[i], offs),
        "library": lambda i: torch.mv(mats[i], sets[i][0]),
    }

    def timed(name, cold):
        if not cold:
            return _device_ms(lambda: fns[name](0), reps=50)
        turn = iter(range(10 ** 9))
        return _device_ms(lambda: fns[name](next(turn) % n_sets), reps=48)

    t = {}
    for cold in (True, False):
        tag = "cold" if cold else "warm"
        for name in ("baseline", "kernel", "kernel", "baseline"):
            t.setdefault((name, tag), []).append(timed(name, cold))
        for name in ("plain", "library"):
            t[(name, tag)] = [timed(name, cold)]
    ms = {k: sum(v) / len(v) for k, v in t.items()}
    bound = max((nbytes / HBM_BYTES_PER_S, "bytes"),
                (2 * K * C * n / FP32_FLOPS, "operations"))
    print(f"[3] fp32 slice shape C={C} (K=5, n={n}), device time per call, "
          f"us, cold ({n_sets} input sets, {n_sets * nbytes / 1e6:.1f}"
          f" MB) / warm: bound {bound[0] * 1e6:.2f} ({nbytes} bytes, by "
          f"{bound[1]}) (card: {smi})")
    for name in ("baseline", "kernel", "plain", "library"):
        c, w = t[(name, "cold")], t[(name, "warm")]
        share = (f"; {bound[0] * 1e3 / ms[(name, 'cold')]:.0%} of the bound "
                 f"cold")
        print(f"[3]   {name:9s} " + " / ".join(
            ", ".join(f"{v * 1e3:.2f}" for v in vals) for vals in (c, w))
            + (" (turns)" if len(w) > 1 else "") + share)
    print(f"[3]   cuSPARSE max|d| against plain {lib_err:.2e}")
    # ms, plain_ms, library_ms, baseline_ms: cold, as the bound assumes
    return dict(
        ms=ms[("kernel", "cold")], plain_ms=ms[("plain", "cold")],
        bound_ms=bound[0] * 1e3, bound_by=bound[1],
        library_ms=ms[("library", "cold")],
        baseline_ms=ms[("baseline", "cold")],
        warm_ms=ms[("kernel", "warm")],
        plain_warm_ms=ms[("plain", "warm")],
        library_warm_ms=ms[("library", "warm")],
        baseline_warm_ms=ms[("baseline", "warm")],
        turns_ms={f"{name} {tag}": vals for (name, tag), vals in t.items()
                  if len(vals) > 1})


def _logged(fn, *args, **kw):
    from rapidcfd_tpu_torch.utils.logging import captured
    with captured() as buf:
        out = fn(*args, **kw)
    return out, [(m.group(1), int(m.group(2)))
                 for m in _ITER_RE.finditer(buf.getvalue())], buf.getvalue()


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def _agreement(tag: str, run_dir: str, n_solves: int):
    """icofoam.run for 10 fp64 steps on cuda and on cpu: fields agree to
    1e-8 relative to their largest magnitude, iteration counts within one
    per solve. Returns the cuda run's case."""
    from rapidcfd_tpu_torch.solvers import icofoam
    outs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        outs[dev] = _logged(icofoam.run, run_dir, device=torch.device(dev),
                            dtype=torch.float64, write=False, max_steps=10)
        print(f"{tag} 10 steps on {dev}: {time.perf_counter() - t0:.2f} s")
    (gc, gU, gp, gphi), g_its, _ = outs["cuda"]
    (cc, cU, cp, cphi), c_its, _ = outs["cpu"]
    maps = cc.maps
    errs = {
        "U": _rel(maps.cells_to_file(gU.data.cpu().numpy()),
                  maps.cells_to_file(cU.data.numpy())),
        "p": _rel(maps.cells_to_file(gp.data.cpu().numpy()),
                  maps.cells_to_file(cp.data.numpy())),
        "phi": _rel(maps.faces_to_file(gphi.data.cpu().numpy(), flux=True),
                    maps.faces_to_file(cphi.data.numpy(), flux=True)),
    }
    print(f"{tag} cuda vs cpu, relative max|d|: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    check(all(v <= 1e-8 for v in errs.values()),
          f"{tag} fp64 cuda and cpu runs disagree: {errs}")
    check(len(g_its) == len(c_its) == n_solves,
          f"{tag} unexpected number of solves")
    diffs = [(i, a, b) for i, (a, b) in enumerate(zip(g_its, c_its))
             if a != b]
    for i, a, b in diffs:
        print(f"{tag} solve {i} ({a[0]}): cuda {a[1]} iterations, "
              f"cpu {b[1]}")
    check(all(a[0] == b[0] and abs(a[1] - b[1]) <= 1 for _, a, b in diffs),
          f"{tag} iteration counts differ by more than one")
    print(f"{tag} iteration counts: {len(diffs)} of {len(g_its)} solves "
          f"differ (by one)")
    return gc


def phase_fp64_agreement(tmp: str):
    from rapidcfd_tpu_torch.utils.casegen import pitz_daily_ico_case
    d = f"{tmp}/pitz1"
    pitz_daily_ico_case(d, scale=1, tight_tol=True)
    _agreement("[4] fp64 pitzDaily x1,", d, 50)


def phase_main_path(tmp: str, smi: str) -> dict:
    from rapidcfd_tpu_torch.ops import gdia_mac
    from rapidcfd_tpu_torch.solvers import icofoam
    from rapidcfd_tpu_torch.utils.casegen import pitz_daily_ico_case
    d = f"{tmp}/pitz5"
    t0 = time.perf_counter()
    pitz_daily_ico_case(d, scale=5)
    print(f"[5] pitzDaily x5 case written in {time.perf_counter() - t0:.2f} s")
    steps = 20
    gdia_mac.reset_launches()
    t0 = time.perf_counter()
    (case, U, p, phi), its, log = _logged(
        icofoam.run, d, device=torch.device("cuda"), dtype=torch.float32,
        write=False, max_steps=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(gdia_mac.LAUNCHES_BY_C)
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
    check(launches.get(3, 0) >= 3 * steps,
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


def _gamg_sizes(case) -> list[int]:
    """Cells per level of the p solver's GAMG hierarchy (the one the
    run built; it is cached per mesh)."""
    from rapidcfd_tpu_torch.linalg.gamg import build_hierarchy, gamg_shape
    n_coarsest, merge_levels = gamg_shape(case.solver_controls("p"))
    levels = build_hierarchy(case.mesh, n_coarsest=n_coarsest,
                             merge_levels=merge_levels)
    return [case.mesh.n_cells] + [lv.n_coarse for lv in levels]


def phase_cavity_agreement(tmp: str):
    from rapidcfd_tpu_torch.utils.casegen import cavity_case
    d = f"{tmp}/cavity20"
    cavity_case(d, n=20, delta_t=0.005, end_time=1.0, tight_tol=True)
    case = _agreement("[6] fp64 cavity 20x20 tutorial,", d, 50)
    check(case.mesh.gdia is None, "the cavity did not take the ELL path")
    d = f"{tmp}/cavity48"
    cavity_case(d, n=48, delta_t=0.005 * 20 / 48, end_time=1.0,
                tight_tol=True, **CAVITY_BENCH)
    case = _agreement("[6] fp64 cavity 48x48 bench,", d, 50)
    print(f"[6] cavity 48x48 GAMG hierarchy, cells per level: "
          f"{_gamg_sizes(case)}")


def phase_cavity_main(tmp: str, smi: str) -> dict:
    """The cavity as bench.py:104-182 drives it. Returns the shift-MAC
    launches by C counted over the run (the ELL path has no call of
    it)."""
    from rapidcfd_tpu_torch.fields.field import Dimensioned
    from rapidcfd_tpu_torch.ops import fvc, gdia_mac
    from rapidcfd_tpu_torch.solvers import icofoam
    from rapidcfd_tpu_torch.solvers.case import Case
    from rapidcfd_tpu_torch.utils.casegen import cavity_case
    from rapidcfd_tpu_torch.utils.logging import captured
    n = CAVITY_N
    d = f"{tmp}/cavity{n}"
    dt = 0.005 * 20 / n * 0.5
    t0 = time.perf_counter()
    pmesh = cavity_case(d, n=n, delta_t=dt, end_time=1e9, write_mesh=False,
                        **CAVITY_BENCH)
    t_case = time.perf_counter() - t0
    gdia_mac.reset_launches()
    t0 = time.perf_counter()
    with captured():
        case = Case(d, device=torch.device("cuda"), dtype=torch.float32,
                    pmesh=pmesh)
        nu = Dimensioned.from_entry(
            case.transport_properties().lookup("nu", required=True), "nu")
        piso = case.algo_dict("PISO")
        step = icofoam.make_chained_step(
            case, nu, int(piso.scalar("nCorrectors", 2)),
            int(piso.scalar("nNonOrthogonalCorrectors", 0)),
            int(piso.scalar("pRefCell", 0)),
            float(piso.scalar("pRefValue", 0)), chain=CAVITY_CHAIN)
        U, p = case.read_field("U"), case.read_field("p")
        phi = fvc.flux(case.mesh, U)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    mesh = case.mesh
    check(mesh.gdia is None and mesh.n_cells == n * n,
          f"expected {n * n} cells on the ELL path")
    ss = case.setup_seconds
    print(f"[7] cavity {n}x{n} fp32 bench setup, {mesh.n_cells} cells, "
          f"K = {mesh.K}: case {t_case:.2f} s, setup {t_setup:.2f} s (RCM "
          f"{ss['rcm']:.2f} s, geometry and ELL {ss['mesh']:.2f} s, upload "
          f"{ss['upload']:.2f} s, GAMG agglomeration "
          f"{ss['agglomeration']:.2f} s); GAMG cells per level "
          f"{_gamg_sizes(case)}")
    windows, stats = [], []
    for w in range(3):        # one warm-up window, then two timed ones
        t0 = time.perf_counter()
        U, p, phi, st = step(U, p, phi, dt)
        torch.cuda.synchronize()
        stats.append(st)
        if w:
            windows.append(time.perf_counter() - t0)
    launches = dict(gdia_mac.LAUNCHES_BY_C)
    for f in (U, p, phi):
        check(bool(torch.isfinite(f.data).all()), f"{f.name} not finite")
    check(U.data.shape == (mesh.n_cells, 3) and p.data.shape
          == (mesh.n_cells,) and phi.data.shape == (mesh.n_faces,),
          "unexpected shapes")
    cont = max(float(st["cont"][0].max()) for st in stats)
    co = max(float(st["co"][1].max()) for st in stats)
    check(cont < 0.1 and co < 10.0,
          f"run not bounded: continuity {cont}, Courant {co}")
    its = {k: torch.cat([perf[2].flatten() for st in stats
                         for perf in st[k]]).double()
           for k in ("p_perf", "u_perf")}
    p_its, u_its = its["p_perf"], its["u_perf"]
    med = statistics.median(windows)
    ms = 1e3 * med / CAVITY_CHAIN
    print(f"[7] {len(stats) * CAVITY_CHAIN} steps: max continuity error "
          f"{cont:.3e}, max Courant {co:.4f}; p iterations per solve mean "
          f"{p_its.mean():.2f} max {int(p_its.max())}, U mean "
          f"{u_its.mean():.2f} max {int(u_its.max())} (card: {smi})")
    print(f"[7] windows of {CAVITY_CHAIN} steps: "
          + ", ".join(f"{1e3 * w / CAVITY_CHAIN:.3f}" for w in windows)
          + f" ms/step; median {ms:.3f} ms/step, "
          f"{mesh.n_cells * CAVITY_CHAIN / med:.1f} cell-updates/s "
          f"(card: {smi})")
    print(f"[7] shift-MAC launches in the cavity run: {launches}")
    return launches


def _simple_rel_errs(gout, cout):
    """Relative max|d| per field of two simpleFoam runs (file order;
    phi in file orientation)."""
    (gc, gU, gp, gphi, gts), (cc, cU, cp, cphi, cts) = gout, cout
    maps = cc.maps
    errs = {}
    for name, a, b in [("U", gU, cU), ("p", gp, cp),
                       *[(k, gts[k], cts[k]) for k in sorted(cts)]]:
        errs[name] = _rel(maps.cells_to_file(a.data.cpu().numpy()),
                          maps.cells_to_file(b.data.numpy()))
    errs["phi"] = _rel(maps.faces_to_file(gphi.data.cpu().numpy(),
                                          flux=True),
                       maps.faces_to_file(cphi.data.numpy(), flux=True))
    return errs


def phase_simple_agreement(tmp: str):
    """simpleFoam pitzDaily x1 in fp64 (every solve to 1e-12) for 3 SIMPLE
    iterations on cuda and on cpu."""
    from rapidcfd_tpu_torch.solvers import simplefoam
    from rapidcfd_tpu_torch.utils.casegen import pitz_daily_case
    d = f"{tmp}/simple1"
    pitz_daily_case(d, scale=1, tight_tol=True)
    outs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        outs[dev] = _logged(simplefoam.run, d, device=torch.device(dev),
                            dtype=torch.float64, write=False, max_steps=3)
        print(f"[8] fp64 simpleFoam pitzDaily x1, 3 iterations on {dev}: "
              f"{time.perf_counter() - t0:.2f} s")
    (gout, g_its, _), (cout, c_its, _) = outs["cuda"], outs["cpu"]
    errs = _simple_rel_errs(gout, cout)
    print("[8] cuda vs cpu, relative max|d|: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    check(all(v <= 1e-8 for v in errs.values()),
          f"fp64 simpleFoam cuda and cpu runs disagree: {errs}")
    check(len(g_its) == len(c_its) == 3 * 6, "unexpected number of solves")
    diffs = [(i, a, b) for i, (a, b) in enumerate(zip(g_its, c_its))
             if a != b]
    for i, a, b in diffs:
        print(f"[8] solve {i} ({a[0]}): cuda {a[1]} iterations, cpu {b[1]}")
    check(all(a[0] == b[0] and abs(a[1] - b[1]) <= 1 for _, a, b in diffs),
          "simpleFoam iteration counts differ by more than one")
    print(f"[8] iteration counts: {len(diffs)} of {len(g_its)} solves "
          f"differ (by one); cuda: {g_its[:6]} ...")


SIMPLE_STEPS = 5            # iterations per timed window


def phase_simple_main(tmp: str, smi: str) -> dict:
    """simpleFoam pitzDaily x5 in fp32 as bench.py:184-228 drives it: one
    warm-up iteration, then two timed windows. Returns the shift-MAC
    launches by C over the whole drive (counts reset just before)."""
    from rapidcfd_tpu_torch.models.transport import SinglePhaseTransportModel
    from rapidcfd_tpu_torch.models.turbulence import make_ras_model
    from rapidcfd_tpu_torch.ops import fvc, gdia_mac
    from rapidcfd_tpu_torch.solvers import simplefoam
    from rapidcfd_tpu_torch.solvers.case import Case
    from rapidcfd_tpu_torch.solvers.controls import SimpleControl
    from rapidcfd_tpu_torch.utils.casegen import pitz_daily_case
    from rapidcfd_tpu_torch.utils.logging import captured
    d = f"{tmp}/simple5"
    t0 = time.perf_counter()
    pitz_daily_case(d, scale=5)
    t_case = time.perf_counter() - t0
    t0 = time.perf_counter()
    with captured():
        case = Case(d, device=torch.device("cuda"), dtype=torch.float32)
        U, p = case.read_field("U"), case.read_field("p")
        phi = fvc.flux(case.mesh, U)
        transport = SinglePhaseTransportModel(case.transport_properties())
        turb = make_ras_model(case, U)
        ts = turb.init_state(U)
        step = simplefoam.make_step(case, transport, turb,
                                    SimpleControl(case))
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    mesh = case.mesh
    live = int(case.maps.cell_primary.sum())
    check(mesh.gdia is not None and live == 106000,
          f"expected the gdia lattice with 106000 live cells, got {live}")
    print(f"[9] simpleFoam pitzDaily x5 fp32: {mesh.n_cells} slots, {live} "
          f"live cells; case written in {t_case:.2f} s, setup "
          f"{t_setup:.2f} s ({', '.join(f'{k} {v:.2f} s' for k, v in case.setup_seconds.items())})")
    stats, windows, steps = [], [], 0
    gdia_mac.reset_launches()
    with captured():
        t0 = time.perf_counter()
        U, p, phi, ts, st = step(U, p, phi, ts)         # warm-up
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        stats.append(st)
        steps += 1
        for _ in range(2):
            t0 = time.perf_counter()
            for _ in range(SIMPLE_STEPS):
                U, p, phi, ts, st = step(U, p, phi, ts)
                stats.append(st)
                steps += 1
            torch.cuda.synchronize()
            windows.append(time.perf_counter() - t0)
    launches = dict(gdia_mac.LAUNCHES_BY_C)
    for f in (U, p, phi, *ts.values()):
        check(bool(torch.isfinite(f.data).all()), f"{f.name} not finite")
    check(U.data.shape == (mesh.n_cells, 3)
          and p.data.shape == (mesh.n_cells,), "unexpected shapes")
    prim = torch.as_tensor(case.maps.cell_primary, device=p.data.device)
    for name in ("k", "epsilon"):
        check(bool((ts[name].data[prim] > 0).all()), f"{name} not positive")
    cont = max(float(s["cont"][0]) for s in stats)
    check(cont < 0.1, f"continuity error {cont}")

    def its(get):
        v = [int(get(s)[2]) for s in stats]
        return f"mean {np.mean(v):.2f} max {max(v)}"
    med = statistics.median(windows)
    print(f"[9] {steps} iterations: p {its(lambda s: s['p_perf'][0])}, U "
          f"{its(lambda s: s['u_perf'][0])}, epsilon "
          f"{its(lambda s: s['turb']['epsilon'])}, k "
          f"{its(lambda s: s['turb']['k'])} per solve; max continuity error "
          f"{cont:.3e}; U max {float(U.data.abs().max()):.3f}, nut max "
          f"{float(ts['nut'].data.max()):.3e}")
    print(f"[9] first iteration {t_first * 1e3:.1f} ms; windows of "
          f"{SIMPLE_STEPS}: "
          + ", ".join(f"{1e3 * w / SIMPLE_STEPS:.3f}" for w in windows)
          + f" ms/step; median {1e3 * med / SIMPLE_STEPS:.3f} ms/step, "
          f"{live * SIMPLE_STEPS / med:.1f} cell-updates/s (card: {smi})")
    per_step = {c: n / steps for c, n in sorted(launches.items())}
    print(f"[9] shift-MAC launches in {steps} iterations: {launches} "
          f"(per iteration {per_step})")
    for c in (3, 1):
        check(launches.get(c, 0) > 0,
              f"the shift-MAC kernel with C = {c} was not launched")
    return launches


def main():
    smi = phase_setup()
    phase_build()
    k = phase_kernel(smi)
    with tempfile.TemporaryDirectory() as tmp:
        phase_fp64_agreement(tmp)
        ico = phase_main_path(tmp, smi)
        phase_cavity_agreement(tmp)
        cavity = phase_cavity_main(tmp, smi)
        phase_simple_agreement(tmp)
        simple = phase_simple_main(tmp, smi)
    kernels = []
    for c, what in ((3, "Gauss gradient"), (1, "divergence contraction")):
        kernels.append({
            "name": f"shift_mac C={c} ({what})", "route": "cuda",
            "source": "rapidcfd_tpu_torch/csrc/shift_mac.cu",
            "replaces": "rapidcfd_tpu/ops/pallas_gdia.py:67",
            "launches": simple.get(c, 0), **k[c],
            "launches_by_path": {
                "simpleFoam pitzDaily x5": simple.get(c, 0),
                "icoFoam pitzDaily x5": ico.get(c, 0),
                "icoFoam cavity 384": cavity.get(c, 0)}})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
