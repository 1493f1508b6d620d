"""thermoFoam — the energy equation on a frozen flow (port of
rapidcfd_tpu/solvers/thermofoam.py; reference: applications/solvers/
heatTransfer/thermoFoam/thermoFoam.C with EEqn.H).

rho, U and phi are read from the case once and held fixed; each timestep
solves ddt(rho, h) + div(phi, h) - laplacian(alphaEff, h) = 0 for the
sensible enthalpy and updates T from it.
"""

from __future__ import annotations

import time as _time

import torch

from ..fields.field import Dimensioned, SurfaceField
from ..linalg.solvers import solve
from ..models.thermo import PsiThermo, read_thermo
from ..ops import fvc, fvm
from ..utils.dimensions import DimensionSet, dim_density
from ..utils.logging import ExecutionTimer, info, log_solve
from .case import Case

_DYN_VISC = DimensionSet.of(1, -1, -1)


def make_step(case: Case, thermo: PsiThermo, rho, phi: SurfaceField):
    """step(T, dt) -> (T, perf) on the frozen rho (with itself as its old
    level) and mass flux phi."""
    case.refuse_second_order_ddt("thermoFoam")
    from ..linalg.precompute import attach_solver_layouts
    m = thermo.model
    h_controls = case.solver_controls("h")
    try:
        div_h = case.div_scheme("div(phi,h)")
    except KeyError:
        div_h = "upwind"
    lap_corr = case.laplacian_scheme()
    ddt_scheme = case.ddt_scheme()
    mesh = attach_solver_layouts(case.mesh, (h_controls,),
                                 timings=case.setup_seconds)

    def step(T, dt):
        h = thermo.he_field(mesh, T, "h").replace(old=None)
        h = h.replace(old=h)
        alpha_f = Dimensioned("alpha", _DYN_VISC,
                              m.alpha_h(fvc.face_values(mesh, T)))
        hEqn = (fvm.ddt(mesh, h, dt, ddt_scheme, coeff=rho)
                + fvm.div(mesh, phi, h, div_h)
                - fvm.laplacian(mesh, alpha_f, h, lap_corr))
        h, perf = solve(mesh, hEqn, h_controls)
        return thermo.update_t(mesh, T, h), perf

    return step


def setup(case: Case):
    """(thermo, T, step): rho from the equation of state at the case's p
    and T, phi = rho_f (U_f & Sf)."""
    m = read_thermo(case.constant_dict("thermophysicalProperties"))
    thermo = PsiThermo(case, m)
    p = case.read_field("p")
    T = case.read_field("T")
    U = case.read_field("U")
    rho = T.with_calculated_bcs(m.rho(p.data, T.data),
                                m.rho(p.bvalues, T.bvalues), dim_density,
                                "rho")
    rho = rho.replace(old=rho.replace(old=None))
    phi = SurfaceField(fvc.face_values(case.mesh, rho)
                       * fvc.flux(case.mesh, U).data,
                       DimensionSet.of(1, 0, -1), "phi")
    return thermo, T, make_step(case, thermo, rho, phi)


def run(case_dir: str, *, device: torch.device, dtype: torch.dtype,
        write: bool = True, max_steps: int | None = None,
        case: Case | None = None):
    """Run thermoFoam until endTime or max_steps. Returns (case, T);
    case.step_log holds each step's h iterations."""
    if case is None:
        case = Case(case_dir, device=device, dtype=dtype)
    thermo, T, step = setup(case)
    h_solver = case.solver_controls("h").solver
    timer = ExecutionTimer()
    case.step_log = []
    info("\nEvolving thermodynamics\n")
    n = 0
    while case.time.loop():
        t0 = _time.perf_counter()
        info(f"Time = {case.time.name}\n")
        T, perf = step(T, case.time.delta_t)
        log_solve(h_solver, "h", *perf[0])
        case.step_seconds.append(_time.perf_counter() - t0)
        case.step_log.append(dict(iterations=[("h", int(perf[0][2]))]))
        timer.log()
        if write and case.time.write_time():
            case.write_fields([T])
        n += 1
        if max_steps and n >= max_steps:
            break
    info("End\n")
    return case, T


def main(argv=None):
    import argparse

    from .. import resolve_device, solver_dtype
    ap = argparse.ArgumentParser(description="thermoFoam (rapidcfd_tpu_torch)")
    ap.add_argument("-case", dest="case", default=".")
    ap.add_argument("-noWrite", action="store_true")
    ap.add_argument("-device", default="cuda")
    ap.add_argument("-precision", choices=["fp32", "fp64"], default=None)
    args = ap.parse_args(argv)
    run(args.case, device=resolve_device(args.device),
        dtype=solver_dtype("thermoFoam", args.precision),
        write=not args.noWrite)


if __name__ == "__main__":
    main()
