"""pimpleFoam / pisoFoam — transient incompressible solvers with RAS or
LES turbulence (port of rapidcfd_tpu/solvers/pimplefoam.py; reference:
applications/solvers/incompressible/pimpleFoam/pimpleFoam.C and
pisoFoam.C).

The ddt scheme is Euler, backward or CrankNicolson: U keeps the old levels
the scheme reads (fvm.store_old: two under backward and CrankNicolson,
whose ddt0 advances with the previous step's dt), and so do the
turbulence model's transported fields. The JAX package keeps one level
under backward, which it then runs as Euler.

A timestep is nOuterCorrectors PIMPLE loops: the momentum predictor
(relaxed on all but the final loop, which also switches to the UFinal and
pFinal solver controls), nCorrectors pressure corrections with their
non-orthogonal correctors, and the turbulence model's transient correct().
pisoFoam is the same with one outer loop. The host loop adapts dt to the
Courant number (reference: cfdTools/general/include/setDeltaT.H), logs in
OpenFOAM format and writes time directories; the controlDict's function
objects run after each step (case.hook_seconds holds their wall time).
SRFPimpleFoam (solvers/srffoam.py) is this run with the case's SRFModel
(the frame's acceleration as u_source, the velocity named Urel).
"""

from __future__ import annotations

import time as _time

import torch

from ..linalg.solvers import solve
from ..models.fvoptions import FvOptions
from ..models.transport import SinglePhaseTransportModel
from ..models.turbulence import make_ras_model
from ..ops import fvc, fvm
from ..utils.logging import (ExecutionTimer, info, log_continuity,
                             log_courant, log_solve)
from ..postprocess import FunctionObjectList
from .case import Case
from .controls import PimpleControl, PisoControl
from .icofoam import continuity_errors, courant_number
from .simplefoam import (div_dev_reff, hook_fields, iteration_counts,
                         refuse_srf_functions, turb_nl_stress,
                         written_fields)


def make_step(case: Case, transport, turb, ctrl, piso_mode: bool,
              u_source=None, u_name: str = "U"):
    """step(U, p, phi, turb_state, dt) -> (U, p, phi, turb_state, stats)
    on the case's mesh. stats holds the last momentum solve's per-
    component perf (u_perf), every p solve of the step in order (p_perf),
    the turbulence solves (turb), the continuity errors (cont) and the
    Courant number (co). pRefCell is mapped from file order to its
    device row. u_source: (mesh, U) -> (n, 3) acceleration on the
    momentum LHS (SRFPimpleFoam's `+ SRF->Su()`); u_name: the velocity's
    fvSolution/fvSchemes name (Urel in the SRF solvers)."""
    from ..linalg.precompute import attach_solver_layouts
    from ..ops.interpolation import set_current_dt
    fv_options = FvOptions(case)
    div_u = case.div_scheme(f"div(phi,{u_name})")
    lap_corr = case.laplacian_scheme()
    ddt_scheme = case.ddt_scheme()
    u_controls = case.solver_controls(u_name)
    u_final = case.solver_controls(u_name, final=True)
    p_controls = case.solver_controls("p")
    p_final = case.solver_controls("p", final=True)
    u_relax = case.relaxation_factor(u_name, "equations", 0.0)
    n_outer = 1 if piso_mode else ctrl.n_outer
    n_corr = ctrl.n_correctors
    n_non_orth = ctrl.n_non_orth
    p_ref_cell = case.maps.device_cell(ctrl.p_ref_cell)
    p_ref_value = ctrl.p_ref_value
    mesh = attach_solver_layouts(
        case.mesh, (u_controls, u_final, p_controls, p_final),
        timings=case.setup_seconds)

    def step(U, p, phi, turb_state, dt):
        set_current_dt(dt)
        U = fvm.store_old(mesh, U, dt, ddt_scheme)
        nu = transport.nu(mesh, U)
        u_perf = None
        p_perf_all = []
        for outer in range(n_outer):
            final_outer = outer == n_outer - 1
            nu_eff = turb.nu_eff(mesh, turb_state, nu)
            UEqn = (fvm.ddt(mesh, U, dt, ddt_scheme)
                    + fvm.div(mesh, phi, U, div_u)
                    + div_dev_reff(mesh, nu_eff, U, lap_corr,
                                   turb_nl_stress(turb, mesh, turb_state,
                                                  U)))
            if u_source is not None:
                UEqn = UEqn.replace(source=UEqn.source - mesh.V[:, None]
                                    * u_source(mesh, U))
            UEqn = fv_options(mesh, "U", UEqn, {"nu": nu})
            if not final_outer:
                UEqn = UEqn.relax(mesh, u_relax)
            UEqn = fv_options.constrain(mesh, "U", UEqn)
            if ctrl.momentum_predictor:
                U, u_perf = solve(
                    mesh, UEqn == (-fvc.grad(mesh, p)),
                    u_final if final_outer else u_controls,
                    env={"phi": phi})

            for corr in range(n_corr):
                UEqn_c = UEqn.replace(psi=U)
                rAU = 1.0 / UEqn_c.A(mesh)
                HbyA = fvc.constrain_hbya(mesh, rAU * UEqn_c.H(mesh), U)
                phi_hbya = fvc.adjust_phi(mesh, fvc.flux(mesh, HbyA), U)
                for north in range(n_non_orth + 1):
                    final = final_outer and corr == n_corr - 1 \
                        and north == n_non_orth
                    pEqn = fvm.laplacian(mesh, rAU, p, lap_corr) \
                        == fvc.div(mesh, phi_hbya)
                    pEqn = pEqn.set_reference(p_ref_cell, p_ref_value)
                    p, p_perf = solve(mesh, pEqn,
                                      p_final if final else p_controls)
                    p_perf_all.append(p_perf[0])
                phi = phi_hbya - pEqn.replace(psi=p).flux(mesh)
                U_star = HbyA - rAU * fvc.grad(mesh, p)
                U = U.replace(data=U_star.data).correct_boundary_conditions(
                    mesh, env={"phi": phi})

            turb_state, turb_perf = turb.correct(mesh, turb_state, U, phi,
                                                 nu, dt=dt)

        if u_perf is None:
            u_perf = ((0.0, 0.0, 0),) * 3
        stats = dict(u_perf=u_perf, p_perf=tuple(p_perf_all),
                     turb=turb_perf, cont=continuity_errors(mesh, phi),
                     co=courant_number(mesh, phi, dt))
        return U, p, phi, turb_state, stats

    return step


def next_delta_t(delta_t: float, max_co: float, co_max_prev: float) -> float:
    """setDeltaT.H: scale dt toward maxCo, growing by at most 20% (and
    by 10% of the headroom) per step."""
    max_dt_f = max_co / (co_max_prev + 1e-30)
    return min(min(max_dt_f, 1.0 + 0.1 * max_dt_f), 1.2) * delta_t


def setup(case: Case, piso_mode: bool = False, srf=None):
    """Fields, models and the step of a case: (U, p, phi, turb_state),
    step, transport, turb. Builds the solver layouts (GAMG hierarchy) on
    ELL meshes. srf: an SRFModel (SRFPimpleFoam): U is the relative
    velocity Urel, with the frame's acceleration on the momentum LHS."""
    u_name = "U" if srf is None else "Urel"
    info(f"Reading field p\n\nReading field {u_name}\n")
    p = case.read_field("p")
    U = case.read_field(u_name)
    if srf is not None:
        U = srf.patch_bcs(case.mesh, U)
    phi = fvc.flux(case.mesh, U)
    transport = SinglePhaseTransportModel(case.transport_properties())
    turb = make_ras_model(case, U)
    turb_state = turb.init_state(U)
    ctrl = PisoControl(case) if piso_mode else PimpleControl(case)
    step = make_step(case, transport, turb, ctrl, piso_mode,
                     u_source=None if srf is None else srf.su,
                     u_name=u_name)
    return (U, p, phi, turb_state), step, transport, turb


def run(case_dir: str, *, device: torch.device, dtype: torch.dtype,
        write: bool = True, max_steps: int | None = None,
        piso_mode: bool = False, case: Case | None = None, srf=None):
    """Run pimpleFoam (pisoFoam with piso_mode) on a case directory until
    endTime or max_steps. `case` passes a Case built already (an
    in-memory mesh). Returns (case, U, p, phi, turb_state);
    case.step_seconds holds each step's wall time (host clock; each step
    ends in a device sync when its residuals are logged) and
    case.step_log each step's dt, Courant number (mean, max), continuity
    errors (local, global) and iteration_counts. srf: an SRFModel
    (SRFPimpleFoam, as the JAX package runs it): U is Urel, Uabs is
    written beside it (also at the end), deltaT stays fixed and no
    function objects run."""
    if case is None:
        case = Case(case_dir, device=device, dtype=dtype)
    u_name = "U" if srf is None else "Urel"
    if srf is not None:
        refuse_srf_functions(case, "SRFPimpleFoam")
    (U, p, phi, turb_state), step, transport, turb = setup(case, piso_mode,
                                                           srf)
    timer = ExecutionTimer()
    cumulative_err = 0.0
    u_solver = case.solver_controls(u_name).solver
    p_solver = case.solver_controls("p").solver
    case.step_log = []
    fos = FunctionObjectList(case)
    case.hook_seconds = []

    info("\nStarting time loop\n")
    n = 0
    co_max_prev = 0.0
    while case.time.run():
        t0 = _time.perf_counter()
        if case.time.adjust_time_step and co_max_prev > 0 and srf is None:
            case.time.set_delta_t(next_delta_t(
                case.time.delta_t, case.time.max_co, co_max_prev))
        case.time.increment()
        info(f"Time = {case.time.name}\n")
        dt = case.time.delta_t

        U, p, phi, turb_state, stats = step(U, p, phi, turb_state, dt)
        co_mean, co_max = stats["co"]
        co_max_prev = float(co_max)
        log_courant(co_mean, co_max)
        for cmpt, perf in zip("xyz", stats["u_perf"]):
            log_solve(u_solver, f"{u_name}{cmpt}", *perf)
        for perf in stats["p_perf"]:
            log_solve(p_solver, "p", *perf)
        for name, perf in sorted(stats["turb"].items()):
            log_solve(case.solver_controls(name).solver, name, *perf)
        local_err, glob_err = stats["cont"]
        cumulative_err += float(glob_err)
        log_continuity(cumulative_err, local_err, glob_err)
        case.step_seconds.append(_time.perf_counter() - t0)
        case.step_log.append(dict(
            dt=dt, co=(float(co_mean), co_max_prev),
            cont=(float(local_err), float(glob_err)),
            iterations=iteration_counts(stats)))
        if fos.objects:
            t1 = _time.perf_counter()
            fos.execute(hook_fields(case.mesh, transport, turb, U, p, phi,
                                    turb_state))
            case.hook_seconds.append(_time.perf_counter() - t1)
        timer.log()

        if write and case.time.write_time():
            case.write_fields(written_fields(case.mesh, U, p, turb_state,
                                             srf))
        n += 1
        if max_steps and n >= max_steps:
            break

    if write and srf is not None:
        case.write_fields(written_fields(case.mesh, U, p, turb_state, srf))
    fos.close()
    info("End\n")
    return case, U, p, phi, turb_state


def main(argv=None):
    import argparse

    from .. import resolve_device, solver_dtype
    ap = argparse.ArgumentParser(description="pimpleFoam (rapidcfd_tpu_torch)")
    ap.add_argument("-case", dest="case", default=".")
    ap.add_argument("-noWrite", action="store_true")
    ap.add_argument("-device", default="cuda")
    ap.add_argument("-precision", choices=["fp32", "fp64"], default=None)
    ap.add_argument("--piso", action="store_true", help="run as pisoFoam")
    args = ap.parse_args(argv)
    name = "pisoFoam" if args.piso else "pimpleFoam"
    run(args.case, device=resolve_device(args.device),
        dtype=solver_dtype(name, args.precision), write=not args.noWrite,
        piso_mode=args.piso)


if __name__ == "__main__":
    main()
