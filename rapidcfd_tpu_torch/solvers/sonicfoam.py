"""sonicFoam — transonic/supersonic compressible PISO solver (port of
rapidcfd_tpu/solvers/sonicfoam.py; reference: applications/solvers/
compressible/sonicFoam/sonicFoam.C with rhoEqn.H, UEqn.H, EEqn.H and
pEqn.H).

A timestep is the density predictor as a diagonal update, the momentum
predictor with ddt(rho, U), the internal-energy equation with the
explicit kinetic-plus-flow-work flux (then T from e and the TMin clamp),
psi with its old level, and nCorrectors transonic pressure corrections
fvm::ddt(psi, p) + fvm::div(phid, p) - fvm::laplacian(rho*rAU, p), each
followed by the pMin clamp, the flux, the momentum correction and rho
from the equation of state. The host loop logs in OpenFOAM format and
writes time directories. sonicDyMFoam (`dym`) is not ported.
"""

from __future__ import annotations

import time as _time

import torch

from ..fields.field import Dimensioned, SurfaceField, VolField
from ..linalg.solvers import gsum, solve
from ..models.thermo import PsiThermo, read_thermo
from ..ops import fvc, fvm
from ..utils.dimensions import DimensionSet, dim_density
from ..utils.logging import (ExecutionTimer, info, log_continuity,
                             log_courant, log_solve)
from .case import Case
from .controls import PisoControl
from .icofoam import courant_number

_DYN_VISC = DimensionSet.of(1, -1, -1)
_PSI = DimensionSet.of(0, -2, 2)
_MASS_FLUX = DimensionSet.of(1, 0, -1)


def _clamp(f: VolField, floor: float) -> VolField:
    return f.replace(data=torch.clamp(f.data, min=floor),
                     bvalues=torch.clamp(f.bvalues, min=floor))


def make_step(case: Case, thermo: PsiThermo, ctrl: PisoControl,
              dym: bool = False):
    """step(U, p, T, rho, phi, dt) -> (U, p, T, rho, phi, stats) on the
    case's mesh. stats holds the momentum solve's per-component perf
    (u_perf), the energy solve's (e_perf), every p solve in order
    (p_perf), the continuity errors (cont: local, global), the Courant
    number of phi/rho_f (co: mean, max) and the largest Mach number
    (mach_max)."""
    case.refuse_second_order_ddt("sonicFoam")
    if dym:
        raise NotImplementedError("sonicDyMFoam (dym=True) is not ported "
                                  "yet")
    from ..linalg.precompute import attach_solver_layouts
    from ..ops.interpolation import set_current_dt
    m = thermo.model
    div_u = case.div_scheme("div(phi,U)")
    div_e = case.div_scheme("div(phi,e)")
    try:
        div_phid_p = case.div_scheme("div(phid,p)")
    except KeyError:
        div_phid_p = "upwind"
    try:
        div_ekp = case.div_scheme("div(phi,Ekp)")
    except KeyError:
        div_ekp = div_e
    lap_corr = case.laplacian_scheme()
    ddt_scheme = case.ddt_scheme()
    u_controls = case.solver_controls("U")
    p_controls = case.solver_controls("p")
    p_final = case.solver_controls("p", final=True)
    e_controls = case.solver_controls("e")
    n_corr = ctrl.n_correctors
    n_non_orth = ctrl.n_non_orth
    # vacuum guards at expansion corners (the newer reference's pMin and
    # TMin limits)
    p_min = float(ctrl.dict.scalar("pMin", 0.0))
    t_min = float(ctrl.dict.scalar("TMin", 0.0))
    mesh = attach_solver_layouts(case.mesh, (p_controls, p_final),
                                 timings=case.setup_seconds)

    def step(U: VolField, p: VolField, T: VolField, rho: VolField,
             phi: SurfaceField, dt):
        set_current_dt(dt)
        U, p, T, rho = (f.store_old() for f in (U, p, T, rho))

        # rhoEqn.H: solve(ddt(rho) + div(phi)), a diagonal update
        rho = rho.replace(data=rho.old.data - dt * fvc.div(mesh, phi).data) \
            .correct_boundary_conditions(mesh)

        # UEqn.H
        mu_f = Dimensioned("mu", _DYN_VISC, m.mu(fvc.face_values(mesh, T)))
        UEqn = (fvm.ddt(mesh, U, dt, ddt_scheme, coeff=rho)
                + fvm.div(mesh, phi, U, div_u)
                - fvm.laplacian(mesh, mu_f, U, lap_corr))
        U, u_perf = solve(mesh, UEqn == (-fvc.grad(mesh, p)), u_controls)

        # EEqn.H: sensible internal energy with the explicit Ekp flux
        e = thermo.he_field(mesh, T).replace(
            old=thermo.he_field(mesh, T.old))
        alpha_f = Dimensioned("alpha", _DYN_VISC,
                              m.alpha_h(fvc.face_values(mesh, T)))
        ekp_data = 0.5 * (U.data * U.data).sum(-1) \
            + p.data / torch.clamp(rho.data, min=1e-30)
        ekp_b = 0.5 * (U.bvalues * U.bvalues).sum(-1) \
            + p.bvalues / torch.clamp(rho.bvalues, min=1e-30)
        Ekp = e.with_calculated_bcs(ekp_data, ekp_b, e.dims, "Ekp")
        eEqn = (fvm.ddt(mesh, e, dt, ddt_scheme, coeff=rho)
                + fvm.div(mesh, phi, e, div_e)
                - fvm.laplacian(mesh, alpha_f, e, lap_corr))
        eEqn = eEqn.equals(-fvc.div(mesh, phi, Ekp, div_ekp))
        e, e_perf = solve(mesh, eEqn, e_controls)
        T = thermo.update_t(mesh, T, e)
        if t_min > 0:
            T = _clamp(T, t_min)

        # psi with its old level, for ddt(psi, p)
        psi = T.with_calculated_bcs(m.psi(T.data), m.psi(T.bvalues), _PSI,
                                    "psi")
        psi_old = T.with_calculated_bcs(m.psi(T.old.data),
                                        m.psi(T.old.bvalues), _PSI, "psi")
        psi = psi.replace(old=psi_old)

        # pEqn.H, transonic
        p_perf_all = []
        for corr in range(n_corr):
            UEqn_c = UEqn.replace(psi=U)
            rAU = 1.0 / UEqn_c.A(mesh)
            HbyA = fvc.constrain_hbya(mesh, rAU * UEqn_c.H(mesh), U)
            # phid = interp(psi) * (interp(HbyA) & Sf)   [dims: phi/p]
            phid = SurfaceField(
                fvc.face_values(mesh, psi) * fvc.flux(mesh, HbyA).data,
                psi.dims * DimensionSet.of(0, 3, -1), "phid")
            rho_rau = rho * rAU
            for north in range(n_non_orth + 1):
                final = corr == n_corr - 1 and north == n_non_orth
                pEqn = (fvm.ddt(mesh, p, dt, ddt_scheme, coeff=psi)
                        + fvm.div(mesh, phid, p, div_phid_p)
                        - fvm.laplacian(mesh, rho_rau, p, lap_corr))
                p, p_perf = solve(mesh, pEqn,
                                  p_final if final else p_controls)
                p_perf_all.append(p_perf[0])
            if p_min > 0:
                p = _clamp(p, p_min)
            phi = pEqn.replace(psi=p).flux(mesh)
            U_star = HbyA - rAU * fvc.grad(mesh, p)
            U = U.replace(data=U_star.data).correct_boundary_conditions(mesh)
            rho = rho.replace(data=m.rho(p.data, T.data),
                              bvalues=m.rho(p.bvalues, T.bvalues))

        # compressible continuity error: the ddt(rho) + div(phi) residual
        cont = (rho.data - rho.old.data) / dt + fvc.div(mesh, phi).data
        umag = torch.linalg.norm(U.data, dim=-1)
        stats = dict(u_perf=u_perf, p_perf=tuple(p_perf_all), e_perf=e_perf,
                     cont=(gsum(cont.abs() * mesh.V), gsum(cont * mesh.V)),
                     co=courant_number(mesh, phi / fvc.interpolate(mesh, rho),
                                       dt),
                     mach_max=(umag / m.c_sound(T.data)).max())
        return U, p, T, rho, phi, stats

    return step


def iteration_counts(stats) -> list[tuple[str, int]]:
    """A timestep's linear-solver iterations in the order the solves are
    logged: Ux, Uy, Uz, e, then p (each corrector)."""
    its = [(f"U{c}", int(pf[2])) for c, pf in zip("xyz", stats["u_perf"])]
    its.append(("e", int(stats["e_perf"][0][2])))
    return its + [("p", int(pf[2])) for pf in stats["p_perf"]]


def setup(case: Case):
    """Thermo, fields and the step of a case: (thermo, (U, p, T, rho,
    phi), step). rho comes from the equation of state and phi =
    rho_f (U_f & Sf)."""
    model = read_thermo(case.constant_dict("thermophysicalProperties"))
    thermo = PsiThermo(case, model)
    info(f"Perfect gas: R={model.r:.6g} Cp={model.cp:.6g} "
         f"gamma={model.gamma:.4g}\n")
    p = case.read_field("p")
    T = case.read_field("T")
    U = case.read_field("U")
    rho = T.with_calculated_bcs(model.rho(p.data, T.data),
                                model.rho(p.bvalues, T.bvalues),
                                dim_density, "rho")
    phi = SurfaceField(fvc.face_values(case.mesh, rho)
                       * fvc.flux(case.mesh, U).data, _MASS_FLUX, "phi")
    step = make_step(case, thermo, PisoControl(case))
    return thermo, (U, p, T, rho, phi), step


def run(case_dir: str, *, device: torch.device, dtype: torch.dtype,
        write: bool = True, max_steps: int | None = None,
        case: Case | None = None):
    """Run sonicFoam on a case directory until endTime or max_steps.
    `case` passes a Case built already (an in-memory mesh). Returns
    (case, U, p, T, rho, phi); case.step_seconds holds each step's wall
    time (host clock; each step ends in a device sync when its residuals
    are logged) and case.step_log each step's Courant number (mean, max),
    continuity errors (local, global), max Mach and iteration_counts."""
    if case is None:
        case = Case(case_dir, device=device, dtype=dtype)
    if case.control_dict.lookup("functions"):
        raise NotImplementedError("functionObjects are not ported yet")
    _, (U, p, T, rho, phi), step = setup(case)
    timer = ExecutionTimer()
    cumulative_err = 0.0
    u_solver = case.solver_controls("U").solver
    e_solver = case.solver_controls("e").solver
    p_solver = case.solver_controls("p").solver
    case.step_log = []

    info("\nStarting time loop\n")
    n = 0
    while case.time.loop():
        t0 = _time.perf_counter()
        info(f"Time = {case.time.name}\n")
        U, p, T, rho, phi, stats = step(U, p, T, rho, phi,
                                        case.time.delta_t)
        co_mean, co_max = stats["co"]
        log_courant(co_mean, co_max)
        for cmpt, perf in zip("xyz", stats["u_perf"]):
            log_solve(u_solver, f"U{cmpt}", *perf)
        log_solve(e_solver, "e", *stats["e_perf"][0])
        for perf in stats["p_perf"]:
            log_solve(p_solver, "p", *perf)
        mach = float(stats["mach_max"])
        info(f"max Mach = {mach:.4g}")
        local_err, glob_err = stats["cont"]
        cumulative_err += float(glob_err)
        log_continuity(cumulative_err, local_err, glob_err)
        case.step_seconds.append(_time.perf_counter() - t0)
        case.step_log.append(dict(
            co=(float(co_mean), float(co_max)),
            cont=(float(local_err), float(glob_err)), mach=mach,
            iterations=iteration_counts(stats)))
        timer.log()

        if write and case.time.write_time():
            case.write_fields([U, p, T, rho.replace(name="rho")])
        n += 1
        if max_steps and n >= max_steps:
            break
    info("End\n")
    return case, U, p, T, rho, phi


def main(argv=None):
    import argparse

    from .. import resolve_device, solver_dtype
    ap = argparse.ArgumentParser(description="sonicFoam (rapidcfd_tpu_torch)")
    ap.add_argument("-case", dest="case", default=".")
    ap.add_argument("-noWrite", action="store_true")
    ap.add_argument("-device", default="cuda")
    ap.add_argument("-precision", choices=["fp32", "fp64"], default=None)
    args = ap.parse_args(argv)
    run(args.case, device=resolve_device(args.device),
        dtype=solver_dtype("sonicFoam", args.precision),
        write=not args.noWrite)


if __name__ == "__main__":
    main()
