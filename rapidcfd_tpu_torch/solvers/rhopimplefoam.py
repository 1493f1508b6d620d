"""rhoPimpleFoam — transient compressible PIMPLE solver, subsonic form
(port of rapidcfd_tpu/solvers/rhopimplefoam.py; reference: applications/
solvers/compressible/rhoPimpleFoam/rhoPimpleFoam.C with UEqn.H, EEqn.H
and pEqn.H, non-transonic branch), with its PIMPLEC form
(rhoPimplecFoam, consistent=True) and its local-time-stepping form
(rhoLTSPimpleFoam, lts=True).

A timestep is the density predictor, then nOuterCorrectors loops of the
momentum predictor with ddt(rho, U), the sensible-enthalpy equation with
the kinetic energy K, dpdt and div(phi, K) (then T from h and the TMin
clamp), psi with its old level and nCorrectors pressure corrections
ddt(psi, p) - laplacian(rho rAtU, p) == -div(phiHbyA), each followed by
the pMin clamp, the flux, the momentum correction and rho from the
equation of state; then the turbulence model's correct(). In fp32 `run`
solves p in deviation form (rhosimplefoam.deviation_offset): the
ddt(psi p) term then gains the explicit p_offset ddt(psi). Under LTS the
step takes the per-cell rDeltaT (solvers/lts.py) in place of dt, and
every ddt and division by dt is elementwise. rhoPimpleDyMFoam (`dym`) is
not ported.
"""

from __future__ import annotations

import time as _time

import torch

from ..fields.field import Dimensioned, SurfaceField, VolField, shift_level
from ..linalg.solvers import gsum, solve
from ..models.thermo import PsiThermo, read_thermo
from ..models.turbulence import CompressibleTurbulence
from ..ops import fvc, fvm
from ..utils.dimensions import DimensionSet, dim_density
from ..utils.logging import (ExecutionTimer, info, log_continuity,
                             log_courant, log_solve)
from .case import Case
from .controls import PimpleControl
from .icofoam import courant_number
from .rhosimplefoam import deviation_offset, simplec_correction

_DYN_VISC = DimensionSet.of(1, -1, -1)
_PSI = DimensionSet.of(0, -2, 2)
_MASS_FLUX = DimensionSet.of(1, 0, -1)


def make_step(case: Case, thermo: PsiThermo, ctrl: PimpleControl,
              lts: bool = False, turb: CompressibleTurbulence | None = None,
              consistent: bool = False, dym: bool = False,
              p_offset: float = 0.0):
    """step(U, p, T, rho, phi, turb_state, dt) -> (U, p, T, rho, phi,
    turb_state, stats). lts=True: dt is the per-cell rDeltaT (nCells,)
    (rhoLTSPimpleFoam). consistent=True: the PIMPLEC corrector
    (rhoPimplecFoam): rAtU = 1/(1/rAU - H1), phiHbyA += interp(rho (rAtU -
    rAU)) snGrad(p) |Sf|, HbyA -= (rAU - rAtU) grad(p) and laplacian(rho
    rAtU, p). p_offset: the level p is shifted by (p holds p - p_offset).
    stats holds the last momentum and enthalpy solves' perf (u_perf,
    h_perf), every p solve in order (p_perf), the turbulence solves
    (turb), the continuity errors (cont: local, global) and the Courant
    number of phi/rho_f (co: mean, max)."""
    case.refuse_second_order_ddt("rhoPimpleFoam")
    if dym:
        raise NotImplementedError("rhoPimpleDyMFoam (dym=True) is not ported "
                                  "yet: it waits for the dynamic-mesh slice")
    from ..linalg.precompute import attach_solver_layouts
    from ..ops.interpolation import set_current_dt
    m = thermo.model
    div_u = case.div_scheme("div(phi,U)")
    try:
        div_h = case.div_scheme("div(phi,h)")
    except KeyError:
        div_h = div_u
    try:
        div_k = case.div_scheme("div(phi,K)")
    except KeyError:
        div_k = div_h
    lap_corr = case.laplacian_scheme()
    ddt_scheme = case.ddt_scheme()
    u_controls = case.solver_controls("U")
    u_final = case.solver_controls("U", final=True)
    p_controls = case.solver_controls("p")
    p_final = case.solver_controls("p", final=True)
    h_controls = case.solver_controls("h")
    n_outer = ctrl.n_outer
    n_corr = ctrl.n_correctors
    n_non_orth = ctrl.n_non_orth
    p_min = float(ctrl.dict.scalar("pMin", 0.0))
    t_min = float(ctrl.dict.scalar("TMin", 0.0))
    has_turb = turb is not None and not turb.laminar
    mesh = attach_solver_layouts(case.mesh, (p_controls, p_final),
                                 timings=case.setup_seconds)

    def eos(p_, T_):
        return m.rho(p_ + p_offset, T_)

    def clamp(f: VolField, floor: float) -> VolField:
        return f.replace(data=torch.clamp(f.data, min=floor),
                         bvalues=torch.clamp(f.bvalues, min=floor))

    def step(U: VolField, p: VolField, T: VolField, rho: VolField,
             phi: SurfaceField, turb_state, dt):
        set_current_dt(dt)
        if lts:
            dt = 1.0 / dt      # the caller passes rDeltaT (nCells,)
        U, p, T, rho = (f.store_old() for f in (U, p, T, rho))

        # rhoEqn.H
        rho = rho.replace(data=rho.old.data - dt * fvc.div(mesh, phi).data) \
            .correct_boundary_conditions(mesh)

        u_perf = h_perf = None
        p_perf_all = []
        for outer in range(n_outer):
            final_outer = outer == n_outer - 1

            # UEqn.H (muEff = mu + rho nut when turbulent)
            mu_face = m.mu(fvc.face_values(mesh, T))
            mut_f = (turb.mut_faces(mesh, turb_state,
                                    fvc.face_values(mesh, rho))
                     if has_turb else None)
            mu_f = Dimensioned("muEff", _DYN_VISC,
                               mu_face + mut_f if mut_f is not None
                               else mu_face)
            UEqn = (fvm.ddt(mesh, U, dt, ddt_scheme, coeff=rho)
                    + fvm.div(mesh, phi, U, div_u)
                    - fvm.laplacian(mesh, mu_f, U, lap_corr))
            U, u_perf = solve(mesh, UEqn == (-fvc.grad(mesh, p)),
                              u_final if final_outer else u_controls)

            # EEqn.H: sensible enthalpy with K and dpdt
            h = thermo.he_field(mesh, T, "h").replace(
                old=thermo.he_field(mesh, T.old, "h").replace(old=None))
            alpha_face = m.alpha_h(fvc.face_values(mesh, T))
            if mut_f is not None:
                alpha_face = alpha_face + mut_f / turb.prt
            alpha_f = Dimensioned("alphaEff", _DYN_VISC, alpha_face)
            K = h.with_calculated_bcs(0.5 * (U.data * U.data).sum(-1),
                                      0.5 * (U.bvalues * U.bvalues).sum(-1),
                                      h.dims, "K")
            K_old = 0.5 * (U.old.data * U.old.data).sum(-1)
            ddt_rhoK = (rho.data * K.data - rho.old.data * K_old) / dt
            dpdt = (p.data - p.old.data) / dt
            rhs = h.with_calculated_bcs(
                dpdt - ddt_rhoK - fvc.div(mesh, phi, K, div_k).data,
                torch.zeros_like(h.bvalues),
                h.dims * dim_density / DimensionSet.of(0, 0, 1))
            hEqn = (fvm.ddt(mesh, h, dt, ddt_scheme, coeff=rho)
                    + fvm.div(mesh, phi, h, div_h)
                    - fvm.laplacian(mesh, alpha_f, h, lap_corr))
            h, h_perf = solve(mesh, hEqn.equals(rhs), h_controls)
            T = thermo.update_t(mesh, T, h)
            if t_min > 0:
                T = clamp(T, t_min)

            psi = T.with_calculated_bcs(m.psi(T.data), m.psi(T.bvalues),
                                        _PSI, "psi")
            psi = psi.replace(old=T.old.with_calculated_bcs(
                m.psi(T.old.data), m.psi(T.old.bvalues), _PSI, "psi"))

            # pEqn.H, subsonic
            for corr in range(n_corr):
                rho = rho.replace(data=eos(p.data, T.data),
                                  bvalues=eos(p.bvalues, T.bvalues))
                UEqn_c = UEqn.replace(psi=U)
                rAU = 1.0 / UEqn_c.A(mesh)
                rAtU = (1.0 / (1.0 / rAU - UEqn_c.H1(mesh))
                        if consistent else rAU)
                HbyA = fvc.constrain_hbya(mesh, rAU * UEqn_c.H(mesh), U)
                phi_hbya = SurfaceField(
                    fvc.face_values(mesh, rho) * fvc.flux(mesh, HbyA).data,
                    _MASS_FLUX, "phiHbyA")
                if consistent:
                    phi_hbya, HbyA = simplec_correction(
                        mesh, phi_hbya, HbyA, rho, rAU, rAtU, p)
                rho_rau = rho * rAtU
                for north in range(n_non_orth + 1):
                    final = (final_outer and corr == n_corr - 1
                             and north == n_non_orth)
                    pEqn = (fvm.ddt(mesh, p, dt, ddt_scheme, coeff=psi)
                            - fvm.laplacian(mesh, rho_rau, p, lap_corr))
                    pEqn = pEqn.equals(-fvc.div(mesh, phi_hbya))
                    if p_offset:
                        # deviation form: ddt(psi p_abs) = ddt(psi p_dev)
                        # + p_offset ddt(psi), the second term explicit
                        dpsi_dt = (psi.data - psi.old.data) / dt
                        pEqn = pEqn.replace(
                            source=pEqn.source - mesh.V * p_offset * dpsi_dt)
                    p, p_perf = solve(mesh, pEqn,
                                      p_final if final else p_controls)
                    p_perf_all.append(p_perf[0])
                if p_min > 0:
                    p = clamp(p, p_min - p_offset)
                # -laplacian sits inside the matrix: its flux is added
                phi = phi_hbya + pEqn.replace(psi=p).flux(mesh)
                U_star = HbyA - rAtU * fvc.grad(mesh, p)
                U = U.replace(data=U_star.data) \
                    .correct_boundary_conditions(mesh)
                rho = rho.replace(data=eos(p.data, T.data),
                                  bvalues=eos(p.bvalues, T.bvalues))

        if has_turb:
            nu_lam = T.with_calculated_bcs(
                m.mu(T.data) / rho.data, m.mu(T.bvalues) / rho.bvalues,
                DimensionSet.of(0, 2, -1), "nu")
            turb_state, turb_perf = turb.correct(mesh, turb_state, U, phi,
                                                 rho, nu_lam, dt=dt)
        else:
            turb_perf = {}

        cont = (rho.data - rho.old.data) / dt + fvc.div(mesh, phi).data
        stats = dict(u_perf=u_perf, h_perf=h_perf, p_perf=tuple(p_perf_all),
                     turb=turb_perf,
                     cont=(gsum(cont.abs() * mesh.V), gsum(cont * mesh.V)),
                     co=courant_number(mesh, phi / fvc.interpolate(mesh, rho),
                                       dt))
        return U, p, T, rho, phi, turb_state, stats

    return step


def iteration_counts(stats) -> list[tuple[str, int]]:
    """A timestep's linear-solver iterations: Ux, Uy, Uz and h of the last
    outer loop, p (every corrector), then the turbulence fields by
    name."""
    its = [(f"U{c}", int(pf[2])) for c, pf in zip("xyz", stats["u_perf"])]
    its.append(("h", int(stats["h_perf"][0][2])))
    its += [("p", int(pf[2])) for pf in stats["p_perf"]]
    return its + [(k, int(pf[2])) for k, pf in sorted(stats["turb"].items())]


def setup(case: Case, lts: bool = False, consistent: bool = False):
    """Thermo, fields, turbulence and the step of a case: (thermo,
    (U, p, T, rho, phi, turb_state), step, p_offset). p is returned in
    deviation form when p_offset is not 0."""
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
    p_offset = deviation_offset(p)
    if p_offset:
        p = shift_level(p, -p_offset)
        info(f"rhoPimpleFoam: solving p in deviation form "
             f"(p_offset = {p_offset:g})\n")
    ctrl = PimpleControl(case)
    turb = CompressibleTurbulence(case, U)
    turb_state = turb.init_state(U)
    step = make_step(case, thermo, ctrl, lts=lts, turb=turb,
                     consistent=consistent, p_offset=p_offset)
    return thermo, (U, p, T, rho, phi, turb_state), step, p_offset


def run(case_dir: str, *, device: torch.device, dtype: torch.dtype,
        write: bool = True, max_steps: int | None = None,
        lts: bool | None = None, consistent: bool = False,
        case: Case | None = None):
    """Run rhoPimpleFoam until endTime or max_steps. lts=True runs as
    rhoLTSPimpleFoam, None picks it from `ddtSchemes default localEuler|
    CoEuler|SLTS`; consistent=True runs as rhoPimplecFoam. Returns (case,
    U, p, T, rho, phi) with p absolute; case.step_seconds holds each
    step's wall time and case.step_log each step's dt (None under LTS),
    Courant number (mean, max), continuity errors (local, global) and
    iteration_counts."""
    if case is None:
        case = Case(case_dir, device=device, dtype=dtype)
    if case.control_dict.lookup("functions"):
        raise NotImplementedError("functionObjects are not ported yet")
    if lts is None:
        lts = case.ddt_scheme() in fvm.LTS_SCHEMES
    _, (U, p, T, rho, phi, turb_state), step, p_offset = setup(
        case, lts, consistent)
    rdelta_t = rdt = None
    if lts:
        from .lts import LTSControls, log_time_scale, make_rdelta_t
        rdelta_t = make_rdelta_t(case.mesh, LTSControls.from_dict(
            PimpleControl(case).dict))
    timer = ExecutionTimer()
    cumulative_err = 0.0
    solver_of = {name: case.solver_controls(name).solver
                 for name in ("U", "h", "p")}
    case.step_log = []

    def absolute(p_):
        return shift_level(p_, p_offset) if p_offset else p_

    info("\nStarting time loop\n")
    n = 0
    while case.time.loop():
        t0 = _time.perf_counter()
        info(f"Time = {case.time.name}\n")
        if lts:
            rdt = rdelta_t(phi.data, rho.data, rdt)
            log_time_scale(rdt)
            dt = rdt
        else:
            dt = case.time.delta_t
        U, p, T, rho, phi, turb_state, stats = step(U, p, T, rho, phi,
                                                    turb_state, dt)
        co_mean, co_max = stats["co"]
        log_courant(co_mean, co_max)
        for cmpt, perf in zip("xyz", stats["u_perf"]):
            log_solve(solver_of["U"], f"U{cmpt}", *perf)
        log_solve(solver_of["h"], "h", *stats["h_perf"][0])
        for name, perf in sorted(stats["turb"].items()):
            log_solve(case.solver_controls(name).solver, name, *perf)
        for perf in stats["p_perf"]:
            log_solve(solver_of["p"], "p", *perf)
        local_err, glob_err = stats["cont"]
        cumulative_err += float(glob_err)
        log_continuity(cumulative_err, local_err, glob_err)
        case.step_seconds.append(_time.perf_counter() - t0)
        case.step_log.append(dict(
            dt=None if lts else dt, co=(float(co_mean), float(co_max)),
            cont=(float(local_err), float(glob_err)),
            iterations=iteration_counts(stats)))
        timer.log()

        if write and case.time.write_time():
            case.write_fields([U, absolute(p), T, rho.replace(name="rho")]
                              + list(turb_state.values()))
        n += 1
        if max_steps and n >= max_steps:
            break
    info("End\n")
    return case, U, absolute(p), T, rho, phi


def main(argv=None):
    import argparse

    from .. import resolve_device, solver_dtype
    ap = argparse.ArgumentParser(
        description="rhoPimpleFoam (rapidcfd_tpu_torch)")
    ap.add_argument("-case", dest="case", default=".")
    ap.add_argument("-noWrite", action="store_true")
    ap.add_argument("-device", default="cuda")
    ap.add_argument("-precision", choices=["fp32", "fp64"], default=None)
    args = ap.parse_args(argv)
    run(args.case, device=resolve_device(args.device),
        dtype=solver_dtype("rhoPimpleFoam", args.precision),
        write=not args.noWrite)


if __name__ == "__main__":
    main()
