"""interPhaseChangeFoam — two incompressible phases with mass transfer
(cavitation), port of rapidcfd_tpu/solvers/interphasechangefoam.py on a
static mesh (reference: applications/solvers/multiphase/
interPhaseChangeFoam/interPhaseChangeFoam.C with alphaEqn.H, UEqn.H and
pEqn.H).

The alpha equation is the implicit upwind form with the vaporisation and
condensation Sp/Su sources and the -Sp(div(U)) dilation term; the p_rgh
equation carries the (vDotvP - vDotcP)(pSat - rho gh) phase-change
compressibility source. The mixture comes from models/phasechange.py.
"""

from __future__ import annotations

import time as _time

import torch

from ..fields.field import Dimensioned, SurfaceField, VolField
from ..linalg.solvers import gsum, solve
from ..models.phasechange import make_phase_change_mixture
from ..ops import fvc, fvm
from ..utils.dimensions import DimensionSet, dim_density
from ..utils.logging import ExecutionTimer, info, log_courant, log_solve
from .case import Case
from .controls import PimpleControl
from .icofoam import courant_number
from .interfoam import alpha_key, read_constants

_RTIME = DimensionSet.of(0, 0, -1)
_DIM_MU = DimensionSet.of(1, -1, -1)


def make_step(case: Case, consts, pc, ctrl: PimpleControl):
    """step(alpha, U, p_rgh, phi, dt) -> (alpha, U, p_rgh, phi, stats);
    stats: a_perf, p_perf, co, alpha (min, max, integral) and vap (the
    vapour volume)."""
    case.refuse_second_order_ddt("interPhaseChangeFoam")
    from ..linalg.precompute import attach_solver_layouts
    rho1, rho2, nu1, nu2, sigma, g = consts
    alpha_controls = case.solver_controls(alpha_key(case))
    p_controls = case.solver_controls("p_rgh")
    p_final = case.solver_controls("p_rgh", final=True)
    div_u = case.div_scheme("div(rhoPhi,U)")
    lap_corr = case.laplacian_scheme()
    n_corr, n_non_orth = ctrl.n_correctors, ctrl.n_non_orth
    p_ref_cell = case.maps.device_cell(ctrl.p_ref_cell)
    p_ref_value = ctrl.p_ref_value
    mesh = attach_solver_layouts(case.mesh, (p_controls, p_final),
                                 timings=case.setup_seconds)
    n_int = mesh.n_internal
    gvec = torch.tensor(g, dtype=mesh.dtype, device=mesh.device)
    gh = (mesh.C * gvec).sum(-1)
    ghf = (mesh.Cf * gvec).sum(-1)

    def mixture(a: VolField):
        rho = a.with_calculated_bcs(
            a.data * rho1 + (1.0 - a.data) * rho2,
            a.bvalues * rho1 + (1.0 - a.bvalues) * rho2, dim_density, "rho")
        mu = a.with_calculated_bcs(
            a.data * rho1 * nu1 + (1.0 - a.data) * rho2 * nu2,
            a.bvalues * rho1 * nu1 + (1.0 - a.bvalues) * rho2 * nu2,
            _DIM_MU, "mu")
        return rho, mu

    def absolute_p(p_rgh: VolField, rho: VolField) -> VolField:
        return p_rgh.with_calculated_bcs(
            p_rgh.data + rho.data * gh,
            p_rgh.bvalues + rho.bvalues * ghf[n_int:], p_rgh.dims, "p")

    def step(alpha: VolField, U: VolField, p_rgh: VolField,
             phi: SurfaceField, dt):
        U, alpha = U.store_old(), alpha.store_old()
        p_abs = absolute_p(p_rgh, mixture(alpha)[0])

        # alphaEqn.H: the implicit form with the phase-change sources
        vdotc_a, vdotv_a = pc.v_dot_alphal(alpha.data, p_abs.data)
        a_eqn = (fvm.ddt(mesh, alpha, dt)
                 + fvm.div(mesh, phi, alpha, "upwind")
                 - fvm.Sp(mesh, Dimensioned("divU", _RTIME,
                                            fvc.div(mesh, phi).data), alpha)
                 - fvm.Sp(mesh, Dimensioned("vDotvmc", _RTIME,
                                            vdotv_a - vdotc_a), alpha))
        rhs_a = alpha.with_calculated_bcs(
            vdotc_a, torch.zeros_like(alpha.bvalues), _RTIME)
        alpha, a_perf = solve(mesh, a_eqn.equals(rhs_a), alpha_controls,
                              env={"phi": phi})
        alpha = alpha.replace(data=torch.clamp(alpha.data, 0.0, 1.0),
                              bvalues=torch.clamp(alpha.bvalues, 0.0, 1.0))

        rho, mu = mixture(alpha)
        rho = rho.replace(old=mixture(alpha.old)[0].replace(old=None))
        a_f = fvc.face_values(mesh, alpha, "vanLeer", phi)
        rho_phi = SurfaceField(phi.data * (a_f * (rho1 - rho2) + rho2),
                               phi.dims * dim_density, "rhoPhi")

        # UEqn.H
        mu_f = Dimensioned("muf", _DIM_MU, fvc.face_values(mesh, mu))
        UEqn = (fvm.ddt(mesh, U, dt, "Euler", coeff=rho)
                + fvm.div(mesh, rho_phi, U, div_u)
                - fvm.laplacian(mesh, mu_f, U, lap_corr))

        p_perf_all = []
        for corr in range(n_corr):
            UEqn_c = UEqn.replace(psi=U) if corr else UEqn
            rAU = 1.0 / UEqn_c.A(mesh)
            rAU_f = fvc.face_values(mesh, rAU)
            HbyA = fvc.constrain_hbya(mesh, rAU * UEqn_c.H(mesh), U)
            phig = -ghf * fvc.sn_grad(mesh, rho).data * rAU_f * mesh.mag_sf
            phig = torch.cat([phig[:n_int], torch.zeros_like(phig[n_int:])])
            phi_hbya = SurfaceField(fvc.flux(mesh, HbyA).data + phig,
                                    phi.dims, "phiHbyA")
            vdotc_p, vdotv_p = pc.v_dot_p(alpha.data, p_abs.data)
            dvp = vdotv_p - vdotc_p          # <= 0 by construction
            for north in range(n_non_orth + 1):
                final = corr == n_corr - 1 and north == n_non_orth
                # fvc::div(phiHbyA) - laplacian(rAU, p_rgh)
                # - (vDotvP - vDotcP)(pSat - rho gh) + Sp(vDotvP - vDotcP)
                pEqn = fvm.laplacian(mesh, rAU, p_rgh, lap_corr) \
                    - fvm.Sp(mesh, Dimensioned(
                        "dvp", DimensionSet.of(-1, 1, 1), dvp), p_rgh)
                rhs_p = p_rgh.with_calculated_bcs(
                    fvc.div(mesh, phi_hbya).data
                    - dvp * (pc.p_sat - rho.data * gh),
                    torch.zeros_like(p_rgh.bvalues),
                    phi.dims / DimensionSet.of(0, 3))
                pEqn = pEqn.equals(rhs_p).set_reference(p_ref_cell,
                                                        p_ref_value)
                p_rgh, p_perf = solve(mesh, pEqn,
                                      p_final if final else p_controls)
                p_perf_all.append(p_perf[0])
            flux_p = pEqn.replace(psi=p_rgh).flux(mesh)
            phi = phi_hbya - flux_p
            corr_f = SurfaceField(
                (phig - flux_p.data) / torch.clamp(rAU_f, min=1e-30),
                phi.dims / rAU.dims, "corrF")
            U_star = HbyA + rAU * fvc.reconstruct(mesh, corr_f)
            U = U.replace(data=U_star.data).correct_boundary_conditions(mesh)
            p_abs = absolute_p(p_rgh, rho)

        stats = dict(a_perf=a_perf, p_perf=tuple(p_perf_all),
                     co=courant_number(mesh, phi, dt),
                     alpha=(alpha.data.min(), alpha.data.max(),
                            gsum(alpha.data * mesh.V)),
                     vap=gsum((1.0 - alpha.data) * mesh.V))
        return alpha, U, p_rgh, phi, stats

    return step


def iteration_counts(stats) -> list[tuple[str, int]]:
    """A step's linear-solver iterations: alpha, then every p_rgh solve."""
    return [("alpha", int(stats["a_perf"][0][2]))] + [
        ("p_rgh", int(pf[2])) for pf in stats["p_perf"]]


def run(case_dir: str, *, device: torch.device, dtype: torch.dtype,
        write: bool = True, max_steps: int | None = None,
        dym: bool = False, case: Case | None = None):
    """Run interPhaseChangeFoam to endTime or max_steps. Returns (case,
    alpha, U, p_rgh, phi); case.step_log holds each step's iteration
    counts. dym=True (interPhaseChangeDyMFoam) raises: the dynamic mesh
    is not ported."""
    if dym:
        raise NotImplementedError(
            "interPhaseChangeDyMFoam (dym=True) needs the dynamic mesh, "
            "which is not ported (ROADMAP Queue 1 item 8)")
    if case is None:
        case = Case(case_dir, device=device, dtype=dtype)
    mesh = case.mesh
    consts = read_constants(case)
    pc = make_phase_change_mixture(case.transport_properties(), consts[0],
                                   consts[1])
    info(f"Cavitation: rho1={consts[0]} rho2={consts[1]} pSat={pc.p_sat}\n")
    alpha_name = "alpha.water" if case.field_exists("alpha.water") \
        else "alpha1"
    alpha = case.read_field(alpha_name)
    U = case.read_field("U")
    p_rgh = case.read_field("p_rgh")
    phi = fvc.flux(mesh, U)
    step = make_step(case, consts, pc, PimpleControl(case))
    p_solver = case.solver_controls("p_rgh").solver
    v_total = float(mesh.V.sum())
    timer = ExecutionTimer()
    case.step_log = []

    info("\nStarting time loop\n")
    n = 0
    while case.time.loop():
        t0 = _time.perf_counter()
        info(f"Time = {case.time.name}\n")
        alpha, U, p_rgh, phi, stats = step(alpha, U, p_rgh, phi,
                                           case.time.delta_t)
        log_courant(*stats["co"])
        a_min, a_max, a_int = (float(x) for x in stats["alpha"])
        info(f"Liquid phase volume fraction = {a_int / v_total:.8g}  "
             f"Min(alpha1) = {a_min:.6g}  Max(alpha1) = {a_max:.6g}")
        for perf in stats["p_perf"]:
            log_solve(p_solver, "p_rgh", *perf)
        case.step_seconds.append(_time.perf_counter() - t0)
        case.step_log.append(dict(iterations=iteration_counts(stats)))
        timer.log()
        if write and case.time.write_time():
            case.write_fields([alpha.replace(name=alpha_name), U, p_rgh])
        n += 1
        if max_steps and n >= max_steps:
            break
    info("End\n")
    return case, alpha, U, p_rgh, phi


def main(argv=None):
    import argparse

    from .. import resolve_device, solver_dtype
    ap = argparse.ArgumentParser(
        description="interPhaseChangeFoam (rapidcfd_tpu_torch)")
    ap.add_argument("-case", dest="case", default=".")
    ap.add_argument("-noWrite", action="store_true")
    ap.add_argument("-device", default="cuda")
    ap.add_argument("-precision", choices=["fp32", "fp64"], default=None)
    args = ap.parse_args(argv)
    run(args.case, device=resolve_device(args.device),
        dtype=solver_dtype("interPhaseChangeFoam", args.precision),
        write=not args.noWrite)


if __name__ == "__main__":
    main()
