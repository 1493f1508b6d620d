"""interMixingFoam — three-phase VOF: one immiscible phase (alpha1)
captured with compressed MULES against two miscible phases (alpha2,
alpha3) that inter-diffuse with diffusivity D23 (port of rapidcfd_tpu/
solvers/intermixingfoam.py; reference: applications/solvers/multiphase/
interFoam/interMixingFoam with alphaEqns.H: one MULES limiter shared by
alpha1 and alpha2, the implicit D23 diffusion of alpha2;
threePhaseInterfaceProperties: CSF with sigma = (a2 sigma12 + a3
sigma13)/(a2 + a3) on the alpha1 interface).
"""

from __future__ import annotations

import time as _time

import torch

from ..fields.field import Dimensioned, SurfaceField, VolField
from ..linalg.solvers import gsum, solve
from ..ops import fvc, fvm
from ..ops.mules import bounded_flux, limiter
from ..utils.dimensions import DimensionSet, dim_density
from ..utils.logging import (ExecutionTimer, info, log_continuity,
                             log_courant, log_solve)
from .buoyantfoam import gravity
from .case import Case
from .controls import PimpleControl
from .icofoam import continuity_errors, courant_number
from .interfoam import compression_flux, interface_normal_flux

_DIM_MU = DimensionSet.of(1, -1, -1)
_DIM_D = DimensionSet.of(0, 2, -1)


def read_constants(case: Case):
    """(phase names, ((rho, nu) per phase), D23, sigma12, sigma13, g)."""
    tp = case.transport_properties()
    phases = tp.lookup("phases")
    names = [str(x) for x in phases] if phases else \
        ["phase1", "phase2", "phase3"]

    def value(d, key):
        return Dimensioned.from_entry(d.lookup(key, required=True)).value
    ds = []
    for i, nm in enumerate(names):
        d = tp.subdict(nm, required=False) or tp.subdict(f"phase{i + 1}")
        ds.append((value(d, "rho"), value(d, "nu")))
    return (names, ds, value(tp, "D23"), value(tp, "sigma12"),
            value(tp, "sigma13"), gravity(case))


def make_step(case: Case, consts, ctrl: PimpleControl):
    """step(a1, a2, U, p_rgh, phi, dt) -> (a1, a2, U, p_rgh, phi, stats);
    stats: p_perf, a2_perf, cont, co, a1 and a2 (min, max, integral)."""
    case.refuse_second_order_ddt("interMixingFoam")
    from ..linalg.precompute import attach_solver_layouts
    names, ds, d23, s12, s13, g = consts
    (rho1, nu1), (rho2, nu2), (rho3, nu3) = ds
    solvers_d = case.fv_solution.subdict("solvers")
    a_d = solvers_d.lookup(f"alpha.{names[0]}") or solvers_d.lookup("alpha1")
    c_alpha = float(a_d.scalar("cAlpha", 1.0)) if a_d else 1.0
    lap_corr = case.laplacian_scheme()
    p_controls = case.solver_controls("p_rgh")
    p_final = case.solver_controls("p_rgh", final=True)
    a2_controls = case.solver_controls("alpha2", final=True)
    n_corr = ctrl.n_correctors
    n_non_orth = ctrl.n_non_orth
    p_ref_cell = case.maps.device_cell(ctrl.p_ref_cell)
    p_ref_value = ctrl.p_ref_value
    mesh = attach_solver_layouts(case.mesh, (p_controls, p_final),
                                 timings=case.setup_seconds)
    n_int = mesh.n_internal
    ghf = (mesh.Cf * torch.tensor(g, dtype=mesh.dtype,
                                  device=mesh.device)).sum(-1)

    def mixture(a1: VolField, a2: VolField):
        a3 = 1.0 - a1.data - a2.data
        a3b = 1.0 - a1.bvalues - a2.bvalues
        rho = a1.with_calculated_bcs(
            a1.data * rho1 + a2.data * rho2 + a3 * rho3,
            a1.bvalues * rho1 + a2.bvalues * rho2 + a3b * rho3,
            dim_density, "rho")
        mu = a1.with_calculated_bcs(
            a1.data * rho1 * nu1 + a2.data * rho2 * nu2 + a3 * rho3 * nu3,
            a1.bvalues * rho1 * nu1 + a2.bvalues * rho2 * nu2
            + a3b * rho3 * nu3, _DIM_MU, "mu")
        return rho, mu

    def sigma_kappa_snalpha(a1: VolField, a2: VolField):
        """threePhaseInterfaceProperties: the CSF face force on the alpha1
        interface with the alpha2/alpha3-weighted sigma, and nHatf."""
        a2l = torch.clamp(a2.data, 0.0, 1.0)
        a3l = torch.clamp(1.0 - a1.data - a2.data, 0.0, 1.0)
        sigma = (a2l * s12 + a3l * s13) / (a2l + a3l + 1e-6)
        nhatf = interface_normal_flux(mesh, a1)
        kappa = -fvc.surface_sum_faces(mesh, nhatf) / mesh.V
        sk = a1.with_calculated_bcs(sigma * kappa,
                                    torch.zeros_like(a1.bvalues),
                                    DimensionSet.of(1, -1, -2), "sigmaK")
        return (fvc.face_values(mesh, sk) * fvc.sn_grad(mesh, a1).data,
                nhatf)

    def sf(data, name):
        return SurfaceField(data, DimensionSet.of(0, 3, -1), name)

    def step(a1: VolField, a2: VolField, U: VolField, p_rgh: VolField,
             phi: SurfaceField, dt):
        U, a1, a2 = U.store_old(), a1.store_old(), a2.store_old()

        # alphaEqns.H: one MULES limiter for alpha1 and alpha2
        _, nhatf = sigma_kappa_snalpha(a1, a2)
        phir = compression_flux(mesh, phi, nhatf, c_alpha)
        a3 = a1.replace(data=1.0 - a1.data - a2.data,
                        bvalues=1.0 - a1.bvalues - a2.bvalues, old=None)
        # phiAlpha1: a1 advected with compression against a2 and a3
        a1_f = fvc.face_values(mesh, a1, "vanLeer", phi)
        m_phir = sf(-phir, "-phir")
        f2 = -(m_phir.data * fvc.face_values(mesh, a2, "vanLeer", m_phir))
        f3 = -(m_phir.data * fvc.face_values(mesh, a3, "vanLeer", m_phir))
        a1_c2 = fvc.face_values(mesh, a1, "vanLeer", sf(f2, "f2"))
        a1_c3 = fvc.face_values(mesh, a1, "vanLeer", sf(f3, "f3"))
        phi_a1 = sf(phi.data * a1_f + f2 * a1_c2 + f3 * a1_c3, "phiAlpha1")
        # phiAlpha2: a2 advected with compression against a1 only
        a2_f = fvc.face_values(mesh, a2, "vanLeer", phi)
        f1 = phir * fvc.face_values(mesh, a1, "vanLeer", sf(phir, "phir"))
        a2_c1 = fvc.face_values(mesh, a2, "vanLeer", sf(-f1, "mf1"))
        phi_a2 = sf(phi.data * a2_f - f1 * a2_c1, "phiAlpha2")

        bd1, corr1 = bounded_flux(mesh, a1, phi, phi_a1)
        bd2, corr2 = bounded_flux(mesh, a2, phi, phi_a2)
        td1 = a1.data - dt / mesh.V * fvc.surface_sum_faces(mesh, bd1)
        td2 = a2.data - dt / mesh.V * fvc.surface_sum_faces(mesh, bd2)
        lam = torch.minimum(limiter(mesh, td1, corr1, dt),
                            limiter(mesh, td2, corr2, dt))
        phi_a1l = bd1 + lam * corr1
        phi_a2l = bd2 + lam * corr2
        a1 = a1.replace(data=a1.data - dt / mesh.V
                        * fvc.surface_sum_faces(mesh, phi_a1l)) \
            .correct_boundary_conditions(mesh)

        # alpha2: explicit limited advection, then the implicit D23
        # diffusion (reference: alphaEqns.H alpha2Eqn)
        zero = torch.zeros_like(a2.data)
        dc23 = d23 * torch.clamp(a3.data, min=0.0) \
            * torch.where(a2.data > 0.0, zero + 1.0, zero)
        dc32 = d23 * torch.clamp(a2.data, min=0.0) \
            * torch.where(a3.data > 0.0, zero + 1.0, zero)
        sng1 = fvc.sn_grad(mesh, a1).data
        dc32_f = fvc.face_values(mesh, a1.with_calculated_bcs(
            dc32, torch.zeros_like(a1.bvalues), _DIM_D, "Dc32"))
        phi_a2l = phi_a2l - dc32_f * mesh.mag_sf * sng1
        a2_adv = a2.replace(data=a2.data - dt / mesh.V
                            * fvc.surface_sum_faces(mesh, phi_a2l))
        # the ddt pair pinned to the advected state (as twoLiquidMixingFoam)
        a2_adv2 = a2_adv.replace(old=a2_adv.replace(old=None))
        dsum = a1.with_calculated_bcs(dc23 + dc32,
                                      torch.zeros_like(a1.bvalues), _DIM_D,
                                      "D")
        a2Eqn = fvm.ddt(mesh, a2_adv2, dt) \
            - fvm.laplacian(mesh, dsum, a2_adv2, lap_corr)
        a2, a2_perf = solve(mesh, a2Eqn, a2_controls)
        dflux = a2Eqn.replace(psi=a2).flux(mesh)

        rho_phi = SurfaceField(
            phi_a1l * (rho1 - rho3) + (phi_a2l + dflux.data) * (rho2 - rho3)
            + phi.data * rho3, phi.dims * dim_density, "rhoPhi")
        rho, mu = mixture(a1, a2)
        rho_old, _ = mixture(a1.old, a2.old)
        rho = rho.replace(old=rho_old.replace(old=None))

        # UEqn.H (as interFoam, linearUpwind whatever the case names)
        mu_f = Dimensioned("muf", _DIM_MU, fvc.face_values(mesh, mu))
        UEqn = (fvm.ddt(mesh, U, dt, coeff=rho)
                + fvm.div(mesh, rho_phi, U, "linearUpwind")
                - fvm.laplacian(mesh, mu_f, U, lap_corr))

        p_perf_all = []
        for corr in range(n_corr):
            UEqn_c = UEqn.replace(psi=U) if corr else UEqn
            rAU = 1.0 / UEqn_c.A(mesh)
            rAU_f = fvc.face_values(mesh, rAU)
            HbyA = fvc.constrain_hbya(mesh, rAU * UEqn_c.H(mesh), U)
            csf, _ = sigma_kappa_snalpha(a1, a2)
            phig = (csf - ghf * fvc.sn_grad(mesh, rho).data) \
                * rAU_f * mesh.mag_sf
            phig = torch.cat([phig[:n_int], torch.zeros_like(phig[n_int:])])
            phi_hbya = SurfaceField(fvc.flux(mesh, HbyA).data + phig,
                                    phi.dims, "phiHbyA")
            for north in range(n_non_orth + 1):
                final = corr == n_corr - 1 and north == n_non_orth
                pEqn = fvm.laplacian(mesh, rAU, p_rgh, lap_corr) \
                    == fvc.div(mesh, phi_hbya)
                pEqn = pEqn.set_reference(p_ref_cell, p_ref_value)
                p_rgh, p_perf = solve(mesh, pEqn,
                                      p_final if final else p_controls)
                p_perf_all.append(p_perf[0])
            flux_p = pEqn.replace(psi=p_rgh).flux(mesh)
            phi = SurfaceField(phi_hbya.data - flux_p.data, phi.dims, "phi")
            corr_f = SurfaceField(
                (phig - flux_p.data) / torch.clamp(rAU_f, min=1e-30),
                phi.dims / rAU.dims, "corrF")
            U_star = HbyA + rAU * fvc.reconstruct(mesh, corr_f)
            U = U.replace(data=U_star.data).correct_boundary_conditions(mesh)

        stats = dict(p_perf=tuple(p_perf_all), a2_perf=a2_perf,
                     cont=continuity_errors(mesh, phi),
                     co=courant_number(mesh, phi, dt),
                     a1=(a1.data.min(), a1.data.max(),
                         gsum(a1.data * mesh.V)),
                     a2=(a2.data.min(), a2.data.max(),
                         gsum(a2.data * mesh.V)))
        return a1, a2, U, p_rgh, phi, stats

    return step


def iteration_counts(stats) -> list[tuple[str, int]]:
    """A step's linear-solver iterations: alpha2's diffusion, then every
    p_rgh solve."""
    return [("alpha2", int(stats["a2_perf"][0][2]))] + [
        ("p_rgh", int(pf[2])) for pf in stats["p_perf"]]


def run(case_dir: str, *, device: torch.device, dtype: torch.dtype,
        write: bool = True, max_steps: int | None = None,
        case: Case | None = None):
    """Run interMixingFoam to endTime or max_steps. Returns (case, a1, a2,
    U, p_rgh, phi); case.step_log holds each step's iteration counts."""
    if case is None:
        case = Case(case_dir, device=device, dtype=dtype)
    mesh = case.mesh
    consts = read_constants(case)
    names = consts[0]
    info(f"Three phases: {names} D23={consts[2]}\n")

    def fname(i):
        cand = f"alpha.{names[i]}"
        return cand if case.field_exists(cand) else f"alpha{i + 1}"

    a1 = case.read_field(fname(0))
    a2 = case.read_field(fname(1))
    U = case.read_field("U")
    p_rgh = case.read_field("p_rgh")
    phi = fvc.flux(mesh, U)
    step = make_step(case, consts, PimpleControl(case))
    p_solver = case.solver_controls("p_rgh").solver
    v_total = float(mesh.V.sum())
    timer = ExecutionTimer()
    cumulative_err = 0.0
    case.step_log = []

    info("\nStarting time loop\n")
    n = 0
    while case.time.run():
        case.time.increment()
        t0 = _time.perf_counter()
        info(f"Time = {case.time.name}\n")
        a1, a2, U, p_rgh, phi, stats = step(a1, a2, U, p_rgh, phi,
                                            case.time.delta_t)
        log_courant(*stats["co"])
        for key, lbl in (("a1", "Air"), ("a2", "Liquid")):
            mn, mx, it = (float(x) for x in stats[key])
            info(f"{lbl} phase volume fraction = {it / v_total:.8g}  "
                 f"Min = {mn:.6g}  Max = {mx:.6g}")
        for perf in stats["p_perf"]:
            log_solve(p_solver, "p_rgh", *perf)
        local_err, glob_err = stats["cont"]
        cumulative_err += float(glob_err)
        log_continuity(cumulative_err, local_err, glob_err)
        case.step_seconds.append(_time.perf_counter() - t0)
        case.step_log.append(dict(iterations=iteration_counts(stats)))
        timer.log()
        if write and case.time.write_time():
            case.write_fields([a1.replace(name=fname(0)),
                               a2.replace(name=fname(1)), U, p_rgh])
        n += 1
        if max_steps and n >= max_steps:
            break
    info("End\n")
    return case, a1, a2, U, p_rgh, phi


def main(argv=None):
    import argparse

    from .. import resolve_device, solver_dtype
    ap = argparse.ArgumentParser(
        description="interMixingFoam (rapidcfd_tpu_torch)")
    ap.add_argument("-case", dest="case", default=".")
    ap.add_argument("-noWrite", action="store_true")
    ap.add_argument("-device", default="cuda")
    ap.add_argument("-precision", choices=["fp32", "fp64"], default=None)
    args = ap.parse_args(argv)
    run(args.case, device=resolve_device(args.device),
        dtype=solver_dtype("interMixingFoam", args.precision),
        write=not args.noWrite)


if __name__ == "__main__":
    main()
