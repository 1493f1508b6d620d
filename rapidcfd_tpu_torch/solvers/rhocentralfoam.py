"""rhoCentralFoam — density-based central-upwind compressible solver (port
of rapidcfd_tpu/solvers/rhocentralfoam.py; reference: applications/
solvers/compressible/rhoCentralFoam/rhoCentralFoam.C:55-270).

A timestep reconstructs rho, rhoU, rPsi, e and the speed of sound on both
sides of every face with a limited scheme (the 'pos' and 'neg' values),
takes the Kurganov-Noelle-Petrova (default) or Kurganov-Tadmor wave
speeds, assembles the mass, momentum and energy fluxes and updates the
conserved variables explicitly. With a viscosity (mu > 0) it adds the
implicit momentum correction ddt(rho, U) - laplacian(muEff, U) ==
div(tauMC), the viscous work sigmaDotU in the energy flux and the
implicit e correction. The inviscid step has no linear solve: on gdia
meshes its gradients (one per reconstructed field) are the shift-MAC
kernel's K = 5, C = 3 launches. rhoCentralDyMFoam (`dym`) is not ported.
"""

from __future__ import annotations

import time as _time

import torch

from ..fields.field import Dimensioned, SurfaceField, VolField
from ..linalg.solvers import gmax, solve
from ..models.thermo import PsiThermo, read_thermo
from ..ops import fvc, fvm
from ..ops.interpolation import interpolate_internal
from ..utils.dimensions import DimensionSet, dim_density, dimless
from ..utils.logging import ExecutionTimer, info, log_solve
from .case import Case

_DYN_VISC = DimensionSet.of(1, -1, -1)
_MASS_FLUX = DimensionSet.of(1, 0, -1)
_STRESS = DimensionSet.of(1, -1, -2)


def _pos_neg(mesh, vf: VolField, scheme, sides):
    """One-sided face values on all faces: owner-upwinded ('pos') and
    neighbour-upwinded ('neg') limited values on the internal faces, the
    field's boundary values on the patches (reference's
    fvc::interpolate(vf, pos|neg, "reconstruct(...)")). sides: the
    internal-face fluxes +1 and -1. Both sides share one gradient of vf."""
    g = fvc.grad(mesh, vf)
    return tuple(torch.cat([interpolate_internal(mesh, vf, scheme, phi, g),
                            vf.bvalues]) for phi in sides)


def _dev2t(t):
    """dev2(T(t)) = t^T - (2/3) tr(t) I of (..., 3, 3) tensors."""
    tr = t.diagonal(dim1=-2, dim2=-1).sum(-1)
    eye = torch.eye(3, dtype=t.dtype, device=t.device)
    return t.transpose(-1, -2) - (2.0 / 3.0) * tr[..., None, None] * eye


def _with_self_as_old(f: VolField) -> VolField:
    """f whose old level is f itself: the ddt pair of a correction step
    collapses to coeff/dt (f - f*)."""
    return f.replace(old=f.replace(old=None))


def make_step(case: Case, thermo: PsiThermo, dym: bool = False):
    """step(U, p, T, dt) -> (U, p, T, phi, stats): stats holds the Courant
    number of the wave speeds (co_max), the largest Mach number
    (mach_max) and, when viscous, the momentum and energy solves' perf
    (u_perf, e_perf; None when inviscid)."""
    case.refuse_second_order_ddt("rhoCentralFoam")
    if dym:
        raise NotImplementedError("rhoCentralDyMFoam (dym=True) is not "
                                  "ported yet: it waits for the dynamic-mesh "
                                  "slice")
    from ..linalg.precompute import attach_solver_layouts
    m = thermo.model
    fluxes = str(case.fv_schemes.word("fluxScheme", "Kurganov"))
    if fluxes not in ("Kurganov", "Tadmor"):
        raise ValueError(f"fluxScheme must be Kurganov or Tadmor, got "
                         f"'{fluxes}'")
    interp = case.fv_schemes.subdict("interpolationSchemes")
    recon_rho = str(interp.word("reconstruct(rho)", "vanLeer"))
    recon_u = str(interp.word("reconstruct(U)", "vanLeerV"))
    recon_t = str(interp.word("reconstruct(T)", "vanLeer"))
    inviscid = float(m.mu0) == 0.0
    lap_corr = case.laplacian_scheme()
    if not inviscid:
        u_controls = case.solver_controls("U")
        e_controls = case.solver_controls("e")
    mesh = attach_solver_layouts(case.mesh, (), timings=case.setup_seconds)
    Sf, mag_sf = mesh.Sf, mesh.mag_sf
    ones = torch.ones(mesh.n_internal, dtype=mesh.dtype, device=mesh.device)
    sides = (SurfaceField(ones, dimless, "pos"),
             SurfaceField(-ones, dimless, "neg"))

    def step(U: VolField, p: VolField, T: VolField, dt):
        # primitive -> conserved
        rho = T.with_calculated_bcs(m.rho(p.data, T.data),
                                    m.rho(p.bvalues, T.bvalues),
                                    dim_density, "rho")
        e = thermo.he_field(mesh, T)
        rhoU_d = rho.data[:, None] * U.data
        rhoE_d = rho.data * (e.data + 0.5 * (U.data * U.data).sum(-1))
        rhoU = U.with_calculated_bcs(rhoU_d, rho.bvalues[:, None] * U.bvalues,
                                     rho.dims * U.dims, "rhoU")
        rpsi = T.with_calculated_bcs(m.r * T.data, m.r * T.bvalues,
                                     p.dims / rho.dims, "rPsi")

        # one-sided reconstructions (rhoCentralFoam.C:61-105)
        rho_pos, rho_neg = _pos_neg(mesh, rho, recon_rho, sides)
        rhoU_pos, rhoU_neg = _pos_neg(mesh, rhoU, recon_u, sides)
        rpsi_pos, rpsi_neg = _pos_neg(mesh, rpsi, recon_t, sides)
        e_pos, e_neg = _pos_neg(mesh, e, recon_t, sides)

        U_pos = rhoU_pos / rho_pos[:, None]
        U_neg = rhoU_neg / rho_neg[:, None]
        p_pos = rho_pos * rpsi_pos
        p_neg = rho_neg * rpsi_neg
        phiv_pos = (U_pos * Sf).sum(-1)
        phiv_neg = (U_neg * Sf).sum(-1)

        c = T.with_calculated_bcs(m.c_sound(T.data), m.c_sound(T.bvalues),
                                  U.dims, "c")
        c_pos, c_neg = _pos_neg(mesh, c, recon_t, sides)
        csf_pos = c_pos * mag_sf
        csf_neg = c_neg * mag_sf

        # local wave speeds (rhoCentralFoam.C:128-151)
        ap = torch.clamp(torch.maximum(phiv_pos + csf_pos,
                                       phiv_neg + csf_neg), min=0.0)
        am = torch.clamp(torch.minimum(phiv_pos - csf_pos,
                                       phiv_neg - csf_neg), max=0.0)
        if fluxes == "Kurganov":
            # zero-measure faces (gdia dummy plane slots) have ap = am = 0:
            # 0/0 there would poison every surface sum (0 * nan = nan); a
            # central weight on a zero-area face is inert
            den = ap - am
            safe = den > 0.0
            a_pos = torch.where(safe, ap / torch.where(safe, den,
                                                       torch.ones_like(den)),
                                torch.full_like(den, 0.5))
            a_sf = am * a_pos
        else:                      # Tadmor's central scheme
            a_sf = -0.5 * torch.maximum(am.abs(), ap.abs())
            a_pos = torch.full_like(ap, 0.5)
        a_neg = 1.0 - a_pos
        aphiv_pos = phiv_pos * a_pos - a_sf
        aphiv_neg = phiv_neg * a_neg + a_sf
        amax_sf = torch.maximum(aphiv_pos.abs(), aphiv_neg.abs())

        # Courant number (compressibleCourantNo.H)
        sum_amax = fvc.surface_sum_faces(mesh, amax_sf, signed=False)
        co_max = 0.5 * gmax(sum_amax / mesh.V) * dt

        # central-upwind fluxes (rhoCentralFoam.C:170-186)
        phi = aphiv_pos * rho_pos + aphiv_neg * rho_neg
        phi_up = (aphiv_pos[:, None] * rhoU_pos
                  + aphiv_neg[:, None] * rhoU_neg) \
            + (a_pos * p_pos + a_neg * p_neg)[:, None] * Sf
        phi_ep = aphiv_pos * (rho_pos * (e_pos + 0.5 * (U_pos * U_pos).sum(-1))
                              + p_pos) \
            + aphiv_neg * (rho_neg * (e_neg + 0.5 * (U_neg * U_neg).sum(-1))
                           + p_neg) \
            + a_sf * (p_pos - p_neg)

        rdtv = dt / mesh.V

        # conserved updates
        rho_new_d = rho.data - rdtv * fvc.surface_sum_faces(mesh, phi)
        rhoU_new_d = rhoU_d - rdtv[:, None] * fvc.surface_sum_faces(mesh,
                                                                    phi_up)
        U = U.replace(data=rhoU_new_d / rho_new_d[:, None]) \
            .correct_boundary_conditions(mesh)

        u_perf = e_perf = None
        if inviscid:
            sigma_dot_u = 0.0
        else:
            # implicit viscous momentum correction (ddt(rho,U) -
            # fvc::ddt(rho,U) - laplacian(muEff,U) == div(tauMC)), the old
            # levels pinned to the post-convective state
            mu_eff = Dimensioned("muEff", _DYN_VISC,
                                 m.mu(fvc.face_values(mesh, T)))
            g = fvc.grad(mesh, U)
            mu_c = torch.as_tensor(m.mu(T.data), dtype=T.data.dtype,
                                   device=T.data.device) \
                * torch.ones_like(T.data)
            mu_b = torch.as_tensor(m.mu(T.bvalues), dtype=T.data.dtype,
                                   device=T.data.device) \
                * torch.ones_like(T.bvalues)
            tau_mc = g.with_calculated_bcs(
                mu_c[:, None, None] * _dev2t(g.data),
                mu_b[:, None, None] * _dev2t(g.bvalues), _STRESS, "tauMC")
            rho_f = _with_self_as_old(T.with_calculated_bcs(
                rho_new_d, rho.bvalues, dim_density, "rho"))
            U2 = _with_self_as_old(U)
            UEqn = fvm.ddt(mesh, U2, dt, coeff=rho_f) \
                - fvm.laplacian(mesh, mu_eff, U2, lap_corr)
            U, u_perf = solve(mesh, UEqn == fvc.div_tensor(mesh, tau_mc),
                              u_controls)

            # the viscous work on the faces
            sng_u = fvc.sn_grad(mesh, U)
            tau_f = fvc.face_values(mesh, tau_mc)
            mu_face = torch.as_tensor(mu_eff.value, dtype=mag_sf.dtype,
                                      device=mag_sf.device) \
                * torch.ones_like(mag_sf)
            visc_vec = mu_face[:, None] * mag_sf[:, None] * sng_u.data \
                + (Sf[:, :, None] * tau_f).sum(1)
            sigma_dot_u = (visc_vec * (a_pos[:, None] * U_pos
                                       + a_neg[:, None] * U_neg)).sum(-1)

        # energy
        rhoE_new_d = rhoE_d - rdtv * fvc.surface_sum_faces(
            mesh, phi_ep - sigma_dot_u)
        e_new_d = rhoE_new_d / rho_new_d - 0.5 * (U.data * U.data).sum(-1)
        T = T.replace(data=m.t_from_he(e_new_d)) \
            .correct_boundary_conditions(mesh)

        if not inviscid:
            alpha_f = Dimensioned("alpha", _DYN_VISC,
                                  m.alpha_h(fvc.face_values(mesh, T)))
            e2 = _with_self_as_old(thermo.he_field(mesh, T))
            rho_f = _with_self_as_old(T.with_calculated_bcs(
                rho_new_d, rho.bvalues, dim_density, "rho"))
            eEqn = fvm.ddt(mesh, e2, dt, coeff=rho_f) \
                - fvm.laplacian(mesh, alpha_f, e2, lap_corr)
            e_solved, e_perf = solve(mesh, eEqn, e_controls)
            T = thermo.update_t(mesh, T, e_solved)

        # p from the equation of state
        p = p.replace(data=rho_new_d * m.r * T.data) \
            .correct_boundary_conditions(mesh)

        mach = torch.linalg.norm(U.data, dim=-1) / m.c_sound(T.data)
        stats = dict(co_max=co_max, mach_max=mach.max(), u_perf=u_perf,
                     e_perf=e_perf)
        # phi is 0 on the faces no sum reads (gdia dummies, empty patches),
        # where the one-sided values divide by a density of 0 (the JAX
        # package's phi holds NaN there)
        return U, p, T, SurfaceField(fvc.zero_unread_faces(mesh, phi),
                                     _MASS_FLUX, "phi"), stats

    return step


def iteration_counts(stats) -> list[tuple[str, int]]:
    """A timestep's linear-solver iterations (the viscous branch's Ux,
    Uy, Uz and e; none when inviscid)."""
    its = []
    if stats["u_perf"] is not None:
        its += [(f"U{c}", int(pf[2])) for c, pf in zip("xyz",
                                                        stats["u_perf"])]
    if stats["e_perf"] is not None:
        its.append(("e", int(stats["e_perf"][0][2])))
    return its


def setup(case: Case, dym: bool = False):
    """Thermo, fields and the step of a case: (thermo, (U, p, T), step)."""
    model = read_thermo(case.constant_dict("thermophysicalProperties"))
    thermo = PsiThermo(case, model)
    info(f"Perfect gas: R={model.r:.6g} Cp={model.cp:.6g} "
         f"gamma={model.gamma:.4g}\n")
    step = make_step(case, thermo, dym)
    U = case.read_field("U")
    p = case.read_field("p")
    T = case.read_field("T")
    return thermo, (U, p, T), step


def run(case_dir: str, *, device: torch.device, dtype: torch.dtype,
        write: bool = True, max_steps: int | None = None,
        case: Case | None = None, dym: bool = False):
    """Run rhoCentralFoam on a case directory until endTime or max_steps,
    with controlDict's adjustTimeStep/maxCo/maxDeltaT. `case` passes a
    Case built already (an in-memory mesh). Returns (case, U, p, T, phi);
    case.step_seconds holds each step's wall time (each step ends in a
    device sync when its Courant number is read) and case.step_log each
    step's dt, Courant max, max Mach and iteration_counts."""
    if case is None:
        case = Case(case_dir, device=device, dtype=dtype)
    if case.control_dict.lookup("functions"):
        raise NotImplementedError("functionObjects are not ported yet")
    thermo, (U, p, T), step = setup(case, dym)
    m = thermo.model
    cd = case.control_dict
    adjust = str(cd.word("adjustTimeStep", "no")) in ("yes", "on", "true")
    max_co = float(cd.scalar("maxCo", 0.5))
    max_dt = float(cd.scalar("maxDeltaT", 1e10))
    timer = ExecutionTimer()
    case.step_log = []
    phi = None

    info("\nStarting time loop\n")
    n = 0
    while case.time.loop():
        t0 = _time.perf_counter()
        info(f"Time = {case.time.name}\n")
        dt = case.time.delta_t
        U, p, T, phi, stats = step(U, p, T, dt)
        co_max = float(stats["co_max"])
        mach = float(stats["mach_max"])
        info(f"Mean and max Courant Numbers = - {co_max:.6g}\n")
        info(f"max Mach = {mach:.4g}\n")
        if stats["u_perf"] is not None:
            u_solver = case.solver_controls("U").solver
            for cmpt, perf in zip("xyz", stats["u_perf"]):
                log_solve(u_solver, f"U{cmpt}", *perf)
            log_solve(case.solver_controls("e").solver, "e",
                      *stats["e_perf"][0])
        case.step_seconds.append(_time.perf_counter() - t0)
        case.step_log.append(dict(dt=dt, co=co_max, mach=mach,
                                  iterations=iteration_counts(stats)))
        timer.log()
        if adjust and co_max > 0:
            case.time.set_delta_t(min(dt * min(max_co / co_max, 1.2),
                                      max_dt))
        if write and case.time.write_time():
            rho = T.with_calculated_bcs(m.rho(p.data, T.data),
                                        m.rho(p.bvalues, T.bvalues),
                                        dim_density, "rho")
            case.write_fields([U, p, T, rho])
        n += 1
        if max_steps and n >= max_steps:
            break
    info("End\n")
    return case, U, p, T, phi


def main(argv=None):
    import argparse

    from .. import resolve_device, solver_dtype
    ap = argparse.ArgumentParser(
        description="rhoCentralFoam (rapidcfd_tpu_torch)")
    ap.add_argument("-case", dest="case", default=".")
    ap.add_argument("-noWrite", action="store_true")
    ap.add_argument("-device", default="cuda")
    ap.add_argument("-precision", choices=["fp32", "fp64"], default=None)
    args = ap.parse_args(argv)
    run(args.case, device=resolve_device(args.device),
        dtype=solver_dtype("rhoCentralFoam", args.precision),
        write=not args.noWrite)


if __name__ == "__main__":
    main()
