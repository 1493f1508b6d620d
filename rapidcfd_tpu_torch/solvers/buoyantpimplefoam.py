"""buoyantPimpleFoam — transient compressible natural convection in the
p_rgh form (port of rapidcfd_tpu/solvers/buoyantpimplefoam.py;
reference: applications/solvers/heatTransfer/buoyantPimpleFoam with
UEqn.H, EEqn.H and pEqn.H).

A timestep is the density predictor (rhoEqn), then nOuterCorrectors
loops of the momentum predictor with ddt(rho, U) and the full-density
buoyancy, the sensible-enthalpy equation with ddt(rho, K), div(phi, K)
and dpdt (and the P1 radiation source when selected), and nCorrectors
pressure corrections fvc::ddt(rho) + psi correction(fvm::ddt(p_rgh)) +
div(phiHbyA) - laplacian(rho rAU, p_rgh) = 0, each followed by the flux,
the momentum correction, p = p_rgh + rho gh and rho from the equation
of state. Laminar, as in the JAX package (see buoyantsimplefoam).
"""

from __future__ import annotations

import time as _time

import torch

from ..fields.bcs import (fixed_flux_pressure_mask,
                          set_fixed_flux_pressure_gradient)
from ..fields.field import Dimensioned, SurfaceField, VolField
from ..linalg.solvers import gsum, solve
from ..models.radiation import make_radiation_model
from ..models.thermo import PsiThermo, read_thermo
from ..ops import fvc, fvm
from ..utils.dimensions import DimensionSet, dim_density
from ..utils.logging import ExecutionTimer, info
from .buoyantfoam import (boundary_masked, corrected_u, face_force,
                          ffp_sngrad, g_dot, gravity)
from .buoyantsimplefoam import (eos_field, initial_state, iteration_counts,
                                laminar_only, log_step, radiation_source)
from .case import Case
from .controls import PimpleControl

_DYN_VISC = DimensionSet.of(1, -1, -1)
_MASS_FLUX = DimensionSet.of(1, 0, -1)
_PSI = DimensionSet.of(0, -2, 2)
_RATE = DimensionSet.of(0, 0, -1)


def make_step(case: Case, thermo: PsiThermo, ctrl: PimpleControl, g,
              rad=None):
    """step(U, p_rgh, T, p, rho, phi, dt, G) -> (U, p_rgh, T, p, rho, phi,
    G, stats); G None without radiation. stats: the last u_perf, h_perf
    and g_perf, every p_rgh solve (p_perf), cont (local, global of
    ddt(rho) + div(phi)) and rho_minmax."""
    case.refuse_second_order_ddt("buoyantPimpleFoam")
    from ..linalg.precompute import attach_solver_layouts
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
    p_controls = case.solver_controls("p_rgh")
    p_final = case.solver_controls("p_rgh", final=True)
    h_controls = case.solver_controls("h")
    n_outer, n_corr = ctrl.n_outer, ctrl.n_correctors
    n_non_orth = ctrl.n_non_orth
    mesh = attach_solver_layouts(case.mesh, (u_controls, p_controls,
                                             p_final),
                                 timings=case.setup_seconds)
    gh = g_dot(mesh, mesh.C, g)
    ghf = g_dot(mesh, mesh.Cf, g)
    ghb = ghf[mesh.n_internal:]

    def step(U: VolField, p_rgh: VolField, T: VolField, p: VolField,
             rho: VolField, phi: SurfaceField, dt, G: VolField | None):
        U, T, p, rho = (f.store_old() for f in (U, T, p, rho))

        # rhoEqn.H
        rho = rho.replace(data=rho.old.data - dt * fvc.div(mesh, phi).data) \
            .correct_boundary_conditions(mesh)

        u_perf = h_perf = g_perf = None
        p_perf_all = []
        for outer in range(n_outer):
            # UEqn.H
            mu_f = Dimensioned("mu", _DYN_VISC,
                               m.mu(fvc.face_values(mesh, T)))
            UEqn = (fvm.ddt(mesh, U, dt, ddt_scheme, coeff=rho)
                    + fvm.div(mesh, phi, U, div_u)
                    - fvm.laplacian(mesh, mu_f, U, lap_corr))
            U, u_perf = solve(mesh, UEqn == face_force(mesh, ghf, rho,
                                                       p_rgh), u_controls)

            # EEqn.H: sensible enthalpy with K and dpdt
            h = thermo.he_field(mesh, T, "h").replace(
                old=thermo.he_field(mesh, T.old, "h").replace(old=None))
            alpha_f = Dimensioned("alpha", _DYN_VISC,
                                  m.alpha_h(fvc.face_values(mesh, T)))
            K = h.with_calculated_bcs(0.5 * (U.data * U.data).sum(-1),
                                      0.5 * (U.bvalues * U.bvalues).sum(-1),
                                      h.dims, "K")
            K_old = 0.5 * (U.old.data * U.old.data).sum(-1)
            ddt_rhoK = (rho.data * K.data - rho.old.data * K_old) / dt
            dpdt = (p.data - p.old.data) / dt
            rhs = h.with_calculated_bcs(
                dpdt - ddt_rhoK - fvc.div(mesh, phi, K, div_k).data,
                torch.zeros_like(h.bvalues), h.dims * dim_density * _RATE)
            hEqn = (fvm.ddt(mesh, h, dt, ddt_scheme, coeff=rho)
                    + fvm.div(mesh, phi, h, div_h)
                    - fvm.laplacian(mesh, alpha_f, h, lap_corr))
            hEqn = hEqn.equals(rhs)
            if rad is not None:
                G, g_perf, hEqn = radiation_source(rad, mesh, m, G, T, hEqn,
                                                   h)
            h, h_perf = solve(mesh, hEqn, h_controls)
            T = thermo.update_t(mesh, T, h)

            # pEqn.H
            for corr in range(n_corr):
                rho = eos_field(m, rho, p, T)
                psi = T.with_calculated_bcs(m.psi(T.data), m.psi(T.bvalues),
                                            _PSI, "psi")
                psi = psi.replace(old=psi.replace(old=None))
                UEqn_c = UEqn.replace(psi=U)
                rAU = 1.0 / UEqn_c.A(mesh)
                rho_rau = rho * rAU
                rho_rau_f = fvc.face_values(mesh, rho_rau)
                HbyA = fvc.constrain_hbya(mesh, rAU * UEqn_c.H(mesh), U)
                rho_f = fvc.face_values(mesh, rho)
                phig = boundary_masked(
                    mesh, -rho_rau_f * ghf * fvc.sn_grad(mesh, rho).data
                    * mesh.mag_sf, fixed_flux_pressure_mask(mesh, p_rgh))
                phi_hbya = SurfaceField(
                    rho_f * fvc.flux(mesh, HbyA).data + phig, _MASS_FLUX,
                    "phiHbyA")
                p_rgh = set_fixed_flux_pressure_gradient(
                    mesh, p_rgh, ffp_sngrad(mesh, phi_hbya.data, U,
                                            rho_rau_f, rho.bvalues))
                # psi correction(ddt(p_rgh)): the old level pinned to the
                # current p_rgh, so the pair is psi/dt (p_rgh - p_rgh*)
                p2 = p_rgh.replace(old=p_rgh.replace(old=None))
                ddt_rho = (rho.data - rho.old.data) / dt
                for north in range(n_non_orth + 1):
                    final = (outer == n_outer - 1 and corr == n_corr - 1
                             and north == n_non_orth)
                    pEqn = fvm.ddt(mesh, p2, dt, ddt_scheme, coeff=psi) \
                        - fvm.laplacian(mesh, rho_rau, p_rgh, lap_corr)
                    pEqn = pEqn.equals(p_rgh.with_calculated_bcs(
                        -ddt_rho - fvc.div(mesh, phi_hbya).data,
                        torch.zeros_like(p_rgh.bvalues),
                        dim_density * _RATE))
                    p_rgh, p_perf = solve(mesh, pEqn,
                                          p_final if final else p_controls)
                    p_perf_all.append(p_perf[0])
                # -laplacian sits inside the matrix: its flux is added
                # (reference: buoyantPimpleFoam pEqn.H phi = phiHbyA +
                # p_rghEqn.flux())
                flux_p = pEqn.replace(psi=p_rgh).flux(mesh)
                phi = phi_hbya + flux_p
                U = corrected_u(mesh, HbyA, rAU, phig, -flux_p.data,
                                rho_rau_f, U, phi.dims / (rho.dims
                                                          * rAU.dims))
                p = p.replace(data=p_rgh.data + rho.data * gh,
                              bvalues=p_rgh.bvalues + rho.bvalues * ghb)
                rho = eos_field(m, rho, p, T)

        cont = (rho.data - rho.old.data) / dt + fvc.div(mesh, phi).data
        stats = dict(u_perf=u_perf, h_perf=h_perf, g_perf=g_perf,
                     p_perf=tuple(p_perf_all),
                     cont=(gsum(cont.abs() * mesh.V), gsum(cont * mesh.V)),
                     rho_minmax=(rho.data.min(), rho.data.max()))
        return U, p_rgh, T, p, rho, phi, G, stats

    return step


def setup(case: Case):
    """Thermo, radiation, fields and the step of a case: (thermo, rad,
    (U, p_rgh, T, p, rho, phi, G), step)."""
    laminar_only(case, "buoyantPimpleFoam")
    model = read_thermo(case.constant_dict("thermophysicalProperties"))
    thermo = PsiThermo(case, model)
    info(f"Perfect gas: R={model.r:.6g} Cp={model.cp:.6g} "
         f"gamma={model.gamma:.4g}\n")
    U, p_rgh, T, p, rho, phi = initial_state(case, model)
    rad = make_radiation_model(case)
    G = rad.read_g() if rad is not None else None
    step = make_step(case, thermo, PimpleControl(case), gravity(case), rad)
    return thermo, rad, (U, p_rgh, T, p, rho, phi, G), step


def run(case_dir: str, *, device: torch.device, dtype: torch.dtype,
        write: bool = True, max_steps: int | None = None,
        case: Case | None = None):
    """Run buoyantPimpleFoam until endTime or max_steps. Returns (case, U,
    p_rgh, T, p, rho, phi); case.step_log holds each step's continuity
    errors and iteration_counts."""
    if case is None:
        case = Case(case_dir, device=device, dtype=dtype)
    if case.control_dict.lookup("functions"):
        raise NotImplementedError("functionObjects are not ported yet")
    thermo, rad, (U, p_rgh, T, p, rho, phi, G), step = setup(case)
    timer = ExecutionTimer()
    cumulative_err = 0.0
    case.step_log = []

    info("\nStarting time loop\n")
    n = 0
    while case.time.loop():
        t0 = _time.perf_counter()
        info(f"Time = {case.time.name}\n")
        U, p_rgh, T, p, rho, phi, G, stats = step(
            U, p_rgh, T, p, rho, phi, case.time.delta_t, G)
        cumulative_err = log_step(case, stats, rad, cumulative_err)
        case.step_seconds.append(_time.perf_counter() - t0)
        case.step_log.append(dict(
            cont=tuple(float(c) for c in stats["cont"]),
            iterations=iteration_counts(stats)))
        timer.log()
        if write and case.time.write_time():
            case.write_fields([U, p_rgh, T, p.replace(name="p"),
                               rho.replace(name="rho")]
                              + ([G] if G is not None else []))
        n += 1
        if max_steps and n >= max_steps:
            break
    info("End\n")
    case.G = G
    return case, U, p_rgh, T, p, rho, phi


def main(argv=None):
    import argparse

    from .. import resolve_device, solver_dtype
    ap = argparse.ArgumentParser(
        description="buoyantPimpleFoam (rapidcfd_tpu_torch)")
    ap.add_argument("-case", dest="case", default=".")
    ap.add_argument("-noWrite", action="store_true")
    ap.add_argument("-device", default="cuda")
    ap.add_argument("-precision", choices=["fp32", "fp64"], default=None)
    args = ap.parse_args(argv)
    run(args.case, device=resolve_device(args.device),
        dtype=solver_dtype("buoyantPimpleFoam", args.precision),
        write=not args.noWrite)


if __name__ == "__main__":
    main()
