"""buoyantSimpleFoam — steady compressible natural convection in the p_rgh
form (port of rapidcfd_tpu/solvers/buoyantsimplefoam.py; reference:
applications/solvers/heatTransfer/buoyantSimpleFoam with UEqn.H, EEqn.H
and pEqn.H).

One SIMPLE iteration: the momentum predictor with the full-density
buoyancy -ghf snGrad(rho), the sensible-enthalpy equation (with the
kinetic energy K and, when constant/radiationProperties selects P1, the
radiation source), the relaxed density from the equation of state, the
rho-weighted pressure equation with fixedFluxPressure patches set from
phiHbyA, and p = p_rgh + rho gh. In a closed volume (no patch of p_rgh
fixes its level) the pressure level is adjusted so the mass stays the
initial mass; the adjustment stays on the device.

Transport is laminar, as in the JAX package (its docstring: "Laminar
transport"): where the JAX package ignores a case's RAS model, the port
raises on any model other than laminar (ROADMAP Queue 3).
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
from ..models.turbulence import ras_model_name
from ..ops import fvc, fvm
from ..utils.dimensions import DimensionSet, dim_density
from ..utils.logging import ExecutionTimer, info, log_continuity, log_solve
from .buoyantfoam import (boundary_masked, corrected_u, face_force,
                          ffp_sngrad, g_dot, gravity)
from .case import Case
from .controls import SimpleControl
from .simplefoam import relax_field

_DYN_VISC = DimensionSet.of(1, -1, -1)
_MASS_FLUX = DimensionSet.of(1, 0, -1)


def laminar_only(case: Case, solver: str) -> None:
    """The full-density buoyant solvers are laminar in the JAX package,
    which ignores a case's RAS model: the port refuses one instead."""
    name = ras_model_name(case)
    if name != "laminar":
        raise NotImplementedError(
            f"{solver} is laminar (as in the JAX package): RASModel "
            f"'{name}' is not supported")


def radiation_source(rad, mesh, m, G: VolField, T: VolField, hEqn,
                     h: VolField):
    """radiation->correct() and hEqn += radiation->Sh(thermo): solve G,
    then add the linearised source to the energy matrix. Returns (G,
    g_perf, hEqn)."""
    G, g_perf = rad.correct(mesh, G, T)
    cpv = m.cp_t(T.data) if hasattr(m, "cp_t") \
        else torch.full_like(T.data, m.cp)
    sp, expl = rad.sh(mesh, G, T, cpv, h.data)
    hEqn = hEqn.replace(diag=hEqn.diag + mesh.V_asm * sp,
                        source=hEqn.source + mesh.V_asm * expl)
    return G, g_perf, hEqn


def eos_field(m, like: VolField, p: VolField, T: VolField) -> VolField:
    """like with the equation of state's rho(p, T), cells and faces."""
    return like.replace(data=m.rho(p.data, T.data),
                        bvalues=m.rho(p.bvalues, T.bvalues))


def initial_state(case: Case, m):
    """(U, p_rgh, T, p, rho, phi) read from the case: rho from the
    equation of state, phi = rho_f (U_f & Sf), p_rgh's fixedFluxPressure
    gradient zero."""
    mesh = case.mesh
    p_rgh = set_fixed_flux_pressure_gradient(
        mesh, case.read_field("p_rgh"),
        torch.zeros(mesh.n_boundary, dtype=mesh.dtype, device=mesh.device))
    T = case.read_field("T")
    U = case.read_field("U")
    p = case.read_field("p")
    rho = T.with_calculated_bcs(m.rho(p.data, T.data),
                                m.rho(p.bvalues, T.bvalues), dim_density,
                                "rho")
    phi = SurfaceField(fvc.face_values(mesh, rho)
                       * fvc.flux(mesh, U).data, _MASS_FLUX, "phi")
    return U, p_rgh, T, p, rho, phi


def make_step(case: Case, thermo: PsiThermo, simple: SimpleControl, g,
              initial_mass: float | None, rad=None):
    """step(U, p_rgh, T, p, rho, phi, G) -> (U, p_rgh, T, p, rho, phi, G,
    stats). initial_mass None: the volume is not closed (no level
    adjustment). G is None without radiation. stats: u_perf, h_perf,
    g_perf (None without radiation), p_perf, cont, rho_minmax."""
    from ..linalg.precompute import attach_solver_layouts
    m = thermo.model
    div_u = case.div_scheme("div(phi,U)")
    try:
        div_h = case.div_scheme("div(phi,h)")
    except KeyError:
        div_h = div_u
    lap_corr = case.laplacian_scheme()
    u_controls = case.solver_controls("U")
    p_controls = case.solver_controls("p_rgh")
    h_controls = case.solver_controls("h")
    u_relax = case.relaxation_factor("U", "equations", 0.3)
    h_relax = case.relaxation_factor("h", "equations", 0.7)
    p_relax = case.relaxation_factor("p_rgh", "fields", 0.7)
    rho_relax = case.relaxation_factor("rho", "fields", 1.0)
    n_non_orth = simple.n_non_orth
    p_ref_cell = case.maps.device_cell(simple.p_ref_cell)
    p_ref_value = simple.p_ref_value
    mesh = attach_solver_layouts(case.mesh, (u_controls, p_controls),
                                 timings=case.setup_seconds)
    gh = g_dot(mesh, mesh.C, g)
    ghf = g_dot(mesh, mesh.Cf, g)
    ghb = ghf[mesh.n_internal:]
    V = mesh.V_asm

    def step(U: VolField, p_rgh: VolField, T: VolField, p: VolField,
             rho: VolField, phi: SurfaceField, G: VolField | None):
        # UEqn.H
        mu_f = Dimensioned("mu", _DYN_VISC, m.mu(fvc.face_values(mesh, T)))
        UEqn = (fvm.div(mesh, phi, U, div_u)
                - fvm.laplacian(mesh, mu_f, U, lap_corr)).relax(mesh,
                                                                u_relax)
        U, u_perf = solve(mesh, UEqn.equals(face_force(mesh, ghf, rho,
                                                       p_rgh)), u_controls)

        # EEqn.H (sensible enthalpy)
        h = thermo.he_field(mesh, T, "h")
        alpha_f = Dimensioned("alpha", _DYN_VISC,
                              m.alpha_h(fvc.face_values(mesh, T)))
        K = h.with_calculated_bcs(0.5 * (U.data * U.data).sum(-1),
                                  0.5 * (U.bvalues * U.bvalues).sum(-1),
                                  h.dims, "K")
        hEqn = (fvm.div(mesh, phi, h, div_h)
                - fvm.laplacian(mesh, alpha_f, h, lap_corr))
        hEqn = hEqn.equals(-fvc.div(mesh, phi, K, div_h))
        g_perf = None
        if rad is not None:
            G, g_perf, hEqn = radiation_source(rad, mesh, m, G, T, hEqn, h)
        h, h_perf = solve(mesh, hEqn.relax(mesh, h_relax), h_controls)
        T = thermo.update_t(mesh, T, h)

        # pEqn.H
        rho = relax_field(eos_field(m, rho, p, T), rho, rho_relax)
        UEqn_c = UEqn.replace(psi=U)
        rAU = 1.0 / UEqn_c.A(mesh)
        rho_rau = rho * rAU
        rho_rau_f = fvc.face_values(mesh, rho_rau)
        HbyA = fvc.constrain_hbya(mesh, rAU * UEqn_c.H(mesh), U)
        rho_f = fvc.face_values(mesh, rho)
        phig = boundary_masked(
            mesh, -rho_rau_f * ghf * fvc.sn_grad(mesh, rho).data
            * mesh.mag_sf, fixed_flux_pressure_mask(mesh, p_rgh))
        phi_hbya = fvc.adjust_phi(mesh, SurfaceField(
            rho_f * fvc.flux(mesh, HbyA).data, _MASS_FLUX, "phiHbyA"), U)
        phi_hbya = SurfaceField(phi_hbya.data + phig, phi_hbya.dims,
                                "phiHbyA")
        p_rgh = set_fixed_flux_pressure_gradient(
            mesh, p_rgh, ffp_sngrad(mesh, phi_hbya.data, U, rho_rau_f,
                                    rho.bvalues))

        p_prev = p_rgh
        p_perf_all = []
        for _ in range(n_non_orth + 1):
            pEqn = fvm.laplacian(mesh, rho_rau, p_rgh, lap_corr) \
                == fvc.div(mesh, phi_hbya)
            pEqn = pEqn.set_reference(p_ref_cell, p_ref_value)
            p_rgh, p_perf = solve(mesh, pEqn, p_controls)
            p_perf_all.append(p_perf[0])
        phi = phi_hbya - pEqn.replace(psi=p_rgh).flux(mesh)
        cont = fvc.div(mesh, phi).data
        cont = (gsum(cont.abs() * mesh.V), gsum(cont * mesh.V))

        p_rgh = relax_field(p_rgh, p_prev, p_relax)
        U = corrected_u(mesh, HbyA, rAU, phig,
                        pEqn.replace(psi=p_rgh).flux(mesh).data, rho_rau_f,
                        U, phi.dims / (rho.dims * rAU.dims))

        # p = p_rgh + rho gh, then the closed-volume level adjustment
        p = p.replace(data=p_rgh.data + rho.data * gh,
                      bvalues=p_rgh.bvalues + rho.bvalues * ghb)
        if initial_mass is not None:
            psi_d = m.psi(T.data)
            dp = (initial_mass - (psi_d * p.data * V).sum()) \
                / (psi_d * V).sum()
            p = p.replace(data=p.data + dp, bvalues=p.bvalues + dp)
            p_rgh = p_rgh.replace(data=p.data - rho.data * gh,
                                  bvalues=p.bvalues - rho.bvalues * ghb)
        rho = eos_field(m, rho, p, T)
        stats = dict(u_perf=u_perf, h_perf=h_perf, g_perf=g_perf,
                     p_perf=tuple(p_perf_all), cont=cont,
                     rho_minmax=(rho.data.min(), rho.data.max()))
        return U, p_rgh, T, p, rho, phi, G, stats

    return step


def closed_initial_mass(case: Case, m, p_rgh: VolField, p: VolField,
                        T: VolField) -> float | None:
    """The initial mass sum(rho V) when no patch of p_rgh fixes its level
    (a closed volume), else None. One host reduction, at set-up."""
    if any(bc.fixes_level for bc in p_rgh.bcs):
        return None
    return float((m.rho(p.data, T.data) * case.mesh.V_asm).sum())


def iteration_counts(stats) -> list[tuple[str, int]]:
    """An iteration's linear-solver iterations: Ux, Uy, Uz, G (with
    radiation), h and every p_rgh solve."""
    its = [(f"U{c}", int(pf[2])) for c, pf in zip("xyz", stats["u_perf"])]
    if stats.get("g_perf") is not None:
        its.append(("G", int(stats["g_perf"][0][2])))
    its.append(("h", int(stats["h_perf"][0][2])))
    return its + [("p_rgh", int(pf[2])) for pf in stats["p_perf"]]


def setup(case: Case):
    """Thermo, radiation, fields and the step of a case: (thermo, rad,
    (U, p_rgh, T, p, rho, phi, G), step)."""
    laminar_only(case, "buoyantSimpleFoam")
    thermo = PsiThermo(case, read_thermo(case.constant_dict(
        "thermophysicalProperties")))
    U, p_rgh, T, p, rho, phi = initial_state(case, thermo.model)
    rad = make_radiation_model(case)
    G = rad.read_g() if rad is not None else None
    step = make_step(case, thermo, SimpleControl(case), gravity(case),
                     closed_initial_mass(case, thermo.model, p_rgh, p, T),
                     rad)
    return thermo, rad, (U, p_rgh, T, p, rho, phi, G), step


def log_step(case: Case, stats, rad, cumulative_err: float) -> float:
    """The OpenFOAM-format log of a buoyant step; returns the cumulative
    continuity error."""
    for cmpt, perf in zip("xyz", stats["u_perf"]):
        log_solve(case.solver_controls("U").solver, f"U{cmpt}", *perf)
    if stats.get("g_perf") is not None:
        log_solve(rad.g_controls.solver, "G", *stats["g_perf"][0])
    log_solve(case.solver_controls("h").solver, "h", *stats["h_perf"][0])
    for perf in stats["p_perf"]:
        log_solve(case.solver_controls("p_rgh").solver, "p_rgh", *perf)
    rmn, rmx = stats["rho_minmax"]
    info(f"rho max/min : {float(rmx):.6g} {float(rmn):.6g}")
    local_err, glob_err = stats["cont"]
    cumulative_err += float(glob_err)
    log_continuity(cumulative_err, local_err, glob_err)
    return cumulative_err


def run(case_dir: str, *, device: torch.device, dtype: torch.dtype,
        write: bool = True, max_steps: int | None = None,
        case: Case | None = None):
    """Run buoyantSimpleFoam until residualControl is met, endTime or
    max_steps. Returns (case, U, p_rgh, T, p, rho, phi); with radiation,
    case.G holds the last G. case.step_log holds each iteration's
    continuity errors and iteration_counts."""
    if case is None:
        case = Case(case_dir, device=device, dtype=dtype)
    if case.control_dict.lookup("functions"):
        raise NotImplementedError("functionObjects are not ported yet")
    thermo, rad, (U, p_rgh, T, p, rho, phi, G), step = setup(case)
    simple = SimpleControl(case)
    timer = ExecutionTimer()
    cumulative_err = 0.0
    case.step_log = []

    info("\nStarting time loop\n")
    n = 0
    initial_residuals = None
    while simple.loop(initial_residuals):
        t0 = _time.perf_counter()
        info(f"Time = {case.time.name}\n")
        U, p_rgh, T, p, rho, phi, G, stats = step(U, p_rgh, T, p, rho, phi,
                                                  G)
        cumulative_err = log_step(case, stats, rad, cumulative_err)
        initial_residuals = {f"U{c}": float(pf[0])
                             for c, pf in zip("xyz", stats["u_perf"])}
        initial_residuals["h"] = float(stats["h_perf"][0][0])
        initial_residuals["p_rgh"] = float(stats["p_perf"][0][0])
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
        description="buoyantSimpleFoam (rapidcfd_tpu_torch)")
    ap.add_argument("-case", dest="case", default=".")
    ap.add_argument("-noWrite", action="store_true")
    ap.add_argument("-device", default="cuda")
    ap.add_argument("-precision", choices=["fp32", "fp64"], default=None)
    args = ap.parse_args(argv)
    run(args.case, device=resolve_device(args.device),
        dtype=solver_dtype("buoyantSimpleFoam", args.precision),
        write=not args.noWrite)


if __name__ == "__main__":
    main()
