"""rhoSimpleFoam — steady compressible SIMPLE solver (port of
rapidcfd_tpu/solvers/rhosimplefoam.py; reference: applications/solvers/
compressible/rhoSimpleFoam/rhoSimpleFoam.C with UEqn.H, EEqn.H and
pEqn.H, subsonic form).

A SIMPLE iteration is the relaxed momentum predictor (muEff = mu + mut
and the explicit dev2 stress when turbulent), the relaxed enthalpy
equation with the explicit kinetic-energy flux (then T from h and the
relaxed density from the equation of state), the rho-weighted pressure
equation with its non-orthogonal correctors, the explicit relaxation of
p, the momentum correction, rho from the equation of state and the
turbulence model's correct(). In fp32 `run` solves p in deviation form
(fields.field.shift_level) when its mean dwarfs its range; every
equation-of-state evaluation adds the offset back and written fields are
absolute. consistent=True runs the SIMPLEC corrector (rhoSimplecFoam):
rAtU = 1/(1/rAU - H1), the flux gains interp(rho (rAtU - rAU)) snGrad(p)
|Sf| and HbyA loses (rAU - rAtU) grad(p).
"""

from __future__ import annotations

import time as _time

import numpy as np
import torch

from ..fields.field import Dimensioned, SurfaceField, VolField, shift_level
from ..linalg.solvers import gsum, solve
from ..models.fvoptions import refuse_options
from ..models.thermo import PsiThermo, read_thermo
from ..models.turbulence import CompressibleTurbulence
from ..ops import fvc, fvm
from ..utils.dimensions import DimensionSet, dim_density
from ..utils.logging import ExecutionTimer, info, log_continuity, log_solve
from .case import Case
from .controls import SimpleControl
from .simplefoam import relax_field

_DYN_VISC = DimensionSet.of(1, -1, -1)
_MASS_FLUX = DimensionSet.of(1, 0, -1)


def _dev2t(t):
    """dev2(T(t)) = t^T - (2/3) tr(t) I of (..., 3, 3) tensors."""
    tr = t.diagonal(dim1=-2, dim2=-1).sum(-1)
    eye = torch.eye(3, dtype=t.dtype, device=t.device)
    return t.transpose(-1, -2) - (2.0 / 3.0) * tr[..., None, None] * eye


def simplec_correction(mesh, phi_hbya: SurfaceField, HbyA: VolField,
                       rho: VolField, rAU: VolField, rAtU: VolField,
                       p: VolField):
    """The consistent (SIMPLEC/PIMPLEC) terms of a compressible pEqn.H:
    phiHbyA += interp(rho (rAtU - rAU)) snGrad(p) |Sf| and
    HbyA -= (rAU - rAtU) grad(p). Returns (phiHbyA, HbyA). The flux term
    is 0 on empty patches, which have no faces in the reference: there
    rAtU's extrapolated boundary value is 1/(1 - 1), and the JAX package's
    phi holds NaN."""
    drho_rau_f = fvc.face_values(mesh, rho * (rAtU - rAU))
    corr = fvc.zero_unread_faces(
        mesh, drho_rau_f * fvc.sn_grad(mesh, p).data * mesh.mag_sf)
    phi_hbya = SurfaceField(phi_hbya.data + corr, phi_hbya.dims,
                            phi_hbya.name)
    return phi_hbya, HbyA - (rAU - rAtU) * fvc.grad(mesh, p)


def make_step(case: Case, thermo: PsiThermo, simple: SimpleControl,
              turb: CompressibleTurbulence | None = None,
              consistent: bool = False, p_offset: float = 0.0):
    """step(U, p, T, rho, phi, turb_state) -> (U, p, T, rho, phi,
    turb_state, stats). turb, when turbulent, adds mut = rho*nut to the
    momentum and energy diffusivities (alphaEff = alpha + mut/Prt) and
    the explicit div(muEff dev2(T(grad U))). p_offset: the level p is
    shifted by (p holds p - p_offset), added back for the equation of
    state and the reference pin. consistent=True: rhoSimplecFoam."""
    from ..linalg.precompute import attach_solver_layouts
    m = thermo.model
    div_u = case.div_scheme("div(phi,U)")
    try:
        div_h = case.div_scheme("div(phi,h)")
    except KeyError:
        div_h = div_u
    lap_corr = case.laplacian_scheme()
    u_controls = case.solver_controls("U")
    p_controls = case.solver_controls("p")
    h_controls = case.solver_controls("h")
    u_relax = case.relaxation_factor("U", "equations", 0.3)
    h_relax = case.relaxation_factor("h", "equations", 0.7)
    p_relax = case.relaxation_factor("p", "fields", 0.3)
    rho_relax = case.relaxation_factor("rho", "fields", 1.0)
    n_non_orth = simple.n_non_orth
    # pRefCell is a file-order label; the pin is inert wherever a BC
    # fixes the level of p (the heated channel's outlet)
    p_ref_cell = case.maps.device_cell(simple.p_ref_cell)
    p_ref_value = simple.p_ref_value - p_offset
    has_turb = turb is not None and not turb.laminar
    mesh = attach_solver_layouts(case.mesh, (u_controls, p_controls,
                                             h_controls),
                                 timings=case.setup_seconds)

    def step(U: VolField, p: VolField, T: VolField, rho: VolField,
             phi: SurfaceField, turb_state):
        mu_face = m.mu(fvc.face_values(mesh, T))
        mut_f = (turb.mut_faces(mesh, turb_state, fvc.face_values(mesh, rho))
                 if has_turb else None)
        mu_eff = mu_face + mut_f if mut_f is not None else mu_face

        # UEqn.H: steady, mass-flux convection
        UEqn = (fvm.div(mesh, phi, U, div_u)
                - fvm.laplacian(mesh, Dimensioned("muEff", _DYN_VISC,
                                                  mu_eff), U, lap_corr))
        if has_turb:
            # the explicit part of divDevRhoReff: div(muEff dev2(T(grad U)))
            g = fvc.grad(mesh, U)
            devT = g.with_calculated_bcs(_dev2t(g.data), _dev2t(g.bvalues),
                                         g.dims, "dev2T")
            nut_c = turb.inner.nut(turb_state)
            mu_eff_c = T.with_calculated_bcs(
                m.mu(T.data) + rho.data * torch.clamp(nut_c.data, min=0.0),
                m.mu(T.bvalues)
                + rho.bvalues * torch.clamp(nut_c.bvalues, min=0.0),
                _DYN_VISC, "muEff")
            expl = fvc.div_tensor(mesh, devT * mu_eff_c)
            UEqn = UEqn.replace(
                source=UEqn.source + mesh.V[:, None] * expl.data)
        UEqn = UEqn.relax(mesh, u_relax)
        U, u_perf = solve(mesh, UEqn == (-fvc.grad(mesh, p)), u_controls)

        # EEqn.H: sensible enthalpy with the explicit K flux
        h = thermo.he_field(mesh, T, "h")
        alpha_face = m.alpha_h(fvc.face_values(mesh, T))
        if mut_f is not None:
            alpha_face = alpha_face + mut_f / turb.prt
        Ek = h.with_calculated_bcs(0.5 * (U.data * U.data).sum(-1),
                                   0.5 * (U.bvalues * U.bvalues).sum(-1),
                                   h.dims, "K")
        hEqn = (fvm.div(mesh, phi, h, div_h)
                - fvm.laplacian(mesh, Dimensioned("alphaEff", _DYN_VISC,
                                                  alpha_face), h, lap_corr))
        hEqn = hEqn.equals(-fvc.div(mesh, phi, Ek, div_h))
        hEqn = hEqn.relax(mesh, h_relax)
        h, h_perf = solve(mesh, hEqn, h_controls)
        T = thermo.update_t(mesh, T, h)
        rho_eos = rho.replace(data=m.rho(p.data + p_offset, T.data),
                              bvalues=m.rho(p.bvalues + p_offset, T.bvalues))
        rho = relax_field(rho_eos, rho, rho_relax)

        # pEqn.H: subsonic SIMPLE
        UEqn_c = UEqn.replace(psi=U)
        rAU = 1.0 / UEqn_c.A(mesh)
        rAtU = 1.0 / (1.0 / rAU - UEqn_c.H1(mesh)) if consistent else rAU
        HbyA = fvc.constrain_hbya(mesh, rAU * UEqn_c.H(mesh), U)
        phi_hbya = SurfaceField(
            fvc.face_values(mesh, rho) * fvc.flux(mesh, HbyA).data,
            _MASS_FLUX, "phiHbyA")
        phi_hbya = fvc.adjust_phi(mesh, phi_hbya, U)
        if consistent:
            phi_hbya, HbyA = simplec_correction(mesh, phi_hbya, HbyA, rho,
                                                rAU, rAtU, p)
        rho_rau = rho * rAtU

        p_prev = p
        p_perf_all = []
        for _ in range(n_non_orth + 1):
            pEqn = fvm.laplacian(mesh, rho_rau, p, lap_corr) \
                == fvc.div(mesh, phi_hbya)
            pEqn = pEqn.set_reference(p_ref_cell, p_ref_value)
            p, p_perf = solve(mesh, pEqn, p_controls)
            p_perf_all.append(p_perf[0])
        phi = phi_hbya - pEqn.replace(psi=p).flux(mesh)
        cont = fvc.div(mesh, phi).data

        p = relax_field(p, p_prev, p_relax)
        U_star = HbyA - rAtU * fvc.grad(mesh, p)
        U = U.replace(data=U_star.data).correct_boundary_conditions(mesh)
        rho = rho.replace(data=m.rho(p.data + p_offset, T.data),
                          bvalues=m.rho(p.bvalues + p_offset, T.bvalues))

        if has_turb:
            nu_lam = T.with_calculated_bcs(
                m.mu(T.data) / rho.data, m.mu(T.bvalues) / rho.bvalues,
                DimensionSet.of(0, 2, -1), "nu")
            turb_state, turb_perf = turb.correct(mesh, turb_state, U, phi,
                                                 rho, nu_lam)
        else:
            turb_perf = {}

        stats = dict(u_perf=u_perf, h_perf=h_perf, p_perf=tuple(p_perf_all),
                     turb=turb_perf,
                     cont=(gsum(cont.abs() * mesh.V), gsum(cont * mesh.V)))
        return U, p, T, rho, phi, turb_state, stats

    return step


def iteration_counts(stats) -> list[tuple[str, int]]:
    """A SIMPLE iteration's linear-solver iterations in the order the
    solves are logged: Ux, Uy, Uz, h, p (each corrector), then the
    turbulence fields by name."""
    its = [(f"U{c}", int(pf[2])) for c, pf in zip("xyz", stats["u_perf"])]
    its.append(("h", int(stats["h_perf"][0][2])))
    its += [("p", int(pf[2])) for pf in stats["p_perf"]]
    return its + [(k, int(pf[2])) for k, pf in sorted(stats["turb"].items())]


def deviation_offset(p: VolField) -> float:
    """The level to run p in deviation form at: its mean when the field
    is fp32 and the mean dwarfs its range (100x), else 0 (fp64 stays
    absolute). One host readback."""
    if p.data.dtype != torch.float32:
        return 0.0
    pa = p.data.cpu().numpy()
    lvl, dyn = float(np.mean(pa)), float(pa.max() - pa.min())
    return lvl if abs(lvl) > 100.0 * max(dyn, 1e-30) else 0.0


def setup(case: Case, consistent: bool = False):
    """Thermo, fields, turbulence and the step of a case: (thermo,
    (U, p, T, rho, phi, turb_state), step, p_offset). p is returned in
    deviation form when p_offset is not 0. consistent=True:
    rhoSimplecFoam."""
    model = read_thermo(case.constant_dict("thermophysicalProperties"))
    thermo = PsiThermo(case, model)
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
        info(f"rhoSimpleFoam: solving p in deviation form "
             f"(p_offset = {p_offset:g})\n")
    simple = SimpleControl(case)
    turb = CompressibleTurbulence(case, U)
    turb_state = turb.init_state(U)
    step = make_step(case, thermo, simple, turb=turb, consistent=consistent,
                     p_offset=p_offset)
    return thermo, (U, p, T, rho, phi, turb_state), step, p_offset


def run(case_dir: str, *, device: torch.device, dtype: torch.dtype,
        write: bool = True, max_steps: int | None = None,
        case: Case | None = None, consistent: bool = False):
    """Run rhoSimpleFoam (rhoSimplecFoam with consistent=True) on a case
    directory until residualControl is met, endTime or max_steps. Returns
    (case, U, p, T, rho, phi) with p absolute; case.step_seconds holds each iteration's wall time and
    case.step_log its continuity errors (local, global) and
    iteration_counts."""
    if case is None:
        case = Case(case_dir, device=device, dtype=dtype)
    if case.control_dict.lookup("functions"):
        raise NotImplementedError("functionObjects are not ported yet")
    refuse_options(case, "rhoSimpleFoam")
    _, (U, p, T, rho, phi, turb_state), step, p_offset = setup(case,
                                                               consistent)
    simple = SimpleControl(case)
    timer = ExecutionTimer()
    cumulative_err = 0.0
    case.step_log = []

    def absolute(p_):
        return shift_level(p_, p_offset) if p_offset else p_

    def write_all():
        case.write_fields([U, absolute(p), T, rho.replace(name="rho")]
                          + list(turb_state.values()))

    info("\nStarting time loop\n")
    n = 0
    initial_residuals = None
    written = False
    while simple.loop(initial_residuals):
        t0 = _time.perf_counter()
        info(f"Time = {case.time.name}\n")
        U, p, T, rho, phi, turb_state, stats = step(U, p, T, rho, phi,
                                                    turb_state)
        initial_residuals = {}
        for cmpt, perf in zip("xyz", stats["u_perf"]):
            log_solve(case.solver_controls("U").solver, f"U{cmpt}", *perf)
            initial_residuals[f"U{cmpt}"] = float(perf[0])
        log_solve(case.solver_controls("h").solver, "h", *stats["h_perf"][0])
        initial_residuals["h"] = float(stats["h_perf"][0][0])
        for perf in stats["p_perf"]:
            log_solve(case.solver_controls("p").solver, "p", *perf)
        initial_residuals["p"] = float(stats["p_perf"][0][0])
        for name, perf in sorted(stats["turb"].items()):
            log_solve(case.solver_controls(name).solver, name, *perf)
            initial_residuals[name] = float(perf[0])
        local_err, glob_err = stats["cont"]
        cumulative_err += float(glob_err)
        log_continuity(cumulative_err, local_err, glob_err)
        case.step_seconds.append(_time.perf_counter() - t0)
        case.step_log.append(dict(cont=(float(local_err), float(glob_err)),
                                  iterations=iteration_counts(stats)))
        timer.log()

        written = write and case.time.write_time()
        if written:
            write_all()
        n += 1
        if max_steps and n >= max_steps:
            break
    if write and n and not written:
        write_all()
    info("End\n")
    return case, U, absolute(p), T, rho, phi


def main(argv=None):
    import argparse

    from .. import resolve_device, solver_dtype
    ap = argparse.ArgumentParser(
        description="rhoSimpleFoam (rapidcfd_tpu_torch)")
    ap.add_argument("-case", dest="case", default=".")
    ap.add_argument("-noWrite", action="store_true")
    ap.add_argument("-device", default="cuda")
    ap.add_argument("-precision", choices=["fp32", "fp64"], default=None)
    args = ap.parse_args(argv)
    run(args.case, device=resolve_device(args.device),
        dtype=solver_dtype("rhoSimpleFoam", args.precision),
        write=not args.noWrite)


if __name__ == "__main__":
    main()
