"""buoyantBoussinesqSimpleFoam and buoyantBoussinesqPimpleFoam — natural
convection under the Boussinesq approximation (port of rapidcfd_tpu/
solvers/buoyantfoam.py; reference: applications/solvers/heatTransfer/
buoyantBoussinesq{Simple,Pimple}Foam with TEqn.H, UEqn.H and pEqn.H).

The buoyancy is rhok = 1 - beta (T - TRef) in the p_rgh form: the
momentum equation's right-hand side is the reconstructed face force
(-ghf snGrad(rhok) - snGrad(p_rgh)) |Sf|, the pressure equation carries
the body-force flux phig, and fixedFluxPressure patches get their
gradient from phiHbyA at every corrector (fields/bcs.py
set_fixed_flux_pressure_gradient). T is transported with alphaEff =
nu/Pr + nut/Prt; the RAS model comes from make_ras_model, so kEpsilon
and kOmegaSST run as in simpleFoam. One SIMPLE iteration (or one PIMPLE
timestep) runs eagerly on the case's device; the host loop logs
residuals in OpenFOAM format and writes time directories.
"""

from __future__ import annotations

import os
import time as _time

import torch

from ..fields.bcs import (fixed_flux_pressure_mask,
                          set_fixed_flux_pressure_gradient)
from ..fields.field import Dimensioned, SurfaceField, VolField
from ..linalg.solvers import solve
from ..models.fvoptions import FvOptions
from ..models.transport import SinglePhaseTransportModel
from ..models.turbulence import make_ras_model
from ..ops import fvc, fvm
from ..utils.dictionary import parse_file
from ..utils.dimensions import DimensionSet, dim_viscosity, dimless
from ..utils.logging import ExecutionTimer, info, log_continuity, log_solve
from .case import Case
from .controls import PimpleControl, SimpleControl
from .icofoam import continuity_errors
from .simplefoam import div_dev_reff, relax_field


def gravity(case) -> list[float]:
    """constant/g's value, (0 -9.81 0) without the file."""
    path = os.path.join(case.dir, "constant", "g")
    if not os.path.isfile(path):
        return [0.0, -9.81, 0.0]
    return [float(x) for x in parse_file(path).lookup("value")]


def g_dot(mesh, points: torch.Tensor, g) -> torch.Tensor:
    """g & x at the given points (cell or face centres), in the mesh's
    layout: on gdia meshes the plane faces include the dummies (Cf 0
    there) and the boundary faces follow the port's patch order."""
    return (points * torch.tensor(g, dtype=mesh.dtype,
                                  device=mesh.device)).sum(-1)


def face_force(mesh, ghf, rho_like: VolField, p_rgh: VolField) -> VolField:
    """reconstruct((-ghf snGrad(rho) - snGrad(p_rgh)) |Sf|): the
    buoyancy and pressure-gradient right-hand side of UEqn.H."""
    ff = (-ghf * fvc.sn_grad(mesh, rho_like).data
          - fvc.sn_grad(mesh, p_rgh).data) * mesh.mag_sf
    return fvc.reconstruct(mesh, SurfaceField(
        ff, p_rgh.dims / DimensionSet.of(0, 1) * DimensionSet.of(0, 2),
        "ff"))


def boundary_masked(mesh, face_data: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """face_data with its boundary part multiplied by mask."""
    n_int = mesh.n_internal
    return torch.cat([face_data[:n_int], face_data[n_int:] * mask])


def ffp_sngrad(mesh, phi_hbya: torch.Tensor, U: VolField,
               d_f: torch.Tensor, rho_b=None) -> torch.Tensor:
    """setSnGrad<fixedFluxPressure>'s gradient on every boundary face:
    (phiHbyA_b - rho_b (Sf_b & U_b)) / (|Sf_b| Dp_b) (reference: the
    buoyant solvers' pEqn.H); rho_b None for the volumetric forms."""
    n_int = mesh.n_internal
    u_flux = (mesh.Sf[n_int:] * U.bvalues).sum(-1)
    if rho_b is not None:
        u_flux = rho_b * u_flux
    return (phi_hbya[n_int:] - u_flux) \
        / (torch.clamp(mesh.mag_sf[n_int:], min=1e-30)
           * torch.clamp(d_f[n_int:], min=1e-30))


def corrected_u(mesh, HbyA: VolField, rAU: VolField, phig, flux_p,
                d_f, U: VolField, dims) -> VolField:
    """U = HbyA + rAU reconstruct((phig - flux_p)/Dp_f), with U's
    boundary conditions re-evaluated (flux_p is the flux the pressure
    equation removes, d_f the face diffusivity of that equation)."""
    corr_f = SurfaceField((phig - flux_p) / torch.clamp(d_f, min=1e-30),
                          dims, "corrF")
    U_star = HbyA + rAU * fvc.reconstruct(mesh, corr_f)
    return U.replace(data=U_star.data).correct_boundary_conditions(mesh)


def _alpha_eff(nu, nut, pr: float, prt: float):
    """alphaEff = nu/Pr + nut/Prt (laminar: nu/Pr)."""
    nu_v = nu.value if isinstance(nu, Dimensioned) else nu.data
    if nut is None:
        return Dimensioned("alphaEff", dim_viscosity, nu_v / pr)
    return nut.with_calculated_bcs(nu_v / pr + nut.data / prt,
                                   nu_v / pr + nut.bvalues / prt,
                                   dim_viscosity, "alphaEff")


def _rhok(T: VolField, beta: float, t_ref: float) -> VolField:
    return T.with_calculated_bcs(1.0 - beta * (T.data - t_ref),
                                 1.0 - beta * (T.bvalues - t_ref), dimless,
                                 "rhok")


class _Schemes:
    """The words and controls both Boussinesq steps read from the case."""

    def __init__(self, case: Case):
        self.div_u = case.div_scheme("div(phi,U)")
        try:
            self.div_t = case.div_scheme("div(phi,T)")
        except KeyError:
            self.div_t = self.div_u
        self.lap_corr = case.laplacian_scheme()
        self.ddt = case.ddt_scheme()
        self.u = case.solver_controls("U")
        self.p = case.solver_controls("p_rgh")
        self.t = case.solver_controls("T")


def _pressure_start(mesh, UEqn, U, rhok, p_rgh, ghf, ffp_mask):
    """The pressure corrector up to its equation: rAU, its face values,
    HbyA, phig, phiHbyA and p_rgh with its fixedFluxPressure gradient."""
    UEqn_c = UEqn.replace(psi=U)
    rAU = 1.0 / UEqn_c.A(mesh)
    rAU_f = fvc.face_values(mesh, rAU)
    HbyA = fvc.constrain_hbya(mesh, rAU * UEqn_c.H(mesh), U)
    phig = boundary_masked(
        mesh, -rAU_f * ghf * fvc.sn_grad(mesh, rhok).data * mesh.mag_sf,
        ffp_mask)
    phi_hbya = fvc.adjust_phi(mesh, fvc.flux(mesh, HbyA), U)
    phi_hbya = SurfaceField(phi_hbya.data + phig, phi_hbya.dims, "phiHbyA")
    p_rgh = set_fixed_flux_pressure_gradient(
        mesh, p_rgh, ffp_sngrad(mesh, phi_hbya.data, U, rAU_f))
    return rAU, rAU_f, HbyA, phig, phi_hbya, p_rgh


def make_step(case: Case, transport, turb, simple: SimpleControl, consts):
    """buoyantBoussinesqSimpleFoam: step(U, p_rgh, T, phi, turb_state) ->
    (U, p_rgh, T, phi, turb_state, stats). consts = (beta, TRef, Pr, Prt,
    g). stats: u_perf, t_perf, p_perf (every non-orthogonal solve),
    turb, cont (local, global)."""
    from ..linalg.precompute import attach_solver_layouts
    fv_options = FvOptions(case)
    beta, t_ref, pr, prt, g = consts
    sc = _Schemes(case)
    u_relax = case.relaxation_factor("U", "equations", 0.3)
    t_relax = case.relaxation_factor("T", "equations", 0.7)
    p_relax = case.relaxation_factor("p_rgh", "fields", 0.3)
    n_non_orth = simple.n_non_orth
    p_ref_cell = case.maps.device_cell(simple.p_ref_cell)
    p_ref_value = simple.p_ref_value
    mesh = attach_solver_layouts(case.mesh, (sc.u, sc.p),
                                 timings=case.setup_seconds)
    ghf = g_dot(mesh, mesh.Cf, g)

    def step(U: VolField, p_rgh: VolField, T: VolField, phi: SurfaceField,
             turb_state):
        nu = transport.nu(mesh, U)
        nu_eff = turb.nu_eff(mesh, turb_state, nu)

        # TEqn.H
        TEqn = (fvm.div(mesh, phi, T, sc.div_t)
                - fvm.laplacian(mesh, _alpha_eff(nu, turb.nut(turb_state),
                                                 pr, prt), T, sc.lap_corr))
        TEqn = fv_options(mesh, "T", TEqn, {"nu": nu, "T": T, "phi": phi,
                                            "U": U}).relax(mesh, t_relax)
        TEqn = fv_options.constrain(mesh, "T", TEqn)
        T, t_perf = solve(mesh, TEqn, sc.t)
        rhok = _rhok(T, beta, t_ref)

        # UEqn.H
        UEqn = fvm.div(mesh, phi, U, sc.div_u) \
            + div_dev_reff(mesh, nu_eff, U, sc.lap_corr)
        UEqn = fv_options(mesh, "U", UEqn, {"nu": nu, "T": T}).relax(
            mesh, u_relax)
        U, u_perf = solve(mesh, UEqn.equals(face_force(mesh, ghf, rhok,
                                                       p_rgh)), sc.u)

        # pEqn.H
        rAU, rAU_f, HbyA, phig, phi_hbya, p_rgh = _pressure_start(
            mesh, UEqn, U, rhok, p_rgh, ghf,
            fixed_flux_pressure_mask(mesh, p_rgh))
        p_prev = p_rgh
        p_perf_all = []
        for _ in range(n_non_orth + 1):
            pEqn = fvm.laplacian(mesh, rAU, p_rgh, sc.lap_corr) \
                == fvc.div(mesh, phi_hbya)
            pEqn = pEqn.set_reference(p_ref_cell, p_ref_value)
            p_rgh, p_perf = solve(mesh, pEqn, sc.p)
            p_perf_all.append(p_perf[0])
        phi = phi_hbya - pEqn.replace(psi=p_rgh).flux(mesh)
        cont = continuity_errors(mesh, phi)
        p_rgh = relax_field(p_rgh, p_prev, p_relax)
        U = corrected_u(mesh, HbyA, rAU, phig,
                        pEqn.replace(psi=p_rgh).flux(mesh).data, rAU_f, U,
                        phi.dims / rAU.dims)

        turb_state, turb_perf = turb.correct(mesh, turb_state, U, phi, nu)
        stats = dict(u_perf=u_perf, t_perf=t_perf, p_perf=tuple(p_perf_all),
                     turb=turb_perf, cont=cont)
        return U, p_rgh, T, phi, turb_state, stats

    return step


def make_pimple_step(case: Case, transport, turb, ctrl: PimpleControl,
                     consts):
    """buoyantBoussinesqPimpleFoam: step(U, p_rgh, T, phi, turb_state, dt)
    with the case's ddt scheme, nOuterCorrectors loops of TEqn, UEqn and
    nCorrectors pressure corrections (the last solve with p_rghFinal),
    the turbulence model corrected once per outer loop."""
    case.refuse_second_order_ddt("buoyantBoussinesqPimpleFoam")
    from ..linalg.precompute import attach_solver_layouts
    fv_options = FvOptions(case)
    beta, t_ref, pr, prt, g = consts
    sc = _Schemes(case)
    p_final = case.solver_controls("p_rgh", final=True)
    n_outer, n_corr = ctrl.n_outer, ctrl.n_correctors
    n_non_orth = ctrl.n_non_orth
    p_ref_cell = case.maps.device_cell(ctrl.p_ref_cell)
    p_ref_value = ctrl.p_ref_value
    mesh = attach_solver_layouts(case.mesh, (sc.u, sc.p, p_final),
                                 timings=case.setup_seconds)
    ghf = g_dot(mesh, mesh.Cf, g)

    def step(U: VolField, p_rgh: VolField, T: VolField, phi: SurfaceField,
             turb_state, dt):
        U, T = U.store_old(), T.store_old()
        nu = transport.nu(mesh, U)
        nu_eff = turb.nu_eff(mesh, turb_state, nu)
        alpha_eff = _alpha_eff(nu, turb.nut(turb_state), pr, prt)
        u_perf = t_perf = None
        p_perf_all = []
        turb_perf = {}
        for outer in range(n_outer):
            # TEqn.H
            TEqn = (fvm.ddt(mesh, T, dt, sc.ddt)
                    + fvm.div(mesh, phi, T, sc.div_t)
                    - fvm.laplacian(mesh, alpha_eff, T, sc.lap_corr))
            TEqn = fv_options.constrain(mesh, "T", fv_options(
                mesh, "T", TEqn, {"nu": nu, "T": T, "dt": dt, "phi": phi,
                                  "U": U}))
            T, t_perf = solve(mesh, TEqn, sc.t)
            rhok = _rhok(T, beta, t_ref)

            # UEqn.H
            UEqn = (fvm.ddt(mesh, U, dt, sc.ddt)
                    + fvm.div(mesh, phi, U, sc.div_u)
                    + div_dev_reff(mesh, nu_eff, U, sc.lap_corr))
            UEqn = fv_options(mesh, "U", UEqn, {"nu": nu, "T": T, "dt": dt})
            U, u_perf = solve(mesh, UEqn.equals(face_force(
                mesh, ghf, rhok, p_rgh)), sc.u)

            # pEqn.H
            for corr in range(n_corr):
                rAU, rAU_f, HbyA, phig, phi_hbya, p_rgh = _pressure_start(
                    mesh, UEqn, U, rhok, p_rgh, ghf,
                    fixed_flux_pressure_mask(mesh, p_rgh))
                for north in range(n_non_orth + 1):
                    final = (outer == n_outer - 1 and corr == n_corr - 1
                             and north == n_non_orth)
                    pEqn = fvm.laplacian(mesh, rAU, p_rgh, sc.lap_corr) \
                        == fvc.div(mesh, phi_hbya)
                    pEqn = pEqn.set_reference(p_ref_cell, p_ref_value)
                    p_rgh, p_perf = solve(mesh, pEqn,
                                          p_final if final else sc.p)
                    p_perf_all.append(p_perf[0])
                flux_p = pEqn.replace(psi=p_rgh).flux(mesh)
                phi = phi_hbya - flux_p
                U = corrected_u(mesh, HbyA, rAU, phig, flux_p.data, rAU_f,
                                U, phi.dims / rAU.dims)
            turb_state, turb_perf = turb.correct(mesh, turb_state, U, phi,
                                                 nu, dt=dt)
        stats = dict(u_perf=u_perf, t_perf=t_perf, p_perf=tuple(p_perf_all),
                     turb=turb_perf, cont=continuity_errors(mesh, phi))
        return U, p_rgh, T, phi, turb_state, stats

    return step


def iteration_counts(stats) -> list[tuple[str, int]]:
    """An iteration's or timestep's linear-solver iterations: Ux, Uy, Uz
    and T (of the last outer loop), p_rgh (every solve), then the
    turbulence fields by name."""
    its = [(f"U{c}", int(pf[2])) for c, pf in zip("xyz", stats["u_perf"])]
    its.append(("T", int(stats["t_perf"][0][2])))
    its += [("p_rgh", int(pf[2])) for pf in stats["p_perf"]]
    return its + [(k, int(pf[2])) for k, pf in sorted(stats["turb"].items())]


def read_constants(case: Case):
    """(beta, TRef, Pr, Prt, g) from transportProperties and constant/g."""
    tp = case.transport_properties()

    def value(key):
        return Dimensioned.from_entry(tp.lookup(key, required=True)).value
    return (value("beta"), value("TRef"), value("Pr"), value("Prt"),
            gravity(case))


def setup(case: Case, transient: bool = False):
    """Fields, models and the step of a case: ((U, p_rgh, T, phi,
    turb_state), step). p_rgh's fixedFluxPressure gradient starts at
    zero, as in the JAX package."""
    mesh = case.mesh
    consts = read_constants(case)
    info("Reading field U\n\nReading field p_rgh\n\nReading field T\n")
    U = case.read_field("U")
    p_rgh = set_fixed_flux_pressure_gradient(
        mesh, case.read_field("p_rgh"),
        torch.zeros(mesh.n_boundary, dtype=mesh.dtype, device=mesh.device))
    T = case.read_field("T")
    phi = fvc.flux(mesh, U)
    transport = SinglePhaseTransportModel(case.transport_properties())
    turb = make_ras_model(case, U)
    turb_state = turb.init_state(U)
    if transient:
        step = make_pimple_step(case, transport, turb, PimpleControl(case),
                                consts)
    else:
        step = make_step(case, transport, turb, SimpleControl(case), consts)
    return (U, p_rgh, T, phi, turb_state), step


def run(case_dir: str, *, device: torch.device, dtype: torch.dtype,
        write: bool = True, max_steps: int | None = None,
        transient: bool = False, case: Case | None = None):
    """Run buoyantBoussinesqSimpleFoam (or, transient=True,
    buoyantBoussinesqPimpleFoam) until residualControl is met, endTime or
    max_steps. Returns (case, U, p_rgh, T, phi, turb_state);
    case.step_seconds holds each iteration's wall time and case.step_log
    its continuity errors and iteration_counts."""
    if case is None:
        case = Case(case_dir, device=device, dtype=dtype)
    if case.control_dict.lookup("functions"):
        raise NotImplementedError("functionObjects are not ported yet")
    (U, p_rgh, T, phi, turb_state), step = setup(case, transient)
    simple = None if transient else SimpleControl(case)
    solver_of = {name: case.solver_controls(name).solver
                 for name in ("U", "T", "p_rgh")}
    timer = ExecutionTimer()
    cumulative_err = 0.0
    case.step_log = []

    info("\nStarting time loop\n")
    n = 0
    initial_residuals = None
    while (case.time.loop() if transient
           else simple.loop(initial_residuals)):
        t0 = _time.perf_counter()
        info(f"Time = {case.time.name}\n")
        if transient:
            U, p_rgh, T, phi, turb_state, stats = step(
                U, p_rgh, T, phi, turb_state, case.time.delta_t)
        else:
            U, p_rgh, T, phi, turb_state, stats = step(U, p_rgh, T, phi,
                                                       turb_state)
        initial_residuals = {}
        for cmpt, perf in zip("xyz", stats["u_perf"]):
            log_solve(solver_of["U"], f"U{cmpt}", *perf)
            initial_residuals[f"U{cmpt}"] = float(perf[0])
        log_solve(solver_of["T"], "T", *stats["t_perf"][0])
        initial_residuals["T"] = float(stats["t_perf"][0][0])
        for perf in stats["p_perf"]:
            log_solve(solver_of["p_rgh"], "p_rgh", *perf)
        initial_residuals["p_rgh"] = float(stats["p_perf"][0][0])
        for name, perf in sorted(stats["turb"].items()):
            log_solve(case.solver_controls(name).solver, name, *perf)
        local_err, glob_err = stats["cont"]
        cumulative_err += float(glob_err)
        log_continuity(cumulative_err, local_err, glob_err)
        case.step_seconds.append(_time.perf_counter() - t0)
        case.step_log.append(dict(cont=(float(local_err), float(glob_err)),
                                  iterations=iteration_counts(stats)))
        timer.log()
        if write and case.time.write_time():
            case.write_fields([U, p_rgh, T] + list(turb_state.values()))
        n += 1
        if max_steps and n >= max_steps:
            break
    info("End\n")
    return case, U, p_rgh, T, phi, turb_state


def main(argv=None, transient: bool = False):
    import argparse

    from .. import resolve_device, solver_dtype
    name = ("buoyantBoussinesqPimpleFoam" if transient
            else "buoyantBoussinesqSimpleFoam")
    ap = argparse.ArgumentParser(description=f"{name} (rapidcfd_tpu_torch)")
    ap.add_argument("-case", dest="case", default=".")
    ap.add_argument("-noWrite", action="store_true")
    ap.add_argument("-device", default="cuda")
    ap.add_argument("-precision", choices=["fp32", "fp64"], default=None)
    args = ap.parse_args(argv)
    run(args.case, device=resolve_device(args.device),
        dtype=solver_dtype(name, args.precision), write=not args.noWrite,
        transient=transient)


if __name__ == "__main__":
    main()
