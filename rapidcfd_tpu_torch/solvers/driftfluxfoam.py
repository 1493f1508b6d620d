"""driftFluxFoam — a two-phase mixture (drift-flux) solver for settling
suspensions, port of rapidcfd_tpu/solvers/driftfluxfoam.py (reference:
applications/solvers/multiphase/driftFluxFoam with alphaEqn.H, UEqn.H,
pEqn.H, relativeVelocityModels and mixtureViscosityModels).

One mixture momentum equation with the diffusion stress tauDm of the
phase slip (fvc.div_tensor: the shift-MAC kernel's C = 1 form three times
per component on gdia meshes), the dispersed phase's implicit upwind
transport with the mixture flux and the drift flux Sf & Udm, and p_rgh
correctors with the buoyancy. Relative velocity: simple and general;
mixture viscosity: plastic.
"""

from __future__ import annotations

import time as _time

import torch

from ..fields.field import Dimensioned, SurfaceField, VolField
from ..linalg.solvers import gsum, solve
from ..ops import fvc, fvm
from ..utils.dictionary import Dictionary
from ..utils.dimensions import DimensionSet, dim_density
from ..utils.logging import ExecutionTimer, info, log_courant, log_solve
from .buoyantfoam import gravity
from .case import Case
from .controls import PimpleControl
from .icofoam import courant_number

_DIM_MU = DimensionSet.of(1, -1, -1)
RELATIVE_VELOCITY_MODELS = ("simple", "general")


def _value(d: Dictionary, key: str, default: float = 0.0):
    e = d.lookup(key)
    return default if e is None else Dimensioned.from_entry(e).value


class DriftModel:
    """The phases, the relative-velocity model and the plastic mixture
    viscosity of transportProperties."""

    def __init__(self, tp: Dictionary):
        phases = tp.lookup("phases")
        self.names = [str(x) for x in phases] if phases \
            else ["sludge", "water"]
        dd, dc = tp.subdict(self.names[0]), tp.subdict(self.names[1])
        self.rhod = _value(dd, "rho")
        self.rhoc = _value(dc, "rho")
        self.nuc = _value(dc, "nu", 1e-6)
        model = dd.word("viscosityModel", "plastic")
        if model != "plastic":
            raise NotImplementedError(
                f"mixture viscosity model '{model}' is not ported (plastic)")
        visc = dd.subdict("viscosityModelCoeffs", required=False) \
            or tp.subdict("plasticCoeffs", required=False) or Dictionary()
        self.pv_coeff = _value(visc, "plasticViscosityCoeff")
        self.pv_exp = _value(visc, "plasticViscosityExponent")
        self.mu_max = _value(visc, "muMax", 1e3)
        self.model = str(tp.word("relativeVelocityModel", "simple"))
        if self.model not in RELATIVE_VELOCITY_MODELS:
            raise NotImplementedError(
                f"relative velocity model '{self.model}' is not ported "
                f"({', '.join(RELATIVE_VELOCITY_MODELS)})")
        rv = tp.subdict(self.model + "Coeffs", required=False) or Dictionary()
        self.v0 = [float(x) for x in Dimensioned.from_entry(
            rv.lookup("V0", required=True)).value]
        self.a = Dimensioned.from_entry(rv.lookup("a", required=True)).value
        self.a1 = _value(rv, "a1")
        self.residual_alpha = _value(rv, "residualAlpha")

    def rho(self, a):
        """The mixture density of dispersed fraction(s) a."""
        return a * self.rhod + (1.0 - a) * self.rhoc

    def mu(self, a):
        """The plastic mixture viscosity, capped at muMax."""
        return torch.clamp(self.rhoc * self.nuc + self.pv_coeff * (
            torch.pow(10.0, self.pv_exp * a) - 1.0), max=self.mu_max)

    def udm(self, alpha_d, rho_d):
        """The dispersed phase's drift velocity Udm (nCells, 3): simple,
        V0 10^(-a alpha), or general, V0 (exp(-a alpha') - exp(-a1
        alpha')) with alpha' = max(alpha - residualAlpha, 0); both scaled
        by rhoc/rho."""
        if self.model == "general" and self.a1 != 0.0:
            ad = torch.clamp(alpha_d - self.residual_alpha, min=0.0)
            mag = torch.exp(-self.a * ad) - torch.exp(-self.a1 * ad)
        else:
            mag = torch.pow(10.0, -self.a * torch.clamp(alpha_d, min=0.0))
        v0 = torch.tensor(self.v0, dtype=alpha_d.dtype,
                          device=alpha_d.device)
        return (self.rhoc / rho_d)[:, None] * v0[None, :] * mag[:, None]

    def tau_dm(self, mesh, alpha: VolField, rho_d, dims) -> VolField:
        """The diffusion stress betad Udm Udm + betac Ucm Ucm (nCells, 3,
        3) with zero-order extrapolated boundary values."""
        udm = self.udm(alpha.data, rho_d)
        betad = alpha.data * self.rhod
        betac = torch.clamp((1.0 - alpha.data) * self.rhoc, min=1e-10)
        ucm = (betad / betac)[:, None] * udm
        tau = betad[:, None, None] * udm[:, :, None] * udm[:, None, :] \
            + betac[:, None, None] * ucm[:, :, None] * ucm[:, None, :]
        return fvc._extrapolated(mesh, tau, dims, "tauDm")


def make_step(case: Case, model: DriftModel, ctrl: PimpleControl,
              a_key: str):
    """step(alpha, U, p_rgh, phi, dt) -> (alpha, U, p_rgh, phi, stats);
    stats: a_perf, u_perf, p_perf (every p_rgh solve), co (mean, max) and
    alpha (min, max, integral)."""
    case.refuse_second_order_ddt("driftFluxFoam")
    from ..linalg.precompute import attach_solver_layouts
    alpha_controls = case.solver_controls(a_key)
    p_controls = case.solver_controls("p_rgh")
    p_final = case.solver_controls("p_rgh", final=True)
    u_controls = case.solver_controls("U")
    div_u = case.div_scheme("div(rhoPhi,U)")
    lap_corr = case.laplacian_scheme()
    n_corr, n_non_orth = ctrl.n_correctors, ctrl.n_non_orth
    p_ref_cell = case.maps.device_cell(ctrl.p_ref_cell)
    p_ref_value = ctrl.p_ref_value
    mesh = attach_solver_layouts(case.mesh, (p_controls, p_final),
                                 timings=case.setup_seconds)
    n_int = mesh.n_internal
    ghf = (mesh.Cf * torch.tensor(gravity(case), dtype=mesh.dtype,
                                  device=mesh.device)).sum(-1)
    rhod, rhoc = model.rhod, model.rhoc

    def internal_only(face_data):
        return torch.cat([face_data[:n_int],
                          torch.zeros_like(face_data[n_int:])])

    def step(alpha: VolField, U: VolField, p_rgh: VolField,
             phi: SurfaceField, dt):
        U = U.store_old()
        alpha = alpha.store_old()

        # the drift flux; none through the boundary (walls accumulate)
        udm = fvc._extrapolated(mesh, model.udm(alpha.data,
                                                model.rho(alpha.data)),
                                U.dims, "Udm")
        phir = SurfaceField(
            internal_only((fvc.face_values(mesh, udm) * mesh.Sf).sum(-1)),
            phi.dims, "phir")

        # alphaEqn.H: implicit upwind with the mixture and drift fluxes
        a_eqn = (fvm.ddt(mesh, alpha, dt)
                 + fvm.div(mesh, phi, alpha, "upwind")
                 + fvm.div(mesh, phir, alpha, "upwind"))
        alpha, a_perf = solve(mesh, a_eqn, alpha_controls, env={"phi": phi})
        alpha = alpha.replace(data=torch.clamp(alpha.data, 0.0, 1.0),
                              bvalues=torch.clamp(alpha.bvalues, 0.0, 1.0))

        rho_d = model.rho(alpha.data)
        rho = alpha.with_calculated_bcs(rho_d, model.rho(alpha.bvalues),
                                        dim_density, "rho")
        rho = rho.replace(old=alpha.old.with_calculated_bcs(
            model.rho(alpha.old.data), rho.bvalues, dim_density,
            "rho").replace(old=None))
        a_f = fvc.face_values(mesh, alpha, "vanLeer", phi)
        rho_phi = SurfaceField(phi.data * (a_f * (rhod - rhoc) + rhoc),
                               phi.dims * dim_density, "rhoPhi")
        mu = alpha.with_calculated_bcs(model.mu(alpha.data),
                                       model.mu(alpha.bvalues), _DIM_MU, "mu")
        div_tau = fvc.div_tensor(mesh, model.tau_dm(
            mesh, alpha, rho_d, dim_density * U.dims * U.dims))

        # UEqn.H, with the buoyancy and p_rgh gradient reconstructed
        mu_f = Dimensioned("muf", _DIM_MU, fvc.face_values(mesh, mu))
        UEqn = (fvm.ddt(mesh, U, dt, "Euler", coeff=rho)
                + fvm.div(mesh, rho_phi, U, div_u)
                - fvm.laplacian(mesh, mu_f, U, lap_corr))
        ff = (-ghf * fvc.sn_grad(mesh, rho).data
              - fvc.sn_grad(mesh, p_rgh).data) * mesh.mag_sf
        rhs_u = fvc.reconstruct(mesh, SurfaceField(
            ff, p_rgh.dims / DimensionSet.of(0, 1) * DimensionSet.of(0, 2),
            "ff"))
        rhs_u = rhs_u.replace(data=rhs_u.data - div_tau.data)
        U, u_perf = solve(mesh, UEqn == rhs_u, u_controls)

        # pEqn.H
        p_perf_all = []
        for corr in range(n_corr):
            UEqn_c = UEqn.replace(psi=U)
            rAU = 1.0 / UEqn_c.A(mesh)
            rAU_f = fvc.face_values(mesh, rAU)
            HbyA = fvc.constrain_hbya(mesh, rAU * UEqn_c.H(mesh), U)
            phig = internal_only(-ghf * fvc.sn_grad(mesh, rho).data * rAU_f
                                 * mesh.mag_sf)
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
            phi = phi_hbya - flux_p
            corr_f = SurfaceField(
                (phig - flux_p.data) / torch.clamp(rAU_f, min=1e-30),
                phi.dims / rAU.dims, "corrF")
            U_star = HbyA + rAU * fvc.reconstruct(mesh, corr_f)
            U = U.replace(data=U_star.data).correct_boundary_conditions(mesh)

        stats = dict(a_perf=a_perf, u_perf=u_perf, p_perf=tuple(p_perf_all),
                     co=courant_number(mesh, phi, dt),
                     alpha=(alpha.data.min(), alpha.data.max(),
                            gsum(alpha.data * mesh.V)))
        return alpha, U, p_rgh, phi, stats

    return step


def iteration_counts(stats) -> list[tuple[str, int]]:
    """A step's linear-solver iterations: alpha, then every p_rgh solve."""
    return [("alpha", int(stats["a_perf"][0][2]))] + [
        ("p_rgh", int(pf[2])) for pf in stats["p_perf"]]


def setup(case: Case):
    """Fields and the step of a case: ((alpha, U, p_rgh, phi), step,
    alpha's file name)."""
    model = DriftModel(case.transport_properties())
    alpha_name = f"alpha.{model.names[0]}" \
        if case.field_exists(f"alpha.{model.names[0]}") else "alpha1"
    solvers_d = case.fv_solution.subdict("solvers")
    a_key = alpha_name if solvers_d.lookup(alpha_name) is not None \
        else "alpha1"
    alpha = case.read_field(alpha_name)
    U = case.read_field("U")
    p_rgh = case.read_field("p_rgh")
    phi = fvc.flux(case.mesh, U)
    step = make_step(case, model, PimpleControl(case), a_key)
    return (alpha, U, p_rgh, phi), step, alpha_name


def run(case_dir: str, *, device: torch.device, dtype: torch.dtype,
        write: bool = True, max_steps: int | None = None,
        case: Case | None = None):
    """Run driftFluxFoam to endTime or max_steps. Returns (case, alpha,
    U, p_rgh, phi); case.step_log holds each step's Courant numbers,
    alpha range and integral and iteration counts."""
    if case is None:
        case = Case(case_dir, device=device, dtype=dtype)
    (alpha, U, p_rgh, phi), step, alpha_name = setup(case)
    p_solver = case.solver_controls("p_rgh").solver
    v_total = float(case.mesh.V.sum())
    timer = ExecutionTimer()
    case.step_log = []

    info("\nStarting time loop\n")
    n = 0
    while case.time.loop():
        t0 = _time.perf_counter()
        info(f"Time = {case.time.name}\n")
        alpha, U, p_rgh, phi, stats = step(alpha, U, p_rgh, phi,
                                           case.time.delta_t)
        co = tuple(float(c) for c in stats["co"])
        log_courant(*co)
        a_min, a_max, a_int = (float(x) for x in stats["alpha"])
        info(f"Dispersed phase volume fraction = {a_int / v_total:.8g}  "
             f"Min = {a_min:.6g}  Max = {a_max:.6g}")
        for perf in stats["p_perf"]:
            log_solve(p_solver, "p_rgh", *perf)
        case.step_seconds.append(_time.perf_counter() - t0)
        case.step_log.append(dict(co=co, alpha=(a_min, a_max, a_int),
                                  iterations=iteration_counts(stats)))
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
        description="driftFluxFoam (rapidcfd_tpu_torch)")
    ap.add_argument("-case", dest="case", default=".")
    ap.add_argument("-noWrite", action="store_true")
    ap.add_argument("-device", default="cuda")
    ap.add_argument("-precision", choices=["fp32", "fp64"], default=None)
    args = ap.parse_args(argv)
    run(args.case, device=resolve_device(args.device),
        dtype=solver_dtype("driftFluxFoam", args.precision),
        write=not args.noWrite)


if __name__ == "__main__":
    main()
