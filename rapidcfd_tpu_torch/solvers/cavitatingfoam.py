"""cavitatingFoam — transient barotropic cavitation (the homogeneous
equilibrium model), port of rapidcfd_tpu/solvers/cavitatingfoam.py on a
static mesh (reference: applications/solvers/multiphase/cavitatingFoam/
cavitatingFoam.C with rhoEqn.H, alphavPsi.H, UEqn.H and pEqn.H).

An implicit density transport bounded below by rhoMin; the vapour
fraction from the barotropic relation alphav = (rho - rholSat)/(rhovSat -
rholSat) with the linear compressibility psi = alphav psiv + (1 - alphav)
psil; the compressible pressure equation ddt(psi, p) - laplacian(rho rAU,
p) with its sources; and the thermodynamic closure, rho from p and then p
from rho, in every corrector.
"""

from __future__ import annotations

import time as _time

import torch

from ..fields.bcs import make_bc
from ..fields.field import Dimensioned, SurfaceField, VolField
from ..linalg.solvers import solve
from ..ops import fvc, fvm
from ..utils.dimensions import DimensionSet, dim_density
from ..utils.logging import ExecutionTimer, info, log_courant, log_solve
from .case import Case
from .controls import PimpleControl
from .icofoam import courant_number
from .interfoam import read_constants

_PSI = DimensionSet.of(0, -2, 2)
_DIM_MU = DimensionSet.of(1, -1, -1)


class Barotropic:
    """thermodynamicProperties' barotropic constants: psil, rholSat,
    psiv, pSat and rhoMin, with rhovSat = psiv pSat and rhol0 = rholSat -
    pSat psil."""

    def __init__(self, td):
        def value(key):
            return Dimensioned.from_entry(td.lookup(key, required=True)).value
        self.psil, self.rhol_sat = value("psil"), value("rholSat")
        self.psiv, self.p_sat = value("psiv"), value("pSat")
        self.rho_min = value("rhoMin")
        self.rhov_sat = self.psiv * self.p_sat
        self.rhol0 = self.rhol_sat - self.p_sat * self.psil

    def alphav_psi(self, rho):
        """alphavPsi.H: (alphav, psi) of densities rho."""
        av = torch.clamp((rho - self.rhol_sat)
                         / (self.rhov_sat - self.rhol_sat), 0.0, 1.0)
        return av, av * self.psiv + (1.0 - av) * self.psil

    def closure(self, p, av, psi):
        """pEqn.H's thermodynamic closure: rho from p (bounded by rhoMin),
        the barotropic state of that rho, then p from it. Returns (rho,
        alphav, psi, p)."""
        rho = torch.clamp(
            psi * p + (1.0 - av) * self.rhol0
            + ((av * self.psiv + (1.0 - av) * self.psil) - psi) * self.p_sat,
            min=self.rho_min)
        av, psi = self.alphav_psi(rho)
        p = (rho - (1.0 - av) * self.rhol0
             - ((av * self.psiv + (1.0 - av) * self.psil) - psi)
             * self.p_sat) / psi
        return rho, av, psi, p


def initial_rho(case: Case, p: VolField, bt: Barotropic) -> VolField:
    """rho from the case's 0/rho, or rhol0 + psil p with zeroGradient on
    every patch that is not empty (rho is solved, so it needs BCs that
    assemble)."""
    if case.field_exists("rho"):
        return case.read_field("rho")
    mesh = case.mesh
    bcs = tuple(make_bc("empty" if pt.is_empty else "zeroGradient", i)
                for i, pt in enumerate(mesh.patches))
    return VolField(bt.rhol0 + bt.psil * p.data,
                    bt.rhol0 + bt.psil * p.bvalues, bcs, dim_density, "rho",
                    tuple({} for _ in mesh.patches))


def make_step(case: Case, bt: Barotropic, consts, ctrl: PimpleControl):
    """step(p, U, rho, phi, dt) -> (p, U, rho, phi, stats); stats:
    u_perf, p_perf (every p solve), co (mean, max), av_max and rho_minmax."""
    case.refuse_second_order_ddt("cavitatingFoam")
    from ..linalg.precompute import attach_solver_layouts
    rho1, rho2, nu1, nu2, _, _ = consts
    mul, muv = rho1 * nu1, rho2 * nu2
    rho_controls = case.solver_controls("rho")
    p_controls = case.solver_controls("p")
    p_final = case.solver_controls("p", final=True)
    u_controls = case.solver_controls("U")
    div_rho = case.div_scheme("div(phi,rho)")
    div_u = case.div_scheme("div(rhoPhi,U)")
    lap_corr = case.laplacian_scheme()
    n_outer, n_corr = ctrl.n_outer, ctrl.n_correctors
    n_non_orth = ctrl.n_non_orth
    mesh = attach_solver_layouts(case.mesh, (p_controls, p_final),
                                 timings=case.setup_seconds)
    psil, psiv, p_sat = bt.psil, bt.psiv, bt.p_sat
    rho_min = bt.rho_min

    def step(p: VolField, U: VolField, rho: VolField, phi: SurfaceField,
             dt):
        U, p, rho = U.store_old(), p.store_old(), rho.store_old()
        av0, psi0 = bt.alphav_psi(rho.old.data)
        psi_old = rho.old.with_calculated_bcs(
            psi0, fvc.boundary_owner_values(mesh, psi0), _PSI,
            "psi0").replace(old=None)
        u_perf = None
        p_perf_all = []
        for outer in range(n_outer):
            # rhoEqn.H, implicit, bounded below by rhoMin
            rho, _ = solve(mesh, fvm.ddt(mesh, rho, dt)
                           + fvm.div(mesh, phi, rho, div_rho),
                           rho_controls, env={"phi": phi})
            rho = rho.replace(data=torch.clamp(rho.data, min=rho_min),
                              bvalues=torch.clamp(rho.bvalues, min=rho_min))
            rho_phi = SurfaceField(
                phi.data * fvc.face_values(mesh, rho, "upwind", phi),
                phi.dims * dim_density, "rhoPhi")

            # alphavPsi.H and the mixture viscosity
            av, psi_d = bt.alphav_psi(rho.data)
            av_b, psi_b = bt.alphav_psi(rho.bvalues)
            mu = rho.with_calculated_bcs(av * muv + (1.0 - av) * mul,
                                         av_b * muv + (1.0 - av_b) * mul,
                                         _DIM_MU, "mu")

            # UEqn.H
            mu_f = Dimensioned("muf", _DIM_MU, fvc.face_values(mesh, mu))
            UEqn = (fvm.ddt(mesh, U, dt, "Euler", coeff=rho)
                    + fvm.div(mesh, rho_phi, U, div_u)
                    - fvm.laplacian(mesh, mu_f, U, lap_corr))
            U, u_perf = solve(mesh, UEqn == (-fvc.grad(mesh, p)), u_controls)

            # pEqn.H
            for corr in range(n_corr):
                rho_f = fvc.face_values(mesh, rho)
                UEqn_c = UEqn.replace(psi=U)
                rAU = 1.0 / UEqn_c.A(mesh)
                rho_rau_f = fvc.face_values(mesh, rho * rAU)
                HbyA = fvc.constrain_hbya(mesh, rAU * UEqn_c.H(mesh), U)
                phi_gradp = rho_rau_f * mesh.mag_sf \
                    * fvc.sn_grad(mesh, p).data
                phi_v = SurfaceField(
                    fvc.flux(mesh, HbyA).data - phi_gradp / rho_f,
                    phi.dims, "phi")
                psi_f = rho.with_calculated_bcs(
                    psi_d, psi_b, _PSI, "psi").replace(old=psi_old)
                ddt_av = (av - av0) / dt
                ddt_psi = (psi_d - psi0) / dt
                for north in range(n_non_orth + 1):
                    final = (outer == n_outer - 1 and corr == n_corr - 1
                             and north == n_non_orth)
                    pEqn = fvm.ddt(mesh, p, dt, "Euler", coeff=psi_f) \
                        - fvm.laplacian(
                            mesh, Dimensioned(
                                "rhorAUf", dim_density * rAU.dims,
                                rho_rau_f), p, lap_corr)
                    rhs = p.with_calculated_bcs(
                        (bt.rhol0 + (psil - psiv) * p_sat) * ddt_av
                        + p_sat * ddt_psi
                        - fvc.div(mesh, phi_v, rho, div_rho).data
                        - fvc.div(mesh, SurfaceField(
                            phi_gradp, phi.dims * dim_density,
                            "phiGradp")).data,
                        torch.zeros_like(p.bvalues),
                        dim_density / DimensionSet.of(0, 0, 1))
                    pEqn = pEqn.equals(rhs)
                    p, p_perf = solve(mesh, pEqn,
                                      p_final if final else p_controls)
                    p_perf_all.append(p_perf[0])
                # -laplacian is inside the matrix: its flux is added
                # (reference: cavitatingFoam pEqn.H)
                flux_p = pEqn.replace(psi=p).flux(mesh)
                phi = SurfaceField(
                    phi_v.data + (phi_gradp + flux_p.data) / rho_f,
                    phi.dims, "phi")

                rho_d, av, psi_d, p_d = bt.closure(p.data, av, psi_d)
                av_b, psi_b = bt.alphav_psi(rho.bvalues)
                rho = rho.replace(data=rho_d)
                p = p.replace(data=p_d).correct_boundary_conditions(mesh)
                U_star = HbyA - rAU * fvc.grad(mesh, p)
                U = U.replace(data=U_star.data) \
                    .correct_boundary_conditions(mesh)

        stats = dict(u_perf=u_perf, p_perf=tuple(p_perf_all),
                     co=courant_number(mesh, phi, dt),
                     av_max=bt.alphav_psi(rho.data)[0].max(),
                     rho_minmax=(rho.data.min(), rho.data.max()))
        return p, U, rho, phi, stats

    return step


def iteration_counts(stats) -> list[tuple[str, int]]:
    """A step's p solves' iterations."""
    return [("p", int(pf[2])) for pf in stats["p_perf"]]


def run(case_dir: str, *, device: torch.device, dtype: torch.dtype,
        write: bool = True, max_steps: int | None = None,
        dym: bool = False, case: Case | None = None):
    """Run cavitatingFoam to endTime or max_steps. Returns (case, p, U,
    rho, phi); case.step_log holds each step's p iteration counts, the
    largest vapour fraction and rho's range. dym=True (cavitatingDyMFoam)
    raises: the dynamic mesh is not ported."""
    if dym:
        raise NotImplementedError(
            "cavitatingDyMFoam (dym=True) needs the dynamic mesh, which is "
            "not ported (ROADMAP Queue 1 item 8)")
    if case is None:
        case = Case(case_dir, device=device, dtype=dtype)
    bt = Barotropic(case.constant_dict("thermodynamicProperties"))
    info(f"Barotropic cavitation: pSat={bt.p_sat} rholSat={bt.rhol_sat} "
         f"psil={bt.psil} psiv={bt.psiv}\n")
    p = case.read_field("p")
    U = case.read_field("U")
    rho = initial_rho(case, p, bt)
    phi = fvc.flux(case.mesh, U)
    step = make_step(case, bt, read_constants(case), PimpleControl(case))
    p_solver = case.solver_controls("p").solver
    timer = ExecutionTimer()
    case.step_log = []

    info("\nStarting time loop\n")
    n = 0
    while case.time.loop():
        t0 = _time.perf_counter()
        info(f"Time = {case.time.name}\n")
        p, U, rho, phi, stats = step(p, U, rho, phi, case.time.delta_t)
        co = tuple(float(c) for c in stats["co"])
        log_courant(*co)
        rmn, rmx = (float(r) for r in stats["rho_minmax"])
        av_max = float(stats["av_max"])
        info(f"max-min rho: {rmx:.6g} {rmn:.6g}  max alphav: {av_max:.6g}")
        for perf in stats["p_perf"]:
            log_solve(p_solver, "p", *perf)
        case.step_seconds.append(_time.perf_counter() - t0)
        case.step_log.append(dict(co=co, av_max=av_max, rho=(rmn, rmx),
                                  iterations=iteration_counts(stats)))
        timer.log()
        if write and case.time.write_time():
            case.write_fields([p, U, rho.replace(name="rho")])
        n += 1
        if max_steps and n >= max_steps:
            break
    info("End\n")
    return case, p, U, rho, phi


def main(argv=None):
    import argparse

    from .. import resolve_device, solver_dtype
    ap = argparse.ArgumentParser(
        description="cavitatingFoam (rapidcfd_tpu_torch)")
    ap.add_argument("-case", dest="case", default=".")
    ap.add_argument("-noWrite", action="store_true")
    ap.add_argument("-device", default="cuda")
    ap.add_argument("-precision", choices=["fp32", "fp64"], default=None)
    args = ap.parse_args(argv)
    run(args.case, device=resolve_device(args.device),
        dtype=solver_dtype("cavitatingFoam", args.precision),
        write=not args.noWrite)


if __name__ == "__main__":
    main()
