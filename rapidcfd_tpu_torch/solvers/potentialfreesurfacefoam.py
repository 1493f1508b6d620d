"""potentialFreeSurfaceFoam — single-phase free-surface flow through a
wave-pressure boundary, port of rapidcfd_tpu/solvers/
potentialfreesurfacefoam.py on a static mesh (reference: applications/
solvers/multiphase/potentialFreeSurfaceFoam/potentialFreeSurfaceFoam.C
and waveSurfacePressureFvPatchScalarField.C: updateCoeffs).

The free surface is not meshed: a wave height zeta on each
waveSurfacePressure patch integrates dzeta = dt n phi/|Sf| every step,
and the patch imposes p_gh = -g & zeta; a PIMPLE loop solves U and p_gh.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass

import torch

from ..fields.bcs import FixedValue
from ..fields.field import Dimensioned, SurfaceField, VolField
from ..linalg.solvers import solve
from ..ops import fvc, fvm
from ..utils.logging import (ExecutionTimer, info, log_continuity,
                             log_courant, log_solve)
from ..utils.registry import register
from .buoyantfoam import gravity
from .case import Case
from .controls import PimpleControl
from .icofoam import continuity_errors, courant_number


@register("fvPatchField", "waveSurfacePressure")
@dataclass(frozen=True)
class WaveSurfacePressure(FixedValue):
    """The dynamic free-surface pressure p_gh = -g & zeta: a fixed value
    that the solver refreshes each step from the zeta it integrates."""
    word = "waveSurfacePressure"


def wave_patches(mesh, p_gh: VolField):
    """The patches on which p_gh is a waveSurfacePressure."""
    return [mesh.patches[bc.patch] for bc in p_gh.bcs
            if isinstance(bc, WaveSurfacePressure)]


def update_zeta(mesh, p_gh: VolField, phi: SurfaceField, zeta, dt, g):
    """waveSurfacePressure's updateCoeffs, Euler form: zeta += dt n
    phi/|Sf| on each wave patch (zeta (nBoundary, 3), indexed by bstart),
    then p_gh = -g & zeta written into the patch value. Returns (p_gh with
    its boundary values evaluated, zeta)."""
    zeta = zeta.clone()
    bcdata = list(p_gh.bcdata)
    for i, bc in enumerate(p_gh.bcs):
        if not isinstance(bc, WaveSurfacePressure):
            continue
        p = mesh.patches[bc.patch]
        bsl = slice(p.bstart, p.bstart + p.size)
        flux = phi.data[p.start:p.start + p.size]
        zeta[bsl] = zeta[bsl] + (dt * flux / torch.clamp(
            mesh.patch_mag_sf(p), min=1e-30))[:, None] * mesh.patch_normals(p)
        bcdata[i] = dict(bcdata[i], value=-(zeta[bsl] * g).sum(-1))
    p_gh = p_gh.replace(bcdata=tuple(bcdata)) \
        .correct_boundary_conditions(mesh)
    return p_gh, zeta


def make_step(case: Case, ctrl: PimpleControl):
    """step(U, p_gh, phi, zeta, dt) -> (U, p_gh, phi, zeta, stats);
    stats: u_perf, p_perf (every p_gh solve), cont (local, global), co
    (mean, max) and zeta_max."""
    case.refuse_second_order_ddt("potentialFreeSurfaceFoam")
    from ..linalg.precompute import attach_solver_layouts
    nu = Dimensioned.from_entry(
        case.transport_properties().lookup("nu", required=True), "nu")
    div_u = case.div_scheme("div(phi,U)")
    lap_corr = case.laplacian_scheme()
    u_controls = case.solver_controls("U")
    p_controls = case.solver_controls("p_gh")
    p_final = case.solver_controls("p_gh", final=True)
    n_outer, n_corr = ctrl.n_outer, ctrl.n_correctors
    n_non_orth = ctrl.n_non_orth
    p_ref_cell = case.maps.device_cell(ctrl.p_ref_cell)
    p_ref_value = ctrl.p_ref_value
    mesh = attach_solver_layouts(case.mesh, (p_controls, p_final),
                                 timings=case.setup_seconds)
    g = torch.tensor(gravity(case), dtype=mesh.dtype, device=mesh.device)

    def step(U: VolField, p_gh: VolField, phi: SurfaceField, zeta, dt):
        U = U.store_old()
        p_gh, zeta = update_zeta(mesh, p_gh, phi, zeta, dt, g)
        u_perf = None
        p_perf_all = []
        for outer in range(n_outer):
            UEqn = (fvm.ddt(mesh, U, dt)
                    + fvm.div(mesh, phi, U, div_u)
                    - fvm.laplacian(mesh, nu, U, lap_corr))
            U, u_perf = solve(mesh, UEqn == (-fvc.grad(mesh, p_gh)),
                              u_controls, env={"phi": phi})
            for corr in range(n_corr):
                UEqn_c = UEqn.replace(psi=U)
                rAU = 1.0 / UEqn_c.A(mesh)
                HbyA = fvc.constrain_hbya(mesh, rAU * UEqn_c.H(mesh), U)
                phi_hbya = fvc.flux(mesh, HbyA)
                for north in range(n_non_orth + 1):
                    final = (outer == n_outer - 1 and corr == n_corr - 1
                             and north == n_non_orth)
                    pEqn = fvm.laplacian(mesh, rAU, p_gh, lap_corr) \
                        == fvc.div(mesh, phi_hbya)
                    pEqn = pEqn.set_reference(p_ref_cell, p_ref_value)
                    p_gh, p_perf = solve(mesh, pEqn,
                                         p_final if final else p_controls)
                    p_perf_all.append(p_perf[0])
                phi = phi_hbya - pEqn.replace(psi=p_gh).flux(mesh)
                U_star = HbyA - rAU * fvc.grad(mesh, p_gh)
                U = U.replace(data=U_star.data) \
                    .correct_boundary_conditions(mesh, env={"phi": phi})

        stats = dict(u_perf=u_perf, p_perf=tuple(p_perf_all),
                     cont=continuity_errors(mesh, phi),
                     co=courant_number(mesh, phi, dt),
                     zeta_max=zeta.abs().max())
        return U, p_gh, phi, zeta, stats

    return step


def iteration_counts(stats) -> list[tuple[str, int]]:
    """A step's linear-solver iterations: U by component, then every p_gh
    solve."""
    return [(f"U{c}", int(pf[2])) for c, pf in zip("xyz", stats["u_perf"])
            ] + [("p_gh", int(pf[2])) for pf in stats["p_perf"]]


def run(case_dir: str, *, device: torch.device, dtype: torch.dtype,
        write: bool = True, max_steps: int | None = None,
        dym: bool = False, case: Case | None = None):
    """Run potentialFreeSurfaceFoam to endTime or max_steps. Returns
    (case, U, p_gh, phi, zeta); case.step_log holds each step's iteration
    counts, Courant numbers and the largest |zeta|. dym=True
    (potentialFreeSurfaceDyMFoam) raises: the dynamic mesh is not
    ported."""
    if dym:
        raise NotImplementedError(
            "potentialFreeSurfaceDyMFoam (dym=True) needs the dynamic mesh, "
            "which is not ported (ROADMAP Queue 1 item 8)")
    if case is None:
        case = Case(case_dir, device=device, dtype=dtype)
    mesh = case.mesh
    U = case.read_field("U")
    p_gh = case.read_field("p_gh")
    phi = fvc.flux(mesh, U)
    zeta = torch.zeros((mesh.n_boundary, 3), dtype=mesh.dtype,
                       device=mesh.device)
    if not wave_patches(mesh, p_gh):
        info("warning: no waveSurfacePressure patch on p_gh\n")
    step = make_step(case, PimpleControl(case))
    u_solver = case.solver_controls("U").solver
    p_solver = case.solver_controls("p_gh").solver
    timer = ExecutionTimer()
    cumulative_err = 0.0
    case.step_log = []

    info("\nStarting time loop\n")
    n = 0
    while case.time.loop():
        t0 = _time.perf_counter()
        info(f"Time = {case.time.name}\n")
        U, p_gh, phi, zeta, stats = step(U, p_gh, phi, zeta,
                                         case.time.delta_t)
        co = tuple(float(c) for c in stats["co"])
        log_courant(*co)
        for cmpt, perf in zip("xyz", stats["u_perf"]):
            log_solve(u_solver, f"U{cmpt}", *perf)
        for perf in stats["p_perf"]:
            log_solve(p_solver, "p_gh", *perf)
        zeta_max = float(stats["zeta_max"])
        info(f"max|zeta| = {zeta_max:.6g}")
        local_err, glob_err = (float(e) for e in stats["cont"])
        cumulative_err += glob_err
        log_continuity(cumulative_err, local_err, glob_err)
        case.step_seconds.append(_time.perf_counter() - t0)
        case.step_log.append(dict(co=co, zeta_max=zeta_max,
                                  iterations=iteration_counts(stats)))
        timer.log()
        if write and case.time.write_time():
            case.write_fields([U, p_gh])
        n += 1
        if max_steps and n >= max_steps:
            break
    info("End\n")
    return case, U, p_gh, phi, zeta


def main(argv=None):
    import argparse

    from .. import resolve_device, solver_dtype
    ap = argparse.ArgumentParser(
        description="potentialFreeSurfaceFoam (rapidcfd_tpu_torch)")
    ap.add_argument("-case", dest="case", default=".")
    ap.add_argument("-noWrite", action="store_true")
    ap.add_argument("-device", default="cuda")
    ap.add_argument("-precision", choices=["fp32", "fp64"], default=None)
    args = ap.parse_args(argv)
    run(args.case, device=resolve_device(args.device),
        dtype=solver_dtype("potentialFreeSurfaceFoam", args.precision),
        write=not args.noWrite)


if __name__ == "__main__":
    main()
