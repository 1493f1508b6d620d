"""icoFoam — transient incompressible laminar solver, PISO (port of
rapidcfd_tpu/solvers/icofoam.py; reference: applications/solvers/
incompressible/icoFoam/icoFoam.C:36-117).

One timestep is the momentum predictor, nCorrectors pressure-velocity
corrections and their Krylov solves, run eagerly on the case's device;
the host loop advances the clock, logs residuals in OpenFOAM format and
writes checkpoints.
"""

from __future__ import annotations

import time as _time

import torch

from ..fields.field import Dimensioned, SurfaceField, VolField
from ..linalg.solvers import gmax, gsum, solve
from ..ops import fvc, fvm
from ..utils.logging import (ExecutionTimer, info, log_continuity,
                             log_courant, log_solve)
from .case import Case


def courant_number(mesh, phi: SurfaceField, dt):
    """CourantNo.H: Co = 0.5*dt*sum|phi|/V."""
    sum_phi = fvc.surface_sum_faces(mesh, torch.abs(phi.data), signed=False)
    per_cell = 0.5 * sum_phi / mesh.V * dt
    return gsum(per_cell * mesh.V) / gsum(mesh.V), gmax(per_cell)


def continuity_errors(mesh, phi: SurfaceField):
    """continuityErrs.H: local/global mass-conservation error."""
    cont = fvc.div(mesh, phi)
    return (gsum(torch.abs(cont.data) * mesh.V),
            gsum(cont.data * mesh.V))


def piso_step(mesh, U: VolField, p: VolField, phi: SurfaceField, dt, nu,
              *, div_scheme, lap_corr, u_controls, p_controls,
              p_final_controls, n_correctors: int, n_non_orth: int,
              p_ref_cell, p_ref_value, p_ref_weight=1.0):
    """One PISO timestep."""
    U = U.store_old()
    env = {"phi": phi, "dt": dt}

    # momentum predictor (UEqn.H)
    UEqn = (fvm.ddt(mesh, U, dt)
            + fvm.div(mesh, phi, U, div_scheme, env)
            - fvm.laplacian(mesh, nu, U, lap_corr, env))
    U, u_perf = solve(mesh, UEqn == (-fvc.grad(mesh, p)), u_controls,
                      env=env)

    p_perf_all = []
    for corr in range(n_correctors):
        UEqn_c = UEqn.replace(psi=U)
        rAU = 1.0 / UEqn_c.A(mesh)
        HbyA = fvc.constrain_hbya(mesh, rAU * UEqn_c.H(mesh), U)
        phi_hbya = fvc.flux(mesh, HbyA)

        p_new = p
        for north in range(n_non_orth + 1):
            final = (corr == n_correctors - 1) and (north == n_non_orth)
            pEqn = fvm.laplacian(mesh, rAU, p_new, lap_corr) \
                == fvc.div(mesh, phi_hbya)
            pEqn = pEqn.set_reference(p_ref_cell, p_ref_value, p_ref_weight)
            p_new, p_perf = solve(
                mesh, pEqn, p_final_controls if final else p_controls)
            p_perf_all.append(p_perf[0])
        p = p_new

        phi = phi_hbya - pEqn.replace(psi=p).flux(mesh)
        U_star = HbyA - rAU * fvc.grad(mesh, p)
        env = dict(env, phi=phi)
        U = U.replace(data=U_star.data).correct_boundary_conditions(
            mesh, env=env)

    stats = dict(u_perf=u_perf, p_perf=tuple(p_perf_all),
                 cont=continuity_errors(mesh, phi),
                 co=courant_number(mesh, phi, dt))
    return U, p, phi, stats


def make_step(case: Case, nu, n_correctors: int, n_non_orth: int,
              p_ref_cell: int, p_ref_value: float):
    """step(U, p, phi, dt) -> (U, p, phi, stats) on the case's mesh."""
    mesh = case.mesh
    kw = dict(
        div_scheme=case.div_scheme("div(phi,U)"),
        lap_corr=case.laplacian_scheme(),
        u_controls=case.solver_controls("U"),
        p_controls=case.solver_controls("p"),
        p_final_controls=case.solver_controls("p", final=True),
        n_correctors=n_correctors, n_non_orth=n_non_orth,
        p_ref_cell=p_ref_cell, p_ref_value=p_ref_value)

    def step(U, p, phi, dt):
        from ..ops.interpolation import set_current_dt
        set_current_dt(dt)
        return piso_step(mesh, U, p, phi, dt, nu, **kw)

    return step


def run(case_dir: str, *, device: torch.device, dtype: torch.dtype,
        write: bool = True, max_steps: int | None = None):
    """Run icoFoam on a case directory. Returns (case, U, p, phi);
    case.step_seconds holds the wall time of each step (host clock; each
    step ends in a device sync when its residuals are logged)."""
    case = Case(case_dir, device=device, dtype=dtype)
    mesh = case.mesh
    if case.control_dict.lookup("functions"):
        raise NotImplementedError("functionObjects are not ported yet")
    nu = Dimensioned.from_entry(
        case.transport_properties().lookup("nu", required=True), "nu")

    piso = case.algo_dict("PISO")
    n_correctors = int(piso.scalar("nCorrectors", 1))
    n_non_orth = int(piso.scalar("nNonOrthogonalCorrectors", 0))
    p_ref_cell = int(piso.scalar("pRefCell", 0))
    p_ref_value = float(piso.scalar("pRefValue", 0.0))

    info("Reading transportProperties\n\nReading field p\n")
    p = case.read_field("p")
    info("Reading field U\n")
    U = case.read_field("U")
    info("Reading/calculating face flux field phi\n")
    if case.field_exists("phi"):
        from ..fields.io import read_surface_field
        phi = read_surface_field(case.dir, case.time.name, "phi", mesh,
                                 case.maps)
    else:
        phi = fvc.flux(mesh, U)

    step = make_step(case, nu, n_correctors, n_non_orth,
                     p_ref_cell, p_ref_value)
    u_solver = case.solver_controls("U").solver
    p_solver = case.solver_controls("p").solver
    timer = ExecutionTimer()
    cumulative_err = 0.0

    info("\nStarting time loop\n")
    n = 0
    while case.time.loop():
        t0 = _time.perf_counter()
        info(f"Time = {case.time.name}\n")
        U, p, phi, stats = step(U, p, phi, case.time.delta_t)

        log_courant(*stats["co"])
        for cmpt, perf in zip("xyz", stats["u_perf"]):
            log_solve(u_solver, f"U{cmpt}", *perf)
        for perf in stats["p_perf"]:
            log_solve(p_solver, "p", *perf)
        local_err, glob_err = stats["cont"]
        cumulative_err += float(glob_err)
        log_continuity(cumulative_err, local_err, glob_err)
        case.step_seconds.append(_time.perf_counter() - t0)
        timer.log()

        if write and case.time.write_time():
            from ..fields.io import write_surface_field
            write_surface_field(phi, case.dir, case.time.name, mesh,
                                case.maps)
            case.write_fields([U, p])
        n += 1
        if max_steps and n >= max_steps:
            break

    info("End\n")
    return case, U, p, phi

