"""The basic solvers: laplacianFoam, scalarTransportFoam and potentialFoam
(port of rapidcfd_tpu/solvers/basic.py; reference: applications/solvers/
basic/laplacianFoam.C, scalarTransportFoam.C and potentialFoam.C).

Each step runs eagerly on the case's device; the host loop logs residuals
in OpenFOAM format and writes time directories. Under backward and
CrankNicolson T keeps two old levels (fvm.store_old, as
rapidcfd_tpu/solvers/basic.py:33-39, 80-86 do for CrankNicolson).
"""

from __future__ import annotations

import time as _time

import torch

from ..fields.field import Dimensioned
from ..linalg.solvers import solve
from ..ops import fvc, fvm
from ..utils.logging import ExecutionTimer, info, log_solve
from .case import Case
from .controls import SimpleControl


def _scalar_setup(case_dir, device, dtype, case):
    if case is None:
        case = Case(case_dir, device=device, dtype=dtype)
    if case.control_dict.lookup("functions"):
        raise NotImplementedError("functionObjects are not ported yet")
    DT = Dimensioned.from_entry(
        case.transport_properties().lookup("DT", required=True), "DT")
    return case, case.read_field("T"), DT


def _time_loop(case, step, T, solver: str, write: bool, max_steps):
    """Advance T by step(T, dt) -> (T, perf) to endTime or max_steps,
    logging the T solve and writing T at write times; case.step_seconds
    and case.step_log (iterations) get one entry a step."""
    timer = ExecutionTimer()
    case.step_log = []
    n = 0
    while case.time.loop():
        t0 = _time.perf_counter()
        info(f"Time = {case.time.name}\n")
        T, perf = step(T, case.time.delta_t)
        log_solve(solver, "T", *perf[0])
        case.step_seconds.append(_time.perf_counter() - t0)
        case.step_log.append(dict(iterations=[("T", int(perf[0][2]))]))
        timer.log()
        if write and case.time.write_time():
            case.write_fields([T])
        n += 1
        if max_steps and n >= max_steps:
            break
    info("End\n")
    return T


def run_laplacian_foam(case_dir: str, *, device: torch.device,
                       dtype: torch.dtype, write: bool = True,
                       max_steps: int | None = None,
                       case: Case | None = None):
    """laplacianFoam: ddt(T) - laplacian(DT, T) = 0. Returns (case, T)."""
    case, T, DT = _scalar_setup(case_dir, device, dtype, case)
    mesh = case.mesh
    controls = case.solver_controls("T")
    lap_corr = case.laplacian_scheme()
    ddt_scheme = case.ddt_scheme()
    n_non_orth = SimpleControl(case).n_non_orth

    def step(T, dt):
        T = fvm.store_old(mesh, T, dt, ddt_scheme)
        eqn = fvm.ddt(mesh, T, dt, ddt_scheme) \
            - fvm.laplacian(mesh, DT, T, lap_corr)
        for _ in range(n_non_orth + 1):
            T, perf = solve(mesh, eqn.replace(psi=T), controls)
        return T, perf

    return case, _time_loop(case, step, T, controls.solver, write,
                            max_steps)


def run_scalar_transport_foam(case_dir: str, *, device: torch.device,
                              dtype: torch.dtype, write: bool = True,
                              max_steps: int | None = None,
                              case: Case | None = None):
    """scalarTransportFoam: ddt(T) + div(phi, T) - laplacian(DT, T) = 0
    with the velocity read from the case and frozen. Returns (case, T)."""
    case, T, DT = _scalar_setup(case_dir, device, dtype, case)
    mesh = case.mesh
    phi = fvc.flux(mesh, case.read_field("U"))
    controls = case.solver_controls("T")
    div_scheme = case.div_scheme("div(phi,T)")
    lap_corr = case.laplacian_scheme()
    ddt_scheme = case.ddt_scheme()
    n_non_orth = SimpleControl(case).n_non_orth

    def step(T, dt):
        T = fvm.store_old(mesh, T, dt, ddt_scheme)
        for _ in range(n_non_orth + 1):
            eqn = (fvm.ddt(mesh, T, dt, ddt_scheme)
                   + fvm.div(mesh, phi, T, div_scheme)
                   - fvm.laplacian(mesh, DT, T, lap_corr))
            T, perf = solve(mesh, eqn, controls)
        return T, perf

    return case, _time_loop(case, step, T, controls.solver, write,
                            max_steps)


def run_potential_foam(case_dir: str, *, device: torch.device,
                       dtype: torch.dtype, write: bool = True,
                       n_non_orth: int | None = None,
                       case: Case | None = None):
    """potentialFoam: laplacian(Phi) == div(phi), then U reconstructed
    from the conservative flux. Phi takes the BCs of a Phi field when the
    case has one, else p's. Returns (case, U, phi); case.step_log holds
    the Phi solves' iterations and the continuity error."""
    if case is None:
        case = Case(case_dir, device=device, dtype=dtype)
    mesh = case.mesh
    U = case.read_field("U")
    phi = fvc.flux(mesh, U)
    name = "Phi" if case.field_exists("Phi") else "p"
    Phi = case.read_field(name).replace(name="Phi")
    controls = case.solver_controls(name)
    simple = SimpleControl(case)
    nno = simple.n_non_orth if n_non_orth is None else n_non_orth
    lap_corr = case.laplacian_scheme()
    ref_cell = case.maps.device_cell(simple.p_ref_cell)

    t0 = _time.perf_counter()
    its = []
    for _ in range(nno + 1):
        eqn = fvm.laplacian(mesh, 1.0, Phi, lap_corr) \
            == fvc.div(mesh, phi)
        eqn = eqn.set_reference(ref_cell, simple.p_ref_value)
        Phi, perf = solve(mesh, eqn, controls)
        phi_new = phi - eqn.replace(psi=Phi).flux(mesh)
        log_solve(controls.solver, "Phi", *perf[0])
        its.append(("Phi", int(perf[0][2])))
    U = U.replace(data=fvc.reconstruct(mesh, phi_new).data) \
        .correct_boundary_conditions(mesh)
    err = float((fvc.div(mesh, phi_new).data.abs() * mesh.V).sum())
    info(f"continuity error = {err:.6g}")
    case.step_seconds.append(_time.perf_counter() - t0)
    case.step_log = [dict(iterations=its, cont=err)]
    if write:
        case.write_fields([U])
    info("End\n")
    return case, U, phi_new
