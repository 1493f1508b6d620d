"""simpleFoam — steady incompressible RANS solver, SIMPLE (port of
rapidcfd_tpu/solvers/simplefoam.py:28-230; reference: applications/
solvers/incompressible/simpleFoam/simpleFoam.C:40-78 with UEqn.H and
pEqn.H).

One SIMPLE iteration is the relaxed momentum predictor, the pressure
equation with its non-orthogonal correctors, the explicit relaxation of
p, the momentum correction and the turbulence model's correct(), run
eagerly on the case's device; the host loop checks residualControl,
logs residuals in OpenFOAM format and writes time directories.
"""

from __future__ import annotations

import time as _time

import torch

from ..fields.field import SurfaceField, VolField
from ..linalg.solvers import solve
from ..models.fvoptions import FvOptions
from ..models.transport import SinglePhaseTransportModel
from ..models.turbulence import make_ras_model
from ..ops import fvc, fvm
from ..utils.logging import ExecutionTimer, info, log_continuity, log_solve
from .case import Case
from .controls import SimpleControl
from .icofoam import continuity_errors


def relax_field(new: VolField, prev: VolField, alpha: float) -> VolField:
    """Explicit field under-relaxation (GeometricField::relax)."""
    if alpha <= 0 or alpha >= 1.0 - 1e-12:
        return new
    return new.replace(
        data=prev.data + alpha * (new.data - prev.data),
        bvalues=prev.bvalues + alpha * (new.bvalues - prev.bvalues))


def div_dev_reff(mesh, nu_eff, U: VolField, lap_corr: str):
    """turbulence->divDevReff(U) (reference: RASModel::divDevReff):
    -laplacian(nuEff, U) - div(nuEff*dev(T(grad U))). On gdia meshes the
    explicit part is the fused div_dev_t_grad (shift-MAC kernel, C = 3
    and C = 1); on ELL meshes the generic grad -> tensor -> div chain."""
    m = -fvm.laplacian(mesh, nu_eff, U, lap_corr)
    if mesh.gdia is not None:
        expl = fvc.div_dev_t_grad(mesh, U, nu_eff)
    else:
        expl = fvc.div_tensor(mesh, fvc.dev_transpose_grad(mesh, U) * nu_eff)
    return m.equals(expl)


def simple_step(mesh, U: VolField, p: VolField, phi: SurfaceField,
                turb_state, *, transport, turb, fv_options, div_u,
                lap_corr, u_controls, p_controls, u_relax, p_relax,
                n_non_orth, p_ref_cell, p_ref_value):
    """One SIMPLE iteration."""
    nu = transport.nu(mesh, U)
    nu_eff = turb.nu_eff(mesh, turb_state, nu)

    # momentum predictor (UEqn.H)
    UEqn = fvm.div(mesh, phi, U, div_u) \
        + div_dev_reff(mesh, nu_eff, U, lap_corr)
    UEqn = fv_options(mesh, "U", UEqn, {"nu": nu})
    UEqn = UEqn.relax(mesh, u_relax)
    UEqn = fv_options.constrain(mesh, "U", UEqn)
    U, u_perf = solve(mesh, UEqn == (-fvc.grad(mesh, p)), u_controls,
                      env={"phi": phi})

    # pressure equation (pEqn.H)
    UEqn_c = UEqn.replace(psi=U)
    rAU = 1.0 / UEqn_c.A(mesh)
    HbyA = fvc.constrain_hbya(mesh, rAU * UEqn_c.H(mesh), U)
    phi_hbya = fvc.adjust_phi(mesh, fvc.flux(mesh, HbyA), U)

    p_prev = p
    p_perf_all = []
    for _ in range(n_non_orth + 1):
        pEqn = fvm.laplacian(mesh, rAU, p, lap_corr) \
            == fvc.div(mesh, phi_hbya)
        pEqn = pEqn.set_reference(p_ref_cell, p_ref_value)
        p, p_perf = solve(mesh, pEqn, p_controls)
        p_perf_all.append(p_perf[0])
    phi = phi_hbya - pEqn.replace(psi=p).flux(mesh)
    cont = continuity_errors(mesh, phi)

    # explicit relaxation of p, then the momentum correction
    p = relax_field(p, p_prev, p_relax)
    U_star = HbyA - rAU * fvc.grad(mesh, p)
    U = U.replace(data=U_star.data).correct_boundary_conditions(
        mesh, env={"phi": phi})

    turb_state, turb_perf = turb.correct(mesh, turb_state, U, phi, nu)
    stats = dict(u_perf=u_perf, p_perf=tuple(p_perf_all), turb=turb_perf,
                 cont=cont)
    return U, p, phi, turb_state, stats


def iteration_counts(stats) -> list[tuple[str, int]]:
    """A SIMPLE iteration's linear-solver iterations from its stats, in
    the order simpleFoam logs the solves: Ux, Uy, Uz, p (each
    corrector), then the turbulence fields by name."""
    its = [(f"U{c}", int(pf[2])) for c, pf in zip("xyz", stats["u_perf"])]
    its += [("p", int(pf[2])) for pf in stats["p_perf"]]
    return its + [(k, int(pf[2])) for k, pf in sorted(stats["turb"].items())]


def step_kwargs_from_case(case: Case, simple: SimpleControl, transport,
                          turb) -> dict:
    """The solver configuration simple_step takes. pRefCell is a cell
    label of the mesh as written (file order), mapped to its device row
    here."""
    return dict(
        transport=transport, turb=turb, fv_options=FvOptions(case),
        div_u=case.div_scheme("div(phi,U)"),
        lap_corr=case.laplacian_scheme(),
        u_controls=case.solver_controls("U"),
        p_controls=case.solver_controls("p"),
        u_relax=case.relaxation_factor("U", "equations", 0.0),
        p_relax=case.relaxation_factor("p", "fields", 0.0),
        n_non_orth=simple.n_non_orth,
        p_ref_cell=case.maps.device_cell(simple.p_ref_cell),
        p_ref_value=simple.p_ref_value)


def make_step(case: Case, transport, turb, simple: SimpleControl):
    """step(U, p, phi, turb_state) -> (U, p, phi, turb_state, stats) on
    the case's mesh (an ELL mesh gets its GAMG hierarchy here; a gdia
    mesh builds its structured levels in each solve)."""
    from ..linalg.precompute import attach_solver_layouts
    kw = step_kwargs_from_case(case, simple, transport, turb)
    mesh = attach_solver_layouts(
        case.mesh, (kw["u_controls"], kw["p_controls"]),
        timings=case.setup_seconds)

    def step(U, p, phi, turb_state):
        return simple_step(mesh, U, p, phi, turb_state, **kw)

    return step


def run(case_dir: str, *, device: torch.device, dtype: torch.dtype,
        write: bool = True, max_steps: int | None = None):
    """Run simpleFoam on a case directory until residualControl is met,
    endTime or max_steps. Returns (case, U, p, phi, turb_state);
    case.step_seconds holds the wall time of each iteration (host clock;
    each ends in a device sync when its residuals are logged)."""
    case = Case(case_dir, device=device, dtype=dtype)
    if case.control_dict.lookup("functions"):
        raise NotImplementedError("functionObjects are not ported yet")
    mesh = case.mesh

    info("Reading field p\n\nReading field U\n")
    p = case.read_field("p")
    U = case.read_field("U")
    phi = fvc.flux(mesh, U)

    transport = SinglePhaseTransportModel(case.transport_properties())
    turb = make_ras_model(case, U)
    turb_state = turb.init_state(U)
    simple = SimpleControl(case)

    step = make_step(case, transport, turb, simple)
    timer = ExecutionTimer()
    cumulative_err = 0.0
    u_solver = case.solver_controls("U").solver
    p_solver = case.solver_controls("p").solver

    info("\nStarting time loop\n")
    n = 0
    initial_residuals = None
    while simple.loop(initial_residuals):
        t0 = _time.perf_counter()
        info(f"Time = {case.time.name}\n")
        U, p, phi, turb_state, stats = step(U, p, phi, turb_state)

        initial_residuals = {}
        for cmpt, perf in zip("xyz", stats["u_perf"]):
            log_solve(u_solver, f"U{cmpt}", *perf)
            initial_residuals[f"U{cmpt}"] = float(perf[0])
        initial_residuals["U"] = max(float(pf[0]) for pf in stats["u_perf"])
        for perf in stats["p_perf"]:
            log_solve(p_solver, "p", *perf)
        initial_residuals["p"] = float(stats["p_perf"][0][0])
        # in name order, as the JAX package logs them (its jitted step
        # returns the dict with sorted keys)
        for name, perf in sorted(stats["turb"].items()):
            log_solve(case.solver_controls(name).solver, name, *perf)
            initial_residuals[name] = float(perf[0])
        local_err, glob_err = stats["cont"]
        cumulative_err += float(glob_err)
        log_continuity(cumulative_err, local_err, glob_err)
        case.step_seconds.append(_time.perf_counter() - t0)
        timer.log()

        if write and case.time.write_time():
            case.write_fields([U, p] + list(turb_state.values()))
        n += 1
        if max_steps and n >= max_steps:
            break

    if write:
        case.write_fields([U, p] + list(turb_state.values()))
    info("End\n")
    return case, U, p, phi, turb_state
