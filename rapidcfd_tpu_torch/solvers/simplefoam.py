"""simpleFoam — steady incompressible RANS solver, SIMPLE (port of
rapidcfd_tpu/solvers/simplefoam.py:28-230; reference: applications/
solvers/incompressible/simpleFoam/simpleFoam.C:40-78 with UEqn.H and
pEqn.H).

One SIMPLE iteration is the relaxed momentum predictor, the pressure
equation with its non-orthogonal correctors, the explicit relaxation of
p, the momentum correction and the turbulence model's correct(), run
eagerly on the case's device; the host loop checks residualControl,
logs residuals in OpenFOAM format and writes time directories.
SRFSimpleFoam (solvers/srffoam.py) is this run with the case's SRFModel.
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
from ..postprocess import FunctionObjectList
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


def div_dev_reff(mesh, nu_eff, U: VolField, lap_corr: str,
                 nl_stress: VolField | None = None):
    """turbulence->divDevReff(U) (port of rapidcfd_tpu/solvers/
    simplefoam.py:37-74; reference: RASModel::divDevReff):
    -laplacian(nuEff, U) - div(nuEff*dev(T(grad U))). On gdia meshes the
    explicit part is the fused div_dev_t_grad (shift-MAC kernel, C = 3
    and C = 1); on ELL meshes the generic grad -> tensor -> div chain.
    nl_stress is a model's explicit nonlinear Reynolds stress (LienCubicKE,
    the scale-similarity family): its divergence (fvc.div_tensor, the
    C = 1 kernel on gdia) leaves the source."""
    m = -fvm.laplacian(mesh, nu_eff, U, lap_corr)
    if mesh.gdia is not None:
        expl = fvc.div_dev_t_grad(mesh, U, nu_eff)
    else:
        expl = fvc.div_tensor(mesh, fvc.dev_transpose_grad(mesh, U) * nu_eff)
    if nl_stress is not None:
        expl = expl - fvc.div_tensor(mesh, nl_stress)
    return m.equals(expl)


def turb_nl_stress(turb, mesh, turb_state, U):
    """A model's nonlinear_stress(mesh, state, U), None for the
    eddy-viscosity models (rapidcfd_tpu/solvers/simplefoam.py:77-80)."""
    fn = getattr(turb, "nonlinear_stress", None)
    return fn(mesh, turb_state, U) if fn is not None else None


def simple_step(mesh, U: VolField, p: VolField, phi: SurfaceField,
                turb_state, *, transport, turb, fv_options, div_u,
                lap_corr, u_controls, p_controls, u_relax, p_relax,
                n_non_orth, p_ref_cell, p_ref_value, u_source=None):
    """One SIMPLE iteration. u_source: (mesh, U) -> (n, 3) acceleration
    on the momentum LHS (SRFSimpleFoam's `+ SRF->Su()`)."""
    nu = transport.nu(mesh, U)
    nu_eff = turb.nu_eff(mesh, turb_state, nu)

    # momentum predictor (UEqn.H)
    UEqn = fvm.div(mesh, phi, U, div_u) \
        + div_dev_reff(mesh, nu_eff, U, lap_corr,
                       turb_nl_stress(turb, mesh, turb_state, U))
    if u_source is not None:
        UEqn = UEqn.replace(
            source=UEqn.source - mesh.V[:, None] * u_source(mesh, U))
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


def hook_fields(mesh, transport, turb, U, p, phi, turb_state) -> dict:
    """The fields a step hands its function objects, as the JAX package's
    simpleFoam, pimpleFoam and pisoFoam do (rapidcfd_tpu/solvers/
    pimplefoam.py:174-180): U, p, phi, the turbulence state, nu (where it
    is a field) and nuEff."""
    nu = transport.nu(mesh, U)
    extra = dict(turb_state)
    extra["nu"] = nu if hasattr(nu, "bvalues") else None
    extra["nuEff"] = turb.nu_eff(mesh, turb_state, nu)
    return {"U": U, "p": p, "phi": phi,
            **{k: v for k, v in extra.items() if v is not None}}


def written_fields(mesh, U, p, turb_state, srf=None) -> list:
    """The fields a write time writes: U, p (and Uabs under an SRFModel),
    then the turbulence state."""
    extra = [] if srf is None else [srf.u_abs(mesh, U)]
    return [U, p] + extra + list(turb_state.values())


def iteration_counts(stats) -> list[tuple[str, int]]:
    """A SIMPLE iteration's or a pimpleFoam timestep's linear-solver
    iterations from its stats, in the order the solves are logged: Ux,
    Uy, Uz, p (each corrector), then the turbulence fields by name."""
    its = [(f"U{c}", int(pf[2])) for c, pf in zip("xyz", stats["u_perf"])]
    its += [("p", int(pf[2])) for pf in stats["p_perf"]]
    return its + [(k, int(pf[2])) for k, pf in sorted(stats["turb"].items())]


def step_kwargs_from_case(case: Case, simple: SimpleControl, transport,
                          turb, u_source=None, u_name: str = "U") -> dict:
    """The solver configuration simple_step takes. pRefCell is a cell
    label of the mesh as written (file order), mapped to its device row
    here. u_name: the velocity's fvSolution/fvSchemes name (Urel in
    SRFSimpleFoam)."""
    return dict(
        transport=transport, turb=turb, fv_options=FvOptions(case),
        div_u=case.div_scheme(f"div(phi,{u_name})"),
        lap_corr=case.laplacian_scheme(),
        u_controls=case.solver_controls(u_name),
        p_controls=case.solver_controls("p"),
        u_relax=case.relaxation_factor(u_name, "equations", 0.0),
        p_relax=case.relaxation_factor("p", "fields", 0.0),
        n_non_orth=simple.n_non_orth,
        p_ref_cell=case.maps.device_cell(simple.p_ref_cell),
        p_ref_value=simple.p_ref_value, u_source=u_source)


def make_step(case: Case, transport, turb, simple: SimpleControl,
              u_source=None, u_name: str = "U"):
    """step(U, p, phi, turb_state) -> (U, p, phi, turb_state, stats) on
    the case's mesh (an ELL mesh gets its GAMG hierarchy here; a gdia
    mesh builds its structured levels in each solve); u_source and u_name
    as in step_kwargs_from_case and simple_step."""
    from ..linalg.precompute import attach_solver_layouts
    kw = step_kwargs_from_case(case, simple, transport, turb, u_source,
                               u_name)
    mesh = attach_solver_layouts(
        case.mesh, (kw["u_controls"], kw["p_controls"]),
        timings=case.setup_seconds)

    def step(U, p, phi, turb_state):
        return simple_step(mesh, U, p, phi, turb_state, **kw)

    return step


def refuse_srf_functions(case: Case, solver: str):
    """The JAX package runs no function objects in the SRF solvers."""
    if case.control_dict.lookup("functions"):
        raise NotImplementedError(
            f"{solver}: functionObjects do not run in the SRF solvers (the "
            "JAX package runs none there)")


def run(case_dir: str, *, device: torch.device, dtype: torch.dtype,
        write: bool = True, max_steps: int | None = None,
        case: Case | None = None, srf=None):
    """Run simpleFoam (and porousSimpleFoam: the porosity comes from
    system/fvOptions) on a case directory until residualControl is met,
    endTime or max_steps. `case` passes a Case built already (an
    in-memory mesh, a full box on gdia). Returns (case, U, p, phi,
    turb_state); case.step_seconds holds the wall time of each iteration
    (host clock; each ends in a device sync when its residuals are
    logged) and case.step_log its continuity errors (local, global) and
    iteration_counts. srf: an SRFModel (SRFSimpleFoam): U is the relative
    velocity Urel, with the frame's acceleration on the momentum LHS, and
    Uabs is written beside it."""
    if case is None:
        case = Case(case_dir, device=device, dtype=dtype)
    mesh = case.mesh
    u_name = "U" if srf is None else "Urel"
    if srf is not None:
        refuse_srf_functions(case, "SRFSimpleFoam")

    info(f"Reading field p\n\nReading field {u_name}\n")
    p = case.read_field("p")
    U = case.read_field(u_name)
    if srf is not None:
        U = srf.patch_bcs(mesh, U)
    phi = fvc.flux(mesh, U)

    transport = SinglePhaseTransportModel(case.transport_properties())
    turb = make_ras_model(case, U)
    turb_state = turb.init_state(U)
    simple = SimpleControl(case)

    step = make_step(case, transport, turb, simple,
                     u_source=None if srf is None else srf.su,
                     u_name=u_name)
    timer = ExecutionTimer()
    cumulative_err = 0.0
    u_solver = case.solver_controls(u_name).solver
    p_solver = case.solver_controls("p").solver
    case.step_log = []
    fos = FunctionObjectList(case)

    info("\nStarting time loop\n")
    n = 0
    initial_residuals = None
    while simple.loop(initial_residuals):
        t0 = _time.perf_counter()
        info(f"Time = {case.time.name}\n")
        U, p, phi, turb_state, stats = step(U, p, phi, turb_state)

        initial_residuals = {}
        for cmpt, perf in zip("xyz", stats["u_perf"]):
            log_solve(u_solver, f"{u_name}{cmpt}", *perf)
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
        case.step_log.append(dict(
            cont=(float(local_err), float(glob_err)),
            iterations=iteration_counts(stats)))
        if fos.objects:
            fos.execute(hook_fields(mesh, transport, turb, U, p, phi,
                                    turb_state))
        timer.log()

        if write and case.time.write_time():
            case.write_fields(written_fields(mesh, U, p, turb_state, srf))
        n += 1
        if max_steps and n >= max_steps:
            break

    if write:
        case.write_fields(written_fields(mesh, U, p, turb_state, srf))
    fos.close()
    info("End\n")
    return case, U, p, phi, turb_state
