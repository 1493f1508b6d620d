"""multiphaseInterFoam — N incompressible immiscible phases (VOF), port of
rapidcfd_tpu/solvers/multiphaseinterfoam.py on a static mesh (reference:
applications/solvers/multiphase/multiphaseInterFoam/multiphaseMixture/
multiphaseMixture.C: solveAlphas and surfaceTensionForce).

Each of the first N-1 phase fractions is advected with explicit MULES and
the pairwise interface compression phir_ij = phic nHatf(alpha_i,
alpha_j); the last (continuous) phase closes the sum. The momentum mass
flux takes the same limited alpha fluxes, the surface tension is pairwise
(sigma_ij), and the mixture's rho and mu feed one p_rgh system with
interFoam's correctors. Each alpha's gradient is taken once per stage (the
old level for the compression and vanLeer, the new for the surface
tension), where the JAX package takes it once per use; the results are
the same.

The JAX module's note stands: violent free-standing collapses at large
density ratios destabilise faster than in the reference.
"""

from __future__ import annotations

import time as _time

import torch

from ..fields.field import Dimensioned, SurfaceField, VolField
from ..linalg.solvers import gsum, solve
from ..ops import fvc, fvm
from ..ops.mules import explicit_solve
from ..utils.dictionary import Dictionary
from ..utils.dimensions import dim_density
from ..utils.logging import ExecutionTimer, info, log_courant, log_solve
from .buoyantfoam import gravity
from .case import Case
from .controls import PimpleControl
from .icofoam import courant_number
from .interfoam import (_DELTA_N, _DIM_MU, compression_flux,
                        interface_curvature)


def read_phases(tp: Dictionary) -> list[tuple[str, float, float]]:
    """phases ( name { rho ...; nu ...; } ... ) -> [(name, rho, nu)]."""
    items = list(tp.lookup("phases", required=True))
    phases = []
    for name, d in zip(items[::2], items[1::2]):
        rho = Dimensioned.from_entry(d.lookup("rho", required=True)).value
        nu = Dimensioned.from_entry(d.lookup("nu", required=True)).value
        phases.append((str(name), rho, nu))
    return phases


def read_sigmas(tp: Dictionary, names) -> dict[tuple[int, int], float]:
    """sigmas ( (a b) sigma ... ) -> {(i, j): sigma} with i < j."""
    entry = tp.lookup("sigmas")
    if entry is None:
        return {}
    items = list(entry)
    idx = {n: k for k, n in enumerate(names)}
    out = {}
    for pair, sig in zip(items[:-1:2], items[1::2]):
        if not isinstance(sig, (int, float)):
            sig = Dimensioned.from_entry(sig).value
        a, b = idx[str(pair[0])], idx[str(pair[1])]
        out[(min(a, b), max(a, b))] = float(sig)
    return out


def nhatf(mesh, a: VolField, b: VolField, ga_f: torch.Tensor,
          gb_f: torch.Tensor):
    """The pairwise interface normal flux (multiphaseMixture::nHatfv): v =
    b_f grad(a)_f - a_f grad(b)_f, normalised with deltaN and dotted with
    Sf; returns (nHatf, a_f, b_f). ga_f, gb_f: the gradients' face
    values."""
    a_f = fvc.face_values(mesh, a)
    b_f = fvc.face_values(mesh, b)
    v = b_f[:, None] * ga_f - a_f[:, None] * gb_f
    nv = v / (v.norm(dim=-1) + _DELTA_N)[:, None]
    return (nv * mesh.Sf).sum(-1), a_f, b_f


def correct_sum(alphas):
    """alpha += alpha (1 - sum of the alphas), on the cells and the
    boundary faces: the reference's correction of the phase fractions'
    sum against drift (multiphaseMixture.C, solveAlphas). Where the last
    phase closes the sum it changes nothing beyond rounding; where the
    first N-1 phases overshoot 1 together (each is limited alone, and the
    last is clipped to 0) it takes the overshoot back from them. The JAX
    package leaves it out (ROADMAP Queue 3)."""
    s_d = sum(a.data for a in alphas)
    s_b = sum(a.bvalues for a in alphas)
    return [a.replace(data=a.data + a.data * (1.0 - s_d),
                      bvalues=a.bvalues + a.bvalues * (1.0 - s_b))
            for a in alphas]


def _grad_faces(mesh, alphas):
    """(fvc.grad of each alpha, their face values): the K = 5 / 7, C = 3
    shift-MAC kernel once per alpha on gdia meshes."""
    grads = [fvc.grad(mesh, a) for a in alphas]
    return grads, [fvc.face_values(mesh, g) for g in grads]


def make_step(case: Case, phases, sigmas, ctrl: PimpleControl):
    """step(alphas, U, p_rgh, phi, dt) -> (alphas, U, p_rgh, phi, stats);
    stats: p_perf (every p_rgh solve), co (mean, max), fracs (each
    phase's volume) and alpha (each phase's min and max)."""
    case.refuse_second_order_ddt("multiphaseInterFoam")
    from ..linalg.precompute import attach_solver_layouts
    rhos = [p[1] for p in phases]
    nus = [p[2] for p in phases]
    solvers_d = case.fv_solution.subdict("solvers")
    a_entry = solvers_d.lookup("alpha")
    c_alpha = float(a_entry.scalar("cAlpha", 1.0)) \
        if isinstance(a_entry, Dictionary) else 1.0
    lap_corr = case.laplacian_scheme()
    p_controls = case.solver_controls("p_rgh")
    p_final = case.solver_controls("p_rgh", final=True)
    n_corr, n_non_orth = ctrl.n_correctors, ctrl.n_non_orth
    p_ref_cell = case.maps.device_cell(ctrl.p_ref_cell)
    p_ref_value = ctrl.p_ref_value
    mesh = attach_solver_layouts(case.mesh, (p_controls, p_final),
                                 timings=case.setup_seconds)
    n_int = mesh.n_internal
    ghf = (mesh.Cf * torch.tensor(gravity(case), dtype=mesh.dtype,
                                  device=mesh.device)).sum(-1)
    rho_n = rhos[-1]

    def solve_alphas(alphas, phi: SurfaceField, dt):
        """MULES for the first N-1 phases with the pairwise compression,
        each clipped to [0, 1]; the last phase closes the sum, and the sum
        is corrected. Returns (the N alphas, the N-1 limited fluxes)."""
        grads, g_f = _grad_faces(mesh, alphas)
        new_alphas, limited = [], []
        for i, a in enumerate(alphas[:-1]):
            flux_a = phi.data * fvc.face_values(mesh, a, "vanLeer", phi,
                                                g=grads[i])
            for j, b in enumerate(alphas):
                if j == i:
                    continue
                nhf, a_f, b_f = nhatf(mesh, a, b, g_f[i], g_f[j])
                phir = compression_flux(mesh, phi, nhf, c_alpha,
                                        capped=True)
                flux_a = flux_a + phir * a_f * b_f
            a_new, lim = explicit_solve(
                mesh, a, phi, SurfaceField(flux_a, phi.dims, "phiAlpha"), dt)
            new_alphas.append(a_new.replace(
                data=torch.clamp(a_new.data, 0.0, 1.0),
                bvalues=torch.clamp(a_new.bvalues, 0.0, 1.0)))
            limited.append(lim.data)
        last = alphas[-1].replace(
            data=torch.clamp(1.0 - sum(a.data for a in new_alphas), 0.0, 1.0),
            bvalues=torch.clamp(1.0 - sum(a.bvalues for a in new_alphas),
                                0.0, 1.0))
        return correct_sum(new_alphas + [last]), limited

    def surface_tension(alphas) -> torch.Tensor:
        """sum over the sigma pairs of sigma_ij kappa_ij (b_f snGrad(a) -
        a_f snGrad(b)) on every face."""
        _, g_f = _grad_faces(mesh, alphas)
        stf = torch.zeros(mesh.n_faces, dtype=mesh.dtype, device=mesh.device)
        for (i, j), sig in sigmas.items():
            a, b = alphas[i], alphas[j]
            nhf, a_f, b_f = nhatf(mesh, a, b, g_f[i], g_f[j])
            stf = stf + sig * interface_curvature(mesh, nhf) * (
                b_f * fvc.sn_grad(mesh, a).data
                - a_f * fvc.sn_grad(mesh, b).data)
        return stf

    def step(alphas, U: VolField, p_rgh: VolField, phi: SurfaceField, dt):
        U = U.store_old()
        alphas, limited = solve_alphas([a.store_old() for a in alphas],
                                       phi, dt)

        # the mixture; rhoPhi from the limited fluxes (the closure phase
        # carries the remainder): sum_i lim_i (rho_i - rho_N) + phi rho_N
        rho = alphas[0].with_calculated_bcs(
            sum(a.data * r for a, r in zip(alphas, rhos)),
            sum(a.bvalues * r for a, r in zip(alphas, rhos)),
            dim_density, "rho")
        rho_old = sum(a.old.data * r for a, r in zip(alphas, rhos))
        rho = rho.replace(old=alphas[0].with_calculated_bcs(
            rho_old, rho.bvalues, dim_density, "rho").replace(old=None))
        rho_phi_d = phi.data * rho_n
        for lim, r in zip(limited, rhos):
            rho_phi_d = rho_phi_d + lim * (r - rho_n)
        rho_phi = SurfaceField(rho_phi_d, phi.dims * dim_density, "rhoPhi")
        mu = alphas[0].with_calculated_bcs(
            sum(a.data * r * n for a, r, n in zip(alphas, rhos, nus)),
            sum(a.bvalues * r * n for a, r, n in zip(alphas, rhos, nus)),
            _DIM_MU, "mu")
        stf = surface_tension(alphas)

        # UEqn.H (linearUpwind, as the JAX package takes it)
        mu_f = Dimensioned("muf", _DIM_MU, fvc.face_values(mesh, mu))
        UEqn = (fvm.ddt(mesh, U, dt, "Euler", coeff=rho)
                + fvm.div(mesh, rho_phi, U, "linearUpwind")
                - fvm.laplacian(mesh, mu_f, U, lap_corr))

        p_perf_all = []
        for corr in range(n_corr):
            UEqn_c = UEqn.replace(psi=U) if corr else UEqn
            rAU = 1.0 / UEqn_c.A(mesh)
            rAU_f = fvc.face_values(mesh, rAU)
            HbyA = fvc.constrain_hbya(mesh, rAU * UEqn_c.H(mesh), U)
            phig = (stf - ghf * fvc.sn_grad(mesh, rho).data) \
                * rAU_f * mesh.mag_sf
            phig = torch.cat([phig[:n_int], torch.zeros_like(phig[n_int:])])
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

        stats = dict(p_perf=tuple(p_perf_all),
                     co=courant_number(mesh, phi, dt),
                     fracs=tuple(gsum(a.data * mesh.V) for a in alphas),
                     alpha=tuple((a.data.min(), a.data.max())
                                 for a in alphas))
        return alphas, U, p_rgh, phi, stats

    return step


def setup(case: Case):
    """Fields and the step of a case: ((alphas, U, p_rgh, phi), step, the
    phase names)."""
    tp = case.transport_properties()
    phases = read_phases(tp)
    names = [p[0] for p in phases]
    sigmas = read_sigmas(tp, names)
    info(f"Phases: {names}; {len(sigmas)} sigma pairs\n")
    alphas = [case.read_field(f"alpha{n}" if case.field_exists(f"alpha{n}")
                              else f"alpha.{n}") for n in names]
    U = case.read_field("U")
    p_rgh = case.read_field("p_rgh")
    phi = fvc.flux(case.mesh, U)
    step = make_step(case, phases, sigmas, PimpleControl(case))
    return (alphas, U, p_rgh, phi), step, names


def run(case_dir: str, *, device: torch.device, dtype: torch.dtype,
        write: bool = True, max_steps: int | None = None,
        dym: bool = False, case: Case | None = None):
    """Run multiphaseInterFoam to endTime or max_steps. Returns (case,
    alphas, U, p_rgh, phi); case.step_log holds each step's Courant
    numbers, phase volumes and p_rgh iteration counts. dym=True
    (multiphaseInterDyMFoam) raises: the dynamic mesh is not ported."""
    if dym:
        raise NotImplementedError(
            "multiphaseInterDyMFoam (dym=True) needs the dynamic mesh, which "
            "is not ported (ROADMAP Queue 1 item 8)")
    if case is None:
        case = Case(case_dir, device=device, dtype=dtype)
    (alphas, U, p_rgh, phi), step, names = setup(case)
    mesh = case.mesh
    p_solver = case.solver_controls("p_rgh").solver
    v_total = float(mesh.V.sum())
    timer = ExecutionTimer()
    case.step_log = []

    info("\nStarting time loop\n")
    n = 0
    co_max_prev = 0.0
    t = case.time
    while t.run():
        if t.adjust_time_step and co_max_prev > 0:
            f = min(min(t.max_co / (co_max_prev + 1e-30),
                        1.0 + 0.1 * t.max_co / (co_max_prev + 1e-30)), 1.2)
            t.set_delta_t(f * t.delta_t)
        t.increment()
        t0 = _time.perf_counter()
        info(f"Time = {t.name}\n")
        alphas, U, p_rgh, phi, stats = step(alphas, U, p_rgh, phi,
                                            t.delta_t)
        co_mean, co_max = (float(c) for c in stats["co"])
        co_max_prev = co_max
        log_courant(co_mean, co_max)
        fracs = [float(f) for f in stats["fracs"]]
        info("Phase fractions: " + "  ".join(
            f"{n0}={f0 / v_total:.6g}" for n0, f0 in zip(names, fracs)))
        for perf in stats["p_perf"]:
            log_solve(p_solver, "p_rgh", *perf)
        case.step_seconds.append(_time.perf_counter() - t0)
        case.step_log.append(dict(
            co=(co_mean, co_max), fracs=fracs,
            iterations=[("p_rgh", int(pf[2])) for pf in stats["p_perf"]]))
        timer.log()
        if write and t.write_time():
            case.write_fields([a.replace(name=f"alpha{n0}")
                               for a, n0 in zip(alphas, names)] + [U, p_rgh])
        n += 1
        if max_steps and n >= max_steps:
            break
    info("End\n")
    return case, alphas, U, p_rgh, phi


def main(argv=None):
    import argparse

    from .. import resolve_device, solver_dtype
    ap = argparse.ArgumentParser(
        description="multiphaseInterFoam (rapidcfd_tpu_torch)")
    ap.add_argument("-case", dest="case", default=".")
    ap.add_argument("-noWrite", action="store_true")
    ap.add_argument("-device", default="cuda")
    ap.add_argument("-precision", choices=["fp32", "fp64"], default=None)
    args = ap.parse_args(argv)
    run(args.case, device=resolve_device(args.device),
        dtype=solver_dtype("multiphaseInterFoam", args.precision),
        write=not args.noWrite)


if __name__ == "__main__":
    main()
