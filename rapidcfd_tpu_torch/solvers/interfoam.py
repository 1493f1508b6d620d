"""interFoam — two-phase VOF solver with MULES-limited alpha transport
(port of rapidcfd_tpu/solvers/interfoam.py; reference: applications/
solvers/multiphase/interFoam/interFoam.C:51-120 with alphaEqn.H, UEqn.H,
pEqn.H and the interfaceProperties/immiscibleIncompressibleTwoPhaseMixture
stack).

Interface-compressed MULES advection of alpha (explicit, or MULESCorr's
implicit upwind solve with a limited explicit correction), the mixture's
density and viscosity, CSF surface tension, and p_rgh correctors with the
buoyancy and surface-tension face flux phig; U is corrected through
fvc.reconstruct. mixing=True is twoLiquidMixingFoam, lts=True
LTSInterFoam. One timestep runs eagerly on the case's device; the host
loop logs in OpenFOAM format and writes time directories.
"""

from __future__ import annotations

import time as _time

import torch

from ..fields.field import Dimensioned, SurfaceField, VolField
from ..linalg.solvers import gsum, solve
from ..models.fvoptions import refuse_options
from ..ops import fvc, fvm
from ..ops.mules import explicit_solve, implicit_solve
from ..utils.dimensions import DimensionSet, dim_density
from ..utils.logging import (ExecutionTimer, info, log_continuity,
                             log_courant, log_solve)
from .buoyantfoam import gravity
from .case import Case
from .controls import PimpleControl
from .icofoam import continuity_errors, courant_number

_DIM_MU = DimensionSet.of(1, -1, -1)
#: interfaceProperties' deltaN: keeps the interface normal finite where
#: grad(alpha) vanishes
_DELTA_N = 1e-8


def alpha_key(case: Case) -> str:
    """The alpha entry of fvSolution.solvers: alpha.water or alpha1."""
    solvers = case.fv_solution.subdict("solvers")
    return "alpha.water" if solvers.lookup("alpha.water") is not None \
        else "alpha1"


def interface_normal_flux(mesh, alpha: VolField) -> torch.Tensor:
    """nHatf = (grad(alpha)_f / (|grad(alpha)_f| + deltaN)) & Sf on every
    face (interfaceProperties::calculateK's nHatfv & Sf); the gradient is
    fvc.grad, the shift-MAC kernel's C = 3 form on gdia meshes."""
    gf = fvc.face_values(mesh, fvc.grad(mesh, alpha))
    mag = gf.norm(dim=-1) + _DELTA_N
    return (gf / mag[:, None] * mesh.Sf).sum(-1)


def compression_flux(mesh, phi: SurfaceField, nhatf: torch.Tensor,
                     c_alpha: float, capped: bool = False) -> torch.Tensor:
    """phir = cAlpha |phi|/|Sf| nHatf, zero through the boundary faces.
    capped: phic = min(cAlpha |phi|/|Sf|, max |phi|/|Sf|), as
    multiphaseMixture caps it."""
    phic = c_alpha * phi.data.abs() / torch.clamp(mesh.mag_sf, min=1e-30)
    if capped:
        phic = torch.minimum(phic, (phi.data.abs() / torch.clamp(
            mesh.mag_sf, min=1e-30)).max())
    phir = phic * nhatf
    n_int = mesh.n_internal
    return torch.cat([phir[:n_int], torch.zeros_like(phir[n_int:])])


def interface_curvature(mesh, nhatf: torch.Tensor) -> torch.Tensor:
    """kappa = -div(nHatf) on every face: interpolated linearly on the
    internal faces, the owner's value on the boundary faces (reference:
    interfaceProperties::calculateK)."""
    n_int = mesh.n_internal
    kappa = -fvc.surface_sum_faces(mesh, nhatf) / mesh.V
    own_k, nei_k = fvc.face_own_nei(mesh, kappa)
    k_int = mesh.weights * own_k + (1 - mesh.weights) * nei_k
    return torch.cat([k_int, kappa[mesh.owner[n_int:]]])


def make_step(case: Case, consts, ctrl: PimpleControl, mixing: bool = False,
              lts: bool = False, dym: bool = False,
              mules_corr: bool | None = None):
    """step(alpha, U, p_rgh, phi, dt) -> (alpha, U, p_rgh, phi, stats).

    mixing=True gives twoLiquidMixingFoam (reference: multiphase/
    twoLiquidMixingFoam): no interface compression and no surface tension,
    plus the implicit Dab diffusion of alpha. lts=True gives LTSInterFoam:
    dt is then the per-cell rDeltaT (reference: LTSInterFoam/setrDeltaT.H
    with the localEuler ddt). mules_corr overrides fvSolution's MULESCorr.
    stats: p_perf (every p_rgh solve), a_perf (the mixing diffusion
    solve), cont (local, global), co (mean, max) and alpha (min, max,
    integral)."""
    case.refuse_second_order_ddt(
        "twoLiquidMixingFoam" if mixing else "interFoam")
    if dym:
        raise NotImplementedError(
            "interDyMFoam (dym=True) needs the dynamic mesh, which is not "
            "ported (ROADMAP Queue 1 item 8)")
    from ..linalg.precompute import attach_solver_layouts
    rho1, rho2, nu1, nu2, sigma, g = consts
    solvers_d = case.fv_solution.subdict("solvers")
    a_key = alpha_key(case)
    alpha_d = solvers_d.lookup(a_key)
    c_alpha = float(alpha_d.scalar("cAlpha", 1.0)) if alpha_d else 1.0
    if mules_corr is None:
        # MULESCorr: the semi-implicit MULES, bounded at any Courant number
        # (reference: interFoam/alphaEqn.H, its MULESCorr branch)
        mules_corr = bool(alpha_d and alpha_d.word("MULESCorr", "no")
                          in ("yes", "true", "on", "1"))
    n_limiter_iter = int(alpha_d.scalar("nLimiterIter", 3)) if alpha_d \
        else 3
    n_alpha_corr = int(alpha_d.scalar("nAlphaCorr", 2)) if alpha_d else 2
    mules_controls = case.solver_controls(a_key) if mules_corr else None
    if mixing:
        c_alpha = 0.0
        sigma = 0.0
        Dab = Dimensioned.from_entry(
            case.transport_properties().lookup("Dab", required=True), "Dab")
        alpha_controls = case.solver_controls(a_key)
    lap_corr = case.laplacian_scheme()
    p_controls = case.solver_controls("p_rgh")
    p_final = case.solver_controls("p_rgh", final=True)
    n_corr = ctrl.n_correctors
    n_alpha_sub = int(ctrl.dict.scalar("nAlphaSubCycles", 1))
    n_non_orth = ctrl.n_non_orth
    p_ref_cell = case.maps.device_cell(ctrl.p_ref_cell)
    p_ref_value = ctrl.p_ref_value
    mesh = attach_solver_layouts(case.mesh, (p_controls, p_final),
                                 timings=case.setup_seconds)
    n_int = mesh.n_internal
    ghf = (mesh.Cf * torch.tensor(g, dtype=mesh.dtype,
                                  device=mesh.device)).sum(-1)

    def mixture(alpha: VolField):
        rho = alpha.with_calculated_bcs(
            alpha.data * rho1 + (1.0 - alpha.data) * rho2,
            alpha.bvalues * rho1 + (1.0 - alpha.bvalues) * rho2,
            dim_density, "rho")
        mu = alpha.with_calculated_bcs(
            alpha.data * rho1 * nu1 + (1.0 - alpha.data) * rho2 * nu2,
            alpha.bvalues * rho1 * nu1
            + (1.0 - alpha.bvalues) * rho2 * nu2, _DIM_MU, "mu")
        return rho, mu

    def sigma_kappa_snalpha(alpha: VolField) -> torch.Tensor:
        """CSF: sigma kappa_f snGrad(alpha) on every face (reference:
        interfaceProperties), kappa = -div(nHatf) interpolated linearly
        (the owner's value on boundary faces)."""
        kf = interface_curvature(mesh, interface_normal_flux(mesh, alpha))
        return sigma * kf * fvc.sn_grad(mesh, alpha).data

    def alpha_eqn(alpha: VolField, phi: SurfaceField, dt):
        """alphaEqn.H over nAlphaSubCycles: (alpha with the step-start old
        level, the sub-cycles' average limited flux)."""
        alpha0_old = alpha.old       # the step-start level, for rho's ddt
        phi_alpha_sum = torch.zeros_like(phi.data)
        for isub in range(n_alpha_sub):
            a_f = fvc.face_values(mesh, alpha, "vanLeer", phi)
            phir = compression_flux(mesh, phi,
                                    interface_normal_flux(mesh, alpha),
                                    c_alpha)
            a_b_f = fvc.face_values(mesh, alpha)      # alpha (1 - alpha)
            phi_alpha = SurfaceField(
                phi.data * a_f + phir * a_b_f * (1.0 - a_b_f), phi.dims,
                "phiAlpha")
            if mules_corr:
                if isub > 0:
                    alpha = alpha.store_old()
                alpha, phi_alpha_lim = implicit_solve(
                    mesh, alpha, phi, phi_alpha, dt / n_alpha_sub,
                    mules_controls, n_limiter_iter=n_limiter_iter,
                    n_corr_iter=n_alpha_corr)
            else:
                # Sp = div(phi) compensates the continuity error of an
                # fp32 flux: a uniform alpha stays exactly uniform
                div_phi = fvc.surface_sum_faces(mesh, phi.data) / mesh.V
                alpha, phi_alpha_lim = explicit_solve(
                    mesh, alpha, phi, phi_alpha, dt / n_alpha_sub,
                    n_limiter_iter=n_limiter_iter, div_phi_comp=div_phi)
            phi_alpha_sum = phi_alpha_sum + phi_alpha_lim.data
        return alpha.replace(old=alpha0_old), phi_alpha_sum / n_alpha_sub

    def step(alpha: VolField, U: VolField, p_rgh: VolField,
             phi: SurfaceField, dt):
        if lts:
            dt = 1.0 / dt      # the caller passes rDeltaT (nCells,)
        U = U.store_old()
        alpha, phi_alpha = alpha_eqn(alpha.store_old(), phi, dt)
        # the sub-cycles' average flux drives rhoPhi (reference: subCycle
        # accumulates (deltaT/totalDeltaT) rhoPhi at each sub-step)
        rho_phi = SurfaceField(phi_alpha * (rho1 - rho2) + phi.data * rho2,
                               phi.dims * dim_density, "rhoPhi")
        a_perf = None
        if mixing:
            # alphaDiffusionEqn.H: ddt(a) - fvc::ddt(a) - laplacian(Dab, a),
            # the old level pinned to the advected state, so the ddt pair
            # is (a_new - a_adv)/dt
            a2 = alpha.replace(old=alpha.replace(old=None))
            aEqn = fvm.ddt(mesh, a2, dt) \
                - fvm.laplacian(mesh, Dab, a2, lap_corr)
            alpha, a_perf = solve(mesh, aEqn, alpha_controls)
            dflux = aEqn.replace(psi=alpha).flux(mesh)
            rho_phi = SurfaceField(rho_phi.data + dflux.data * (rho1 - rho2),
                                   rho_phi.dims, "rhoPhi")

        rho, mu = mixture(alpha)
        rho = rho.replace(old=mixture(alpha.old)[0].replace(old=None))

        # UEqn.H; the JAX package takes linearUpwind for U whatever
        # div(rhoPhi,U) names (ROADMAP Queue 3), and so does the port
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
            # buoyancy and surface tension as face forces, none through
            # the boundary (the reference pairs this with fixedFluxPressure)
            phig = (sigma_kappa_snalpha(alpha)
                    - ghf * fvc.sn_grad(mesh, rho).data) \
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
            # U = HbyA + rAU reconstruct((phig - pEqn.flux())/rAUf)
            corr_f = SurfaceField(
                (phig - flux_p.data) / torch.clamp(rAU_f, min=1e-30),
                phi.dims / rAU.dims, "corrF")
            U_star = HbyA + rAU * fvc.reconstruct(mesh, corr_f)
            U = U.replace(data=U_star.data).correct_boundary_conditions(mesh)

        stats = dict(p_perf=tuple(p_perf_all), a_perf=a_perf,
                     cont=continuity_errors(mesh, phi),
                     co=courant_number(mesh, phi, dt),
                     alpha=(alpha.data.min(), alpha.data.max(),
                            gsum(alpha.data * mesh.V)))
        return alpha, U, p_rgh, phi, stats

    return step


def read_constants(case: Case):
    """(rho1, rho2, nu1, nu2, sigma, g) from transportProperties (its
    `phases` names, or phase1/phase2) and constant/g."""
    tp = case.transport_properties()
    phases = tp.lookup("phases")
    names = [str(x) for x in phases] if phases else ["phase1", "phase2"]
    d1 = tp.subdict(names[0], required=False) or tp.subdict("phase1")
    d2 = tp.subdict(names[1], required=False) or tp.subdict("phase2")

    def value(d, key):
        return Dimensioned.from_entry(d.lookup(key, required=True)).value
    sigma_e = tp.lookup("sigma", required=False)
    sigma = Dimensioned.from_entry(sigma_e).value if sigma_e is not None \
        else 0.0
    return (value(d1, "rho"), value(d2, "rho"), value(d1, "nu"),
            value(d2, "nu"), sigma, gravity(case))


def setup(case: Case, mixing: bool = False, lts: bool | None = None):
    """Fields, the step and the LTS rDeltaT of a case: ((alpha, U, p_rgh,
    phi), step, rdelta_t or None, alpha's file name). lts None detects
    `ddtSchemes { default localEuler; }`."""
    if lts is None:
        lts = case.ddt_scheme() in ("localEuler", "CoEuler", "SLTS")
    consts = read_constants(case)
    info(f"Two phases: rho1={consts[0]} rho2={consts[1]} "
         f"sigma={consts[4]}\n")
    alpha_name = "alpha.water" if case.field_exists("alpha.water") \
        else "alpha1"
    alpha = case.read_field(alpha_name)
    U = case.read_field("U")
    p_rgh = case.read_field("p_rgh")
    phi = fvc.flux(case.mesh, U)
    ctrl = PimpleControl(case)
    step = make_step(case, consts, ctrl, mixing=mixing, lts=lts)
    rdelta_t = None
    if lts:
        from .lts import LTSControls, make_rdelta_t_interface
        rdelta_t = make_rdelta_t_interface(
            case.mesh, LTSControls.from_dict(ctrl.dict),
            float(ctrl.dict.scalar("maxAlphaCo", 0.2)))
    return (alpha, U, p_rgh, phi), step, rdelta_t, alpha_name


def p_iterations(stats) -> list[tuple[str, int]]:
    """A step's linear-solver iterations: alpha's diffusion solve
    (twoLiquidMixingFoam) and every p_rgh solve."""
    its = [] if stats.get("a_perf") is None else \
        [("alpha", int(stats["a_perf"][0][2]))]
    return its + [("p_rgh", int(pf[2])) for pf in stats["p_perf"]]


def run(case_dir: str, *, device: torch.device, dtype: torch.dtype,
        write: bool = True, max_steps: int | None = None,
        mixing: bool = False, lts: bool | None = None,
        case: Case | None = None):
    """Run interFoam (twoLiquidMixingFoam with mixing=True; LTSInterFoam
    with lts=True, or None to detect localEuler) to endTime or max_steps.
    Returns (case, alpha, U, p_rgh, phi); case.step_seconds holds each
    step's wall time and case.step_log its Courant numbers, continuity
    errors, alpha range and iteration counts."""
    from .lts import log_time_scale
    if case is None:
        case = Case(case_dir, device=device, dtype=dtype)
    if case.control_dict.lookup("functions"):
        raise NotImplementedError("functionObjects are not ported yet")
    refuse_options(case, "interFoam")
    (alpha, U, p_rgh, phi), step, rdelta_t, alpha_name = setup(
        case, mixing, lts)
    mesh = case.mesh
    p_solver = case.solver_controls("p_rgh").solver
    v_total = float(mesh.V.sum())
    timer = ExecutionTimer()
    cumulative_err = 0.0
    case.step_log = []

    info("\nStarting time loop\n")
    n = 0
    co_max_prev = 0.0
    rdt = None
    t = case.time
    while t.run():
        if rdelta_t is None and t.adjust_time_step and co_max_prev > 0:
            f = min(min(t.max_co / (co_max_prev + 1e-30),
                        1.0 + 0.1 * t.max_co / (co_max_prev + 1e-30)), 1.2)
            t.set_delta_t(f * t.delta_t)
        t.increment()
        t0 = _time.perf_counter()
        info(f"Time = {t.name}\n")
        if rdelta_t is not None:
            rdt = rdelta_t(phi.data, alpha.data, rdt)
            log_time_scale(rdt)
            dt_arg = rdt
        else:
            dt_arg = t.delta_t
        alpha, U, p_rgh, phi, stats = step(alpha, U, p_rgh, phi, dt_arg)
        co_mean, co_max = stats["co"]
        co_max_prev = float(co_max)
        log_courant(co_mean, co_max)
        a_min, a_max, a_int = (float(x) for x in stats["alpha"])
        info(f"Phase-1 volume fraction = {a_int / v_total:.8g}  "
             f"Min(alpha1) = {a_min:.6g}  Max(alpha1) = {a_max:.6g}")
        for perf in stats["p_perf"]:
            log_solve(p_solver, "p_rgh", *perf)
        local_err, glob_err = stats["cont"]
        cumulative_err += float(glob_err)
        log_continuity(cumulative_err, local_err, glob_err)
        case.step_seconds.append(_time.perf_counter() - t0)
        case.step_log.append(dict(
            co=(float(co_mean), co_max_prev),
            cont=(float(local_err), float(glob_err)),
            alpha=(a_min, a_max, a_int), iterations=p_iterations(stats)))
        timer.log()
        if write and t.write_time():
            case.write_fields([alpha.replace(name=alpha_name), U, p_rgh])
        n += 1
        if max_steps and n >= max_steps:
            break
    info("End\n")
    return case, alpha, U, p_rgh, phi


def main(argv=None, mixing: bool = False, lts: bool | None = None):
    import argparse

    from .. import resolve_device, solver_dtype
    name = "twoLiquidMixingFoam" if mixing else \
        "LTSInterFoam" if lts else "interFoam"
    ap = argparse.ArgumentParser(description=f"{name} (rapidcfd_tpu_torch)")
    ap.add_argument("-case", dest="case", default=".")
    ap.add_argument("-noWrite", action="store_true")
    ap.add_argument("-device", default="cuda")
    ap.add_argument("-precision", choices=["fp32", "fp64"], default=None)
    args = ap.parse_args(argv)
    run(args.case, device=resolve_device(args.device),
        dtype=solver_dtype(name, args.precision), write=not args.noWrite,
        mixing=mixing, lts=lts)


if __name__ == "__main__":
    main()
