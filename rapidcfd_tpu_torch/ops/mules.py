"""MULES — bounded explicit transport (flux-corrected transport), port of
rapidcfd_tpu/ops/mules.py (reference: src/finiteVolume/fvMatrices/solvers/
MULES/MULES.H:28-129, MULESTemplates.C limiter loop).

Zalesak FCT limiting of the anti-diffusive flux, so the transported
scalar stays in [psiMin, psiMax] (VOF alpha in [0, 1]). The limiter's
per-cell sums are face gathers over the ELL slots, or plane shifts on a
gdia lattice (per slot, as the JAX package's ELL sums over the lattice's
slots); the face values of the cell bounds come from fvc.face_own_nei.
Plain torch: the JAX package runs this as XLA code, not as a Pallas
kernel.
"""

from __future__ import annotations

import torch

from ..fields.field import SurfaceField, VolField
from ..linalg.solvers import gsum
from ..mesh.mesharrays import MeshArrays
from . import fvc


def limiter(mesh: MeshArrays, psi_td, corr, dt, psi_max=1.0,
            psi_min=0.0, n_limiter_iter: int = 3):
    """Zalesak FCT limiter lambda in [0, 1] per face (reference:
    MULES::limiter, MULESTemplates.C): the largest fraction of the
    anti-diffusive correction `corr` that keeps the bounded (low-order)
    solution psi_td within [psi_min, psi_max]. Boundary faces keep
    lambda = 1 (BC-controlled). dt is a number or a per-cell tensor (LTS)."""
    n_int = mesh.n_internal
    rdtv = dt / mesh.V
    q_plus = torch.clamp(psi_max - psi_td, min=0.0)
    q_minus = torch.clamp(psi_td - psi_min, min=0.0)
    lam = torch.ones_like(corr)
    for _ in range(n_limiter_iter):
        a = lam * corr
        out_f, in_f = torch.clamp(a, min=0.0), torch.clamp(-a, min=0.0)
        # P+ sums what enters a cell, P- what leaves it (a > 0 leaves the
        # owner)
        p_plus = fvc.surface_sum_sided(mesh, in_f, out_f) * rdtv
        p_minus = fvc.surface_sum_sided(mesh, out_f, in_f) * rdtv
        r_plus = torch.clamp(q_plus / torch.clamp(p_plus, min=1e-30),
                             max=1.0)
        r_minus = torch.clamp(q_minus / torch.clamp(p_minus, min=1e-30),
                              max=1.0)
        rp_o, rp_n = fvc.face_own_nei(mesh, r_plus)
        rm_o, rm_n = fvc.face_own_nei(mesh, r_minus)
        lam_f = torch.where(a[:n_int] >= 0.0, torch.minimum(rm_o, rp_n),
                            torch.minimum(rm_n, rp_o))
        lam = torch.cat([lam[:n_int] * lam_f, lam[n_int:]])
    return lam


def bounded_flux(mesh: MeshArrays, psi: VolField, phi: SurfaceField,
                 phi_psi: SurfaceField):
    """Split a candidate psi-flux into (upwind bounded flux, correction)
    (reference: MULES upwind phiBD + phiCorr); the boundary faces keep
    the candidate's flux."""
    n_int = mesh.n_internal
    own_v, nei_v = fvc.face_own_nei(mesh, psi.data)
    phi_i = phi.data[:n_int]
    psi_up = torch.where(phi_i >= 0.0, own_v, nei_v)
    phi_bd = torch.cat([phi_i * psi_up, phi_psi.data[n_int:]])
    return phi_bd, phi_psi.data - phi_bd


def _restore_conservation(mesh, psi_old_data, data, phi_lim, dt, su,
                          sp_real=None):
    """Redistribute the global conservation defect onto interface cells.

    The div(phi)-compensation that keeps the update bounded under a
    non-divergence-free fp32 flux is a (tiny) artificial source; this
    puts the lost or gained integral back, weighted by psi (1 - psi) V so
    only interface cells move. The sums run over mesh.V, as in the JAX
    package: on a lattice with dead or ghost slots they would count a
    real cell's volume again at each (ROADMAP Queue 3); the full box has
    none."""
    bflux = torch.zeros((), dtype=phi_lim.dtype, device=phi_lim.device)
    for p in mesh.patches:
        if p.is_empty or p.size == 0:
            continue
        bflux = bflux + gsum(phi_lim[p.start:p.start + p.size])
    target = gsum(psi_old_data * mesh.V) - dt * bflux
    if su is not None:
        target = target + dt * gsum(su * mesh.V)
    if sp_real is not None:
        # a real (physical) Sp source, treated implicitly in the update
        target = target + dt * gsum(sp_real * data * mesh.V)
    defect = target - gsum(data * mesh.V)
    w = torch.clamp(data * (1.0 - data), min=0.0) * mesh.V
    wsum = gsum(w)
    return data + torch.where(wsum > 1e-30, defect * w / (wsum * mesh.V),
                              torch.zeros_like(w))


def explicit_solve(mesh: MeshArrays, psi: VolField, phi: SurfaceField,
                   phi_psi: SurfaceField, dt, psi_max=1.0, psi_min=0.0,
                   n_limiter_iter: int = 3, sp=None, su=None,
                   div_phi_comp=None):
    """Advance psi one step with the limited flux: (psi_new, the limited
    flux phi_psi_lim as a SurfaceField).

    phi: volumetric face flux; phi_psi: the high-order candidate psi-flux
    (e.g. vanLeer interpolation * phi + interface compression). sp/su:
    optional per-cell implicit/explicit physical sources (reference:
    MULES::explicitSolve(rho, psi, phi, phiPsi, Sp, Su)): d(psi)/dt =
    -div(phiPsi)/V + Su + Sp psi, Sp implicit. div_phi_comp: div(phi), to
    compensate the continuity error of an fp32 flux (an artificial Sp that
    keeps a uniform field uniform); the integral it perturbs is restored
    afterwards (_restore_conservation)."""
    phi_bd, corr = bounded_flux(mesh, psi, phi, phi_psi)
    sp_c = 0.0 if sp is None else sp
    if div_phi_comp is not None:
        sp_c = sp_c + div_phi_comp
    su_c = 0.0 if su is None else su

    def advance(flux_faces):
        # (psi0/dt + Su - div(F)/V) / (1/dt - Sp)
        num = psi.data / dt + su_c \
            - fvc.surface_sum_faces(mesh, flux_faces) / mesh.V
        return num / (1.0 / dt - sp_c)

    psi_td = advance(phi_bd)                   # the low-order update
    lam = limiter(mesh, psi_td, corr, dt, psi_max, psi_min, n_limiter_iter)
    phi_lim = phi_bd + lam * corr
    data = advance(phi_lim)
    if div_phi_comp is not None:
        data = _restore_conservation(mesh, psi.data, data, phi_lim, dt, su,
                                     sp_real=sp)
    psi_new = psi.replace(data=data).correct_boundary_conditions(mesh)
    return psi_new, SurfaceField(phi_lim, phi_psi.dims, phi_psi.name)


def implicit_solve(mesh: MeshArrays, psi: VolField, phi: SurfaceField,
                   phi_psi: SurfaceField, dt, controls, psi_max=1.0,
                   psi_min=0.0, n_limiter_iter: int = 3,
                   n_corr_iter: int = 2, sp=None, su=None):
    """MULES::implicitSolve (MULESCorr; reference: MULES.H:102-129,
    MULESTemplates.C::implicitSolve): the bounded upwind transport solved
    implicitly (an M-matrix, bounded at any Courant number once the
    bounded form's -Sp(div(phi)) restores the row sums of an fp32 flux),
    then the anti-diffusive correction against its conservative matrix
    flux, Zalesak-limited against that solution and applied explicitly.
    n_corr_iter is read and unused, as in the JAX package. psi must carry
    an old-time level. Returns (psi_new, limited flux)."""
    from ..linalg.solvers import solve
    from . import fvm

    base = fvm.ddt(mesh, psi, dt) \
        + fvm.div(mesh, phi, psi, ("bounded", "upwind"))
    if sp is not None:
        base = base - fvm.Sp(mesh, sp, psi)
    if su is not None:
        base = base.replace(source=base.source + su.data * mesh.V_asm)
    psi_bd, _perf = solve(mesh, base, controls)

    flux_bd = base.replace(psi=psi_bd).flux(mesh)
    corr = phi_psi.data - flux_bd.data
    lam = limiter(mesh, psi_bd.data, corr, dt, psi_max, psi_min,
                  n_limiter_iter)
    data = psi_bd.data \
        - fvc.surface_sum_faces(mesh, lam * corr) / mesh.V * dt
    phi_lim = flux_bd.data + lam * corr
    su_f = None if su is None else su.data
    data = _restore_conservation(mesh, psi.old.data, data, phi_lim, dt, su_f)
    psi_new = psi_bd.replace(data=data).correct_boundary_conditions(mesh)
    return psi_new, SurfaceField(phi_lim, phi_psi.dims, phi_psi.name)
