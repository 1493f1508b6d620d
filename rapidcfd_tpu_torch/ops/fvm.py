"""fvm — implicit finite-volume operators returning FvMatrix systems
(port of rapidcfd_tpu/ops/fvm.py: Euler and steadyState ddt, Gauss and
bounded Gauss div, the orthogonal and corrected laplacian, the Sp/Su/SuSp
sources, with negSumDiag as an ELL gather or by gdia plane shifts)."""

from __future__ import annotations

import torch

from ..utils.dimensions import DimensionSet, dim_length, dimless

from ..fields.field import Dimensioned, SurfaceField, VolField
from ..mesh import gdia as gd
from ..mesh.mesharrays import MeshArrays
from .fvmatrix import FvMatrix, _ext
from .interpolation import scheme_weights

_VOL = DimensionSet.of(0, 3)
_TIME = DimensionSet.of(0, 0, 1)
_AREA = dim_length ** 2


def _pair_gather(mesh: MeshArrays, own_arr, nei_arr):
    """Per-cell-slot gather where owner slots read own_arr[f] and
    neighbour slots read nei_arr[f] (the [0..nInt | nInt..2nInt | zero]
    structure of ell_coeff_idx)."""
    cat = torch.cat([own_arr, nei_arr, own_arr.new_zeros(1)])
    return cat[mesh.ell_coeff_idx]


def _neg_sum_diag(mesh: MeshArrays, lower, upper):
    """diag[own] -= lower[f]; diag[nei] -= upper[f] (lduMatrix::negSumDiag):
    an ELL gather, or per lattice slot on gdia meshes (the fold to primary
    rows happens in component_system)."""
    if mesh.gdia is None:
        return -_pair_gather(mesh, lower, upper).sum(1)
    return gd.neg_sum_diag(mesh.gdia, lower, upper)


def ddt(mesh: MeshArrays, vf: VolField, dt, scheme: str = "Euler"
        ) -> FvMatrix:
    """fvm::ddt, Euler (reference: EulerDdtScheme::fvmDdt) or steadyState
    (the zero matrix)."""
    if scheme not in ("Euler", "steadyState"):
        raise NotImplementedError(f"ddtScheme '{scheme}' is not ported yet "
                                  "(Euler, steadyState)")
    m = FvMatrix.zeros(mesh, vf, vf.dims * _VOL / _TIME, symmetric=True)
    if scheme == "steadyState":
        return m
    if vf.old is None:
        raise ValueError(f"ddt({vf.name}): no old-time field stored")
    diag = mesh.V_asm * (1.0 / dt)
    return m.replace(diag=diag, source=_ext(diag, vf.old.data) * vf.old.data)


def div(mesh: MeshArrays, phi: SurfaceField, vf: VolField,
        scheme="linear", env=None) -> FvMatrix:
    """fvm::div(phi, psi) — Gauss convection (reference:
    gaussConvectionScheme: lower = -w*phi, upper = lower + phi,
    negSumDiag; boundary via the BC value-coefficient hooks). A
    ('bounded', inner) spec subtracts Sp(div(phi), psi) (reference:
    boundedConvectionScheme), which keeps transport bounded while the
    flux is not yet conservative."""
    if isinstance(scheme, tuple) and scheme and scheme[0] == "bounded":
        from . import fvc
        inner = div(mesh, phi, vf, scheme[1], env)
        div_phi = fvc.surface_sum_faces(mesh, phi.data) / mesh.V
        return inner - Sp(mesh, Dimensioned("div(phi)", phi.dims / _VOL,
                                            div_phi), vf)
    env = dict(env) if env else {}
    env.setdefault("phi", phi)
    w = scheme_weights(mesh, vf, scheme, phi)
    phi_i = phi.data[:mesh.n_internal]
    lower = -w * phi_i
    upper = lower + phi_i
    diag = _neg_sum_diag(mesh, lower, upper)

    m = FvMatrix.zeros(mesh, vf, phi.dims * vf.dims, symmetric=False)
    ics, bcs_ = [], []
    for i, (patch, bc, bd) in enumerate(
            zip(mesh.patches, vf.bcs, vf.bcdata)):
        if not bc.assembles or patch.size == 0:
            ics.append(m.internal_coeffs[i])
            bcs_.append(m.boundary_coeffs[i])
            continue
        vic, vbc = bc.value_coeffs(mesh, patch, vf, bd, env=env)
        phi_b = _ext(phi.data[patch.start:patch.start + patch.size], vbc)
        ics.append(phi_b * vic * torch.ones_like(vbc))
        bcs_.append(-phi_b * vbc)
    return m.replace(diag=diag, lower=lower, upper=upper,
                     internal_coeffs=tuple(ics), boundary_coeffs=tuple(bcs_))


def _gamma_faces(mesh, gamma):
    from .fvc import face_values
    if isinstance(gamma, VolField):
        return face_values(mesh, gamma), gamma.dims
    if isinstance(gamma, SurfaceField):
        return gamma.data, gamma.dims
    value, dims = (gamma.value, gamma.dims) if isinstance(gamma, Dimensioned) \
        else (gamma, dimless)
    return torch.full((mesh.n_faces,), float(value), dtype=mesh.dtype,
                      device=mesh.device), dims


def laplacian(mesh: MeshArrays, gamma, vf: VolField,
              scheme: str = "orthogonal", env=None) -> FvMatrix:
    """fvm::laplacian(gamma, psi) (reference: gaussLaplacianScheme
    fvmLaplacianUncorrected: upper = deltaCoeffs*gamma_f*magSf,
    negSumDiag; boundary via the BC gradient-coefficient hooks).
    'corrected' and 'limited' take the non-orthogonal delta coefficients
    in the implicit part and add the explicit non-orthogonal face-flux
    correction gamma_f*|Sf|*(k . grad_f psi) to the source (rapidcfd_tpu/
    ops/fvm.py:302-365, which applies no limiter for 'limited')."""
    g_f, g_dims = _gamma_faces(mesh, gamma)
    n_int = mesh.n_internal
    corrected = scheme in ("corrected", "limited")
    dc = mesh.nonorth_delta_coeffs if corrected else mesh.delta_coeffs
    g_int = g_f[:n_int] * mesh.mag_sf[:n_int] * dc
    diag = _neg_sum_diag(mesh, g_int, g_int)

    m = FvMatrix.zeros(mesh, vf, g_dims * _AREA * vf.dims / dim_length,
                       symmetric=True)
    ics, bcs_ = [], []
    for i, (patch, bc, bd) in enumerate(
            zip(mesh.patches, vf.bcs, vf.bcdata)):
        if not bc.assembles or patch.size == 0:
            ics.append(m.internal_coeffs[i])
            bcs_.append(m.boundary_coeffs[i])
            continue
        gb = g_f[patch.start:patch.start + patch.size] \
            * mesh.patch_mag_sf(patch)
        gic, gbc = bc.gradient_coeffs(mesh, patch, vf, bd, env)
        gb = _ext(gb, gbc)
        ics.append(gb * gic * torch.ones_like(gbc))
        bcs_.append(-gb * gbc)
    m = m.replace(diag=diag, lower=g_int, upper=g_int,
                  internal_coeffs=tuple(ics), boundary_coeffs=tuple(bcs_))
    if not corrected:
        return m

    # explicit non-orthogonal correction gamma_f*|Sf|*(k . grad_f psi);
    # it belongs to the operator, so it leaves the source. On gdia meshes
    # the face sum stays per slot (raw): the matrix folds its rows later.
    from . import fvc
    gf = fvc.face_values(mesh, fvc.grad(mesh, vf))[:n_int]
    if vf.data.dim() == 1:
        corr = (mesh.corr_vecs * gf).sum(-1)
    else:
        corr = (mesh.corr_vecs[:, :, None] * gf).sum(1)
    corr = _ext(g_f[:n_int] * mesh.mag_sf[:n_int], corr) * corr
    full = torch.cat([corr, corr.new_zeros((mesh.n_boundary,)
                                           + corr.shape[1:])])
    return m.replace(
        source=m.source - fvc.surface_sum_faces(mesh, full, raw=True))


# ---------------------------------------------------------------------------
# sources
# ---------------------------------------------------------------------------

def _coeff(mesh: MeshArrays, x):
    """(cell data or constant as a tensor, dims) of a source coefficient:
    a VolField, a Dimensioned or a plain number."""
    if isinstance(x, VolField):
        return x.data, x.dims
    value, dims = (x.value, x.dims) if isinstance(x, Dimensioned) \
        else (x, dimless)
    return torch.as_tensor(value, dtype=mesh.dtype, device=mesh.device), dims


def Sp(mesh: MeshArrays, sp, vf: VolField) -> FvMatrix:
    """Implicit source fvm::Sp(sp, psi): E += sp*V*psi."""
    sp_data, sp_dims = _coeff(mesh, sp)
    m = FvMatrix.zeros(mesh, vf, sp_dims * vf.dims * _VOL, symmetric=True)
    return m.replace(diag=mesh.V_asm * sp_data)


def Su(mesh: MeshArrays, su, vf: VolField) -> FvMatrix:
    """Explicit source fvm::Su(su, psi): E += su*V."""
    su_data, su_dims = _coeff(mesh, su)
    m = FvMatrix.zeros(mesh, vf, su_dims * _VOL, symmetric=True)
    return m.replace(source=m.source - _ext(mesh.V_asm, m.source) * su_data)


def SuSp(mesh: MeshArrays, sp, vf: VolField) -> FvMatrix:
    """fvm::SuSp: implicit where it stabilises (sp > 0), explicit
    otherwise."""
    sp_data, sp_dims = _coeff(mesh, sp)
    m = FvMatrix.zeros(mesh, vf, sp_dims * vf.dims * _VOL, symmetric=True)
    diag = mesh.V_asm * torch.clamp(sp_data, min=0.0)
    src = -_ext(mesh.V_asm * torch.clamp(sp_data, max=0.0), vf.data) \
        * vf.data
    return m.replace(diag=diag, source=src)
