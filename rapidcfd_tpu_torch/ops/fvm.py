"""fvm — implicit finite-volume operators returning FvMatrix systems
(port of rapidcfd_tpu/ops/fvm.py: Euler ddt, Gauss div, orthogonal
laplacian, with negSumDiag by gdia plane shifts)."""

from __future__ import annotations

import torch

from rapidcfd_tpu.utils.dimensions import DimensionSet, dim_length, dimless

from ..fields.field import Dimensioned, SurfaceField, VolField
from ..mesh import gdia as gd
from ..mesh.mesharrays import MeshArrays
from .fvmatrix import FvMatrix, _ext
from .interpolation import scheme_weights

_VOL = DimensionSet.of(0, 3)
_TIME = DimensionSet.of(0, 0, 1)
_AREA = dim_length ** 2


def _neg_sum_diag(mesh: MeshArrays, lower, upper):
    """diag[own] -= lower[f]; diag[nei] -= upper[f] (lduMatrix::negSumDiag)
    per lattice slot (the fold to primary rows happens in
    component_system)."""
    return gd.neg_sum_diag(mesh.gdia, lower, upper)


def ddt(mesh: MeshArrays, vf: VolField, dt, scheme: str = "Euler"
        ) -> FvMatrix:
    """fvm::ddt, Euler (reference: EulerDdtScheme::fvmDdt)."""
    if scheme != "Euler":
        raise NotImplementedError(f"ddtScheme '{scheme}' is not ported yet "
                                  "(Euler only)")
    if vf.old is None:
        raise ValueError(f"ddt({vf.name}): no old-time field stored")
    m = FvMatrix.zeros(mesh, vf, vf.dims * _VOL / _TIME, symmetric=True)
    diag = mesh.V_asm * (1.0 / dt)
    return m.replace(diag=diag, source=_ext(diag, vf.old.data) * vf.old.data)


def div(mesh: MeshArrays, phi: SurfaceField, vf: VolField,
        scheme="linear", env=None) -> FvMatrix:
    """fvm::div(phi, psi) — Gauss convection (reference:
    gaussConvectionScheme: lower = -w*phi, upper = lower + phi,
    negSumDiag; boundary via the BC value-coefficient hooks)."""
    if isinstance(scheme, tuple) and scheme and scheme[0] == "bounded":
        raise NotImplementedError("bounded Gauss convection is not ported yet")
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
    """fvm::laplacian(gamma, psi), uncorrected (reference:
    gaussLaplacianScheme fvmLaplacianUncorrected: upper =
    deltaCoeffs*gamma_f*magSf, negSumDiag; boundary via the BC
    gradient-coefficient hooks)."""
    if scheme in ("corrected", "limited"):
        raise NotImplementedError(f"laplacian '{scheme}' correction is not "
                                  "ported yet (orthogonal only)")
    g_f, g_dims = _gamma_faces(mesh, gamma)
    n_int = mesh.n_internal
    g_int = g_f[:n_int] * mesh.mag_sf[:n_int] * mesh.delta_coeffs
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
    return m.replace(diag=diag, lower=g_int, upper=g_int,
                     internal_coeffs=tuple(ics), boundary_coeffs=tuple(bcs_))
