"""fvc — explicit finite-volume operators returning fields (port of the
gdia-lattice branches of rapidcfd_tpu/ops/fvc.py). Every operator is a
plane shift, slice or multiply-add over flat (n_lat,) tensors; the Gauss
gradient goes through the shift-MAC kernel (ops/gdia_mac.py)."""

from __future__ import annotations

import torch

from rapidcfd_tpu.utils.dimensions import dim_length, dim_volume

from ..fields.field import SurfaceField, VolField
from ..mesh import gdia as gd
from ..mesh.mesharrays import MeshArrays

_AREA = dim_length ** 2


def _ext(a, like):
    """Append trailing singleton dims to broadcast a face-scalar over a
    (nFaces, ...) field."""
    return a.reshape(a.shape + (1,) * (like.dim() - a.dim()))


# ---------------------------------------------------------------------------
# interpolation
# ---------------------------------------------------------------------------

def face_values(mesh: MeshArrays, vf: VolField, scheme="linear",
                phi: SurfaceField | None = None) -> torch.Tensor:
    """Face values on ALL faces: internal by the scheme, boundary from the
    field's materialized patch values."""
    from .interpolation import interpolate_internal
    internal = interpolate_internal(mesh, vf, scheme, phi)
    return torch.cat([internal, vf.bvalues])


# ---------------------------------------------------------------------------
# surface sums
# ---------------------------------------------------------------------------

def surface_sum_faces(mesh: MeshArrays, face_data: torch.Tensor,
                      signed: bool = True) -> torch.Tensor:
    """Per-cell sum of face data (owner +, neighbour - when signed): plane
    shifts over the internal faces plus one batched boundary fold. The
    result is folded to primary slots and ghost-synced (cell-field
    semantics)."""
    g = mesh.gdia
    out = gd.surface_sum_internal(g, face_data[:mesh.n_internal], signed)
    out = mesh.add_at_boundary_cells(out, face_data[mesh.n_internal:])
    return gd.sync(g, gd.fold(g, out))


def surface_integrate(mesh: MeshArrays, ssf: SurfaceField) -> VolField:
    """(1/V) * sum of owner-outward face values (fvc::surfaceIntegrate)."""
    summed = surface_sum_faces(mesh, ssf.data)
    data = summed / _ext(mesh.V, summed)
    return _extrapolated(mesh, data, ssf.dims / dim_volume,
                         f"surfaceIntegrate({ssf.name})")


def boundary_owner_values(mesh: MeshArrays, data: torch.Tensor
                          ) -> torch.Tensor:
    """data at the owner cell of every boundary face (bstart order).
    Empty-patch faces read 1.0 (not 0.0, which would manufacture inf/NaN
    in pointwise arithmetic such as 1/A)."""
    parts = []
    for p in mesh.patches:
        if p.size == 0:
            continue
        if p.is_empty:
            parts.append(torch.ones((p.size,) + data.shape[1:],
                                    dtype=data.dtype, device=data.device))
        else:
            parts.append(data.index_select(0, mesh.patch_face_cells(p)))
    if not parts:
        return data[:0]
    return torch.cat(parts)


def _extrapolated(mesh: MeshArrays, data, dims, name="") -> VolField:
    """Wrap cell data as a VolField with zero-order extrapolated boundary
    values and calculated BCs."""
    from ..fields.bcs import Calculated
    bcs = tuple(Calculated(i) for i in range(len(mesh.patches)))
    return VolField(data, boundary_owner_values(mesh, data), bcs, dims, name,
                    tuple({} for _ in mesh.patches))


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------

def _gdia_rows_tail(mesh: MeshArrays, g_, rows, brows):
    """Shared tail of the cell-axis-last Gauss pipelines: add the
    boundary-face contributions, fold ghost partials into primaries,
    restore the ghost-sync invariant, divide by cell volumes. rows (C, n);
    brows list of C (nb,) tensors (bstart order) or None."""
    if brows is not None and mesh.bnd_cells is not None:
        vals = torch.stack(brows).index_select(1, mesh.bnd_sel)
        add = torch.zeros_like(rows).index_add_(1, mesh.bnd_cells, vals)
        rows = rows + add
    y = gd.sync_last(g_, gd.fold_last(g_, rows))
    return y / mesh.V[None, :]


def div(mesh: MeshArrays, a, b=None, scheme="linear") -> VolField:
    """fvc::div(ssf) or fvc::div(phi, vf) (Gauss)."""
    if b is None:
        if not isinstance(a, SurfaceField):
            raise TypeError("fvc.div(mesh, ssf) needs a SurfaceField")
        return surface_integrate(mesh, a)
    phi, vf = a, b
    face_v = face_values(mesh, vf, scheme, phi)
    flux_f = _ext(phi.data, face_v) * face_v
    return surface_integrate(
        mesh, SurfaceField(flux_f, phi.dims * vf.dims,
                           f"div({phi.name},{vf.name})"))


def grad(mesh: MeshArrays, vf: VolField, scheme="linear") -> VolField:
    """Gauss linear gradient through the precomputed shift-MAC planes,
    with the boundary normal-gradient correction (reference:
    gaussGrad.C:51-101 + correctBoundaryConditions).

    scalar -> vector; vector -> tensor with (grad U)[i,j] = dU_j/dx_i."""
    if scheme != "linear":
        raise NotImplementedError(
            f"grad scheme '{scheme}' is not ported yet (Gauss linear only)")
    g_ = mesh.gdia
    x = gd.sync(g_, vf.data)
    Sfb = mesh.Sf[mesh.n_internal:]
    if x.dim() == 1:
        rows = gd.gauss_mac3(g_, mesh.gauss, x)                 # (3, n)
        brows = [Sfb[:, i] * vf.bvalues for i in range(3)]
        data = _gdia_rows_tail(mesh, g_, rows, brows).T
    else:
        m = x.shape[1]
        rows = torch.cat([gd.gauss_mac3(g_, mesh.gauss, x[:, j])
                          for j in range(m)])                   # (3m, n)
        brows = [Sfb[:, i] * vf.bvalues[:, j]
                 for j in range(m) for i in range(3)]
        y = _gdia_rows_tail(mesh, g_, rows, brows)
        # row r = j*3 + i -> out[s, i, j]
        data = y.reshape(m, 3, y.shape[-1]).permute(2, 1, 0)
    g = _extrapolated(mesh, data.contiguous(), vf.dims / dim_length,
                      f"grad({vf.name})")
    return _grad_correct_boundary(mesh, g, vf)


def _grad_correct_boundary(mesh: MeshArrays, g: VolField,
                           vf: VolField) -> VolField:
    """Replace the patch-normal gradient component with the BC's exact
    snGrad (reference: gaussGrad::correctBoundaryConditions)."""
    bvalues = g.bvalues.clone()
    for bc, bd in zip(vf.bcs, vf.bcdata):
        patch = mesh.patches[bc.patch]
        if patch.is_empty or patch.size == 0:
            continue
        n = mesh.patch_normals(patch)                          # (np, 3)
        gc = mesh.patch_cell_values(patch, g.data)
        sngrad = bc.snGrad(mesh, patch, vf, bd)                # (np[, r])
        if gc.dim() == 2:     # gradient of a scalar: (np, 3)
            corrected = gc - n * (n * gc).sum(-1, keepdim=True) \
                + n * sngrad[:, None]
        else:                 # gradient of a vector: (np, 3, r)
            ndotg = (n[:, :, None] * gc).sum(1, keepdim=True)
            corrected = gc - n[:, :, None] * ndotg \
                + n[:, :, None] * sngrad[:, None, :]
        bvalues[patch.bstart:patch.bstart + patch.size] = corrected
    return g.replace(bvalues=bvalues)


def face_own_nei(mesh: MeshArrays, data: torch.Tensor):
    """(owner, neighbour) cell values on the internal (plane) faces."""
    return gd.face_own_nei(mesh.gdia, data)


def sn_grad(mesh: MeshArrays, vf: VolField) -> SurfaceField:
    """Surface-normal gradient (orthogonal)."""
    own_v, nei_v = face_own_nei(mesh, vf.data)
    d_int = nei_v - own_v
    internal = d_int * _ext(mesh.delta_coeffs, d_int)
    d_b = vf.bvalues - boundary_owner_values(mesh, vf.data)
    boundary = d_b * _ext(mesh.b_delta_coeffs, d_b)
    return SurfaceField(torch.cat([internal, boundary]),
                        vf.dims / dim_length, f"snGrad({vf.name})")


def flux(mesh: MeshArrays, U: VolField) -> SurfaceField:
    """Volumetric face flux phi = interpolate(U) & Sf (createPhi.H),
    fused per plane (no (nF, 3) face-value materialization)."""
    g_ = mesh.gdia
    x = gd.sync(g_, U.data)
    internal = gd.flux_mac(g_, mesh.Sf, mesh.weights, x)
    b = (U.bvalues * mesh.Sf[mesh.n_internal:]).sum(-1)
    return SurfaceField(torch.cat([internal, b]), U.dims * _AREA, "phi")


def constrain_hbya(mesh: MeshArrays, hbya: VolField,
                   U: VolField) -> VolField:
    """Impose U's boundary values on HbyA where U's BC fixes the value
    (reference: cfdTools/general constrainHbyA)."""
    b = hbya.bvalues.clone()
    for bc, patch in zip(U.bcs, mesh.patches):
        if bc.fixes_value and patch.size:
            sl = slice(patch.bstart, patch.bstart + patch.size)
            b[sl] = U.bvalues[sl]
    return hbya.replace(bvalues=b)
