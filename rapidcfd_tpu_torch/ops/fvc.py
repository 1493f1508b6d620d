"""fvc — explicit finite-volume operators returning fields (port of the
padded-ELL and gdia-lattice branches of rapidcfd_tpu/ops/fvc.py). On ELL
meshes every operator is a face gather and a reduction over each cell's
K slots; on gdia meshes a plane shift, slice or multiply-add over flat
(n_lat,) tensors, with the Gauss gradient (C = 3) and the divergence
contraction (C = 1) through the shift-MAC kernel (ops/gdia_mac.py)."""

from __future__ import annotations

import torch

from ..utils.dimensions import dim_length, dim_volume

from ..fields.field import Dimensioned, SurfaceField, VolField
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
                      signed: bool = True, raw: bool = False
                      ) -> torch.Tensor:
    """Per-cell sum of face data (owner +, neighbour - when signed). ELL:
    out[c] = sum_k sign[c,k] * x[face[c,k]] (the reference's cell-gather
    functor, fvcSurfaceIntegrate.C:41-100). gdia: plane shifts over the
    internal faces plus one batched boundary fold, folded to primary
    slots and ghost-synced (cell-field semantics) unless raw=True, which
    keeps the per-slot partial sums (assembly space: the matrix folds
    them later, in component_system)."""
    g = mesh.gdia
    if g is None:
        gathered = face_data[mesh.cell_faces]
        w = mesh.cell_sign if signed else mesh.cell_sign.abs()
        return (gathered * _ext(w, gathered)).sum(1)
    out = gd.surface_sum_internal(g, face_data[:mesh.n_internal], signed)
    out = mesh.add_at_boundary_cells(out, face_data[mesh.n_internal:])
    if raw:
        return out
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
    if brows is not None:
        rows = mesh.add_at_boundary_cells(rows, torch.stack(brows), dim=1)
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


def div_tensor(mesh: MeshArrays, T: VolField) -> VolField:
    """fvc::div of a rank-2 tensor field -> vector field: per cell
    (1/V) sum_f Sf_i T_ij. On gdia meshes the contraction over i runs on
    the grad planes (three shift-MAC calls with C = 1 per component), cell
    axis last, with no (nF, 3, 3) face values."""
    g_ = mesh.gdia
    if g_ is not None:
        Tt = gd.sync_last(g_, T.data.permute(1, 2, 0))      # (3, 3, n)
        Sfb = mesh.Sf[mesh.n_internal:]
        rows = torch.stack(
            [sum(gd.gauss_mac1(g_, mesh.gauss, i, Tt[i, c])
                 for i in range(3)) for c in range(3)])
        brows = [sum(Sfb[:, i] * T.bvalues[:, i, c] for i in range(3))
                 for c in range(3)]
        y = _gdia_rows_tail(mesh, g_, rows, brows)
        return _extrapolated(mesh, y.T.contiguous(), T.dims / dim_length,
                             f"div({T.name})")
    fv = face_values(mesh, T)                           # (nF, 3, 3)
    face_term = (mesh.Sf[:, :, None] * fv).sum(1)       # (nF, 3)
    summed = surface_sum_faces(mesh, face_term)
    return _extrapolated(mesh, summed / _ext(mesh.V, summed),
                         T.dims / dim_length, f"div({T.name})")


def _dev_t(t):
    """dev(T(t)) of (..., 3, 3) tensors."""
    tr = t.diagonal(dim1=-2, dim2=-1).sum(-1)
    eye = torch.eye(3, dtype=t.dtype, device=t.device)
    return t.transpose(-1, -2) - (tr / 3.0)[..., None, None] * eye


def dev_transpose_grad(mesh: MeshArrays, U: VolField) -> VolField:
    """dev(T(grad(U))) (the explicit part of divDevReff)."""
    g = grad(mesh, U)
    return g.with_calculated_bcs(_dev_t(g.data), _dev_t(g.bvalues), g.dims,
                                 f"devT(grad({U.name}))")


def div_dev_t_grad(mesh: MeshArrays, U: VolField, nu_eff) -> VolField:
    """fvc::div(nuEff * dev(T(grad U))) on gdia meshes, fused: the nine
    gradient columns stay separate (n,) tensors through the whole
    pipeline (3 shift-MAC Gauss sums with C = 3, dev and transpose as
    column permutations, the divergence as 9 contractions with C = 1);
    only boundary-sized tensors are (nb, 3, 3). Matches
    div_tensor(dev_transpose_grad(U) * nuEff) to roundoff."""
    g_ = mesh.gdia
    planes = mesh.gauss
    n_int = mesh.n_internal
    x = gd.sync(g_, U.data)
    Sfb = mesh.Sf[n_int:]

    # gradient rows G[j*3 + i] = dU_j/dx_i, cell axis last
    rows = torch.cat([gd.gauss_mac3(g_, planes, x[:, j]) for j in range(3)])
    brows = [Sfb[:, i] * U.bvalues[:, j] for j in range(3) for i in range(3)]
    G = _gdia_rows_tail(mesh, g_, rows, brows)               # (9, n)

    def gcol(i, j):
        return G[j * 3 + i]

    # the gradient at the boundary faces' cells, snGrad-corrected
    # (gaussGrad::correctBoundaryConditions on the (nb, 3, 3) tile)
    idx = mesh.owner[n_int:]
    gb = torch.stack([torch.stack([gcol(i, j)[idx] for j in range(3)], 1)
                      for i in range(3)], 1)                 # (nb, 3, 3)
    for bc, bd in zip(U.bcs, U.bcdata):
        patch = mesh.patches[bc.patch]
        if patch.is_empty or patch.size == 0:
            continue
        nv = mesh.patch_normals(patch)
        sl = slice(patch.bstart, patch.bstart + patch.size)
        gc = gb[sl]
        sngrad = bc.snGrad(mesh, patch, U, bd)
        ndotg = (nv[:, :, None] * gc).sum(1, keepdim=True)
        gb[sl] = gc - nv[:, :, None] * ndotg \
            + nv[:, :, None] * sngrad[:, None, :]

    # T_ic = nuEff * (dU_i/dx_c - delta_ic tr/3), with nuEff ghost-synced
    if isinstance(nu_eff, Dimensioned):
        nu_d = nu_b = torch.as_tensor(nu_eff.value, dtype=mesh.dtype,
                                      device=mesh.device)
        nu_dims = nu_eff.dims
    else:
        nu_d, nu_b = gd.sync(g_, nu_eff.data), nu_eff.bvalues[:, None, None]
        nu_dims = nu_eff.dims
    tr = gcol(0, 0) + gcol(1, 1) + gcol(2, 2)

    def T_ic(i, c):
        t = gcol(c, i)
        if i == c:
            t = t - tr / 3.0
        return nu_d * t
    Tb = nu_b * _dev_t(gb)

    # divergence: out_c = (1/V) [sum_i planes_i(T_ic) + boundary]
    rows2 = torch.stack([sum(gd.gauss_mac1(g_, planes, i, T_ic(i, c))
                             for i in range(3)) for c in range(3)])
    brows2 = [sum(Sfb[:, i] * Tb[:, i, c] for i in range(3))
              for c in range(3)]
    out = _gdia_rows_tail(mesh, g_, rows2, brows2)
    return _extrapolated(mesh, out.T.contiguous(),
                         nu_dims * U.dims / dim_length / dim_length,
                         f"div(devT(grad({U.name})))")


def grad(mesh: MeshArrays, vf: VolField, scheme="linear") -> VolField:
    """Gauss linear gradient with the boundary normal-gradient correction
    (reference: gaussGrad.C:51-101 + correctBoundaryConditions): on ELL
    meshes face values -> Sf-weighted surface sum -> /V, on gdia meshes
    through the precomputed shift-MAC planes.

    scalar -> vector; vector -> tensor with (grad U)[i,j] = dU_j/dx_i."""
    if scheme != "linear":
        raise NotImplementedError(
            f"grad scheme '{scheme}' is not ported yet (Gauss linear only)")
    g_ = mesh.gdia
    if g_ is None:
        fv = face_values(mesh, vf, scheme)
        if fv.dim() == 1:
            face_term = mesh.Sf * fv[:, None]                  # (nF, 3)
        else:
            face_term = mesh.Sf[:, :, None] * fv[:, None, :]   # (nF, 3, r)
        summed = surface_sum_faces(mesh, face_term)
        g = _extrapolated(mesh, summed / _ext(mesh.V, summed),
                          vf.dims / dim_length, f"grad({vf.name})")
        return _grad_correct_boundary(mesh, g, vf)
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
    """(owner, neighbour) cell values on the internal faces."""
    if mesh.gdia is None:
        return (data.index_select(0, mesh.owner[:mesh.n_internal]),
                data.index_select(0, mesh.neighbour))
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
    """Volumetric face flux phi = interpolate(U) & Sf (createPhi.H); on
    gdia meshes fused per plane (no (nF, 3) face-value
    materialization)."""
    g_ = mesh.gdia
    if g_ is None:
        fv = face_values(mesh, U)
        return SurfaceField((fv * mesh.Sf).sum(-1), U.dims * _AREA, "phi")
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


def adjust_phi(mesh: MeshArrays, phi: SurfaceField, U: VolField
               ) -> SurfaceField:
    """Balance the boundary flux over the patches whose U is not fixed
    (reference: cfdTools/general/adjustPhi): their outflow is scaled to
    match the inflow, so the domain conserves mass. The identity when no
    patch is adjustable."""
    zero = torch.zeros((), dtype=phi.data.dtype, device=phi.data.device)
    fixed_in = adj_in = adj_out = zero
    adjustable = []
    for bc, patch in zip(U.bcs, mesh.patches):
        if patch.size == 0 or patch.is_empty:
            continue
        pphi = phi.data[patch.start:patch.start + patch.size]
        if bc.fixes_value:
            fixed_in = fixed_in + pphi.sum()
        else:
            adjustable.append(patch)
            adj_in = adj_in + torch.clamp(pphi, max=0.0).sum()
            adj_out = adj_out + torch.clamp(pphi, min=0.0).sum()
    if not adjustable:
        return phi
    scale = -(fixed_in + adj_in) / torch.where(
        adj_out == 0.0, torch.full_like(adj_out, 1e-30), adj_out)
    data = phi.data.clone()
    for patch in adjustable:
        sl = slice(patch.start, patch.start + patch.size)
        pphi = data[sl]
        data[sl] = torch.where(pphi > 0.0, pphi * scale, pphi)
    return SurfaceField(data, phi.dims, phi.name)
