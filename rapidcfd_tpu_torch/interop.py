"""Carry state from the JAX package into the port.

Each function takes an object of the JAX package (a MeshArrays, VolField,
SurfaceField or FvMatrix) and rebuilds the port's counterpart on a given
device and dtype. Arrays are read through the numpy array protocol
(`np.asarray`), so this module never imports jax; the caller holds the
JAX objects. The tests use it to feed both packages identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .fields.bcs import BC_TYPES
from .fields.field import SurfaceField, VolField
from .mesh.gdia import GaussPlanes, GdiaInfo, gauss_planes_from_numpy
from .mesh.mesharrays import MeshArrays, Patch
from .ops.fvmatrix import FvMatrix

_BC_BY_CLASS = {cls.__name__: cls for cls in BC_TYPES.values()}


def tensor(a, *, device, dtype=None) -> torch.Tensor:
    """A tensor copy of any array-like (floats to `dtype`, integers to
    int64)."""
    arr = np.array(a)
    if np.issubdtype(arr.dtype, np.integer):
        arr = arr.astype(np.int64)
    elif dtype is not None:
        return torch.tensor(arr, dtype=dtype, device=device)
    return torch.as_tensor(arr, device=device)


def gdia_info(src, *, device, dtype) -> GdiaInfo:
    """GdiaInfo from the JAX one; all-zero ghost masks become None."""
    def mask(m):
        if m is None or not np.asarray(m).any():
            return None
        return tensor(m, device=device, dtype=dtype)
    return GdiaInfo(
        ghost_prev=tuple(mask(m) for m in src.ghost_prev),
        dead=tensor(src.dead, device=device, dtype=dtype),
        primary=tensor(src.primary, device=device, dtype=dtype),
        plane_mask=(None if src.plane_mask is None
                    else tensor(src.plane_mask, device=device, dtype=dtype)),
        shape=tuple(src.shape), sync_iters=int(src.sync_iters),
        axes=tuple(bool(a) for a in src.axes))


def gauss_planes(src, *, device, dtype) -> GaussPlanes:
    return gauss_planes_from_numpy(src.offsets, np.asarray(src.coeffs),
                                   device=device, dtype=dtype)


def mesh_arrays(src, *, device, dtype) -> MeshArrays:
    """MeshArrays of a JAX gdia-mode mesh (with its GdiaInfo and
    GaussPlanes)."""
    if src.gdia is None or src.gauss is None:
        raise ValueError("only gdia-mode meshes are ported")

    def f(name):
        return tensor(getattr(src, name), device=device, dtype=dtype)

    def opt(name):
        v = getattr(src, name)
        return None if v is None else f(name)
    return MeshArrays(
        owner=f("owner"), neighbour=f("neighbour"), Sf=f("Sf"),
        mag_sf=f("mag_sf"), Cf=f("Cf"), C=f("C"), V=f("V"),
        weights=f("weights"), delta_coeffs=f("delta_coeffs"),
        nonorth_delta_coeffs=f("nonorth_delta_coeffs"),
        corr_vecs=f("corr_vecs"), b_delta_coeffs=f("b_delta_coeffs"),
        b_nonorth_delta_coeffs=f("b_nonorth_delta_coeffs"),
        n_cells=int(src.n_cells), n_faces=int(src.n_faces),
        n_internal=int(src.n_internal),
        patches=tuple(Patch(p.name, p.type, p.start, p.size, p.bstart)
                      for p in src.patches),
        gdia=gdia_info(src.gdia, device=device, dtype=dtype),
        gauss=gauss_planes(src.gauss, device=device, dtype=dtype),
        V_assemble=f("V_assemble" if src.V_assemble is not None else "V"),
        bnd_cells=opt("bnd_cells"), bnd_sel=opt("bnd_sel"))


def _bc(src_bc):
    cls = _BC_BY_CLASS.get(type(src_bc).__name__)
    if cls is None:
        raise NotImplementedError(f"boundary condition "
                                  f"{type(src_bc).__name__} is not ported")
    return cls(int(src_bc.patch))


def vol_field(src, *, device, dtype) -> VolField:
    """VolField (data, bvalues, BCs, bcdata and the old-time level)."""
    def bd(d):
        return {k: tensor(v, device=device, dtype=dtype)
                for k, v in (d.items() if isinstance(d, dict) else ())}
    return VolField(
        tensor(src.data, device=device, dtype=dtype),
        tensor(src.bvalues, device=device, dtype=dtype),
        tuple(_bc(b) for b in src.bcs), src.dims, src.name,
        tuple(bd(d) for d in src.bcdata),
        None if src.old is None else vol_field(src.old, device=device,
                                               dtype=dtype))


def surface_field(src, *, device, dtype) -> SurfaceField:
    return SurfaceField(tensor(src.data, device=device, dtype=dtype),
                        src.dims, src.name)


def fv_matrix(src, *, device, dtype) -> FvMatrix:
    """FvMatrix coefficients (its psi converted with vol_field)."""
    def t(a):
        return tensor(a, device=device, dtype=dtype)
    ref = src.ref_cell is not None
    return FvMatrix(
        diag=t(src.diag), lower=t(src.lower), upper=t(src.upper),
        source=t(src.source),
        internal_coeffs=tuple(t(a) for a in src.internal_coeffs),
        boundary_coeffs=tuple(t(a) for a in src.boundary_coeffs),
        psi=vol_field(src.psi, device=device, dtype=dtype), V=t(src.V),
        dims=src.dims, symmetric=bool(src.symmetric),
        ref_cell=int(np.asarray(src.ref_cell)) if ref else None,
        ref_value=float(np.asarray(src.ref_value)) if ref else None,
        ref_weight=float(np.asarray(src.ref_weight)) if ref else None,
        ref_diag=t(src.ref_diag) if ref else None)
