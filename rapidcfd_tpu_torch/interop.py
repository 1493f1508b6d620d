"""Carry state from the JAX package into the port.

Each function takes an object of the JAX package (a MeshArrays with its
GAMG levels, on the ELL or the gdia layout, merged-cell ghost slots
included; a VolField, SurfaceField, FvMatrix, a turbulence model's state
dict or kOmegaSST's wall distance) and rebuilds the port's counterpart on
a given device and dtype. The structured multigrid levels are built per
solve from the matrix, so there is nothing of them to carry. Arrays are
read through the numpy array protocol (`np.asarray`), so this module never
imports jax; the caller holds the JAX objects. The tests use it to feed both packages identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .fields.bcs import BC_TYPES
from .fields.field import SurfaceField, VolField
from .linalg.gamg import Level
from .mesh.gdia import GaussPlanes, GdiaInfo, gauss_planes_from_numpy
from .mesh.mesharrays import MeshArrays, Patch, _bnd_segments
from .ops.fvmatrix import FvMatrix
from .utils.dimensions import DimensionSet

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


def dims(src) -> DimensionSet:
    """The port's DimensionSet of a JAX DimensionSet."""
    return DimensionSet(*src.as_tuple())


def levels(src, *, device, dtype) -> tuple[Level, ...]:
    """GAMG levels of the JAX package (numpy arrays) as the port's."""
    return tuple(Level.from_arrays(lv, device=device, dtype=dtype)
                 for lv in src)


def mesh_arrays(src, *, device, dtype) -> MeshArrays:
    """MeshArrays of a JAX mesh: a gdia-mode mesh (with its GdiaInfo and
    GaussPlanes) or a padded-ELL mesh (with its GAMG levels, when
    attached). The structured-box layout is not ported."""
    if src.structured is not None:
        raise ValueError("the structured-box layout is not ported")

    def f(name):
        return tensor(getattr(src, name), device=device, dtype=dtype)

    def opt(name):
        v = getattr(src, name)
        return None if v is None else f(name)
    bnd = {}
    if src.bnd_cells is not None:
        uniq, seg = _bnd_segments(np.asarray(src.bnd_cells),
                                  np.asarray(src.bnd_sel),
                                  int(src.n_faces - src.n_internal))
        bnd = dict(bnd_cells=f("bnd_cells"), bnd_sel=f("bnd_sel"),
                   bnd_uniq=tensor(uniq, device=device),
                   bnd_seg=tensor(seg, device=device))
    if src.gdia is None:
        layout = dict(
            cell_faces=f("cell_faces"), cell_sign=f("cell_sign"),
            cell_nbr=f("cell_nbr"), ell_coeff_idx=f("ell_coeff_idx"),
            internal_mask=f("internal_mask"), K=int(src.K),
            gamg=(None if src.gamg is None else
                  levels(src.gamg, device=device, dtype=dtype)))
    else:
        layout = dict(
            gdia=gdia_info(src.gdia, device=device, dtype=dtype),
            gauss=gauss_planes(src.gauss, device=device, dtype=dtype))
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
        V_assemble=opt("V_assemble"), **layout, **bnd)


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
        tuple(_bc(b) for b in src.bcs), dims(src.dims), src.name,
        tuple(bd(d) for d in src.bcdata),
        None if src.old is None else vol_field(src.old, device=device,
                                               dtype=dtype))


def turb_state(src, *, device, dtype) -> dict:
    """A RAS model's state dict (kEpsilon: k, epsilon and nut; kOmegaSST:
    k, omega and nut; with their wall-function BCs) as the port's
    VolFields."""
    return {name: vol_field(f, device=device, dtype=dtype)
            for name, f in src.items()}


def wall_distance(src_model, *, device, dtype) -> torch.Tensor:
    """The wall distance per cell slot of a JAX kOmegaSST model (its `y`),
    for the port's model of the same case."""
    return tensor(src_model.y, device=device, dtype=dtype)


def surface_field(src, *, device, dtype) -> SurfaceField:
    return SurfaceField(tensor(src.data, device=device, dtype=dtype),
                        dims(src.dims), src.name)


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
        dims=dims(src.dims), symmetric=bool(src.symmetric),
        ref_cell=int(np.asarray(src.ref_cell)) if ref else None,
        ref_value=float(np.asarray(src.ref_value)) if ref else None,
        ref_weight=float(np.asarray(src.ref_weight)) if ref else None,
        ref_diag=t(src.ref_diag) if ref else None)
