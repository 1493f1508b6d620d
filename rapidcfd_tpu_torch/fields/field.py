"""Geometric fields: cell- and face-registered tensors (port of
rapidcfd_tpu/fields/field.py).

- `VolField` = internal (nCells, ...) tensor + materialized boundary face
  values (nBoundaryFaces, ...) + a tuple of boundary-condition descriptors
  + one old-time level. Frozen: operations return new fields.
- `SurfaceField` = one (nFaces, ...) tensor covering internal AND
  boundary faces.
- Dimensions are checked on every operation (DimensionSet metadata).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import torch

from rapidcfd_tpu.utils.dimensions import DimensionSet, dimless


@dataclass(frozen=True)
class Dimensioned:
    """A named, dimensioned scalar/vector constant (dimensionedScalar)."""
    name: str
    dims: DimensionSet
    value: Any

    @staticmethod
    def from_entry(entry, name=""):
        """Parse `nu [0 2 -1 0 0 0 0] 0.01`-style dictionary entries. A
        vector value stays a Python list (fields broadcast it)."""
        if isinstance(entry, (int, float)):
            return Dimensioned(name, dimless, float(entry))
        items = list(entry) if isinstance(entry, tuple) else [entry]
        nm, dims, val = name, dimless, None
        for it in items:
            if isinstance(it, DimensionSet):
                dims = it
            elif isinstance(it, str):
                nm = it
            elif isinstance(it, list):
                val = [float(v) for v in it]
            else:
                val = float(it)
        return Dimensioned(nm, dims, val)


@dataclass(frozen=True)
class SurfaceField:
    data: torch.Tensor           # (nFaces, ...) internal + boundary
    dims: DimensionSet
    name: str = ""

    def replace(self, **kw) -> "SurfaceField":
        return dataclasses.replace(self, **kw)

    def _binop(self, other, f, dims):
        return SurfaceField(f(self.data, _argdata(other)), dims, self.name)

    def __add__(self, o):
        return self._binop(o, torch.add, self.dims.check_same(_argdims(o), "+"))

    def __sub__(self, o):
        return self._binop(o, torch.sub,
                           self.dims.check_same(_argdims(o), "-"))

    def __mul__(self, o):
        return self._binop(o, torch.mul, self.dims * _argdims(o))

    def __rmul__(self, o):
        return self.__mul__(o)

    def __truediv__(self, o):
        return self._binop(o, torch.div, self.dims / _argdims(o))

    def __neg__(self):
        return SurfaceField(-self.data, self.dims, self.name)


def _argdims(o) -> DimensionSet:
    if isinstance(o, (VolField, SurfaceField, Dimensioned)):
        return o.dims
    return dimless


def _argdata(o):
    if isinstance(o, (VolField, SurfaceField)):
        return o.data
    if isinstance(o, Dimensioned):
        return o.value
    return o


def _argb(o):
    if isinstance(o, VolField):
        return o.bvalues
    if isinstance(o, SurfaceField):
        raise TypeError("cannot combine VolField with SurfaceField directly")
    if isinstance(o, Dimensioned):
        return o.value
    return o


@dataclass(frozen=True)
class VolField:
    data: torch.Tensor           # (nCells, ...) internal values
    bvalues: torch.Tensor        # (nBoundaryFaces, ...) boundary values
    bcs: tuple                   # one BC descriptor per patch
    dims: DimensionSet
    name: str = ""
    bcdata: tuple = ()           # per-patch dicts of BC parameter tensors
    old: Optional["VolField"] = None

    # -- structure helpers ---------------------------------------------------
    def replace(self, **kw) -> "VolField":
        return dataclasses.replace(self, **kw)

    def with_calculated_bcs(self, data, bvalues, dims,
                            name="") -> "VolField":
        from .bcs import Calculated
        keep = tuple(bc.preserves_type and bc.value_free for bc in self.bcs)
        bcs = tuple(bc if k else Calculated(bc.patch)
                    for bc, k in zip(self.bcs, keep))
        return VolField(data, bvalues, bcs, dims, name or self.name,
                        tuple(d if k else {}
                              for k, d in zip(keep, self.bcdata)),
                        None)

    def store_old(self) -> "VolField":
        """Shift current values into the old-time slot (one level, Euler)."""
        old = VolField(self.data, self.bvalues, self.bcs, self.dims,
                       self.name, self.bcdata, None)
        return self.replace(old=old)

    # -- arithmetic -----------------------------------------------------------
    def _binop(self, other, f, dims, name=""):
        a, b = self.data, _argdata(other)
        ab, bb = self.bvalues, _argb(other)
        # rank promotion: a scalar field combines with a vector field by
        # broadcasting over components (cell axis leading)
        if isinstance(b, torch.Tensor) and b.dim() > 0:
            while a.dim() < b.dim():
                a, ab = a[..., None], ab[..., None]
            while b.dim() < a.dim() and isinstance(other, VolField):
                b, bb = b[..., None], bb[..., None]
        return self.with_calculated_bcs(f(a, b), f(ab, bb), dims, name)

    def __add__(self, o):
        return self._binop(o, torch.add, self.dims.check_same(_argdims(o), "+"))

    def __sub__(self, o):
        return self._binop(o, torch.sub,
                           self.dims.check_same(_argdims(o), "-"))

    def __mul__(self, o):
        return self._binop(o, torch.mul, self.dims * _argdims(o))

    def __rmul__(self, o):
        return self.__mul__(o)

    def __truediv__(self, o):
        return self._binop(o, torch.div, self.dims / _argdims(o))

    def __rtruediv__(self, o):
        return self.with_calculated_bcs(
            _argdata(o) / self.data, _argb(o) / self.bvalues,
            _argdims(o) / self.dims)

    def __neg__(self):
        return self.with_calculated_bcs(-self.data, -self.bvalues, self.dims)

    # -- boundary -------------------------------------------------------------
    def correct_boundary_conditions(self, mesh, env=None) -> "VolField":
        """Re-evaluate every patch's face values from its BC (reference:
        GeometricField::correctBoundaryConditions)."""
        new_b = self.bvalues.clone()
        for bc, bd in zip(self.bcs, self.bcdata):
            patch = mesh.patches[bc.patch]
            if patch.is_empty:
                continue
            new_b[patch.bstart:patch.bstart + patch.size] = bc.evaluate(
                mesh, patch, self, bd, env)
        return self.replace(bvalues=new_b)

    def patch_internal(self, mesh, patch) -> torch.Tensor:
        """Internal-cell values adjacent to a patch (patchInternalField)."""
        return mesh.patch_cell_values(patch, self.data)

    def patch_values(self, mesh, patch) -> torch.Tensor:
        return self.bvalues[patch.bstart:patch.bstart + patch.size]
