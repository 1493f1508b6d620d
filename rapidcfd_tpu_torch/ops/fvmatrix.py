"""FvMatrix — the implicit finite-volume system (port of the gdia-lattice
branches of rapidcfd_tpu/ops/fvmatrix.py).

LDU semantics as in the reference's fvMatrix : lduMatrix — face-indexed
lower/upper coefficients, per-patch internal/boundary coefficients, an
integrated source — with the off-diagonal product as gdia plane shifts.

Sign convention: the assembled expression is E(psi) = M*psi - source; the
solve is M*psi = source. Patch coefficients: internal_coeffs[p] adds to
the diagonal of the patch's face cells, boundary_coeffs[p] to their
source (both shaped (size,) + rank of psi).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from rapidcfd_tpu.utils.dimensions import DimensionSet

from ..fields.field import VolField
from ..mesh import gdia as gd
from ..mesh.mesharrays import MeshArrays

_VOL_DIMS = DimensionSet.of(0, 3, 0)


def _ext(a, like):
    return a.reshape(a.shape + (1,) * (like.dim() - a.dim()))


@dataclass(frozen=True, eq=False)
class FvMatrix:
    diag: torch.Tensor              # (nCells,)
    lower: torch.Tensor             # (nInternal,)
    upper: torch.Tensor             # (nInternal,)
    source: torch.Tensor            # (nCells,) + rank
    internal_coeffs: tuple          # per patch: (size,) + rank
    boundary_coeffs: tuple          # per patch: (size,) + rank
    psi: VolField
    V: torch.Tensor                 # (nCells,) assembly volumes
    dims: DimensionSet
    symmetric: bool = False
    # setReference pin (cell, value, weight, the pin's diag bump), kept so
    # the solver can re-pin the level after solving and the source can be
    # projected onto the compatible subspace
    ref_cell: int | None = None
    ref_value: float | None = None
    ref_weight: float | None = None
    ref_diag: torch.Tensor | None = None

    # -- construction --------------------------------------------------------
    @staticmethod
    def zeros(mesh: MeshArrays, psi: VolField, dims: DimensionSet,
              symmetric: bool = True) -> "FvMatrix":
        rank = tuple(psi.data.shape[1:])
        kw = dict(dtype=psi.data.dtype, device=psi.data.device)
        return FvMatrix(
            diag=torch.zeros(mesh.n_cells, **kw),
            lower=torch.zeros(mesh.n_internal, **kw),
            upper=torch.zeros(mesh.n_internal, **kw),
            source=torch.zeros((mesh.n_cells,) + rank, **kw),
            internal_coeffs=tuple(torch.zeros((p.size,) + rank, **kw)
                                  for p in mesh.patches),
            boundary_coeffs=tuple(torch.zeros((p.size,) + rank, **kw)
                                  for p in mesh.patches),
            psi=psi, V=mesh.V_asm, dims=dims, symmetric=symmetric)

    def replace(self, **kw) -> "FvMatrix":
        return dataclasses.replace(self, **kw)

    # -- algebra ---------------------------------------------------------------
    def __add__(self, o: "FvMatrix") -> "FvMatrix":
        self.dims.check_same(o.dims, "fvMatrix +")
        return FvMatrix(
            self.diag + o.diag, self.lower + o.lower, self.upper + o.upper,
            self.source + o.source,
            tuple(a + b for a, b in
                  zip(self.internal_coeffs, o.internal_coeffs)),
            tuple(a + b for a, b in
                  zip(self.boundary_coeffs, o.boundary_coeffs)),
            self.psi, self.V, self.dims, self.symmetric and o.symmetric)

    def __sub__(self, o: "FvMatrix") -> "FvMatrix":
        return self + (o * -1.0)

    def __mul__(self, s) -> "FvMatrix":
        return FvMatrix(
            self.diag * s, self.lower * s, self.upper * s, self.source * s,
            tuple(a * s for a in self.internal_coeffs),
            tuple(a * s for a in self.boundary_coeffs),
            self.psi, self.V, self.dims, self.symmetric)

    __rmul__ = __mul__

    def __neg__(self):
        return self * -1.0

    def __eq__(self, rhs):  # OpenFOAM sugar: fvm::... == rhs
        return self.equals(rhs)

    __hash__ = None

    def equals(self, rhs) -> "FvMatrix":
        """`fvm == rhs`: move the RHS into the source. rhs may be another
        FvMatrix or a per-volume VolField (integrated with V here)."""
        if isinstance(rhs, FvMatrix):
            return self - rhs
        if isinstance(rhs, VolField):
            self.dims.check_same(rhs.dims * _VOL_DIMS, "fvMatrix ==")
            return self.replace(
                source=self.source + rhs.data * _ext(self.V, rhs.data))
        raise TypeError(f"cannot == fvMatrix with {type(rhs)}")

    # -- matrix action -----------------------------------------------------------
    def offdiag_mv(self, mesh: MeshArrays):
        """x -> the off-diagonal product, as gdia plane shifts."""
        return gd.offdiag_mv(mesh.gdia, self.lower, self.upper)

    @staticmethod
    def _fold_patches(mesh, data, items):
        """data[faceCells] += vals over a list of (patch, vals), in one
        concatenated index_add."""
        if not items:
            return data
        if len(items) == 1:
            p, v = items[0]
            return mesh.add_at_patch_cells(p, data, v)
        cells = torch.cat([mesh.patch_face_cells(p) for p, _ in items])
        vals = torch.cat([v for _, v in items])
        return data.index_add(0, cells, vals)

    def component_system_all(self, mesh: MeshArrays):
        """(diag (n,m), source (n,m)) for a column-batched vector solve
        (patch internal coeffs may differ per component)."""
        m_comp = self.source.shape[1]
        diag = self.diag[:, None].expand(self.diag.shape[0], m_comp)
        d_items, s_items = [], []
        for p, ic, bc in zip(mesh.patches, self.internal_coeffs,
                             self.boundary_coeffs):
            if p.is_empty or p.size == 0:
                continue
            d_items.append((p, ic))
            s_items.append((p, bc))
        diag = self._fold_patches(mesh, diag, d_items)
        src = self._fold_patches(mesh, self.source, s_items)
        diag, src = self._gdia_fold_system(mesh, diag, src)
        return diag, self._compat_project(src)

    def component_system(self, mesh: MeshArrays, cmpt: int | None):
        """(diag, source) for one component with the patch coefficients
        folded in (reference: addBoundaryDiag/addBoundarySource)."""
        src = self.source if cmpt is None else self.source[:, cmpt]
        d_items, s_items = [], []
        for p, ic, bc in zip(mesh.patches, self.internal_coeffs,
                             self.boundary_coeffs):
            if p.is_empty or p.size == 0:
                continue
            d_items.append((p, ic if cmpt is None else ic[:, cmpt]))
            s_items.append((p, bc if cmpt is None else bc[:, cmpt]))
        diag = self._fold_patches(mesh, self.diag, d_items)
        src = self._fold_patches(mesh, src, s_items)
        diag, src = self._gdia_fold_system(mesh, diag, src)
        return diag, self._compat_project(src)

    @staticmethod
    def _gdia_fold_system(mesh, diag, src):
        """Fold per-slot diag/source contributions (ghost rows) into the
        primary rows and NULL the ghost/dead rows (0*x = 0: inert in every
        residual sum and in the residual norm factor)."""
        g = mesh.gdia
        diag = gd.fold_diag(g, diag)
        src = gd.fold(g, src)
        prim = g.primary.reshape(g.primary.shape + (1,) * (src.dim() - 1))
        return diag, src * prim

    def _compat_project(self, src):
        """Compatibility projection for setReference'd (pure-Neumann)
        systems: subtract the volume-distributed source imbalance left by
        roundoff, after every source is folded in."""
        if self.ref_cell is None:
            return src
        from ..linalg.solvers import gsum
        pin = torch.zeros_like(src)
        pin[self.ref_cell] = (self.ref_diag * self.ref_value
                              * self.ref_weight)
        imb = gsum(src - pin) / gsum(self.V)
        return src - _ext(self.V, src) * imb

    # -- queries -------------------------------------------------------------------
    def A(self, mesh: MeshArrays) -> VolField:
        """Central coefficients / V (reference: fvMatrix::A). For vector
        systems the patch internal coeffs are averaged over components."""
        from .fvc import _extrapolated
        items = [(p, ic.mean(dim=-1) if ic.dim() > 1 else ic)
                 for p, ic in zip(mesh.patches, self.internal_coeffs)
                 if not (p.is_empty or p.size == 0)]
        diag = self._fold_patches(mesh, self.diag, items)
        g = mesh.gdia
        diag = gd.sync(g, gd.fold(g, diag))
        # dead slots have no equation (zero diag): pin A=1 there so rAU
        # stays finite (0*inf would poison surface sums)
        diag = diag + g.dead * mesh.V
        return _extrapolated(mesh, diag / mesh.V,
                             self.dims / (self.psi.dims * _VOL_DIMS),
                             f"A({self.psi.name})")

    def H(self, mesh: MeshArrays) -> VolField:
        """(source - offdiag*psi + boundary sources)/V (fvMatrix::H)."""
        from .fvc import _extrapolated
        psi = self.psi.data
        h = self.source - self.offdiag_mv(mesh)(psi)
        items = [(p, bc) for p, bc in zip(mesh.patches, self.boundary_coeffs)
                 if not (p.is_empty or p.size == 0)]
        h = self._fold_patches(mesh, h, items)
        g = mesh.gdia
        h = gd.sync(g, gd.fold(g, h))
        h = h / _ext(mesh.V, h)
        return _extrapolated(mesh, h, self.dims / _VOL_DIMS,
                             f"H({self.psi.name})")

    def flux(self, mesh: MeshArrays):
        """Face flux consistent with the assembled operator (reference:
        fvMatrix::flux via lduMatrix::faceH): internal F = upper*psi_n -
        lower*psi_o; boundary F = ic*psi_c - bc. Scalar matrices only."""
        from ..fields.field import SurfaceField
        from .fvc import face_own_nei
        psi = self.psi.data
        if psi.dim() > 1:
            raise TypeError("flux() only valid for scalar matrices")
        own_v, nei_v = face_own_nei(mesh, psi)
        parts = [self.upper * nei_v - self.lower * own_v]
        for p, ic, bc in zip(mesh.patches, self.internal_coeffs,
                             self.boundary_coeffs):
            if p.is_empty:
                parts.append(torch.zeros((p.size,), dtype=psi.dtype,
                                         device=psi.device))
                continue
            parts.append(ic * mesh.patch_cell_values(p, psi) - bc)
        return SurfaceField(torch.cat(parts), self.dims,
                            f"flux({self.psi.name})")

    # -- manipulation ------------------------------------------------------------
    def set_reference(self, cell: int, value: float, weight: float = 1.0,
                      force: bool = False) -> "FvMatrix":
        """Pin psi at one cell (fvMatrix::setReference), only when no
        boundary condition fixes the level (the reference's needReference
        guard) unless force=True."""
        if not force and any(bc.fixes_level for bc in self.psi.bcs):
            return self
        dc = self.diag[cell] * weight
        diag = self.diag.clone()
        diag[cell] += dc
        src = self.source.clone()
        src[cell] += dc * value
        return self.replace(diag=diag, source=src, ref_cell=int(cell),
                            ref_value=float(value), ref_weight=float(weight),
                            ref_diag=dc)
