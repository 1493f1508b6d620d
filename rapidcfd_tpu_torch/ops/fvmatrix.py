"""FvMatrix — the implicit finite-volume system (port of the padded-ELL
and gdia-lattice branches of rapidcfd_tpu/ops/fvmatrix.py, relax,
set_values and H1 included).

LDU semantics as in the reference's fvMatrix : lduMatrix — face-indexed
lower/upper coefficients, per-patch internal/boundary coefficients, an
integrated source — with the off-diagonal product as an ELL gather or as
gdia plane shifts.

Sign convention: the assembled expression is E(psi) = M*psi - source; the
solve is M*psi = source. Patch coefficients: internal_coeffs[p] adds to
the diagonal of the patch's face cells, boundary_coeffs[p] to their
source (both shaped (size,) + rank of psi).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..utils.dimensions import DimensionSet

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
    def ell_coeffs(self, mesh: MeshArrays) -> torch.Tensor:
        """(nCells, K) off-diagonal coefficients, gathered from
        [upper | lower | 0]."""
        cat = torch.cat([self.upper, self.lower, self.upper.new_zeros(1)])
        return cat[mesh.ell_coeff_idx]

    def offdiag_mv(self, mesh: MeshArrays):
        """x -> sum_k coeff[c,k] * x[nbr[c,k]], the off-diagonal product:
        the (nCells, K) gather on ELL meshes, plane shifts on gdia
        meshes. x may be (n,) or (n, m)."""
        if mesh.gdia is not None:
            return gd.offdiag_mv(mesh.gdia, self.lower, self.upper)
        ell = self.ell_coeffs(mesh)

        def mv(x):
            g = x[mesh.cell_nbr]
            c = ell[..., None] if x.dim() == 2 else ell
            return (c * g).sum(1)
        return mv

    def _coupled_flags(self) -> tuple:
        """Per patch: True where the patch couples implicitly (cyclicAMI):
        its boundary_coeffs multiply the partner's ghost values inside the
        matrix product instead of folding into the source."""
        return tuple(bc.coupled for bc in self.psi.bcs)

    def coupled_mv(self, mesh: MeshArrays):
        """(x, out) -> out plus the implicit-interface part of M*x: at
        every coupled patch, -boundary_coeffs * ghost(x) added at the
        face cells (the reference's updateMatrixInterfaces). None when
        the matrix has no coupled patch."""
        items = [(p, i) for i, (p, cpl) in enumerate(
            zip(mesh.patches, self._coupled_flags())) if cpl and p.size]
        if not items:
            return None

        def mv(x, out):
            adds = []
            for p, i in items:
                cc = self.boundary_coeffs[i]
                if x.dim() == 1 and cc.dim() > 1:
                    cc = cc[:, 0]
                adds.append((p, -cc * mesh.ami_ghost(p, x)))
            return mesh.add_at_patches(out, adds)
        return mv

    def _ghost_sources(self, mesh: MeshArrays, psi):
        """(patch, boundary_coeffs) of every non-empty patch, a coupled
        patch's multiplied by the ghost values of psi."""
        return [(p, bc * mesh.ami_ghost(p, psi) if cpl else bc)
                for p, bc, cpl in zip(mesh.patches, self.boundary_coeffs,
                                      self._coupled_flags())
                if not (p.is_empty or p.size == 0)]

    def _system_items(self, mesh: MeshArrays, cmpt):
        """(diag items, source items) of the patch coefficients (one
        component's, unless cmpt is None); a coupled patch's boundary
        coefficients stay out of the source."""
        d_items, s_items = [], []
        for p, ic, bc, cpl in zip(mesh.patches, self.internal_coeffs,
                                  self.boundary_coeffs,
                                  self._coupled_flags()):
            if p.is_empty or p.size == 0:
                continue
            d_items.append((p, ic if cmpt is None else ic[:, cmpt]))
            if not cpl:
                s_items.append((p, bc if cmpt is None else bc[:, cmpt]))
        return d_items, s_items

    def component_system_all(self, mesh: MeshArrays):
        """(diag (n,m), source (n,m)) for a column-batched vector solve
        (patch internal coeffs may differ per component)."""
        m_comp = self.source.shape[1]
        diag = self.diag[:, None].expand(self.diag.shape[0], m_comp)
        d_items, s_items = self._system_items(mesh, None)
        diag = mesh.add_at_patches(diag, d_items)
        src = mesh.add_at_patches(self.source, s_items)
        diag, src = self._gdia_fold_system(mesh, diag, src)
        return diag, self._compat_project(src)

    def component_system(self, mesh: MeshArrays, cmpt: int | None):
        """(diag, source) for one component with the patch coefficients
        folded in (reference: addBoundaryDiag/addBoundarySource)."""
        src = self.source if cmpt is None else self.source[:, cmpt]
        d_items, s_items = self._system_items(mesh, cmpt)
        diag = mesh.add_at_patches(self.diag, d_items)
        src = mesh.add_at_patches(src, s_items)
        diag, src = self._gdia_fold_system(mesh, diag, src)
        return diag, self._compat_project(src)

    @staticmethod
    def _gdia_fold_system(mesh, diag, src):
        """gdia meshes: fold per-slot diag/source contributions (ghost
        rows) into the primary rows and NULL the ghost/dead rows (0*x = 0:
        inert in every residual sum and in the residual norm factor).
        The identity on ELL meshes."""
        g = mesh.gdia
        if g is None:
            return diag, src
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
        diag = mesh.add_at_patches(self.diag, items)
        g = mesh.gdia
        if g is not None:
            diag = gd.sync(g, gd.fold(g, diag))
            # dead slots have no equation (zero diag): pin A=1 there so
            # rAU stays finite (0*inf would poison surface sums)
            diag = diag + g.dead * mesh.V
        return _extrapolated(mesh, diag / mesh.V,
                             self.dims / (self.psi.dims * _VOL_DIMS),
                             f"A({self.psi.name})")

    def H(self, mesh: MeshArrays) -> VolField:
        """(source - offdiag*psi + boundary sources)/V (fvMatrix::H)."""
        from .fvc import _extrapolated
        psi = self.psi.data
        h = self.source - self.offdiag_mv(mesh)(psi)
        h = mesh.add_at_patches(h, self._ghost_sources(mesh, psi))
        g = mesh.gdia
        if g is not None:
            h = gd.sync(g, gd.fold(g, h))
        h = h / _ext(mesh.V, h)
        return _extrapolated(mesh, h, self.dims / _VOL_DIMS,
                             f"H({self.psi.name})")

    def H1(self, mesh: MeshArrays) -> VolField:
        """-(row sum of the off-diagonal coefficients)/V, i.e. H at psi = 1
        without the source (reference: lduMatrix::H1 and fvMatrix::H1; the
        SIMPLEC denominator 1/(1/rAU - H1)): the row sums, and at coupled
        patches the boundary coefficients (the reference adds
        boundaryCoeffs.component(0) there only); folded and synced on
        gdia meshes."""
        from .fvc import _extrapolated
        h = -self.offdiag_mv(mesh)(torch.ones_like(self.diag))
        h = mesh.add_at_patches(h, [
            (p, bc[..., 0] if bc.dim() > 1 else bc)
            for p, bc, cpl in zip(mesh.patches, self.boundary_coeffs,
                                  self._coupled_flags())
            if cpl and not (p.is_empty or p.size == 0)])
        g = mesh.gdia
        if g is not None:
            h = gd.sync(g, gd.fold(g, h))
        return _extrapolated(mesh, h / mesh.V,
                             self.dims / (self.psi.dims * _VOL_DIMS),
                             f"H1({self.psi.name})")

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
        for p, ic, bc, cpl in zip(mesh.patches, self.internal_coeffs,
                                  self.boundary_coeffs,
                                  self._coupled_flags()):
            if p.is_empty:
                parts.append(torch.zeros((p.size,), dtype=psi.dtype,
                                         device=psi.device))
                continue
            if cpl:
                bc = bc * mesh.ami_ghost(p, psi)
            parts.append(ic * mesh.patch_cell_values(p, psi) - bc)
        return SurfaceField(torch.cat(parts), self.dims,
                            f"flux({self.psi.name})")

    # -- manipulation ------------------------------------------------------------
    def relax(self, mesh: MeshArrays, alpha: float) -> "FvMatrix":
        """Under-relax (reference: fvMatrix::relax): make the diagonal at
        least the sum of the row's off-diagonal magnitudes (patch internal
        coeffs included), divide it by alpha and compensate the source
        with the current psi."""
        if alpha is None or alpha <= 0 or alpha >= 1.0 - 1e-12:
            return self
        g = mesh.gdia
        if g is not None:
            # ROW sums: row own holds upper, row nei holds lower, so the
            # arguments are swapped against negSumDiag's column sums
            sum_off = -gd.neg_sum_diag(g, self.upper.abs(), self.lower.abs())
        else:
            sum_off = self.ell_coeffs(mesh).abs().sum(1)
        items = [(p, ic.abs().mean(dim=-1) if ic.dim() > 1 else ic.abs())
                 for p, ic in zip(mesh.patches, self.internal_coeffs)
                 if not (p.is_empty or p.size == 0)]
        sum_off = mesh.add_at_patches(sum_off, items)
        d0 = self.diag
        if g is not None:
            # dominance on the FOLDED (per-cell) row; the whole change
            # lands on the primary slot, so the folded diagonal is the
            # reference's relaxed value
            d0f = gd.fold(g, d0)
            sof = gd.fold(g, sum_off)
            df = torch.where(d0f.abs() < sof, torch.sign(d0f) * sof, d0f)
            delta = (df / alpha - d0f) * g.primary
            src = self.source + _ext(delta, self.source) * self.psi.data
            return self.replace(diag=d0 + delta, source=src)
        d = torch.where(d0.abs() < sum_off, torch.sign(d0) * sum_off, d0)
        d = d / alpha
        src = self.source + _ext(d - d0, self.source) * self.psi.data
        return self.replace(diag=d, source=src)

    def set_values(self, mesh: MeshArrays, fix_mask, values) -> "FvMatrix":
        """Fix psi at the masked cells (reference: fvMatrix::setValues):
        the fixed rows become diag*psi = diag*value, and their columns move
        into the neighbours' sources, by gathers only.
        fix_mask: (nCells,) 1.0 where fixed; values: (nCells,) targets, or
        (nCells, 3) for a vector equation (the JAX package's set_values
        takes scalars only)."""
        from .fvc import face_own_nei
        fix_o, fix_n = face_own_nei(mesh, fix_mask)
        col = self.offdiag_mv(mesh)(_ext(fix_mask, values) * values)
        src = self.source - _ext(col, self.source)
        fm = _ext(fix_mask, src)
        src = src * (1.0 - fm) \
            + fm * _ext(_ext(self.diag, values) * values, src)
        keep = (1.0 - fix_o) * (1.0 - fix_n)
        return self.replace(upper=self.upper * keep, lower=self.lower * keep,
                            source=src, symmetric=False)

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
