"""MeshArrays — the static device mesh (port of rapidcfd_tpu/mesh/
mesharrays.py). This slice ports the generalized-DIA lattice layout
(`build_gdia_mesh_arrays`, mesh/gdia.py); the padded-ELL build, RCM
renumbering, the structured-box layout and AMI come with later slices, so
MeshArrays carries no ELL connectivity yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .gdia import GaussPlanes, GdiaInfo, build_gauss_planes
from .geometry import (cell_centres_and_vols, face_centres_and_areas,
                       interpolation_coeffs)
from .polymesh import PolyMesh


@dataclass(frozen=True)
class Patch:
    """Static boundary-patch metadata (name/type/face range)."""
    name: str
    type: str
    start: int      # face index of the first patch face (device layout)
    size: int
    bstart: int     # index into boundary-face-indexed arrays

    @property
    def is_empty(self) -> bool:
        return self.type == "empty"


@dataclass(frozen=True)
class MeshArrays:
    # face-indexed geometry/topology (internal faces = lattice planes)
    owner: torch.Tensor          # (nFaces,) int64
    neighbour: torch.Tensor      # (nInternal,) int64
    Sf: torch.Tensor             # (nFaces, 3)
    mag_sf: torch.Tensor         # (nFaces,)
    Cf: torch.Tensor             # (nFaces, 3)
    # cell-indexed geometry (cells = lattice slots)
    C: torch.Tensor              # (nCells, 3)
    V: torch.Tensor              # (nCells,)
    # interpolation coefficients (internal faces)
    weights: torch.Tensor        # (nInternal,) owner weight
    delta_coeffs: torch.Tensor   # (nInternal,)
    nonorth_delta_coeffs: torch.Tensor
    corr_vecs: torch.Tensor      # (nInternal, 3)
    # boundary-face-indexed (size nFaces - nInternal)
    b_delta_coeffs: torch.Tensor
    b_nonorth_delta_coeffs: torch.Tensor
    n_cells: int
    n_faces: int
    n_internal: int
    patches: tuple
    gdia: GdiaInfo
    gauss: GaussPlanes
    # per-slot assembly volume (ghost/dead slots 0)
    V_assemble: torch.Tensor
    # batched boundary fold: bnd_cells[i] = face-cell of boundary face
    # bnd_sel[i] (bstart order, sorted by cell); None when every patch is
    # empty
    bnd_cells: torch.Tensor | None = None
    bnd_sel: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.V.device

    @property
    def dtype(self) -> torch.dtype:
        return self.V.dtype

    @property
    def V_asm(self) -> torch.Tensor:
        return self.V_assemble

    @property
    def n_boundary(self) -> int:
        return self.n_faces - self.n_internal

    def patch_face_cells(self, p: Patch) -> torch.Tensor:
        return self.owner[p.start:p.start + p.size]

    def patch_cell_values(self, p: Patch, data: torch.Tensor
                          ) -> torch.Tensor:
        """data at the patch's face cells."""
        return data.index_select(0, self.patch_face_cells(p))

    def add_at_patch_cells(self, p: Patch, data: torch.Tensor,
                           vals: torch.Tensor) -> torch.Tensor:
        """data[faceCells(p)] += vals."""
        return data.index_add(0, self.patch_face_cells(p), vals)

    def add_at_boundary_cells(self, data: torch.Tensor,
                              bvals: torch.Tensor) -> torch.Tensor:
        """data[faceCells] += bvals over every non-empty patch at once
        (bvals in bstart order): the per-cell sums of the boundary values
        are formed first and then added, as the JAX segment sum does."""
        if self.bnd_cells is None:
            return data
        vals = bvals.index_select(0, self.bnd_sel)
        add = torch.zeros_like(data).index_add_(0, self.bnd_cells, vals)
        return data + add

    def patch_mag_sf(self, p: Patch) -> torch.Tensor:
        return self.mag_sf[p.start:p.start + p.size]

    def patch_sf(self, p: Patch) -> torch.Tensor:
        return self.Sf[p.start:p.start + p.size]

    def patch_delta_coeffs(self, p: Patch) -> torch.Tensor:
        return self.b_delta_coeffs[p.bstart:p.bstart + p.size]

    def patch_normals(self, p: Patch) -> torch.Tensor:
        sf = self.patch_sf(p)
        return sf / torch.clamp(self.patch_mag_sf(p), min=1e-30)[:, None]


@dataclass(frozen=True)
class MeshMaps:
    """Orderings between on-disk and device layouts (perm[new] = old).
    cell_primary: bool mask of device slots that uniquely own a file cell
    (ghost slots mirror their primary; dead slots must not write back).
    n_file_faces: faces on disk (padded dummy faces map to this sentinel
    in face_perm)."""
    cell_perm: np.ndarray
    face_perm: np.ndarray
    cell_primary: np.ndarray
    n_file_faces: int

    @property
    def n_file_cells(self) -> int:
        return int(self.cell_perm[self.cell_primary].max()) + 1

    def cells_to_device(self, file_order: np.ndarray) -> np.ndarray:
        return file_order[self.cell_perm]

    def cells_to_file(self, dev_order: np.ndarray) -> np.ndarray:
        perm = self.cell_perm[self.cell_primary]
        out = np.empty((self.n_file_cells,) + dev_order.shape[1:],
                       dev_order.dtype)
        out[perm] = dev_order[self.cell_primary]
        return out

    def faces_to_device(self, file_order: np.ndarray) -> np.ndarray:
        """Dummy (padded) faces read 0."""
        ext = np.concatenate(
            [file_order, np.zeros((1,) + file_order.shape[1:],
                                  file_order.dtype)])
        return ext[self.face_perm]

    def faces_to_file(self, dev_order: np.ndarray) -> np.ndarray:
        real = self.face_perm < self.n_file_faces
        out = np.empty((self.n_file_faces,) + dev_order.shape[1:],
                       dev_order.dtype)
        out[self.face_perm[real]] = dev_order[real]
        return out


def _bnd_batch(own: np.ndarray, patches):
    """(bnd_cells, bnd_sel) for the one-pass boundary fold, or
    (None, None) when every patch is empty. bnd_cells is sorted (stable);
    bnd_sel carries the matching permutation into bstart order."""
    cells, sel = [], []
    for p in patches:
        if p.is_empty or p.size == 0:
            continue
        cells.append(np.asarray(own[p.start:p.start + p.size]))
        sel.append(np.arange(p.bstart, p.bstart + p.size))
    if not cells:
        return None, None
    cells = np.concatenate(cells)
    sel = np.concatenate(sel)
    order = np.argsort(cells, kind="stable")
    return cells[order], sel[order]


def build_gdia_mesh_arrays(mesh: PolyMesh, lattice: dict, *, device,
                           dtype) -> tuple[MeshArrays, PolyMesh, MeshMaps]:
    """Build MeshArrays in the generalized-DIA lattice mode.

    `lattice` is the embedding from utils.unstructured.detect_lattice:
    shape (nz, ny, nx), slot_cell (n_lat,) cell per slot, ghost_lead
    (n_lat,) leader slot per slot, orig_own_int/orig_nei_int (per internal
    face, in face order), orig_own_bnd, flip_int and dead.

    Cells become lattice slots (fields padded, ghost slots mirroring their
    primary); internal faces become up to three full (n_lat,) offset
    planes with zero-area dummies.
    """
    nz, ny, nx = lattice["shape"]
    n_lat = nz * ny * nx
    slot_cell = np.asarray(lattice["slot_cell"], np.int64)
    ghost_lead = np.asarray(lattice["ghost_lead"], np.int64)
    oo = np.asarray(lattice["orig_own_int"], np.int64)
    on = np.asarray(lattice["orig_nei_int"], np.int64)
    ob = np.asarray(lattice["orig_own_bnd"], np.int64)
    flip = np.asarray(lattice.get("flip_int",
                                  np.zeros(oo.size, dtype=bool)))
    if slot_cell.size != n_lat:
        raise ValueError(f"slot_cell has {slot_cell.size} slots, lattice "
                         f"{n_lat}")

    # geometry on the REAL mesh (compacted cells, real faces)
    Cf, Sf = face_centres_and_areas(mesh)
    C, V = cell_centres_and_vols(mesh, Cf, Sf)
    coeffs = interpolation_coeffs(mesh, C, Cf, Sf)
    n_int_r = mesh.n_internal_faces
    nf_r = mesh.n_faces
    n_bnd = nf_r - n_int_r

    # plane classification: every internal face separates two
    # lattice-adjacent slots
    steps = [st for st, on_ in zip((1, nx, nx * ny), (nx > 1, ny > 1, nz > 1))
             if on_]
    d = on - oo
    plane_of = np.full(n_int_r, -1, np.int64)
    for pi, st in enumerate(steps):
        plane_of[d == st] = pi
    if (plane_of < 0).any():
        bad = np.nonzero(plane_of < 0)[0][:5]
        raise ValueError(
            f"gdia: {int((plane_of < 0).sum())} internal faces are not "
            f"lattice-adjacent (first offsets {d[bad]})")
    n_planes = len(steps)
    n_pl = n_planes * n_lat
    pos = plane_of * n_lat + oo          # padded slot per real face
    n_faces_pad = n_pl + n_bnd

    def place_f(real, dummy):
        out = np.full((n_faces_pad,) + real.shape[1:], dummy, real.dtype)
        out[pos] = real[:n_int_r]
        out[n_pl:] = real[n_int_r:]
        return out

    def place_int(real, dummy):
        out = np.full((n_pl,) + real.shape[1:], dummy, real.dtype)
        out[pos] = real
        return out

    # flipped faces (owner order opposite to slot order) are re-oriented
    # into the slot convention: Sf/corr negate, w -> 1-w
    sgn_int = np.where(flip, -1.0, 1.0)
    Sf_slot = Sf.copy()
    Sf_slot[:n_int_r] *= sgn_int[:, None]
    w_slot = np.asarray(coeffs["weights"]).copy()
    w_slot[flip] = 1.0 - w_slot[flip]
    cv_slot = np.asarray(coeffs["corr_vecs"]).copy()
    cv_slot[flip] *= -1.0
    Sf_pad = place_f(Sf_slot, 0.0)
    Cf_pad = place_f(Cf, 0.0)
    w_pad = place_int(w_slot, 0.5)
    dc_pad = place_int(np.asarray(coeffs["delta_coeffs"]), 1.0)
    ndc_pad = place_int(np.asarray(coeffs["nonorth_delta_coeffs"]), 1.0)
    cv_pad = place_int(cv_slot, 0.0)

    # slot-space owner/neighbour (edge dummies clipped; their
    # coefficients are identically zero)
    slot_ids = np.arange(n_lat, dtype=np.int64)
    own_pad = np.concatenate([slot_ids] * n_planes + [ob])
    nei_pad = np.concatenate(
        [np.minimum(slot_ids + st, n_lat - 1) for st in steps])

    # dead slots (masked-out lattice cells) carry no DOF: null rows
    # (fold_diag) and no write-back (cell_primary)
    dead = np.asarray(lattice.get("dead", np.zeros(n_lat, bool)), bool)
    is_ghost = (ghost_lead != slot_ids) & ~dead
    ghost_axis = np.full(n_lat, -1, np.int64)
    for pi, st in enumerate(steps):
        ghost_axis[is_ghost & (slot_ids - ghost_lead == st)] = pi
    if (is_ghost & (ghost_axis < 0)).any():
        raise ValueError("gdia: ghost slot not lattice-adjacent to its "
                         "primary (chained merges unsupported)")
    primary = (~is_ghost & ~dead).astype(np.float64)

    patches = tuple(Patch(p.name, p.type, p.start_face - n_int_r + n_pl,
                          p.n_faces, p.start_face - n_int_r)
                    for p in mesh.patches)
    plane_mask = np.zeros(n_pl)
    plane_mask[pos] = 1.0

    def t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    ginfo = GdiaInfo(
        ghost_prev=tuple(
            t((ghost_axis == pi).astype(np.float64))
            if (ghost_axis == pi).any() else None
            for pi in range(n_planes)),
        dead=t(dead.astype(np.float64)),
        primary=t(primary),
        plane_mask=t(plane_mask),
        shape=(nz, ny, nx), sync_iters=1,
        axes=(nx > 1, ny > 1, nz > 1),
    )

    V_slot = np.where(primary > 0, V[slot_cell], 0.0)
    bnd_cells, bnd_sel = _bnd_batch(own_pad, patches)
    idx = torch.int64
    ma = MeshArrays(
        owner=t(own_pad, idx),
        neighbour=t(nei_pad, idx),
        Sf=t(Sf_pad),
        mag_sf=t(np.linalg.norm(Sf_pad, axis=1)),
        Cf=t(Cf_pad),
        C=t(C[slot_cell]),
        V=t(V[slot_cell]),
        weights=t(w_pad),
        delta_coeffs=t(dc_pad),
        nonorth_delta_coeffs=t(ndc_pad),
        corr_vecs=t(cv_pad),
        b_delta_coeffs=t(coeffs["b_delta_coeffs"]),
        b_nonorth_delta_coeffs=t(coeffs["b_nonorth_delta_coeffs"]),
        n_cells=n_lat, n_faces=n_faces_pad, n_internal=n_pl,
        patches=patches, gdia=ginfo,
        gauss=build_gauss_planes(ginfo, Sf_pad[:n_pl], w_pad,
                                 device=device, dtype=dtype),
        V_assemble=t(V_slot),
        bnd_cells=None if bnd_cells is None else t(bnd_cells, idx),
        bnd_sel=None if bnd_sel is None else t(bnd_sel, idx),
    )
    # maps: slot -> real cell (ghosts share their primary's cell);
    # padded face -> real face (dummies -> sentinel nf_r)
    face_perm = np.full(n_faces_pad, nf_r, np.int64)
    face_perm[pos] = np.arange(n_int_r)
    face_perm[n_pl:] = np.arange(n_int_r, nf_r)
    return ma, mesh, MeshMaps(slot_cell.copy(), face_perm, primary > 0,
                              nf_r)
