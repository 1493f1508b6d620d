"""MeshArrays — the static device mesh (port of rapidcfd_tpu/mesh/
mesharrays.py). Two layouts:

- the padded ELL (`build_mesh_arrays`): cells renumbered by reverse
  Cuthill-McKee, every cell owns K face slots with the face, its sign
  (+1 owner, -1 neighbour), the cell across it and the index of its LDU
  coefficient in [upper | lower | 0]; every finite-volume gather is a
  dense (nCells, K) indexed load and a reduction over K;
- the generalized-DIA lattice (`build_gdia_mesh_arrays`, mesh/gdia.py)
  for masked-lattice meshes.

The structured-box layout and cyclic/AMI coupling are TPU layouts or
later slices and are not ported.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch

from .gdia import GaussPlanes, GdiaInfo, build_gauss_planes
from .geometry import (cell_centres_and_vols, cuthill_mckee,
                       face_centres_and_areas, interpolation_coeffs,
                       renumber_mesh)
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
    # face-indexed geometry/topology
    owner: torch.Tensor          # (nFaces,) int64
    neighbour: torch.Tensor      # (nInternal,) int64
    Sf: torch.Tensor             # (nFaces, 3)
    mag_sf: torch.Tensor         # (nFaces,)
    Cf: torch.Tensor             # (nFaces, 3)
    # cell-indexed geometry
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
    # ELL connectivity (None on gdia meshes)
    cell_faces: torch.Tensor | None = None     # (nCells, K) int64, pad 0
    cell_sign: torch.Tensor | None = None      # (nCells, K) +1/-1/0
    cell_nbr: torch.Tensor | None = None       # (nCells, K) int64, pad self
    ell_coeff_idx: torch.Tensor | None = None  # (nCells, K) into [up|lo|0]
    internal_mask: torch.Tensor | None = None  # (nCells, K) 1.0 internal
    K: int = 0
    # generalized-DIA lattice embedding and its Gauss planes, or None
    gdia: GdiaInfo | None = None
    gauss: GaussPlanes | None = None
    # per-slot assembly volume (gdia ghost/dead slots 0); None = V
    V_assemble: torch.Tensor | None = None
    # batched boundary fold: bnd_cells[i] = face-cell of boundary face
    # bnd_sel[i] (bstart order, sorted by cell); bnd_uniq are the distinct
    # boundary cells and bnd_seg (len(bnd_uniq), M) the boundary faces of
    # each (bstart indices, padded with n_boundary). All None when every
    # patch is empty.
    bnd_cells: torch.Tensor | None = None
    bnd_sel: torch.Tensor | None = None
    bnd_uniq: torch.Tensor | None = None
    bnd_seg: torch.Tensor | None = None
    # GAMG agglomeration hierarchy (tuple of linalg.gamg.Level) attached by
    # linalg.precompute.attach_solver_layouts, or None
    gamg: tuple | None = None

    @property
    def device(self) -> torch.device:
        return self.V.device

    @property
    def dtype(self) -> torch.dtype:
        return self.V.dtype

    @property
    def V_asm(self) -> torch.Tensor:
        return self.V if self.V_assemble is None else self.V_assemble

    @property
    def n_boundary(self) -> int:
        return self.n_faces - self.n_internal

    def replace(self, **kw) -> "MeshArrays":
        return dataclasses.replace(self, **kw)

    def patch_face_cells(self, p: Patch) -> torch.Tensor:
        return self.owner[p.start:p.start + p.size]

    def patch_cell_values(self, p: Patch, data: torch.Tensor
                          ) -> torch.Tensor:
        """data at the patch's face cells."""
        return data.index_select(0, self.patch_face_cells(p))

    def add_at_boundary_cells(self, data: torch.Tensor,
                              bvals: torch.Tensor, dim: int = 0
                              ) -> torch.Tensor:
        """data[faceCells] += bvals over every non-empty patch at once
        (bvals in bstart order along `dim`). Each boundary cell's values
        are summed first, in bnd_cells order, and added once: the sorted
        segment sum of the JAX package, with no two adds to one cell (so
        the result does not depend on the order of atomics on the card)."""
        if self.bnd_seg is None:
            return data
        pad = list(bvals.shape)
        pad[dim] = 1
        ext = torch.cat([bvals, bvals.new_zeros(pad)], dim)
        idx = (slice(None),) * dim + (self.bnd_seg,)
        sums = ext[idx].sum(dim + 1)
        return data.index_add(dim, self.bnd_uniq, sums)

    def add_at_patches(self, data: torch.Tensor, items) -> torch.Tensor:
        """data[faceCells(p)] += vals over a list of (patch, vals) of
        non-empty patches, patch after patch and, within a patch, face
        after face: the order of the JAX package's per-patch scatter-adds
        (fvMatrix A, H and relax), so that a cell on two patches rounds
        as it does there. Each add writes unique indices (a cell with
        several faces on one patch takes them in successive adds), so the
        result does not depend on the order of atomics on the card."""
        for p, v in items:
            for pos, cells in _patch_add_columns(self, p):
                data = data.index_add(0, cells, v if pos is None
                                      else v.index_select(0, pos))
        return data

    def patch_mag_sf(self, p: Patch) -> torch.Tensor:
        return self.mag_sf[p.start:p.start + p.size]

    def patch_active(self, p: Patch) -> torch.Tensor:
        """1.0 for real patch faces, 0.0 for zero-area padding faces (a
        scatter over patch_face_cells must skip those)."""
        return (self.patch_mag_sf(p) > 0).to(self.mag_sf.dtype)

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
    (gdia ghost slots mirror their primary; dead slots must not write
    back; all True on ELL meshes). n_file_faces: faces on disk (gdia
    padded dummy faces map to this sentinel in face_perm). face_sign:
    -1.0 at device faces whose orientation is the reverse of the file's
    (renumbering or lattice re-orientation), +1.0 elsewhere; a face flux
    changes sign with it."""
    cell_perm: np.ndarray
    face_perm: np.ndarray
    cell_primary: np.ndarray
    n_file_faces: int
    face_sign: np.ndarray | None = None

    @property
    def n_file_cells(self) -> int:
        return int(self.cell_perm[self.cell_primary].max()) + 1

    def device_cell(self, file_cell: int) -> int:
        """The device row (the primary slot on gdia meshes) of a file-order
        cell label such as fvSolution's pRefCell."""
        rows = np.nonzero((self.cell_perm == file_cell)
                          & self.cell_primary)[0]
        if rows.size != 1:
            raise ValueError(f"cell {file_cell} is not a cell of the mesh "
                             f"({self.n_file_cells} cells)")
        return int(rows[0])

    def cells_to_device(self, file_order: np.ndarray) -> np.ndarray:
        return file_order[self.cell_perm]

    def cells_to_file(self, dev_order: np.ndarray) -> np.ndarray:
        perm = self.cell_perm[self.cell_primary]
        out = np.empty((self.n_file_cells,) + dev_order.shape[1:],
                       dev_order.dtype)
        out[perm] = dev_order[self.cell_primary]
        return out

    def _sign(self, data: np.ndarray) -> np.ndarray:
        return self.face_sign.reshape((-1,) + (1,) * (data.ndim - 1))

    def faces_to_device(self, file_order: np.ndarray,
                        flux: bool = False) -> np.ndarray:
        """Dummy (padded) faces read 0. flux=True: the data is a face flux
        and takes the device orientation."""
        ext = np.concatenate(
            [file_order, np.zeros((1,) + file_order.shape[1:],
                                  file_order.dtype)])
        out = ext[self.face_perm]
        if flux and self.face_sign is not None:
            out = out * self._sign(out)
        return out

    def faces_to_file(self, dev_order: np.ndarray,
                      flux: bool = False) -> np.ndarray:
        """flux=True: the data is a face flux and takes the file's
        orientation."""
        if flux and self.face_sign is not None:
            dev_order = dev_order * self._sign(dev_order)
        real = self.face_perm < self.n_file_faces
        out = np.empty((self.n_file_faces,) + dev_order.shape[1:],
                       dev_order.dtype)
        out[self.face_perm[real]] = dev_order[real]
        return out


#: (id(mesh.owner), patch start) -> (mesh.owner, columns): the per-patch
#: add columns of add_at_patches, computed once per mesh on the host
_PATCH_COLUMNS: dict = {}


def _patch_add_columns(mesh: MeshArrays, p: Patch):
    """[(face positions or None, face cells)] splitting a patch's faces
    into adds of unique cells, the k-th face of each cell in the k-th
    add (one add of every face, positions None, when the cells are
    distinct)."""
    key = (id(mesh.owner), p.start, p.size)
    hit = _PATCH_COLUMNS.get(key)
    if hit is not None and hit[0] is mesh.owner:
        return hit[1]
    cells_t = mesh.patch_face_cells(p)
    cells = cells_t.cpu().numpy()
    if np.unique(cells).size == cells.size:
        cols = [(None, cells_t)]
    else:
        order = np.argsort(cells, kind="stable")
        first = np.r_[0, np.nonzero(np.diff(cells[order]))[0] + 1]
        rank = np.empty(cells.size, np.int64)
        rank[order] = np.arange(cells.size) - np.repeat(
            first, np.diff(np.r_[first, cells.size]))
        cols = []
        for k in range(int(rank.max()) + 1):
            pos = np.nonzero(rank == k)[0]
            pos_t = torch.as_tensor(pos, device=cells_t.device)
            cols.append((pos_t, cells_t.index_select(0, pos_t)))
    _PATCH_COLUMNS[key] = (mesh.owner, cols)
    return cols


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


def _bnd_segments(bnd_cells: np.ndarray, bnd_sel: np.ndarray,
                  n_boundary: int):
    """(bnd_uniq, bnd_seg): the distinct cells of the sorted bnd_cells and,
    per cell, its boundary faces as bstart indices in bnd_cells order,
    padded with n_boundary (a zero slot)."""
    uniq, start, count = np.unique(bnd_cells, return_index=True,
                                   return_counts=True)
    seg = np.full((uniq.size, int(count.max())), n_boundary, np.int64)
    col = np.arange(bnd_cells.size) - np.repeat(start, count)
    seg[np.repeat(np.arange(uniq.size), count), col] = bnd_sel
    return uniq, seg


def _bnd_tensors(own: np.ndarray, patches, n_boundary: int, t) -> dict:
    """The four boundary-fold fields of MeshArrays, as tensors."""
    bnd_cells, bnd_sel = _bnd_batch(own, patches)
    if bnd_cells is None:
        return {}
    uniq, seg = _bnd_segments(bnd_cells, bnd_sel, n_boundary)
    idx = torch.int64
    return dict(bnd_cells=t(bnd_cells, idx), bnd_sel=t(bnd_sel, idx),
                bnd_uniq=t(uniq, idx), bnd_seg=t(seg, idx))


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
        **_bnd_tensors(own_pad, patches, n_bnd, t),
    )
    # maps: slot -> real cell (ghosts share their primary's cell);
    # padded face -> real face (dummies -> sentinel nf_r)
    face_perm = np.full(n_faces_pad, nf_r, np.int64)
    face_perm[pos] = np.arange(n_int_r)
    face_perm[n_pl:] = np.arange(n_int_r, nf_r)
    face_sign = np.ones(n_faces_pad)
    face_sign[pos[flip]] = -1.0
    return ma, mesh, MeshMaps(slot_cell.copy(), face_perm, primary > 0,
                              nf_r, face_sign)


def build_ell(own: np.ndarray, nei: np.ndarray, nc: int, n_int: int,
              active: np.ndarray) -> dict:
    """Pack face incidence into the padded ELL layout (host numpy).

    own: (nFaces,) owner cell per face; nei: (nInternal,); active:
    (nFaces,) bool mask of faces that take part (empty-patch faces do
    not). Returns cell_faces/cell_sign/cell_nbr/ell_idx/internal_mask/K.
    """
    act_f = np.nonzero(active)[0]
    act_int = act_f[act_f < n_int]
    cells = np.concatenate([own[act_f], nei[act_int]])
    faces = np.concatenate([act_f, act_int])
    signs = np.concatenate([np.ones(act_f.size), -np.ones(act_int.size)])
    order = np.argsort(cells, kind="stable")
    cells, faces, signs = cells[order], faces[order], signs[order]

    counts = np.bincount(cells, minlength=nc)
    K = int(counts.max()) if counts.size else 0
    starts = np.zeros(nc + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slots = np.arange(cells.size) - starts[cells]

    cell_faces = np.zeros((nc, K), dtype=np.int64)
    cell_sign = np.zeros((nc, K))
    cell_nbr = np.tile(np.arange(nc)[:, None], (1, K))
    ell_idx = np.full((nc, K), 2 * n_int, dtype=np.int64)
    internal_mask = np.zeros((nc, K))

    cell_faces[cells, slots] = faces
    cell_sign[cells, slots] = signs
    is_int = faces < n_int
    safe_f = np.minimum(faces, max(n_int - 1, 0))
    # owner-side slot of an internal face sees nei[f]; neighbour-side own[f]
    other = np.where(signs > 0, nei[safe_f] if n_int else cells, own[faces])
    cell_nbr[cells, slots] = np.where(is_int, other, cells)
    ell_idx[cells, slots] = np.where(
        is_int, np.where(signs > 0, faces, n_int + faces), 2 * n_int)
    internal_mask[cells, slots] = is_int.astype(float)
    return dict(cell_faces=cell_faces, cell_sign=cell_sign,
                cell_nbr=cell_nbr, ell_idx=ell_idx,
                internal_mask=internal_mask, K=K)


def build_mesh_arrays(mesh: PolyMesh, *, device, dtype,
                      timings: dict | None = None
                      ) -> tuple[MeshArrays, PolyMesh, MeshMaps]:
    """Host pipeline of the padded-ELL layout: renumber -> geometry -> ELL
    -> device. Returns (MeshArrays, renumbered PolyMesh, MeshMaps).
    timings, when given, receives the host seconds of the renumbering
    ("rcm"), of geometry and ELL ("mesh") and of the copy to the device
    ("upload")."""
    coupled = [p.name for p in mesh.patches
               if p.type in ("cyclic", "cyclicAMI", "cyclicACMI")]
    if coupled:
        raise NotImplementedError(
            f"coupled patches {coupled}: cyclic and AMI interfaces are not "
            "ported yet")
    t0 = time.perf_counter()
    nc0, nf0 = mesh.n_cells, mesh.n_faces
    cell_perm = np.arange(nc0, dtype=np.int64)
    face_perm = np.arange(nf0, dtype=np.int64)
    face_flip = np.zeros(nf0, bool)
    if mesh.n_internal_faces > 0:
        cell_perm = cuthill_mckee(mesh)
        mesh, face_perm, face_flip = renumber_mesh(mesh, cell_perm)
    t1 = time.perf_counter()

    Cf, Sf = face_centres_and_areas(mesh)
    C, V = cell_centres_and_vols(mesh, Cf, Sf)
    coeffs = interpolation_coeffs(mesh, C, Cf, Sf)
    nc, nf, n_int = mesh.n_cells, mesh.n_faces, mesh.n_internal_faces
    own, nei = mesh.owner, mesh.neighbour
    patches = tuple(Patch(p.name, p.type, p.start_face, p.n_faces,
                          p.start_face - n_int) for p in mesh.patches)
    # empty-patch faces (2-D cases) take no part in the ELL
    active = np.ones(nf, dtype=bool)
    for p in patches:
        if p.is_empty:
            active[p.start:p.start + p.size] = False
    ell = build_ell(own, nei, nc, n_int, active)
    t2 = time.perf_counter()

    def t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    idx = torch.int64
    ma = MeshArrays(
        owner=t(own, idx), neighbour=t(nei, idx), Sf=t(Sf),
        mag_sf=t(np.linalg.norm(Sf, axis=1)), Cf=t(Cf), C=t(C), V=t(V),
        weights=t(coeffs["weights"]),
        delta_coeffs=t(coeffs["delta_coeffs"]),
        nonorth_delta_coeffs=t(coeffs["nonorth_delta_coeffs"]),
        corr_vecs=t(coeffs["corr_vecs"]),
        b_delta_coeffs=t(coeffs["b_delta_coeffs"]),
        b_nonorth_delta_coeffs=t(coeffs["b_nonorth_delta_coeffs"]),
        n_cells=nc, n_faces=nf, n_internal=n_int, patches=patches,
        cell_faces=t(ell["cell_faces"], idx),
        cell_sign=t(ell["cell_sign"]),
        cell_nbr=t(ell["cell_nbr"], idx),
        ell_coeff_idx=t(ell["ell_idx"], idx),
        internal_mask=t(ell["internal_mask"]), K=ell["K"],
        **_bnd_tensors(own, patches, nf - n_int, t),
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if timings is not None:
        timings.update(rcm=t1 - t0, mesh=t2 - t1,
                       upload=time.perf_counter() - t2)
    maps = MeshMaps(cell_perm, face_perm, np.ones(nc, bool), nf,
                    np.where(face_flip, -1.0, 1.0))
    return ma, mesh, maps
