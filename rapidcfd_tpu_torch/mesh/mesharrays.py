"""MeshArrays — the static device mesh (port of rapidcfd_tpu/mesh/
mesharrays.py). Two layouts:

- the padded ELL (`build_mesh_arrays`): cells renumbered by reverse
  Cuthill-McKee, every cell owns K face slots with the face, its sign
  (+1 owner, -1 neighbour), the cell across it and the index of its LDU
  coefficient in [upper | lower | 0]; every finite-volume gather is a
  dense (nCells, K) indexed load and a reduction over K;
- the generalized-DIA lattice (`build_gdia_mesh_arrays`, mesh/gdia.py)
  for masked-lattice meshes.

Mesh coupling is an ELL matter: matched cyclic pairs are merged into
internal faces before the renumbering (mesh/cyclic.py), and cyclicAMI and
cyclicACMI patches stay patches whose ghost values are overlap-weighted
sums of the partner's face cells (mesh/ami.py, AmiDevTable). The
structured-box layout is a TPU layout and is not ported.
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
from ..utils.dictionary import Dictionary


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

    @property
    def is_ami(self) -> bool:
        return self.type in AMI_TYPES


#: patch types of the implicitly coupled interfaces kept as patches, and of
#: all coupled patches (a cyclic pair is merged into internal faces)
AMI_TYPES = ("cyclicAMI", "cyclicACMI")
COUPLED_TYPES = ("cyclic",) + AMI_TYPES


@dataclass(frozen=True)
class AmiDevTable:
    """The coupling table of one cyclicAMI/cyclicACMI patch on the device:
    its ghost values are w-weighted sums of the partner's face-cell
    values (rapidcfd_tpu/mesh/mesharrays.py:59-80)."""
    nbr_cells: torch.Tensor       # (size, K) int64 partner face cells
    w: torch.Tensor               # (size, K) overlap weights
    dc: torch.Tensor              # (size,) owner-ghost delta coefficient
    w_face: torch.Tensor          # (size,) owner weight of the face value
    rot: torch.Tensor | None = None   # (3, 3) vector transform
    #: the owner side of the pair (the patch listed first): jump BCs add
    #: +jump here and -jump on the other side (cyclicPolyPatch::owner())
    owner: bool = True
    partner: int = -1             # partner patch index
    #: cyclicACMI: per-face covered fraction in [tol, 1-tol] (the rows of
    #: w then sum to the raw coverage) and the non-overlap patch that
    #: carries the (1 - mask) remainder
    mask: torch.Tensor | None = None
    non_overlap: int = -1


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
    # cyclicAMI/cyclicACMI tables, one entry per patch (None where not
    # AMI); () when the mesh has no AMI interface
    ami: tuple = ()

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

    def ami_table(self, p: Patch) -> AmiDevTable | None:
        if not self.ami:
            return None
        return self.ami[self.patches.index(p)]

    def ami_ghost(self, p: Patch, x: torch.Tensor,
                  default: torch.Tensor | None = None) -> torch.Tensor:
        """The partner-side ghost values at an AMI patch's faces: the
        w-weighted sum of the partner face cells' values of x ((n,) or
        (n, m)), a vector rotated by the coupled transform. On a
        cyclicACMI patch the rows of w sum to the covered fraction, so
        the sum alone is the coupled part (the reference's matrix-side
        interpolate(pnf)); `default` adds the uncovered remainder,
        (1 - mask) * default (its interpolate(pnf, defaultValues))."""
        t = self.ami_table(p)
        g = x[t.nbr_cells]
        w = t.w[..., None] if x.dim() == 2 else t.w
        g = (w * g).sum(1)
        if t.rot is not None and x.dim() == 2 and x.shape[1] == 3:
            g = g @ t.rot.T
        if t.mask is not None and default is not None:
            m = t.mask[:, None] if g.dim() == 2 else t.mask
            g = g + (1.0 - m) * default
        return g

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
    changes sign with it. A mesh with merged cyclic pairs also keeps
    partner_face, the file face of the dropped B side of each merged
    device face (-1 elsewhere), whose flux is the negative of the A
    side's, and the file's layout: n_file_internal and file_patches,
    (name, type, start, size) of every patch, the cyclic ones included."""
    cell_perm: np.ndarray
    face_perm: np.ndarray
    cell_primary: np.ndarray
    n_file_faces: int
    face_sign: np.ndarray | None = None
    partner_face: np.ndarray | None = None
    file_patches: tuple | None = None
    n_file_internal: int | None = None

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
        if self.partner_face is not None:
            b = self.partner_face >= 0
            out[self.partner_face[b]] = (-1.0 if flux else 1.0) \
                * dev_order[b]
        return out

    def file_layout(self, n_boundary: int, patches) -> tuple:
        """(the file's internal face count, [(name, type, start, size)]
        of the file's patches); on a mesh without merged pairs these are
        the device patches."""
        if self.file_patches is not None:
            return self.n_file_internal, list(self.file_patches)
        n_int = self.n_file_faces - n_boundary
        return n_int, [(p.name, p.type, n_int + p.bstart, p.size)
                       for p in patches]


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
    coupled = coupled_patch_names(mesh)
    if coupled:
        raise ValueError(
            f"gdia: coupled patches {coupled} need the ELL layout (a merged "
            "cyclic face joins cells that are no lattice neighbours)")
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


def _patch_face_centres(mesh: PolyMesh, types) -> np.ndarray:
    """(nFaces, 3) face centres, those of the patches of the given types
    computed (face_centres_and_areas on those faces alone: each face's
    centre is its own arithmetic, so the values are the whole mesh's) and
    NaN elsewhere."""
    faces = np.concatenate(
        [np.arange(p.start_face, p.start_face + p.n_faces)
         for p in mesh.patches if p.type in types]
        + [np.zeros(0, np.int64)]).astype(np.int64)
    off = mesh.face_offsets
    sizes = off[faces + 1] - off[faces]
    sub_off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    face_of = np.repeat(np.arange(faces.size), sizes)
    sub_fp = mesh.face_points[off[faces][face_of] + np.arange(sub_off[-1])
                              - sub_off[face_of]]
    sub = PolyMesh(mesh.points, sub_fp, sub_off, mesh.owner[faces],
                   np.zeros(0, np.int64), [])
    out = np.full((mesh.n_faces, 3), np.nan)
    out[faces] = face_centres_and_areas(sub)[0]
    return out


def coupled_patch_names(mesh) -> list[str]:
    """The cyclic, cyclicAMI and cyclicACMI patches of a PolyMesh."""
    return [p.name for p in mesh.patches if p.type in COUPLED_TYPES]


def keep_cyclic_pairs(mesh: PolyMesh, keep_cyclic) -> PolyMesh:
    """A copy of the mesh whose cyclic pairs named in keep_cyclic (either
    side) are conformal cyclicAMI pairs: the pairs that carry jump BCs,
    which a merge would erase (reference: jumpCyclicFvPatchField with
    `patchType cyclic`). A pair with no transform takes the translation
    between its two sides' mean face centres, the rule the merge matches
    by (a coincident fan baffle gets 0). The input mesh and its patch
    dictionaries are left as they are (the JAX package writes the
    transform into the caller's patches,
    rapidcfd_tpu/mesh/mesharrays.py:416-418)."""
    keep = set(keep_cyclic)
    for p in mesh.patches:
        if p.name in keep and p.type == "cyclic":
            keep.add(p.extra.word("neighbourPatch", ""))
    Cf0 = _patch_face_centres(mesh, ("cyclic",))
    by_name = {p.name: p for p in mesh.patches}
    patches = []
    for p in mesh.patches:
        if p.name not in keep or p.type != "cyclic":
            patches.append(p)
            continue
        extra = Dictionary(p.extra)
        if extra.word("transform", "none") == "none":
            nbr = by_name[extra.word("neighbourPatch", "")]
            ca = Cf0[p.start_face:p.start_face + p.n_faces]
            cb = Cf0[nbr.start_face:nbr.start_face + nbr.n_faces]
            extra["transform"] = "translational"
            extra["separationVector"] = tuple(
                float(x) for x in cb.mean(0) - ca.mean(0))
        patches.append(dataclasses.replace(p, type="cyclicAMI",
                                           extra=extra))
    return dataclasses.replace(mesh, patches=patches)


def build_mesh_arrays(mesh: PolyMesh, *, device, dtype,
                      timings: dict | None = None, keep_cyclic=()
                      ) -> tuple[MeshArrays, PolyMesh, MeshMaps]:
    """Host pipeline of the padded-ELL layout: [keep_cyclic conversion]
    -> cyclic merge -> renumber -> geometry -> ELL -> device. Returns
    (MeshArrays, renumbered PolyMesh, MeshMaps). keep_cyclic names the
    cyclic pairs that stay coupled patches (keep_cyclic_pairs); every
    other cyclic pair is merged into internal faces before the
    renumbering, so the periodic edges inform the bandwidth. timings,
    when given, receives the host seconds of the merge ("merge"), the
    renumbering ("rcm"), of geometry, AMI weights and ELL ("mesh", the
    AMI weights also alone as "ami") and of the copy to the device
    ("upload")."""
    from .cyclic import cyclic_interpolation_override, merge_cyclic
    t0 = time.perf_counter()
    if keep_cyclic:
        mesh = keep_cyclic_pairs(mesh, keep_cyclic)
    nf_file = mesh.n_faces
    file_layout = (mesh.n_internal_faces,
                   tuple((p.name, p.extra.word("_originalType", p.type)
                          if p.extra else p.type, p.start_face, p.n_faces)
                         for p in mesh.patches))
    face_map0 = np.arange(nf_file, dtype=np.int64)
    partner = a_cell = b_face = None
    flip0 = np.zeros(nf_file, bool)
    merged = any(p.type == "cyclic" for p in mesh.patches)
    if merged:
        mesh, face_map0, partner, a_cell, flip0, b_face = merge_cyclic(
            mesh, _patch_face_centres(mesh, ("cyclic",)))
    t_merge = time.perf_counter()

    nc0, nf0 = mesh.n_cells, mesh.n_faces
    cell_perm = np.arange(nc0, dtype=np.int64)
    face_perm = np.arange(nf0, dtype=np.int64)
    face_flip = np.zeros(nf0, bool)
    if mesh.n_internal_faces > 0:
        cell_perm = cuthill_mckee(mesh)
        mesh, face_perm, face_flip = renumber_mesh(mesh, cell_perm)
        if merged:
            inv = np.empty(mesh.n_cells, dtype=np.int64)
            inv[cell_perm] = np.arange(mesh.n_cells)
            partner = partner[face_perm]
            a_cell = a_cell[face_perm]
            a_cell = np.where(a_cell >= 0, inv[np.maximum(a_cell, 0)], -1)
    face_flip = face_flip ^ flip0[face_perm]
    if merged:
        b_face = b_face[face_perm]
    face_perm = face_map0[face_perm]
    t1 = time.perf_counter()

    Cf, Sf = face_centres_and_areas(mesh)
    t_ami = time.perf_counter()
    raw_ami, area_scale = _ami_raw_tables(mesh)
    t_ami = time.perf_counter() - t_ami
    if area_scale is not None:
        # cyclicACMI area apportioning before the cell geometry: coupled
        # faces carry mask*|Sf0|, their non-overlap twins (1-mask)*|Sf0|
        # (reference: cyclicACMIPolyPatch::resetAMI), so the twin pair
        # counts the interface once in the cell volumes
        Sf = Sf * area_scale[:, None]
    own_ctrs, nei_ctrs = Cf, None
    if merged:
        n_int0 = mesh.n_internal_faces
        own_ctrs = Cf.copy()
        nei_ctrs = Cf[:n_int0].copy()
        cyc = a_cell[:n_int0] >= 0
        own_is_a = mesh.owner[:n_int0] == a_cell[:n_int0]
        # the cell that does not hold the A geometry sees the partner
        sel_o, sel_n = cyc & ~own_is_a, cyc & own_is_a
        own_ctrs[:n_int0][sel_o] = partner[:n_int0][sel_o]
        nei_ctrs[sel_n] = partner[:n_int0][sel_n]
    C, V = cell_centres_and_vols(mesh, own_ctrs, Sf, nei_ctrs)
    coeffs = interpolation_coeffs(mesh, C, Cf, Sf)
    if merged:
        coeffs = cyclic_interpolation_override(mesh, partner, a_cell, C,
                                               Cf, Sf, coeffs)
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
        ami=_build_ami(mesh, patches, raw_ami, coeffs["b_delta_coeffs"],
                       n_int, t),
        **_bnd_tensors(own, patches, nf - n_int, t),
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if timings is not None:
        timings.update(rcm=t1 - t_merge, mesh=t2 - t1,
                       upload=time.perf_counter() - t2)
        if merged:
            timings["merge"] = t_merge - t0
        if raw_ami is not None:
            timings["ami"] = t_ami
    maps = MeshMaps(cell_perm, face_perm, np.ones(nc, bool), nf_file,
                    np.where(face_flip, -1.0, 1.0))
    if merged:
        maps = dataclasses.replace(
            maps, partner_face=b_face, n_file_internal=file_layout[0],
            file_patches=file_layout[1])
    return ma, mesh, maps


def _ami_raw_tables(mesh: PolyMesh):
    """(raw, area_scale): the host AMI/ACMI tables {patch index: AmiPair}
    (None without AMI patches) and the (nFaces,) cyclicACMI area
    multiplier, mask on the coupled faces and 1 - mask on their
    non-overlap twins (reference: cyclicACMIPolyPatch.C:95-98), or None
    without ACMI. The weights need points and faces only, so this runs
    before the cell geometry, which the scaled areas must feed."""
    if not any(p.type in AMI_TYPES for p in mesh.patches):
        return None, None
    from .ami import build_ami_tables
    raw = build_ami_tables(mesh, None, None)
    scale = None
    for i, tab in raw.items():
        if tab.mask is None:
            continue
        p = mesh.patches[i]
        no = mesh.patches[tab.non_overlap]
        if no.n_faces != p.n_faces:
            raise ValueError(
                f"cyclicACMI '{p.name}': nonOverlapPatch '{no.name}' "
                f"size {no.n_faces} != patch size {p.n_faces}")
        if scale is None:
            scale = np.ones(mesh.n_faces)
        scale[p.start_face:p.start_face + p.n_faces] = tab.mask
        scale[no.start_face:no.start_face + no.n_faces] = 1.0 - tab.mask
    return raw, scale


def _build_ami(mesh: PolyMesh, patches, raw, b_dc, n_int, t) -> tuple:
    """The device AMI tables of every patch (None where not AMI) from
    the host tables and the delta coefficients across the interface: the
    owner's distance plus the w-averaged distance on the partner side
    (reference: cyclicAMIFvPatch::deltaCoeffs), renormalised by the
    coverage on cyclicACMI. () without AMI patches."""
    if raw is None:
        return ()
    out = []
    for i, p in enumerate(patches):
        if i not in raw:
            out.append(None)
            continue
        tab = raw[i]
        tgt = patches[tab.tgt]
        tgt_cells = np.asarray(mesh.owner[tgt.start:tgt.start + tgt.size])
        d_own = 1.0 / np.maximum(
            b_dc[p.start - n_int:p.start - n_int + p.size], 1e-30)
        d_tgt = 1.0 / np.maximum(
            b_dc[tgt.start - n_int:tgt.start - n_int + tgt.size], 1e-30)
        wsum = (np.maximum(tab.weights.sum(1), 1e-12)
                if tab.mask is not None else 1.0)
        d_ghost = (tab.weights * d_tgt[tab.nbr_idx]).sum(1) / wsum
        dc = 1.0 / np.maximum(d_own + d_ghost, 1e-30)
        w_face = d_ghost / np.maximum(d_own + d_ghost, 1e-30)
        out.append(AmiDevTable(
            nbr_cells=t(tgt_cells[tab.nbr_idx], torch.int64),
            w=t(tab.weights), dc=t(dc), w_face=t(w_face),
            rot=None if tab.rot is None else t(tab.rot),
            owner=i < tab.tgt, partner=tab.tgt,
            mask=None if tab.mask is None else t(tab.mask),
            non_overlap=tab.non_overlap))
    return tuple(out)
