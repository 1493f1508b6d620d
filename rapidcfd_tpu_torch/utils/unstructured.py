"""The structured hex box and lattice detection for masked-grid meshes —
numpy copies of rapidcfd_tpu/utils/unstructured.py::box_mesh_fast (:32)
and detect_lattice (:530-607)."""

from __future__ import annotations

import numpy as np

from ..mesh.geometry import cell_centres_and_vols, face_centres_and_areas
from ..mesh.polymesh import BoundaryPatch, PolyMesh
from .dictionary import Dictionary

_SIDES = ("xmin", "xmax", "ymin", "ymax", "zmin", "zmax")


def box_mesh_fast(nx: int, ny: int, nz: int,
                  size=(1.0, 1.0, 1.0), origin=(0.0, 0.0, 0.0),
                  patch_spec: dict | None = None,
                  coords=None) -> PolyMesh:
    """Vectorized structured hex box (numpy; million-cell capable).

    Same mesh contract as casegen.box_mesh: owner-sorted upper-triangular
    internal faces first, then boundary faces grouped into patches by
    patch_spec {side: (name, type)} with sides sharing a name merged.
    coords=(xs, ys, zs) overrides the uniform spacing (graded meshes).
    """
    patch_spec = patch_spec or {s: (s, "patch") for s in _SIDES}
    if coords is not None:
        xs, ys, zs = (np.asarray(c, float) for c in coords)
    else:
        xs = origin[0] + np.linspace(0.0, size[0], nx + 1)
        ys = origin[1] + np.linspace(0.0, size[1], ny + 1)
        zs = origin[2] + np.linspace(0.0, size[2], nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    pts = np.stack([X.ravel(order="F"), Y.ravel(order="F"),
                    Z.ravel(order="F")], axis=1)

    npx, npxy = nx + 1, (nx + 1) * (ny + 1)

    def nid(i, j, k):
        return i + j * npx + k * npxy

    def cid(i, j, k):
        return i + j * nx + k * nx * ny

    own_l, nei_l, quad_l = [], [], []

    # x-internal faces: between cid(i,j,k) and cid(i+1,j,k), i in [0,nx-1)
    if nx > 1:
        i, j, k = np.meshgrid(np.arange(nx - 1), np.arange(ny),
                              np.arange(nz), indexing="ij")
        i, j, k = i.ravel(), j.ravel(), k.ravel()
        ii = i + 1
        own_l.append(cid(i, j, k))
        nei_l.append(cid(i + 1, j, k))
        quad_l.append(np.stack([nid(ii, j, k), nid(ii, j + 1, k),
                                nid(ii, j + 1, k + 1), nid(ii, j, k + 1)],
                               axis=1))
    # y-internal
    if ny > 1:
        i, j, k = np.meshgrid(np.arange(nx), np.arange(ny - 1),
                              np.arange(nz), indexing="ij")
        i, j, k = i.ravel(), j.ravel(), k.ravel()
        jj = j + 1
        own_l.append(cid(i, j, k))
        nei_l.append(cid(i, j + 1, k))
        quad_l.append(np.stack([nid(i, jj, k), nid(i, jj, k + 1),
                                nid(i + 1, jj, k + 1), nid(i + 1, jj, k)],
                               axis=1))
    # z-internal
    if nz > 1:
        i, j, k = np.meshgrid(np.arange(nx), np.arange(ny),
                              np.arange(nz - 1), indexing="ij")
        i, j, k = i.ravel(), j.ravel(), k.ravel()
        kk = k + 1
        own_l.append(cid(i, j, k))
        nei_l.append(cid(i, j, kk))
        quad_l.append(np.stack([nid(i, j, kk), nid(i + 1, j, kk),
                                nid(i + 1, j + 1, kk), nid(i, j + 1, kk)],
                               axis=1))

    own = np.concatenate(own_l) if own_l else np.zeros(0, np.int64)
    nei = np.concatenate(nei_l) if nei_l else np.zeros(0, np.int64)
    quads = (np.concatenate(quad_l, axis=0) if quad_l
             else np.zeros((0, 4), np.int64))
    order = np.lexsort((nei, own))
    own, nei, quads = own[order], nei[order], quads[order]

    # boundary faces per side (node order gives outward normals)
    def side_faces(side):
        # loop orders match casegen.box_mesh exactly: xmin/xmax (k,j),
        # ymin/ymax (k,i), zmin/zmax (j,i) — outer index first
        if side in ("xmin", "xmax"):
            k, j = np.meshgrid(np.arange(nz), np.arange(ny), indexing="ij")
            j, k = j.ravel(), k.ravel()
            if side == "xmin":
                return cid(0, j, k), np.stack(
                    [nid(0, j, k), nid(0, j, k + 1),
                     nid(0, j + 1, k + 1), nid(0, j + 1, k)], axis=1)
            return cid(nx - 1, j, k), np.stack(
                [nid(nx, j, k), nid(nx, j + 1, k),
                 nid(nx, j + 1, k + 1), nid(nx, j, k + 1)], axis=1)
        if side in ("ymin", "ymax"):
            k, i = np.meshgrid(np.arange(nz), np.arange(nx), indexing="ij")
            i, k = i.ravel(), k.ravel()
            if side == "ymin":
                return cid(i, 0, k), np.stack(
                    [nid(i, 0, k), nid(i + 1, 0, k),
                     nid(i + 1, 0, k + 1), nid(i, 0, k + 1)], axis=1)
            return cid(i, ny - 1, k), np.stack(
                [nid(i, ny, k), nid(i, ny, k + 1),
                 nid(i + 1, ny, k + 1), nid(i + 1, ny, k)], axis=1)
        j, i = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
        i, j = i.ravel(), j.ravel()
        if side == "zmin":
            return cid(i, j, 0), np.stack(
                [nid(i, j, 0), nid(i, j + 1, 0),
                 nid(i + 1, j + 1, 0), nid(i + 1, j, 0)], axis=1)
        return cid(i, j, nz - 1), np.stack(
            [nid(i, j, nz), nid(i + 1, j, nz),
             nid(i + 1, j + 1, nz), nid(i, j + 1, nz)], axis=1)

    patch_order: list[str] = []
    patch_type: dict[str, str] = {}
    patch_nbr: dict[str, str] = {}
    patch_sides: dict[str, list[str]] = {}
    for s, spec in patch_spec.items():
        name, typ = spec[0], spec[1]
        if name not in patch_type:
            patch_order.append(name)
            patch_type[name] = typ
            patch_sides[name] = []
            if len(spec) > 2:
                patch_nbr[name] = spec[2]
        patch_sides[name].append(s)

    owners = [own]
    face_quads = [quads]
    patches = []
    start = own.size
    for name in patch_order:
        p_own, p_quads = [], []
        for s in patch_sides[name]:
            o, q = side_faces(s)
            p_own.append(o)
            p_quads.append(q)
        p_own = np.concatenate(p_own)
        p_quads = np.concatenate(p_quads, axis=0)
        owners.append(p_own)
        face_quads.append(p_quads)
        extra = Dictionary()
        if name in patch_nbr:
            extra["neighbourPatch"] = patch_nbr[name]
        patches.append(BoundaryPatch(name, patch_type[name], start,
                                     p_own.size, extra))
        start += p_own.size

    all_own = np.concatenate(owners).astype(np.int64)
    all_quads = np.concatenate(face_quads, axis=0).astype(np.int64)
    nf = all_quads.shape[0]
    offsets = np.arange(nf + 1, dtype=np.int64) * 4
    return PolyMesh(pts, all_quads.ravel(), offsets, all_own,
                    nei.astype(np.int64), patches)




def _cluster_coords(v: np.ndarray, span: float):
    """Sorted unique cluster centres of a coordinate array (gap-based:
    values closer than 1e-6*span merge). Returns (centres, index-of-v)."""
    order = np.argsort(v)
    sv = v[order]
    tol = 1e-6 * max(span, 1e-300)
    brk = np.nonzero(np.diff(sv) > tol)[0]
    starts = np.concatenate([[0], brk + 1])
    ends = np.concatenate([brk + 1, [sv.size]])
    centres = np.array([sv[s:e].mean() for s, e in zip(starts, ends)])
    cluster_of_sorted = np.zeros(sv.size, np.int64)
    cluster_of_sorted[starts[1:]] = 1
    cluster_of_sorted = np.cumsum(cluster_of_sorted)
    out = np.empty(v.size, np.int64)
    out[order] = cluster_of_sorted
    return centres, out


def detect_lattice(mesh: PolyMesh) -> dict | None:
    """Recover a box-lattice embedding from an axis-aligned masked-grid
    mesh (forward steps, T-junctions, obstacles: a uniform-or-graded grid
    MINUS blanked cells). Returns the lattice dict consumed by
    build_gdia_mesh_arrays (dead slots marked), or None when the mesh is
    not of this class or is a full box (no dead slot)."""
    n_cells = mesh.n_cells
    if n_cells == 0:
        return None
    if any(p.type in ("cyclicAMI", "cyclicACMI") for p in mesh.patches):
        return None
    Cf, Sf = face_centres_and_areas(mesh)
    C, _ = cell_centres_and_vols(mesh, Cf, Sf)
    spans = C.max(axis=0) - C.min(axis=0)
    centres, idx = zip(*(_cluster_coords(C[:, a], float(spans.max()))
                         for a in range(3)))
    nx, ny, nz = (len(c) for c in centres)
    n_lat = nx * ny * nz
    if n_lat < n_cells or n_lat > 8 * n_cells:
        return None
    slot = idx[0] + idx[1] * nx + idx[2] * nx * ny
    if np.unique(slot).size != n_cells:
        return None
    n_int = mesh.n_internal_faces
    so = slot[mesh.owner[:n_int]]
    sn = slot[mesh.neighbour]
    d = sn - so
    if not np.isin(np.abs(d), [1, nx, nx * ny]).all():
        return None
    flip = d < 0
    slot_cell = np.zeros(n_lat, np.int64)
    slot_cell[slot] = np.arange(n_cells)
    dead = np.ones(n_lat, bool)
    dead[slot] = False
    if not dead.any():
        return None
    return {
        "shape": (nz, ny, nx),
        "slot_cell": slot_cell,
        "ghost_lead": np.arange(n_lat, dtype=np.int64),
        "orig_own_int": np.where(flip, sn, so),
        "orig_nei_int": np.where(flip, so, sn),
        "orig_own_bnd": slot[mesh.owner[n_int:]],
        "flip_int": flip,
        "dead": dead,
    }
