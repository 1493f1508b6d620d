"""Lattice detection for masked-grid meshes — a numpy copy of
rapidcfd_tpu/utils/unstructured.py::detect_lattice (:530-607)."""

from __future__ import annotations

import numpy as np

from ..mesh.geometry import cell_centres_and_vols, face_centres_and_areas
from ..mesh.polymesh import PolyMesh


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
