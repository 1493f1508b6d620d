"""Mesh geometry: face centres/areas, cell centres/volumes, interpolation
coefficients, and the bandwidth-reducing renumbering — a numpy copy of
rapidcfd_tpu/mesh/geometry.py (the same algorithms as the reference's
primitiveMesh, surfaceInterpolation and bandCompression, so the two
packages build bit-identical geometry). Host-side, run once at mesh
load."""

from __future__ import annotations

import numpy as np

from .polymesh import PolyMesh


def face_centres_and_areas(mesh: PolyMesh) -> tuple[np.ndarray, np.ndarray]:
    nf = mesh.n_faces
    ctrs = np.zeros((nf, 3))
    areas = np.zeros((nf, 3))
    pts = mesh.points
    fp, off = mesh.face_points, mesh.face_offsets
    sizes = np.diff(off)

    # triangles: exact formula
    tri = np.nonzero(sizes == 3)[0]
    if tri.size:
        p0 = pts[fp[off[tri]]]
        p1 = pts[fp[off[tri] + 1]]
        p2 = pts[fp[off[tri] + 2]]
        ctrs[tri] = (p0 + p1 + p2) / 3.0
        areas[tri] = 0.5 * np.cross(p1 - p0, p2 - p0)

    # general faces: decompose about the estimated centre, per size
    for s in np.unique(sizes[sizes != 3]):
        idx = np.nonzero(sizes == s)[0]
        p = pts[fp[off[idx][:, None] + np.arange(s)[None, :]]]
        c_est = p.mean(axis=1)
        p_next = np.roll(p, -1, axis=1)
        ta = 0.5 * np.cross(p_next - p, c_est[:, None, :] - p)
        tc = (p + p_next + c_est[:, None, :]) / 3.0
        ta_mag = np.linalg.norm(ta, axis=2)
        sum_a = ta_mag.sum(axis=1)
        sum_ac = (ta_mag[:, :, None] * tc).sum(axis=1)
        sum_n = ta.sum(axis=1)
        small = sum_a < 1e-300
        ctrs[idx] = np.where(small[:, None], c_est,
                             sum_ac / np.maximum(sum_a, 1e-300)[:, None])
        areas[idx] = sum_n
    return ctrs, areas


def cell_centres_and_vols(mesh: PolyMesh, face_ctrs: np.ndarray,
                          face_areas: np.ndarray,
                          nei_face_ctrs: np.ndarray | None = None
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Pyramid decomposition about the face-centre average.
    nei_face_ctrs: the internal faces' centres seen from the neighbour
    cell, which differ from face_ctrs only at merged cyclic faces (the
    neighbour's own face lies at the matched partner)."""
    nc = mesh.n_cells
    own, nei = mesh.owner, mesh.neighbour
    n_int = mesh.n_internal_faces
    if nei_face_ctrs is None:
        nei_face_ctrs = face_ctrs[:n_int]

    c_est = np.zeros((nc, 3))
    n_cell_faces = np.zeros(nc)
    np.add.at(c_est, own, face_ctrs)
    np.add.at(n_cell_faces, own, 1.0)
    np.add.at(c_est, nei, nei_face_ctrs)
    np.add.at(n_cell_faces, nei, 1.0)
    c_est /= n_cell_faces[:, None]

    ctrs = np.zeros((nc, 3))
    vols = np.zeros(nc)

    def accumulate(cells, fc, fa, sign):
        pyr3 = sign * np.einsum("ij,ij->i", fa, fc - c_est[cells])
        pc = 0.75 * fc + 0.25 * c_est[cells]
        np.add.at(vols, cells, pyr3)
        np.add.at(ctrs, cells, pyr3[:, None] * pc)

    accumulate(own, face_ctrs, face_areas, 1.0)
    accumulate(nei, nei_face_ctrs, face_areas[:n_int], -1.0)

    ctrs /= np.maximum(vols, 1e-300)[:, None]
    vols /= 3.0
    return ctrs, vols


def interpolation_coeffs(mesh: PolyMesh, C: np.ndarray, Cf: np.ndarray,
                         Sf: np.ndarray) -> dict:
    """Linear weights, deltaCoeffs, nonOrthDeltaCoeffs, correction vectors
    on internal faces, plus the boundary-face delta coefficients."""
    own, nei = mesh.owner, mesh.neighbour
    n_int = mesh.n_internal_faces
    own_i = own[:n_int]

    sf = Sf[:n_int]
    sfd_own = np.einsum("ij,ij->i", sf, Cf[:n_int] - C[own_i])
    sfd_nei = np.einsum("ij,ij->i", sf, C[nei] - Cf[:n_int])
    weights = sfd_nei / np.where(np.abs(sfd_own + sfd_nei) < 1e-300, 1e-300,
                                 sfd_own + sfd_nei)

    delta = C[nei] - C[own_i]
    mag_delta = np.linalg.norm(delta, axis=1)
    delta_coeffs = 1.0 / np.maximum(mag_delta, 1e-300)

    mag_sf = np.linalg.norm(sf, axis=1)
    nhat = sf / np.maximum(mag_sf, 1e-300)[:, None]
    n_dot_d = np.einsum("ij,ij->i", nhat, delta)
    nonorth_delta_coeffs = 1.0 / np.maximum(n_dot_d, 0.05 * mag_delta)
    corr_vecs = nhat - delta * nonorth_delta_coeffs[:, None]

    bdelta = Cf[n_int:] - C[own[n_int:]]
    bmag = np.linalg.norm(bdelta, axis=1)
    b_delta_coeffs = 1.0 / np.maximum(bmag, 1e-300)
    bsf = Sf[n_int:]
    bmag_sf = np.linalg.norm(bsf, axis=1)
    bnhat = bsf / np.maximum(bmag_sf, 1e-300)[:, None]
    bn_dot_d = np.einsum("ij,ij->i", bnhat, bdelta)
    b_nonorth_delta_coeffs = 1.0 / np.maximum(bn_dot_d, 0.05 * bmag)

    return dict(
        weights=weights,
        delta_coeffs=delta_coeffs,
        nonorth_delta_coeffs=nonorth_delta_coeffs,
        corr_vecs=corr_vecs,
        b_delta_coeffs=b_delta_coeffs,
        b_nonorth_delta_coeffs=b_nonorth_delta_coeffs,
        b_delta=bdelta,
    )


def cuthill_mckee(mesh: PolyMesh, reverse: bool = True) -> np.ndarray:
    """Bandwidth-reducing cell renumbering (scipy's reverse Cuthill-McKee;
    the reference's bandCompression, src/OpenFOAM/meshes/bandCompression/
    bandCompression.H:27-34). Returns perm with perm[new] = old."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    nc = mesh.n_cells
    n_int = mesh.n_internal_faces
    own = mesh.owner[:n_int]
    nei = mesh.neighbour
    a = sp.coo_matrix(
        (np.ones(2 * n_int),
         (np.concatenate([own, nei]), np.concatenate([nei, own]))),
        shape=(nc, nc)).tocsr()
    perm = reverse_cuthill_mckee(a, symmetric_mode=True)
    if not reverse:
        perm = perm[::-1].copy()
    return np.asarray(perm, dtype=np.int64)


def renumber_mesh(mesh: PolyMesh, perm: np.ndarray):
    """Apply a cell permutation (perm[new] = old) and restore the
    owner-sorted upper-triangular face ordering of the polyMesh format.

    Returns (mesh, face_perm, face_flip): face_perm[new] = old face
    (boundary faces keep their place), face_flip[new] is True where the
    face was reversed to keep owner < neighbour, so that a face flux on
    the new mesh is the negative of the file's."""
    nc = mesh.n_cells
    n_int = mesh.n_internal_faces
    inv = np.empty(nc, dtype=np.int64)
    inv[perm] = np.arange(nc)

    own = inv[mesh.owner]
    nei = inv[mesh.neighbour]

    # ensure owner < neighbour on internal faces (flip face if swapped)
    flip = own[:n_int] > nei
    new_own = own.copy()
    new_own[:n_int] = np.where(flip, nei, own[:n_int])
    new_nei = np.where(flip, own[:n_int], nei)

    # re-sort internal faces by (owner, neighbour); boundary faces stay put
    order = np.lexsort((new_nei, new_own[:n_int]))

    fp, off = mesh.face_points, mesh.face_offsets
    new_fp_chunks = []
    sizes = np.diff(off)
    new_sizes = np.concatenate([sizes[order], sizes[n_int:]])
    for fi in order:
        pts = fp[off[fi]:off[fi + 1]]
        if flip[fi]:
            pts = pts[::-1]
        new_fp_chunks.append(pts)
    new_fp_chunks.append(fp[off[n_int]:])
    new_fp = np.concatenate(new_fp_chunks)
    new_off = np.zeros(len(new_sizes) + 1, dtype=np.int64)
    np.cumsum(new_sizes, out=new_off[1:])

    final_own = np.concatenate([new_own[:n_int][order], new_own[n_int:]])
    final_nei = new_nei[order]
    out = PolyMesh(mesh.points, new_fp, new_off, final_own, final_nei,
                   mesh.patches)
    face_perm = np.concatenate(
        [order, np.arange(n_int, mesh.n_faces)]).astype(np.int64)
    face_flip = np.concatenate([flip[order],
                                np.zeros(mesh.n_faces - n_int, bool)])
    return out, face_perm, face_flip
