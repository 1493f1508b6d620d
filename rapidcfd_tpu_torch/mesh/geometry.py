"""Mesh geometry: face centres/areas, cell centres/volumes, interpolation
coefficients — a numpy copy of rapidcfd_tpu/mesh/geometry.py (the same
algorithms as the reference's primitiveMesh and surfaceInterpolation, so
the two packages build bit-identical geometry). Host-side, run once at
mesh load."""

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
                          face_areas: np.ndarray
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Pyramid decomposition about the face-centre average (the cyclic
    neighbour-centre variant of the JAX package is not ported)."""
    nc = mesh.n_cells
    own, nei = mesh.owner, mesh.neighbour
    n_int = mesh.n_internal_faces
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
