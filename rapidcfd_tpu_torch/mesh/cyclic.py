"""Cyclic (periodic) patches merged into coupled internal faces — a numpy
copy of rapidcfd_tpu/mesh/cyclic.py, with the per-face loops done by
array operations (the merged mesh is integer-identical).

The reference couples a cyclic pair through interface updates of the
matrix (polyMesh/polyPatches/constraint/cyclic, cyclicFvPatchField,
cyclicLduInterface). Here each matched face pair becomes one internal
face before the renumbering: owner and neighbour are the two face cells
(the smaller first), the face keeps the A side's polygon, and every
operator downstream sees periodicity as ordinary connectivity. Only the
interpolation weights and delta coefficients across the interface need
the partner face, whose centre is kept per coupled face.

Translational (matching-plane) cyclics only, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from .polymesh import BoundaryPatch, PolyMesh


def find_cyclic_pairs(mesh: PolyMesh) -> list[tuple[int, int]]:
    """[(patch A index, patch B index), ...], each pair once."""
    by_name = {p.name: i for i, p in enumerate(mesh.patches)}
    pairs, seen = [], set()
    for i, p in enumerate(mesh.patches):
        if p.type != "cyclic" or i in seen:
            continue
        nbr = p.extra.word("neighbourPatch", "")
        if not nbr or nbr not in by_name:
            raise ValueError(
                f"cyclic patch '{p.name}' has no matching neighbourPatch")
        j = by_name[nbr]
        pairs.append((i, j))
        seen.update((i, j))
    return pairs


def merge_cyclic(mesh: PolyMesh, face_ctrs: np.ndarray):
    """The mesh with its cyclic pairs as coupled internal faces.

    Returns (merged PolyMesh, face_map, partner, a_cell, flip, b_face):
    face_map[new face] = old face (the B faces are dropped); partner[new
    face] the matched B face centre of a coupled face (NaN elsewhere);
    a_cell[new face] the cell whose own face carries the face's geometry
    (the A side's cell; -1 elsewhere); flip[new face] True where the face
    was reversed to keep owner < neighbour; b_face[new face] the old B
    face matched to a coupled face (-1 elsewhere)."""
    from scipy.spatial import cKDTree
    pairs = find_cyclic_pairs(mesh)
    n_int = mesh.n_internal_faces
    own = mesh.owner
    fp, off = mesh.face_points, mesh.face_offsets

    coupled_a, coupled_b, coupled_nei, coupled_ctr_b = [], [], [], []
    dropped = set()
    for ia, ib in pairs:
        pa, pb = mesh.patches[ia], mesh.patches[ib]
        if pa.n_faces != pb.n_faces:
            raise ValueError(f"cyclic pair {pa.name}/{pb.name}: "
                             "face counts differ")
        a_faces = np.arange(pa.start_face, pa.start_face + pa.n_faces)
        b_faces = np.arange(pb.start_face, pb.start_face + pb.n_faces)
        # match by the mean separation and the nearest centre (the
        # reference matches through the patch transforms and ordering)
        ca, cb = face_ctrs[a_faces], face_ctrs[b_faces]
        _, j = cKDTree(cb).query(ca + (cb.mean(0) - ca.mean(0)))
        if np.unique(j).size != j.size:
            raise ValueError(f"cyclic pair {pa.name}/{pb.name}: "
                             "face matching is not one-to-one")
        coupled_a.append(a_faces)
        coupled_b.append(b_faces[j])
        coupled_nei.append(own[b_faces[j]])
        coupled_ctr_b.append(cb[j])
        dropped.update((ia, ib))
    coupled_a = np.concatenate(coupled_a)
    coupled_nei = np.concatenate(coupled_nei)

    # new order: [internal | coupled A faces | remaining boundary faces]
    kept = [p for i, p in enumerate(mesh.patches) if i not in dropped]
    keep_bnd = np.concatenate(
        [np.arange(p.start_face, p.start_face + p.n_faces) for p in kept]
        + [np.zeros(0, np.int64)]).astype(np.int64)
    face_map = np.concatenate([np.arange(n_int), coupled_a, keep_bnd])

    # owner / neighbour with the coupled faces appended, owner < neighbour
    new_own = own[face_map].copy()
    new_nei = np.concatenate([mesh.neighbour, coupled_nei])
    n_int_new = new_nei.size
    flip = np.zeros(face_map.size, bool)
    flip[:n_int_new] = new_own[:n_int_new] > new_nei
    lo = np.minimum(new_own[:n_int_new], new_nei)
    new_nei = np.maximum(new_own[:n_int_new], new_nei)
    new_own[:n_int_new] = lo

    # face point lists, a flipped face reversed (owner-outward Sf)
    sizes = np.diff(off)[face_map]
    new_off = np.zeros(face_map.size + 1, dtype=np.int64)
    np.cumsum(sizes, out=new_off[1:])
    face_of = np.repeat(np.arange(face_map.size), sizes)
    k = np.arange(new_off[-1]) - new_off[face_of]
    k = np.where(flip[face_of], sizes[face_of] - 1 - k, k)
    new_fp = fp[off[face_map][face_of] + k]

    partner = np.full((face_map.size, 3), np.nan)
    partner[n_int:n_int_new] = np.concatenate(coupled_ctr_b)
    a_cell = np.full(face_map.size, -1, dtype=np.int64)
    a_cell[n_int:n_int_new] = own[coupled_a]
    b_face = np.full(face_map.size, -1, dtype=np.int64)
    b_face[n_int:n_int_new] = np.concatenate(coupled_b)

    new_patches, start = [], n_int_new
    for p in kept:
        new_patches.append(BoundaryPatch(p.name, p.type, start, p.n_faces,
                                         p.extra))
        start += p.n_faces
    merged = PolyMesh(mesh.points, new_fp, new_off, new_own, new_nei,
                      new_patches)
    return merged, face_map, partner, a_cell, flip, b_face


def cyclic_interpolation_override(mesh: PolyMesh, partner: np.ndarray,
                                  a_cell: np.ndarray, C: np.ndarray,
                                  Cf: np.ndarray, Sf: np.ndarray,
                                  coeffs: dict) -> dict:
    """Weights and delta coefficients of the coupled faces from the two
    half-deltas (owner cell to its side of the interface, neighbour cell
    to its matched side), not the cell-to-cell vector across the
    domain."""
    n_int = mesh.n_internal_faces
    f = np.nonzero(a_cell[:n_int] >= 0)[0]
    if not f.size:
        return coeffs
    o, n = mesh.owner[f], mesh.neighbour[f]
    own_is_a = (o == a_cell[f])[:, None]
    cf_own = np.where(own_is_a, Cf[f], partner[f])
    cf_nei = np.where(own_is_a, partner[f], Cf[f])
    sf = Sf[f]
    nhat = sf / np.maximum(np.linalg.norm(sf, axis=1), 1e-300)[:, None]
    sfd_own = np.einsum("ij,ij->i", sf, cf_own - C[o])
    sfd_nei = np.einsum("ij,ij->i", sf, C[n] - cf_nei)
    tot = np.where(np.abs(sfd_own + sfd_nei) < 1e-300, 1e-300,
                   sfd_own + sfd_nei)
    coeffs["weights"][f] = sfd_nei / tot
    dist = np.einsum("ij,ij->i", nhat, cf_own - C[o]) \
        + np.einsum("ij,ij->i", nhat, C[n] - cf_nei)
    coeffs["delta_coeffs"][f] = 1.0 / np.maximum(np.abs(dist), 1e-300)
    coeffs["nonorth_delta_coeffs"][f] = coeffs["delta_coeffs"][f]
    coeffs["corr_vecs"][f] = 0.0
    return coeffs
