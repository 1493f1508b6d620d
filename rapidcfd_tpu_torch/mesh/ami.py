"""Arbitrary Mesh Interface (AMI) weights on the host — a numpy copy of
rapidcfd_tpu/mesh/ami.py (reference: src/meshTools/AMIInterpolation/
AMIInterpolation/AMIInterpolation.H:138-166, faceAreaWeightAMI).

For every face of the source patch, the fraction of its area that each
target face overlaps after the coupled transform (none, translational or
rotational): faces are projected onto the source face's plane and
clipped with Sutherland-Hodgman. Weights are normalised per source face
(cyclicAMI) or kept raw, summing to the covered fraction (cyclicACMI).
This runs once at mesh build; the device sees padded (size, K) index and
weight tables (mesh/mesharrays.AmiDevTable), and the coupled exchange
becomes one gather and a weighted sum.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class AmiPair:
    """One coupled AMI patch pair (indices into mesh.patches)."""
    src: int                  # patch index (owner side)
    tgt: int
    nbr_idx: np.ndarray       # (srcSize, K) target LOCAL face ids, pad 0
    weights: np.ndarray       # (srcSize, K) overlap fractions, pad 0
    # transform applied to TARGET-side vectors when seen from src side
    rot: np.ndarray | None    # (3,3) rotation or None
    sep: np.ndarray | None    # (3,) separation or None
    # cyclicACMI (partially-overlapping) extras: per-face covered
    # fraction, clamped to [tol, 1-tol] (reference:
    # cyclicACMIPolyPatch::srcMask, tolerance_ = 1e-6), and the
    # non-overlap patch index carrying the uncovered remainder. weights
    # rows then sum to the RAW coverage (reference: non-conformal
    # normaliseWeights divides by the full face area, AMIInterpolation.C:
    # 199-246), not to 1.
    mask: np.ndarray | None = None   # (srcSize,) or None for plain AMI
    non_overlap: int = -1            # patch index, -1 for plain AMI


def _poly_area(pts2):
    x, y = pts2[:, 0], pts2[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _cross2(a, b):
    return a[0] * b[1] - a[1] * b[0]


def _clip(subject, clipper):
    """Sutherland-Hodgman: clip subject polygon by CONVEX clipper
    (both (n,2) CCW)."""
    out = list(subject)
    n = len(clipper)
    for i in range(n):
        a, b = clipper[i], clipper[(i + 1) % n]
        edge = b - a
        inp = out
        out = []
        if not inp:
            break
        prev = inp[-1]
        prev_in = _cross2(edge, prev - a) >= 0
        for cur in inp:
            cur_in = _cross2(edge, cur - a) >= 0
            if cur_in != prev_in:
                denom = _cross2(edge, cur - prev)
                t = _cross2(edge, a - prev) / denom if denom != 0 else 0.0
                out.append(prev + t * (cur - prev))
            if cur_in:
                out.append(cur)
            prev, prev_in = cur, cur_in
    return np.asarray(out) if out else np.zeros((0, 2))


def _face_poly(mesh, f):
    s, e = mesh.face_offsets[f], mesh.face_offsets[f + 1]
    return mesh.points[mesh.face_points[s:e]]


def _ccw(pts2):
    x, y = pts2[:, 0], pts2[:, 1]
    if 0.5 * (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))) < 0:
        return pts2[::-1]
    return pts2


def rotation_about_axis(axis, angle):
    a = np.asarray(axis, float)
    a = a / np.linalg.norm(a)
    c, s = np.cos(angle), np.sin(angle)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) * c + s * K + (1 - c) * np.outer(a, a)


def compute_ami_weights(mesh, src_patch, tgt_patch, face_ctrs, face_areas,
                        rot=None, sep=None, centre=None,
                        kmax=None, normalize=True):
    """Padded (idx, weights) tables mapping target faces onto each
    source face. rot/sep transform TARGET geometry into the source
    frame (x' = rot @ (x - centre) + centre, or x' = x + sep).
    normalize=False keeps the raw overlap fractions (rows sum to the
    covered fraction — the partial-overlap cyclicACMI mode, reference
    imPartialFaceAreaWeight)."""
    sp, tp = src_patch, tgt_patch
    n_src = sp.n_faces

    def tx(pts):
        if rot is not None:
            c = np.zeros(3) if centre is None else np.asarray(centre)
            return (pts - c) @ rot.T + c
        if sep is not None:
            return pts + sep
        return pts

    src_polys = [_face_poly(mesh, sp.start_face + i) for i in range(n_src)]
    tgt_polys = [tx(_face_poly(mesh, tgt_patch.start_face + j))
                 for j in range(tgt_patch.n_faces)]
    tgt_ctrs = np.array([p.mean(0) for p in tgt_polys])
    # every target vertex, and where each polygon's run starts in them:
    # the candidates' bounding boxes in the source plane are taken in one
    # pass, and a candidate whose box misses the source face's (by more
    # than a rounding margin) is skipped before the clip, which would
    # give it no area (the weights are those of the JAX package's loop)
    tgt_flat = np.concatenate(tgt_polys) if tgt_polys else np.zeros((0, 3))
    tgt_len = np.array([len(p) for p in tgt_polys], np.int64)
    tgt_off = np.concatenate([[0], np.cumsum(tgt_len)[:-1]]).astype(
        np.int64)

    idx_rows, w_rows = [], []
    for i in range(n_src):
        poly = src_polys[i]
        ctr = poly.mean(0)
        # local orthonormal basis of the source face plane
        nrm = np.cross(poly[1] - poly[0], poly[2] - poly[0])
        nn = np.linalg.norm(nrm)
        if nn < 1e-30:
            idx_rows.append([])
            w_rows.append([])
            continue
        nrm = nrm / nn
        e1 = poly[1] - poly[0]
        e1 = e1 / np.linalg.norm(e1)
        e2 = np.cross(nrm, e1)

        def to2d(p):
            d = p - ctr
            return np.stack([d @ e1, d @ e2], axis=-1)

        sp2 = _ccw(to2d(poly))
        a_src = _poly_area(sp2)
        # candidate target faces: centres within ~2 face diameters
        diam = np.sqrt(a_src) * 3.0 + 1e-12
        cand = np.where(np.linalg.norm(tgt_ctrs - ctr, axis=1)
                        < max(diam, 4 * np.sqrt(a_src)))[0]
        if cand.size:
            lens = tgt_len[cand]
            seg = np.concatenate([[0], np.cumsum(lens)[:-1]])
            pts = tgt_flat[np.repeat(tgt_off[cand] - seg, lens)
                           + np.arange(lens.sum())] - ctr
            margin = 1e-6 * np.sqrt(a_src)
            keep = np.ones(cand.size, bool)
            for e, c in ((e1, sp2[:, 0]), (e2, sp2[:, 1])):
                u = pts @ e
                keep &= (np.minimum.reduceat(u, seg) <= c.max() + margin) \
                    & (np.maximum.reduceat(u, seg) >= c.min() - margin)
            cand = cand[keep]
        row_i, row_w = [], []
        for j in cand:
            tp2 = _ccw(to2d(tgt_polys[j]))
            inter = _clip(tp2, sp2)
            if len(inter) >= 3:
                a = _poly_area(inter)
                if a > 1e-12 * a_src:
                    row_i.append(int(j))
                    row_w.append(a / a_src)
        idx_rows.append(row_i)
        w_rows.append(row_w)

    K = kmax or max((len(r) for r in idx_rows), default=1) or 1
    idx = np.zeros((n_src, K), np.int64)
    w = np.zeros((n_src, K))
    low = 0
    coverage = 0.0
    for i, (ri, rw) in enumerate(zip(idx_rows, w_rows)):
        ri, rw = ri[:K], rw[:K]
        idx[i, :len(ri)] = ri
        w[i, :len(rw)] = rw
        s = sum(rw)
        coverage += min(s, 1.0)
        if s > 1e-8:
            if normalize:
                w[i] /= s       # normalise (reference: AMI weights sum 1)
        else:
            low += 1
    if low and normalize:
        from ..utils.logging import info
        info(f"AMI: {low}/{n_src} source faces have low overlap "
             f"(uncovered); weights zero there")
    return idx, w, coverage / max(n_src, 1)


def find_ami_pairs(mesh):
    """[(src_idx, tgt_idx, transform_kw), ...]; each pair once, from the
    side that lists neighbourPatch first (both sides get tables)."""
    by_name = {p.name: i for i, p in enumerate(mesh.patches)}
    pairs = []
    seen = set()
    for i, p in enumerate(mesh.patches):
        if p.type not in ("cyclicAMI", "cyclicACMI") or i in seen:
            continue
        nbr = p.extra.word("neighbourPatch", "")
        if nbr not in by_name:
            raise ValueError(f"{p.type} '{p.name}': neighbourPatch "
                             f"'{nbr}' not found")
        j = by_name[nbr]
        tr = p.extra.word("transform", "none")
        kw = {}
        if tr in ("rotational",):
            axis = np.asarray(
                [float(x) for x in p.extra.lookup("rotationAxis")])
            centre = np.asarray(
                [float(x) for x in p.extra.lookup("rotationCentre")])
            ang = p.extra.lookup("rotationAngle")
            if ang is None:
                raise ValueError("cyclicAMI rotational needs "
                                 "rotationAngle (degrees)")
            kw = dict(rot=rotation_about_axis(
                axis, np.deg2rad(float(ang))), centre=centre)
        elif tr in ("translational",):
            # separationVector: from THIS patch to the neighbour
            # (reference: cyclicAMIPolyPatch); mapping neighbour
            # geometry into this patch's frame subtracts it
            kw = dict(sep=-np.asarray(
                [float(x) for x in p.extra.lookup("separationVector")]))
        if p.type == "cyclicACMI":
            # each side carries its own nonOverlapPatch (reference:
            # cyclicACMIPolyPatch.C:247); build_ami_tables reads both
            q = mesh.patches[j]
            for side, sp in ((i, p), (j, q)):
                no = sp.extra.word("nonOverlapPatch", "")
                if no not in by_name:
                    raise ValueError(
                        f"cyclicACMI '{sp.name}': nonOverlapPatch "
                        f"'{no}' not found")
            kw = dict(kw, acmi=True,
                      non_overlap={i: by_name[p.extra.word(
                          "nonOverlapPatch")],
                          j: by_name[q.extra.word("nonOverlapPatch")]})
        pairs.append((i, j, kw))
        seen.add(i)
        seen.add(j)
    return pairs


ACMI_TOLERANCE = 1e-6   # reference: cyclicACMIPolyPatch::tolerance_


def build_ami_tables(mesh, face_ctrs, face_areas):
    """All AMI pairs' padded tables, BOTH directions. Returns a dict
    {patch_index: AmiPair} (entries for src and tgt separately)."""
    out = {}
    for i, j, kw in find_ami_pairs(mesh):
        pi, pj = mesh.patches[i], mesh.patches[j]
        rot = kw.get("rot")
        sep = kw.get("sep")
        centre = kw.get("centre")
        acmi = kw.get("acmi", False)
        norm = not acmi
        # the separation/rotation SIGN convention differs between
        # OpenFOAM versions and user dicts — try both directions and
        # keep the one that actually overlaps the patches
        best = None
        for r_, s_ in (((rot, sep)) ,
                       ((rot.T if rot is not None else None,
                         -sep if sep is not None else None))):
            idx_, w_, cov = compute_ami_weights(
                mesh, pi, pj, face_ctrs, face_areas, rot=r_, sep=s_,
                centre=centre, normalize=norm)
            if best is None or cov > best[3]:
                best = (idx_, w_, (r_, s_), cov)
        idx_ij, w_ij, (rot, sep), cov = best
        if cov < 0.5 and not acmi:
            from ..utils.logging import info
            info(f"AMI pair {pi.name}<->{pj.name}: low coverage "
                 f"{cov:.2f} — check the transform spec")
        inv_rot = rot.T if rot is not None else None
        inv_sep = -sep if sep is not None else None
        idx_ji, w_ji, _ = compute_ami_weights(
            mesh, pj, pi, face_ctrs, face_areas, rot=inv_rot,
            sep=inv_sep, centre=centre, normalize=norm)
        mask_ij = mask_ji = None
        no_i = no_j = -1
        if acmi:
            tol = ACMI_TOLERANCE
            mask_ij = np.clip(w_ij.sum(1), tol, 1.0 - tol)
            mask_ji = np.clip(w_ji.sum(1), tol, 1.0 - tol)
            no = kw["non_overlap"]
            no_i, no_j = no[i], no[j]
        out[i] = AmiPair(i, j, idx_ij, w_ij, rot, sep,
                         mask=mask_ij, non_overlap=no_i)
        out[j] = AmiPair(j, i, idx_ji, w_ji, inv_rot, inv_sep,
                         mask=mask_ji, non_overlap=no_j)
    return out
