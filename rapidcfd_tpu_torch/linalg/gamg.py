"""GAMG — geometric-algebraic multigrid, single device (port of
rapidcfd_tpu/linalg/gamg.py; reference: GAMGSolver.H:72, V-cycle in
GAMGSolverSolve.C:181-475).

Agglomeration on the host, cycling on the device:

- the hierarchy is faceAreaPair pair-agglomeration (reference:
  pairGAMGAgglomerate.C:31-130), geometry only, built once per mesh in
  numpy (the same code as the JAX package, so the levels are identical)
  and stored as tensors of gather addressing;
- each solve assembles the coarse matrices on the device by padded
  gathers over those maps; the V-cycle is a fixed-depth loop of Chebyshev
  (or damped-Jacobi) smooths with restriction and prolongation;
- the coarsest level is a dense inverse, computed once per solve and
  applied as a matrix product.

gdia lattice meshes take the structured geometric multigrid instead
(linalg/structured_mg.py), wrapped in a Krylov solver. The distributed
block hierarchy of the JAX package is not ported.
"""

from __future__ import annotations

import dataclasses
import types
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from ..mesh.mesharrays import MeshArrays, build_ell

# hierarchy shape when fvSolution sets neither mergeLevels nor
# nCellsInCoarsestLevel (the JAX package's defaults)
DEFAULT_MERGE_LEVELS = 4
DEFAULT_N_COARSEST = 1024

# (id(mesh.owner), shape args) -> (weakref to it, levels)
_HIERARCHY_CACHE: dict = {}


def gamg_shape(controls):
    """(n_coarsest, merge_levels), with the defaults for entries not set
    in fvSolution (SolverControls keeps None for those)."""
    nc = controls.n_coarsest_cells
    ml = controls.merge_levels
    return (DEFAULT_N_COARSEST if nc is None else nc,
            DEFAULT_MERGE_LEVELS if ml is None else ml)


@dataclass(frozen=True)
class Level:
    """Static maps from a fine level to its coarse level."""
    restrict_addr: torch.Tensor    # (nc_fine,) coarse cell of fine cell
    face_coarse: torch.Tensor      # (nif,) coarse face id (nfc if internal)
    face_flip: torch.Tensor        # (nif,) 1.0 if fine owner/nei swapped
    face_cell: torch.Tensor        # (nif,) coarse cell for internal faces
    # coarse-level ELL connectivity (from coarse owner/neighbour)
    cell_nbr: torch.Tensor         # (ncc, Kc)
    ell_idx: torch.Tensor          # (ncc, Kc) into [upper|lower|0]
    coarse_owner: torch.Tensor     # (nfc,)
    coarse_neighbour: torch.Tensor
    # padded gather addressing (restriction and coarsening without
    # scatters; the reference's restrictSortAddressing,
    # GAMGAgglomeration.H:149)
    children: torch.Tensor         # (ncc, Kch) fine cells, pad=nc_fine
    face_children: torch.Tensor    # (nfc, Kfc) fine faces, pad=nif
    face_child_flip: torch.Tensor  # (nfc, Kfc) 1.0 where owner/nei swap
    int_faces: torch.Tensor        # (ncc, Kif) collapsed faces, pad=nif
    n_coarse: int = 0
    n_coarse_faces: int = 0
    n_fine: int = 0
    n_fine_faces: int = 0

    #: the float-valued fields (the rest are int64 indices)
    FLOAT_FIELDS = ("face_flip", "face_child_flip")

    @staticmethod
    def from_arrays(src, *, device, dtype) -> "Level":
        """A Level from any object with the same attributes holding
        array-likes (the host build below, or the JAX package's Level)."""
        kw = {}
        for f in dataclasses.fields(Level):
            v = getattr(src, f.name)
            if f.type == "int":
                kw[f.name] = int(v)
            elif f.name in Level.FLOAT_FIELDS:
                kw[f.name] = torch.as_tensor(np.asarray(v), dtype=dtype,
                                             device=device)
            else:
                kw[f.name] = torch.as_tensor(np.asarray(v, np.int64),
                                             device=device)
        return Level(**kw)


def _pair_agglomerate(own: np.ndarray, nei: np.ndarray,
                      weights: np.ndarray, nc: int):
    """Greedy max-weight pair agglomeration (reference:
    pairGAMGAgglomerate.C:31-130): pass 1 pairs each unmatched cell with
    its strongest unmatched neighbour; pass 2 merges leftover singles
    into their strongest cluster."""
    # adjacency in CSR
    deg = np.bincount(own, minlength=nc) + np.bincount(nei, minlength=nc)
    adj_start = np.zeros(nc + 1, dtype=np.int64)
    np.cumsum(deg, out=adj_start[1:])
    adj_cell = np.empty(adj_start[-1], dtype=np.int64)
    adj_w = np.empty(adj_start[-1])
    fill = adj_start[:-1].copy()
    for f in range(own.size):
        o, n, w = own[f], nei[f], weights[f]
        adj_cell[fill[o]] = n
        adj_w[fill[o]] = w
        fill[o] += 1
        adj_cell[fill[n]] = o
        adj_w[fill[n]] = w
        fill[n] += 1

    coarse = np.full(nc, -1, dtype=np.int64)
    ncc = 0
    for c in range(nc):
        if coarse[c] >= 0:
            continue
        best, best_w = -1, -1.0
        for k in range(adj_start[c], adj_start[c + 1]):
            n = adj_cell[k]
            if coarse[n] < 0 and adj_w[k] > best_w:
                best, best_w = n, adj_w[k]
        if best >= 0:
            coarse[c] = coarse[best] = ncc
            ncc += 1
        # leave singles for pass 2
    for c in range(nc):
        if coarse[c] >= 0:
            continue
        best, best_w = -1, -1.0
        for k in range(adj_start[c], adj_start[c + 1]):
            n = adj_cell[k]
            if coarse[n] >= 0 and adj_w[k] > best_w:
                best, best_w = n, adj_w[k]
        if best >= 0:
            coarse[c] = coarse[best]
        else:  # isolated cell
            coarse[c] = ncc
            ncc += 1
    return coarse, ncc


def _coarse_graph(own, nei, weights, coarse, ncc):
    """Deduplicated coarse-level (own, nei, weights) from a cell map."""
    co, cn = coarse[own], coarse[nei]
    ext = co != cn
    fo = np.minimum(co[ext], cn[ext])
    fn = np.maximum(co[ext], cn[ext])
    keys = fo * ncc + fn
    uniq, inv = np.unique(keys, return_inverse=True)
    w = np.zeros(uniq.size)
    np.add.at(w, inv, weights[ext])
    return (uniq // ncc).astype(np.int64), (uniq % ncc).astype(np.int64), w


def _padded_lists(ids, nbins, pad, aux=None):
    """CSR -> padded-ELL lists: per bin, member indices (and aux)."""
    order2 = np.argsort(ids, kind="stable")
    sids = ids[order2]
    counts = np.bincount(sids, minlength=nbins)
    kmax = max(int(counts.max()) if nbins else 1, 1)
    out = np.full((nbins, kmax), pad, dtype=np.int64)
    starts = np.zeros(nbins + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    cols = np.arange(ids.size) - starts[sids]
    out[sids, cols] = order2
    res = [out]
    if aux is not None:
        a_out = np.zeros((nbins, kmax), dtype=np.float32)
        a_out[sids, cols] = aux[order2]
        res.append(a_out)
    return res


def _graph_hierarchy(own, nei, weights, nc, n_coarsest=32, max_levels=20,
                     merge_levels=1) -> list[dict]:
    """Agglomeration hierarchy over an (own, nei, weights) graph, as host
    dicts of Level's fields (numpy)."""
    levels: list[dict] = []
    while nc > n_coarsest and len(levels) < max_levels:
        coarse, ncc = _pair_agglomerate(own, nei, weights, nc)
        for _ in range(merge_levels - 1):
            if ncc <= n_coarsest:
                break
            o2, n2, w2 = _coarse_graph(own, nei, weights, coarse, ncc)
            c2, ncc2 = _pair_agglomerate(o2, n2, w2, ncc)
            if ncc2 >= ncc:
                break
            coarse, ncc = c2[coarse], ncc2
        if ncc >= nc:  # no coarsening progress
            break
        co, cn = coarse[own], coarse[nei]
        internal = co == cn
        flip = co > cn
        fo = np.where(flip, cn, co)
        fn = np.where(flip, co, cn)
        # unique coarse faces among external fine faces
        ext = ~internal
        keys = fo[ext] * ncc + fn[ext]
        uniq, inv = np.unique(keys, return_inverse=True)
        nfc = uniq.size
        face_coarse = np.full(own.size, nfc, dtype=np.int64)
        face_coarse[ext] = inv
        c_own = (uniq // ncc).astype(np.int64)
        c_nei = (uniq % ncc).astype(np.int64)
        # canonical coarse face order: lexsort by (owner, neighbour)
        order = np.lexsort((c_nei, c_own))
        rank = np.empty(nfc, dtype=np.int64)
        rank[order] = np.arange(nfc)
        face_coarse[ext] = rank[face_coarse[ext]]
        c_own, c_nei = c_own[order], c_nei[order]
        c_w = np.zeros(nfc)
        np.add.at(c_w, face_coarse[ext], weights[ext])

        ell = build_ell(c_own, c_nei, ncc, nfc, np.ones(nfc, dtype=bool))

        (children,) = _padded_lists(coarse, ncc, nc)
        ext_ids = np.where(ext)[0]
        if ext_ids.size:
            fch, ffl = _padded_lists(face_coarse[ext], nfc, own.size,
                                     aux=flip[ext].astype(np.float32))
            # member positions index into the ext subset: map back
            fch = np.where(fch == own.size, own.size, ext_ids[
                np.clip(fch, 0, ext_ids.size - 1)])
        else:
            fch = np.full((nfc, 1), own.size, dtype=np.int64)
            ffl = np.zeros((nfc, 1), dtype=np.float32)
        int_ids = np.where(internal)[0]
        if int_ids.size:
            (ifc,) = _padded_lists(co[internal], ncc, own.size)
            ifc = np.where(ifc == own.size, own.size, int_ids[
                np.clip(ifc, 0, int_ids.size - 1)])
        else:
            ifc = np.full((ncc, 1), own.size, dtype=np.int64)

        levels.append(dict(
            n_coarse=ncc, n_coarse_faces=nfc,
            restrict_addr=coarse, face_coarse=face_coarse,
            face_flip=flip.astype(np.float32),
            face_cell=np.where(internal, co, 0),
            cell_nbr=ell["cell_nbr"], ell_idx=ell["ell_idx"],
            coarse_owner=c_own, coarse_neighbour=c_nei,
            children=children, face_children=fch, face_child_flip=ffl,
            int_faces=ifc, n_fine=int(nc), n_fine_faces=int(own.size)))
        own, nei, weights, nc = c_own, c_nei, c_w, ncc
    return levels


def build_hierarchy(mesh: MeshArrays, n_coarsest: int = 32,
                    max_levels: int = 20,
                    merge_levels: int = 1) -> tuple[Level, ...]:
    """The mesh's hierarchy: the one attached to it
    (linalg.precompute.attach_solver_layouts, built with that call's
    n_coarsest/merge_levels), else a host build, cached per mesh (one
    agglomeration per mesh, as the reference's GAMGAgglomeration).
    merge_levels composes that many pair-agglomerations per stored level
    (the reference's GAMG mergeLevels)."""
    if mesh.gamg is not None:
        return mesh.gamg
    # keyed by the identity of the mesh's addressing tensor; the entry
    # holds it weakly and goes when it is collected, so a recycled id
    # cannot alias a stale hierarchy
    anchor = mesh.owner
    key = (id(anchor), n_coarsest, max_levels, merge_levels)
    hit = _HIERARCHY_CACHE.get(key)
    if hit is not None and hit[0]() is anchor:
        return hit[1]
    own = mesh.owner[:mesh.n_internal].cpu().numpy().astype(np.int64)
    nei = mesh.neighbour.cpu().numpy().astype(np.int64)
    weights = mesh.mag_sf[:mesh.n_internal].cpu().numpy().astype(float)
    levels = tuple(
        Level.from_arrays(types.SimpleNamespace(**lv), device=mesh.device,
                          dtype=mesh.dtype)
        for lv in _graph_hierarchy(own, nei, weights, mesh.n_cells,
                                   n_coarsest, max_levels, merge_levels))
    weakref.finalize(anchor, _HIERARCHY_CACHE.pop, key, None)
    _HIERARCHY_CACHE[key] = (weakref.ref(anchor), levels)
    return levels


def _ext(a, like):
    """Broadcast a (n,)/(nf,) tensor against trailing component axes."""
    return a.reshape(a.shape + (1,) * (like.dim() - a.dim()))


def _pad1(x):
    """x with one zero row appended (the pad target of the gathers)."""
    return torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])


def _restrict(level: Level, r):
    """Coarse r = sum over each coarse cell's fine children (padded
    gather; the pad index n_fine reads the appended zero row)."""
    return _pad1(r)[level.children].sum(1)


def _coarsen_matrix(level: Level, diag, lower, upper):
    """The coarse-level (diag, lower, upper), by padded gathers."""
    c_diag = _restrict(level, diag)
    up_p, lo_p = _pad1(upper), _pad1(lower)
    # faces collapsing into a coarse cell add (upper+lower) to its diag
    c_diag = c_diag + _ext((up_p + lo_p)[level.int_faces].sum(1), c_diag)
    up_g = up_p[level.face_children]
    lo_g = lo_p[level.face_children]
    fl = level.face_child_flip > 0.5
    c_upper = torch.where(fl, lo_g, up_g).sum(1)
    c_lower = torch.where(fl, up_g, lo_g).sum(1)
    return c_diag, c_lower, c_upper


def _level_amul(level: Level, diag, lower, upper):
    cat = torch.cat([upper, lower, upper.new_zeros(1)])
    coeffs = cat[level.ell_idx]

    def amul(x):
        nbr = x[level.cell_nbr]
        return _ext(diag, x) * x + (_ext(coeffs, nbr) * nbr).sum(1)
    return amul


def _recip_or_one(diag):
    return 1.0 / torch.where(diag == 0.0, torch.ones_like(diag), diag)


def _jacobi(amul, diag, b, x, n, omega=0.9):
    rd = omega * _recip_or_one(diag)
    for _ in range(n):
        x = x + _ext(rd, x) * (b - amul(x))
    return x


def _lambda_max(amul, diag, b, n_iter=8):
    """Power-iteration estimate of the spectral radius of D^-1 A."""
    rd = _recip_or_one(diag)
    v = torch.where(b.abs() > 0, b, torch.ones_like(b))
    v = v / torch.linalg.norm(v)
    lam = torch.ones((), dtype=b.dtype, device=b.device)
    for _ in range(n_iter):
        w = rd * amul(v)
        lam = torch.linalg.norm(w)
        v = w / torch.where(lam == 0.0, torch.ones_like(lam), lam)
    return lam


def _chebyshev(amul, diag, b, x, degree, lam_max):
    """Chebyshev polynomial smoother on [lam_max/4, 1.05*lam_max] of
    D^-1 A: Gauss-Seidel-class smoothing from Amuls alone (the reference
    aliases GaussSeidel to Jacobi, GaussSeidelSmoother.C:43-67)."""
    rd = _recip_or_one(diag)
    lmax = 1.05 * lam_max
    lmin = lam_max / 4.0
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma

    r = _ext(rd, b) * (b - amul(x))
    d_vec = r / theta
    for _ in range(degree):
        x = x + d_vec
        r = r - _ext(rd, r) * amul(d_vec)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d_vec = (rho_new * rho) * d_vec + (2.0 * rho_new / delta) * r
        rho = rho_new
    return x


def make_vcycle(mesh: MeshArrays, m, amul_fine, diag, controls,
                scale_correction: bool, fixed_scale: float = 1.0):
    """The one-V-cycle closure (x, b) -> x' over the mesh's hierarchy.
    scale_correction=False gives a LINEAR operator, usable as a Krylov
    preconditioner (the <c,r>/<c,Ac> line-search scaling is
    nonlinear). On a gdia lattice mesh: the structured geometric V-cycle
    (linalg/structured_mg.py)."""
    if mesh.gdia is not None:
        from .structured_mg import make_structured_vcycle
        return make_structured_vcycle(mesh, m, amul_fine, diag, controls,
                                      scale_correction, fixed_scale)
    n_coarsest, merge_levels = gamg_shape(controls)
    levels = build_hierarchy(mesh, n_coarsest=n_coarsest,
                             merge_levels=merge_levels)
    return _vcycle_from_levels(levels, diag, m.lower, m.upper, amul_fine,
                               controls, scale_correction, fixed_scale)


def _vcycle_from_levels(levels, diag, lower, upper, amul_fine, controls,
                        scale_correction, fixed_scale):
    """The V-cycle closure over an explicit hierarchy."""
    from .solvers import gsum
    n_pre = controls.n_pre_sweeps
    n_post = controls.n_post_sweeps
    n_finest = controls.n_finest_sweeps
    use_cheby = controls.smoother in ("Chebyshev", "GaussSeidel",
                                      "symGaussSeidel", "DIC",
                                      "DICGaussSeidel")

    # coarse matrices, assembled once per solve
    mats = [(diag, lower, upper)]
    for lv in levels:
        mats.append(_coarsen_matrix(lv, *mats[-1]))
    amuls = [amul_fine] + [
        _level_amul(lv, *mats[i + 1]) for i, lv in enumerate(levels)]
    # Chebyshev spectral bound: rho(D^-1 A) <= 2 for the weakly
    # diagonally dominant FV matrices GAMG sees, so the bound is fixed
    # (the JAX package's default; it estimates only when
    # cheby_power_iter is set, which no fvSolution entry sets)
    lam = 2.0

    def smooth(i, b, x, sweeps):
        if sweeps == 0:
            return x
        if use_cheby:
            return _chebyshev(amuls[i], mats[i][0], b, x,
                              max(2, sweeps + 1), lam)
        return _jacobi(amuls[i], mats[i][0], b, x, sweeps)

    # coarsest level: a dense inverse, once per solve, applied as a matmul
    if levels:
        lvl = levels[-1]
        dC, loC, upC = mats[-1]

        def dense_of(dcol):
            dcol = torch.where(dcol == 0.0, torch.ones_like(dcol), dcol)
            a = torch.diag(dcol)
            a = a.index_put((lvl.coarse_owner, lvl.coarse_neighbour), upC,
                            accumulate=True)
            return a.index_put((lvl.coarse_neighbour, lvl.coarse_owner),
                               loC, accumulate=True)

        if dC.dim() == 1:
            invC = torch.linalg.inv(dense_of(dC))
        else:
            # column-batched vector system: one inverse per component
            invC = torch.stack([torch.linalg.inv(dense_of(dC[:, k]))
                                for k in range(dC.shape[1])])

    def vcycle(x, b):
        # down-leg: smooth, residual, restrict
        xs, bs = [x], [b]
        for i, lv in enumerate(levels):
            xi = xs[i]
            if n_pre:
                xi = smooth(i, bs[i], xi, n_pre)
            r = bs[i] - amuls[i](xi)
            xs[i] = xi
            bs.append(_restrict(lv, r))
            xs.append(x.new_zeros((lv.n_coarse,) + tuple(x.shape[1:])))
        # coarsest: precomputed-inverse matrix product
        if levels:
            if invC.dim() == 2:
                xs[-1] = invC @ bs[-1]
            else:
                xs[-1] = torch.einsum("kij,jk->ik", invC, bs[-1])
        else:
            xs[-1] = smooth(0, bs[-1], xs[-1], 8)
        # up-leg: prolong, scale the correction, post-smooth
        for i in range(len(levels) - 1, -1, -1):
            lv = levels[i]
            corr = xs[i + 1][lv.restrict_addr]
            if scale_correction:
                # alpha = <c,r>/<c,Ac> (reference: GAMGSolverScale.C)
                r_cur = bs[i] - amuls[i](xs[i])
                a_corr = amuls[i](corr)
                num = gsum(corr * r_cur)
                den = gsum(corr * a_corr)
                den = torch.where(den.abs() < 1e-30,
                                  torch.full_like(den, 1e-30), den)
                corr = (num / den) * corr
            elif fixed_scale != 1.0:
                # linear stand-in for the line search (a preconditioner
                # must stay a fixed linear operator)
                corr = fixed_scale * corr
            xs[i] = smooth(i, bs[i], xs[i] + corr,
                           n_finest if i == 0 else n_post)
        return xs[0]

    return vcycle


def gamg_solve(mesh: MeshArrays, m, amul_fine, diag, source, psi0,
               controls):
    """V-cycle iteration until convergence (fvSolution `solver GAMG`).

    On a gdia lattice mesh the V-cycle preconditions the pure lattice
    operator (the ghost fold/sync coupling of merged cells is not in its
    planes), so cycling alone would converge to another fixed point: GAMG
    is wrapped in a Krylov solver instead, PCG for a symmetric matrix and
    PBiCGStab otherwise, with one V-cycle as the preconditioner."""
    from .solvers import _norm_factor, _pbicgstab, _pcg, _Stop, gsum
    if mesh.gdia is not None:
        c2 = dataclasses.replace(controls, preconditioner="GAMG")
        krylov = _pcg if m.symmetric else _pbicgstab
        return krylov(mesh, amul_fine, m, diag, source, psi0, c2)
    vcycle = make_vcycle(mesh, m, amul_fine, diag, controls, m.symmetric)
    apsi = amul_fine(psi0)
    nf = _norm_factor(amul_fine, psi0, source, apsi, torch.ones_like(psi0))
    # delta form (see solvers._pcg): cycle on A*delta = r0 from zero
    b = source - apsi
    res0 = gsum(b.abs()) / nf
    # stall guard: a few cycles without a 3% drop end the solve (fp32
    # and fp64 V-cycling both have a roundoff floor)
    stop = _Stop(controls, res0, psi0.dtype, 6, stall_fp64=30,
                 improve=0.97)
    x = torch.zeros_like(psi0)
    res, it = res0, 0
    while not stop.done(res, it):
        x = vcycle(x, b)
        res = gsum((b - amul_fine(x)).abs()) / nf
        stop.update(res)
        it += 1
    return psi0 + x, (res0, res, it)
