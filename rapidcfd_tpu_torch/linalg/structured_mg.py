"""Structured geometric multigrid on the gdia lattice (port of
rapidcfd_tpu/linalg/structured_mg.py:38-46 and :118-441).

GAMG on a gdia lattice mesh cycles on the lattice itself instead of a
pair agglomeration:

- levels are 2x2(x2) slot blocks (geometric coarsening); odd grid
  dimensions are zero-padded;
- restriction is a reshape and block sum, prolongation a repeat;
- every level's matrix is 2*dim+1 coefficient planes (the diagonal and
  one per face direction), so a level product is shifted multiply-adds;
- the Galerkin coarse coefficients (P^T A P over each block, the
  reference's face-summed agglomerateMatrix, GAMGSolverAgglomerateMatrix.C)
  are parity-selected block sums of the fine planes;
- the coarsest level is a dense inverse, once per solve, applied as a
  matrix product.

The planes hold the pure lattice operator: the ghost fold/sync coupling
of merged cells is not in them, so the V-cycle is only a preconditioner
(the Krylov wrapper in linalg/gamg.gamg_solve supplies the exact folded
matrix), and its output is projected onto the primary slots.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mesh import gdia as gd


def structured_info(mesh):
    """(nz, ny, nx) of the mesh's lattice, or None. Only gdia meshes are
    lattices in the port (the JAX package's structured-box layout and its
    DIA census of ELL meshes are not ported)."""
    if mesh.gdia is not None:
        return mesh.gdia.shape
    return None


def _e(p, x):
    """Broadcast a (nz, ny, nx) plane against trailing component axes."""
    if p is None:
        return None
    return p.reshape(p.shape + (1,) * (x.dim() - 3))


def _shift(x, axis, sign):
    """result[c] = x[c + sign] along axis, zero-filled."""
    n = x.shape[axis]
    zshape = list(x.shape)
    zshape[axis] = 1
    z = x.new_zeros(zshape)
    if sign > 0:
        return torch.cat([x.narrow(axis, 1, n - 1), z], dim=axis)
    return torch.cat([z, x.narrow(axis, 0, n - 1)], dim=axis)


class GridLevel:
    """One multigrid level: coefficient planes on a (nz, ny, nx) grid."""

    def __init__(self, shape, diag, planes):
        self.shape = shape            # (nz, ny, nx)
        self.diag = diag              # (nz, ny, nx[, m])
        self.planes = planes          # {offset key: plane or None}

    def amul(self, x):
        nz, ny, nx = self.shape
        y = self.diag * x
        for axis, key in ((2, 1), (1, nx), (0, nx * ny)):
            pp = self.planes.get(key)
            pm = self.planes.get(-key)
            if pp is not None:
                y = y + _e(pp, x) * _shift(x, axis, +1)
            if pm is not None:
                y = y + _e(pm, x) * _shift(x, axis, -1)
        return y


def _pad_even(a, dims):
    """Zero-pad the grid axes in dims to even length."""
    for ax in dims:
        if a.shape[ax] % 2:
            zshape = list(a.shape)
            zshape[ax] = 1
            a = torch.cat([a, a.new_zeros(zshape)], dim=ax)
    return a


def _block_sum(a, dims):
    """Sum over 2-slot blocks along the grid axes in dims (ascending)."""
    for ax in dims:
        s = a.shape
        a = a.reshape(s[:ax] + (s[ax] // 2, 2) + s[ax + 1:]).sum(ax + 1)
    return a


def _parity(a, axis, par):
    """The slots of the given parity along a grid axis."""
    sl = [slice(None)] * a.dim()
    sl[axis] = slice(par, None, 2)
    return a[tuple(sl)]


def coarsen(level: GridLevel) -> GridLevel:
    """Galerkin 2x2(x2) coarsening: faces crossing block boundaries sum
    into coarse planes, faces inside a block fold into the coarse
    diagonal (P^T A P for piecewise-constant P)."""
    nz, ny, nx = level.shape
    cdims = [ax for ax, nn in ((0, nz), (1, ny), (2, nx)) if nn > 1]
    key_of = {2: 1, 1: nx, 0: nx * ny}

    def padded(p):
        return None if p is None else _pad_even(p, cdims)

    diag = padded(level.diag)
    planes = {k: padded(p) for k, p in level.planes.items()}
    d_c = _block_sum(diag, cdims)

    def add_to_diag(dc, contrib):
        # the diagonal may carry trailing component axes; planes never do
        return dc + contrib.reshape(contrib.shape
                                    + (1,) * (dc.dim() - contrib.dim()))

    shape_c = [1, 1, 1]
    for ax, nn in ((0, nz), (1, ny), (2, nx)):
        shape_c[ax] = (nn + 1) // 2 if ax in cdims else nn
    nz_c, ny_c, nx_c = shape_c
    ckey_of = {2: 1, 1: nx_c, 0: nx_c * ny_c}

    planes_c = {}
    for ax in (0, 1, 2):
        pp = planes.get(key_of[ax])
        pm = planes.get(-key_of[ax])
        if pp is None and pm is None:
            continue
        others = [d for d in cdims if d != ax]
        if ax in cdims:
            # in-block faces (even -> odd) fold into the diagonal
            if pp is not None:
                d_c = add_to_diag(d_c, _block_sum(_parity(pp, ax, 0),
                                                  others))
            if pm is not None:
                d_c = add_to_diag(d_c, _block_sum(_parity(pm, ax, 1),
                                                  others))
            # block-crossing faces (odd -> next block) become coarse planes
            if pp is not None:
                planes_c[ckey_of[ax]] = _block_sum(_parity(pp, ax, 1),
                                                   others)
            if pm is not None:
                planes_c[-ckey_of[ax]] = _block_sum(_parity(pm, ax, 0),
                                                    others)
        else:
            # an axis that is not coarsened (nz = 1): block sums only
            if pp is not None:
                planes_c[ckey_of[ax]] = _block_sum(pp, cdims)
            if pm is not None:
                planes_c[-ckey_of[ax]] = _block_sum(pm, cdims)
    return GridLevel((nz_c, ny_c, nx_c), d_c, planes_c)


def restrict(level: GridLevel, r, cdims):
    return _block_sum(_pad_even(r, cdims), cdims)


def prolong(level: GridLevel, xc, cdims):
    nz, ny, nx = level.shape
    for ax in cdims:
        xc = torch.repeat_interleave(xc, 2, dim=ax)
    return xc[:nz, :ny, :nx]


def _chebyshev_grid(level: GridLevel, b, x, degree, lam_max=2.0):
    """Chebyshev smoother on [lam/4, 1.05*lam] of D^-1 A (as
    linalg.gamg._chebyshev), from level products only."""
    rd = 1.0 / torch.where(level.diag == 0.0,
                           torch.ones_like(level.diag), level.diag)
    lmax = 1.05 * lam_max
    lmin = lam_max / 4.0
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    r = rd * (b - level.amul(x))
    d_vec = r / theta
    for _ in range(degree):
        x = x + d_vec
        r = r - rd * level.amul(d_vec)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d_vec = (rho_new * rho) * d_vec + (2.0 * rho_new / delta) * r
        rho = rho_new
    return x


def _dense_indices(shape):
    """(n, {key: (axis, rows, cols)}): the coarsest grid's size and, per
    face direction, the (from, to) slot pairs of its faces."""
    nz, ny, nx = shape
    n = nz * ny * nx
    idx = np.arange(n).reshape(nz, ny, nx)
    pairs = {}
    for ax, key in ((2, 1), (1, nx), (0, nx * ny)):
        if shape[ax] == 1:
            continue
        sl_from = [slice(None)] * 3
        sl_to = [slice(None)] * 3
        sl_from[ax] = slice(0, shape[ax] - 1)
        sl_to[ax] = slice(1, None)
        pairs[key] = (ax, idx[tuple(sl_from)].ravel(),
                      idx[tuple(sl_to)].ravel())
    return n, pairs


def make_structured_vcycle(mesh, m, amul_fine, diag, controls,
                           scale_correction: bool,
                           fixed_scale: float = 1.0):
    """The V-cycle closure (x, b) -> x' over geometric 2x2(x2) levels of
    the mesh's gdia lattice, or None when the mesh is not a lattice. The
    call contract of linalg.gamg.make_vcycle; amul_fine is not used (the
    finest level's product is its planes)."""
    shape = structured_info(mesh)
    if shape is None:
        return None
    # the reference's 32-cell coarsest level unless fvSolution says
    # otherwise (not gamg_shape's default, which is the aggregation's)
    n_coarsest = max(int(controls.n_coarsest_cells or 32), 8)
    n_pre = controls.n_pre_sweeps
    n_post = controls.n_post_sweeps
    n_finest = controls.n_finest_sweeps

    nz, ny, nx = shape
    g = mesh.gdia
    # diag hygiene: the folded system gives ghost and dead slots null
    # rows; summed into 2x2 block diagonals they would distort the coarse
    # levels near masked regions. Ghost slots take their primary's diag
    # (their plane couplings are real), dead slots 0 (the smoother's
    # zero-diag guard handles them)
    diag = gd.sync(g, diag) * gd._bcast(1.0 - g.dead, diag)
    d0 = diag.reshape((nz, ny, nx) + tuple(diag.shape[1:]))
    planes0 = {d: c.reshape(shape)
               for d, c in gd.dia_planes(g, m.lower, m.upper)}
    for d in (1, nx, nx * ny):
        planes0.setdefault(d, None)
        planes0.setdefault(-d, None)
    levels = [GridLevel(shape, d0, planes0)]
    while int(np.prod(levels[-1].shape)) > n_coarsest:
        if max(levels[-1].shape) <= 2:
            break
        levels.append(coarsen(levels[-1]))
    cdims_of = [[ax for ax in (0, 1, 2) if lv.shape[ax] > 1]
                for lv in levels]

    # coarsest level: a dense inverse, once per solve
    last = levels[-1]
    ncc, pairs = _dense_indices(last.shape)
    pairs = {key: (ax, torch.as_tensor(r, device=diag.device),
                   torch.as_tensor(c, device=diag.device))
             for key, (ax, r, c) in pairs.items()}

    def dense_of(dflat):
        a = torch.diag(torch.where(dflat == 0.0, torch.ones_like(dflat),
                                   dflat))
        for key, (ax, rows, cols) in pairs.items():
            pp = last.planes.get(key)
            pm = last.planes.get(-key)
            if pp is not None:
                sl = [slice(None)] * 3
                sl[ax] = slice(0, last.shape[ax] - 1)
                a[rows, cols] += pp[tuple(sl)].reshape(-1)
            if pm is not None:
                sl = [slice(None)] * 3
                sl[ax] = slice(1, None)
                a[cols, rows] += pm[tuple(sl)].reshape(-1)
        return a

    rank = diag.dim() - 1
    if rank == 0:
        invC = torch.linalg.inv(dense_of(last.diag.reshape(-1)))
    else:
        invC = torch.linalg.inv(torch.stack([
            dense_of(last.diag[..., k].reshape(-1))
            for k in range(last.diag.shape[-1])]))
    prim = g.primary.reshape((nz, ny, nx) + (1,) * rank)

    def smooth(i, b, x, sweeps):
        if sweeps == 0:
            return x
        return _chebyshev_grid(levels[i], b, x, max(2, sweeps + 1))

    def vcycle(x, b):
        grid_shape = (nz, ny, nx) + tuple(x.shape[1:])
        xs, bs = [x.reshape(grid_shape)], [b.reshape(grid_shape)]
        for i, lv in enumerate(levels[:-1]):
            xi = xs[i]
            if n_pre:
                xi = smooth(i, bs[i], xi, n_pre)
            r = bs[i] - lv.amul(xi)
            xs[i] = xi
            bs.append(restrict(lv, r, cdims_of[i]))
            xs.append(x.new_zeros(levels[i + 1].shape + tuple(x.shape[1:])))
        bl = bs[-1].reshape((ncc,) + tuple(x.shape[1:]))
        xl = invC @ bl if rank == 0 else torch.einsum("kij,jk->ik", invC, bl)
        xs[-1] = xl.reshape(levels[-1].shape + tuple(x.shape[1:]))
        for i in range(len(levels) - 2, -1, -1):
            lv = levels[i]
            corr = prolong(lv, xs[i + 1], cdims_of[i])
            if scale_correction:
                r_cur = bs[i] - lv.amul(xs[i])
                a_corr = lv.amul(corr)
                num = (corr * r_cur).sum((0, 1, 2))
                den = (corr * a_corr).sum((0, 1, 2))
                den = torch.where(den.abs() < 1e-30,
                                  torch.full_like(den, 1e-30), den)
                corr = (num / den) * corr
            elif fixed_scale != 1.0:
                corr = fixed_scale * corr
            sweeps = n_finest if i == 0 else n_post
            xs[i] = smooth(i, bs[i], xs[i] + corr, sweeps)
        # project onto the live (primary) slots: keeps the preconditioner
        # symmetric positive on the folded system
        return (xs[0] * prim).reshape(x.shape)

    return vcycle
