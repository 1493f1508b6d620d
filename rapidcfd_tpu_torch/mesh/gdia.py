"""Generalized-DIA lattice mode — gather-free kernels for lattice-derived
meshes (port of rapidcfd_tpu/mesh/gdia.py:55-440).

Every cell occupies one or more slots of an (nz, ny, nx) lattice: one
primary slot carrying the DOF, ghost slots for merged-away neighbours
(mirroring their primary's value), and dead slots (masked-out lattice
cells). Internal faces pack into up to three full (n_lat,) planes (offset
+1, +nx, +nx*ny) with zero-coefficient dummies where the lattice has no
face, so every operator is a flat shift, slice or multiply-add over
(n_lat,) arrays. Shifts wrap across lattice rows; the wrapped positions
are always-dummy edge slots whose coefficients are zero, and raw face
data is masked by `plane_mask` where it could leak (surface sums).

A ghost mask that is zero everywhere is stored as None (the JAX package
keeps the zero array): sync/fold then skip that plane, which gives the
same values the masked blend would.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class GdiaInfo:
    """Lattice embedding of a polyhedral mesh."""
    # per present plane: (n_lat,) 1.0 where the slot is a ghost whose
    # primary is the slot `step` BEFORE it along that plane, or None
    ghost_prev: tuple
    dead: torch.Tensor           # (n_lat,) 1.0 where the slot is dead
    primary: torch.Tensor        # (n_lat,) 1.0 where the slot carries a DOF
    # (n_planes * n_lat,) 1.0 at REAL plane faces, 0.0 at dummies
    plane_mask: torch.Tensor | None = None
    shape: tuple = ()
    # sync sweeps needed (max merge-chain length)
    sync_iters: int = 1
    # which of the three planes exist (nx>1, ny>1, nz>1)
    axes: tuple = ()

    @property
    def n_lat(self) -> int:
        nz, ny, nx = self.shape
        return nz * ny * nx

    @property
    def steps(self) -> tuple:
        """Flat offset per present plane, in plane order (x, y, z)."""
        nz, ny, nx = self.shape
        return tuple(s for s, on in zip((1, nx, nx * ny), self.axes) if on)


def _bcast(mask_flat, x):
    return mask_flat.reshape(mask_flat.shape + (1,) * (x.dim() - 1))


def _shift_flat(x, d, n):
    """result[s] = x[s - d] (flat, zero-filled outside [0, n))."""
    if d == 0:
        return x
    if d > 0:
        return torch.cat([x.new_zeros((d,) + x.shape[1:]), x[:n - d]])
    return torch.cat([x[-d:], x.new_zeros((-d,) + x.shape[1:])])


def plane_steps(info: GdiaInfo):
    """(plane_index, flat_step) for each present plane."""
    return list(enumerate(info.steps))


def face_planes(info: GdiaInfo, face_data):
    """Split internal-face data into its per-plane flat arrays."""
    n = info.n_lat
    return [face_data[i * n:(i + 1) * n] for i in range(len(info.steps))]


# ---------------------------------------------------------------------------
# ghost sync / fold — masked flat shifts
# ---------------------------------------------------------------------------

def sync(info: GdiaInfo, x):
    """Ghost-sync: x[ghost] := x[primary]."""
    n = info.n_lat
    for _ in range(info.sync_iters):
        for (pi, step) in plane_steps(info):
            m = info.ghost_prev[pi]
            if m is None:
                continue
            mm = _bcast(m, x)
            x = mm * _shift_flat(x, step, n) + (1.0 - mm) * x
    return x


def fold(info: GdiaInfo, y):
    """Fold ghost rows into primaries: y[primary] += y[ghost];
    y[ghost] := 0. Exact transpose of sync."""
    n = info.n_lat
    for _ in range(info.sync_iters):
        for (pi, step) in reversed(plane_steps(info)):
            m = info.ghost_prev[pi]
            if m is None:
                continue
            mm = _bcast(m, y)
            y = y + _shift_flat(mm * y, -step, n) - mm * y
    return y


def unfold(info: GdiaInfo, x):
    """x with ghost entries replaced by their primary's value."""
    return sync(info, x)


# ---------------------------------------------------------------------------
# face-plane kernels — faces laid out as [x-plane | y-plane | z-plane |
# boundary], each plane (n_lat,) with slot s = face between s and s+step
# ---------------------------------------------------------------------------

def face_own_nei(info: GdiaInfo, x):
    """(own, nei) cell values on the plane faces: own[p, s] = x[s],
    nei[p, s] = x[s + step]. Dummy-face values are finite garbage that
    every consumer multiplies by a zero coefficient."""
    n = info.n_lat
    xs = sync(info, x)
    owns, neis = [], []
    for (pi, step) in plane_steps(info):
        owns.append(xs)
        neis.append(_shift_flat(xs, -step, n))
    return torch.cat(owns), torch.cat(neis)


def surface_sum_internal(info: GdiaInfo, face_data, signed: bool):
    """Per-slot sum over plane faces: out[own] += f, out[nei] -+= f. The
    dummy mask is a select, not a multiply (face data can be inf/nan at
    zero-area dummies)."""
    sgn = -1.0 if signed else 1.0
    n = info.n_lat
    if info.plane_mask is not None:
        m = _bcast(info.plane_mask, face_data)
        face_data = torch.where(m > 0, face_data,
                                torch.zeros((), dtype=face_data.dtype,
                                            device=face_data.device))
    out = None
    for (pi, step), f in zip(plane_steps(info), face_planes(info, face_data)):
        contrib = f + sgn * _shift_flat(f, step, n)
        out = contrib if out is None else out + contrib
    return out


def neg_sum_diag(info: GdiaInfo, lower, upper):
    """-(column sums of the off-diagonals) (lduMatrix::negSumDiag)."""
    n = info.n_lat
    out = None
    for (pi, step), lp, up in zip(plane_steps(info),
                                  face_planes(info, lower),
                                  face_planes(info, upper)):
        contrib = lp + _shift_flat(up, step, n)
        out = contrib if out is None else out + contrib
    return -out


def dia_planes(info: GdiaInfo, lower, upper):
    """[(offset, coeff plane (n_lat,))] for the shift SpMV:
    c_{+step}[s] = upper[s]; c_{-step}[s] = lower[s - step]."""
    n = info.n_lat
    planes = []
    for (pi, step), lp, up in zip(plane_steps(info),
                                  face_planes(info, lower),
                                  face_planes(info, upper)):
        planes.append((step, up))
        planes.append((-step, _shift_flat(lp, step, n)))
    return planes


def offdiag_mv(info: GdiaInfo, lower, upper):
    """x -> fold(planes @ unfold(x)): the gather-free off-diagonal
    product. x may be (n_lat,) or (n_lat, m); ghost/dead entries of the
    result are zero (folded)."""
    planes = dia_planes(info, lower, upper)
    n = info.n_lat
    max_off = max(abs(d) for d, _ in planes) if planes else 0

    def mv(x):
        two_d = x.dim() == 2
        vec = x if two_d else x[:, None]
        vec = unfold(info, vec)
        zpad = vec.new_zeros((max_off, vec.shape[1]))
        xp = torch.cat([zpad, vec, zpad])
        y = torch.zeros_like(vec)
        for d, c_d in planes:
            y = y + c_d[:, None] * xp[max_off + d:max_off + d + n]
        y = fold(info, y)
        return y if two_d else y[:, 0]

    return mv


def internal_flux(info: GdiaInfo, psi, lower, upper):
    """upper*psi[nei] - lower*psi[own] on plane faces (faceH)."""
    own, nei = face_own_nei(info, psi)
    r = (1,) * (own.dim() - 1)
    return upper.reshape(upper.shape + r) * nei \
        - lower.reshape(lower.shape + r) * own


# ---------------------------------------------------------------------------
# precomputed Gauss shift-MAC planes — the fused fvc fast path:
#
#   out_c[s] = sum_p ( Sf_pc[s] w_p[s] - Sf_pc[s-d] (1-w_p[s-d]) ) x[s]
#            + Sf_pc[s] (1-w_p[s]) x[s+d]  -  Sf_pc[s-d] w_p[s-d] x[s-d]
#
# coefficient planes built once at mesh build; each evaluation is one
# shift-MAC kernel call (ops/gdia_mac.py) + the boundary fold + fold/sync.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GaussPlanes:
    """Shift-MAC coefficients of the linear-weight Gauss surface sum over
    internal lattice faces: out[c, s] = sum_k coeffs[k, c, s] *
    x[s + offsets[k]]. coeffs_i are the contiguous per-direction (K, 1, n)
    slices consumed by the divergence contraction."""
    coeffs: torch.Tensor         # (K, 3, n_lat)
    coeffs_i: tuple              # 3 x (K, 1, n_lat)
    offsets: tuple = ()


def gauss_planes_numpy(steps, n: int, Sf, weights):
    """Host-side: (offsets, (K, 3, n) coefficients) from the plane Sf
    (n_planes*n, 3) and owner weights (n_planes*n,)."""
    Sf = np.asarray(Sf)
    w = np.asarray(weights)

    def np_shift(a, d):
        out = np.zeros_like(a)
        if d > 0:
            out[d:] = a[:-d]
        elif d < 0:
            out[:d] = a[-d:]
        else:
            out = a.copy()
        return out

    coefs: dict[int, np.ndarray] = {}

    def acc(off, c):
        coefs[off] = coefs.get(off, 0) + c
    for i, st in enumerate(steps):
        Sfi = Sf[i * n:(i + 1) * n, :]
        wi = w[i * n:(i + 1) * n][:, None]
        acc(0, Sfi * wi - np_shift(Sfi * (1.0 - wi), st))
        acc(st, Sfi * (1.0 - wi))
        acc(-st, -np_shift(Sfi * wi, st))
    offs = tuple(sorted(coefs))
    coeffs = np.stack([coefs[o] for o in offs])            # (K, n, 3)
    return offs, np.ascontiguousarray(np.swapaxes(coeffs, 1, 2))


def gauss_planes_from_numpy(offsets, ct, *, device, dtype) -> GaussPlanes:
    """GaussPlanes on `device` from host (K, 3, n) coefficients."""
    return GaussPlanes(
        coeffs=torch.tensor(ct, dtype=dtype, device=device),
        coeffs_i=tuple(
            torch.tensor(ct[:, i:i + 1, :], dtype=dtype, device=device)
            for i in range(3)),
        offsets=tuple(int(o) for o in offsets))


def build_gauss_planes(info: GdiaInfo, Sf, weights, *, device,
                       dtype) -> GaussPlanes:
    """Combine Sf planes and owner weights into the grad MAC
    coefficients (see the expansion above)."""
    offs, ct = gauss_planes_numpy(info.steps, info.n_lat, Sf, weights)
    return gauss_planes_from_numpy(offs, ct, device=device, dtype=dtype)


def _shift_last(x, d, n):
    """result[..., s] = x[..., s - d] (zero-filled outside [0, n))."""
    if d == 0:
        return x
    if d > 0:
        z = x.new_zeros(x.shape[:-1] + (d,))
        return torch.cat([z, x[..., :n - d]], dim=-1)
    z = x.new_zeros(x.shape[:-1] + (-d,))
    return torch.cat([x[..., -d:], z], dim=-1)


def sync_last(info: GdiaInfo, x):
    """Ghost-sync over the LAST axis of a (..., n_lat) array."""
    n = info.n_lat
    for _ in range(info.sync_iters):
        for (pi, step) in plane_steps(info):
            m = info.ghost_prev[pi]
            if m is None:
                continue
            x = m * _shift_last(x, step, n) + (1.0 - m) * x
    return x


def fold_last(info: GdiaInfo, y):
    """Fold over the LAST axis of a (..., n_lat) array (transpose of
    sync_last)."""
    n = info.n_lat
    for _ in range(info.sync_iters):
        for (pi, step) in reversed(plane_steps(info)):
            m = info.ghost_prev[pi]
            if m is None:
                continue
            y = y + _shift_last(m * y, -step, n) - m * y
    return y


def gauss_mac3(info: GdiaInfo, planes: GaussPlanes, x):
    """Internal-face Gauss sum of a ghost-synced scalar cell field: (3, n)
    per-slot partial sums (pre-fold), via the shift-MAC kernel."""
    from ..ops.gdia_mac import shift_mac_cols
    return shift_mac_cols(x.contiguous(), planes.coeffs, planes.offsets)


def gauss_mac1(info: GdiaInfo, planes: GaussPlanes, i: int, x):
    """Single-direction Gauss sum: (n,) partials of planes_i applied to a
    scalar cell field (the divergence contraction building block)."""
    from ..ops.gdia_mac import shift_mac_cols
    return shift_mac_cols(x.contiguous(), planes.coeffs_i[i],
                          planes.offsets)[0]


def flux_mac(info: GdiaInfo, Sf, weights, x):
    """Plane-face fluxes of a ghost-synced (n, 3) vector field:
    phi_p[s] = sum_c Sf_pc[s] (w_p[s] x_c[s] + (1-w_p[s]) x_c[s+d])."""
    n = info.n_lat
    steps = info.steps
    D = max(steps)
    cols = [x[:, c] for c in range(x.shape[1])]
    pads = [torch.nn.functional.pad(c_, (D, D)) for c_ in cols]
    out = []
    for i, st in enumerate(steps):
        wi = weights[i * n:(i + 1) * n]
        acc = None
        for c in range(len(cols)):
            sfc = Sf[i * n:(i + 1) * n, c]
            xn = pads[c][D + st:D + st + n]
            t = sfc * (wi * cols[c] + (1.0 - wi) * xn)
            acc = t if acc is None else acc + t
        out.append(acc)
    return torch.cat(out)


def fold_diag(info: GdiaInfo, diag):
    """Fold per-slot diagonal contributions into the primary row and NULL
    the ghost/dead rows (diag 0; their rhs is zeroed by the caller).
    Null rows, not identity rows: an identity row's |psi_g - xRef| would
    enter the residual norm factor at full field scale (see the JAX
    package's fold_diag)."""
    d = fold(info, diag)
    return d * _bcast(info.primary, d)
