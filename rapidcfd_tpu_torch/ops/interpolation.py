"""Face interpolation of cell fields (port of rapidcfd_tpu/ops/
interpolation.py:22-257 and set_current_dt). Every scheme reduces to owner
weights w on internal faces (faceVal = w*own + (1-w)*nei). Ported: linear,
upwind, linearUpwind (upwind weights, as the JAX package's fvm path takes
it), LUST (its weights only, as the JAX package) and the limited (TVD) family: vanLeer, Minmod, vanAlbada, MUSCL,
SuperBee, OSPRE, UMIST and limitedLinear k, each also under its V and 01
names. The NVD/extended family and the blended schemes are not ported.

The limiters use the Sweby r-formulation with the reference's stencil
estimate r = 2*(d . gradc)/(psiN - psiO) - 1, gradc the upwind cell
gradient (reference: limitedSchemes/LimitedScheme).
"""

from __future__ import annotations

import torch

from ..fields.field import SurfaceField, VolField
from ..mesh.mesharrays import MeshArrays


def _unwrap(scheme):
    """('bounded', inner) is an fvm-only marker; interpolation uses the
    inner scheme."""
    if isinstance(scheme, tuple) and len(scheme) == 2 \
            and scheme[0] == "bounded":
        return scheme[1]
    return scheme


def _upwind_weights(mesh, phi):
    return (phi.data[:mesh.n_internal] >= 0.0).to(mesh.weights.dtype)


def _linear(mesh, vf, phi, g=None):
    return mesh.weights


def _upwind(mesh, vf, phi, g=None):
    if phi is None:
        raise ValueError("upwind interpolation requires a flux field")
    return _upwind_weights(mesh, phi)


def _linear_upwind(mesh, vf, phi, *args, g=None):
    """Second-order upwind is value-corrected, not weight-expressible: the
    fvm path takes pure upwind weights, as the JAX package does (its
    explicit correction is not ported)."""
    if phi is None:
        raise ValueError("linearUpwind requires a flux field")
    return _upwind_weights(mesh, phi)


def _lust(mesh, vf, phi, *args, g=None):
    """LUST (port of rapidcfd_tpu/ops/interpolation.py:445-452; reference:
    schemes/LUST): 0.75 linear + 0.25 upwind weights. The reference's
    explicit linearUpwind correction is not applied, as in the JAX
    package; the grad(U) word is read and unused."""
    if phi is None:
        raise ValueError("LUST requires a flux field")
    return 0.75 * mesh.weights + 0.25 * _upwind_weights(mesh, phi)


SCHEMES = {"linear": _linear, "upwind": _upwind,
           "linearUpwind": _linear_upwind, "LUST": _lust}


# ---------------------------------------------------------------------------
# limited (TVD) family — reference: limitedSchemes/LimitedScheme
# ---------------------------------------------------------------------------

def _guard(den):
    """den with |den| < 1e-30 replaced by +-1e-30 (its sign kept)."""
    tiny = torch.full_like(den, 1e-30)
    return torch.where(den.abs() < tiny, torch.where(den >= 0, tiny, -tiny),
                       den)


def _face_r(mesh: MeshArrays, vf: VolField, phi: SurfaceField,
            g: VolField | None = None) -> torch.Tensor:
    """Upwind gradient ratio r per internal face. For vector fields the
    limiter contracts over components: one r per face, from (d . gradc)
    against (psiN - psiO), as the JAX package does. g: fvc.grad(vf),
    computed here when not given."""
    from . import fvc
    if g is None:
        g = fvc.grad(mesh, vf)       # scalar->vector, vector->tensor
    if mesh.gdia is not None:
        return _face_r_gdia(mesh, vf, phi, g)
    C_o, C_n = fvc.face_own_nei(mesh, mesh.C)
    d = C_n - C_o
    g_o, g_n = fvc.face_own_nei(mesh, g.data)
    v_o, v_n = fvc.face_own_nei(mesh, vf.data)
    up = phi.data[:mesh.n_internal] >= 0.0
    dpsi = v_n - v_o
    if vf.data.dim() == 1:
        gradc = torch.where(up[:, None], g_o, g_n)
        num = 2.0 * (d * gradc).sum(-1)
        den = dpsi
    else:
        gradc = torch.where(up[:, None, None], g_o, g_n)
        num = 2.0 * ((d[:, :, None] * gradc).sum(1) * dpsi).sum(-1)
        den = (dpsi * dpsi).sum(-1)
    return num / _guard(den) - 1.0


def _face_r_gdia(mesh: MeshArrays, vf: VolField, phi: SurfaceField,
                 grad: VolField) -> torch.Tensor:
    """_face_r on gdia lattice meshes, per plane over (n,) component
    slices, in slot orientation: plane face s joins slot s (owner) and
    slot s + step (neighbour). Dummy and dead faces get a finite r (the
    1e-30 guard), which the null rows of the matrix never read."""
    from ..mesh import gdia as gd
    g_ = mesh.gdia
    n = g_.n_lat
    steps = g_.steps
    D = max(steps)
    x = gd.sync(g_, vf.data)
    g = gd.sync(g_, grad.data)                  # grad is ghost-synced
    C = mesh.C                                   # ghost-synced by build

    def sl(xp, st):
        return xp[D + st:D + st + n]

    Cp = [gd.pad_cell(C[:, i], D) for i in range(3)]
    if x.dim() == 1:
        xp = gd.pad_cell(x, D)
        gp = [gd.pad_cell(g[:, i], D) for i in range(3)]
    else:
        m = x.shape[1]
        xp = [gd.pad_cell(x[:, j], D) for j in range(m)]
        gp = [[gd.pad_cell(g[:, i, j], D) for i in range(3)]
              for j in range(m)]
    rs = []
    for pi, st in enumerate(steps):
        up = phi.data[pi * n:(pi + 1) * n] >= 0.0
        d_i = [sl(Cp[i], st) - C[:, i] for i in range(3)]
        if x.dim() == 1:
            den = sl(xp, st) - x
            num = 0.0
            for i in range(3):
                num = num + d_i[i] * torch.where(up, g[:, i],
                                                 sl(gp[i], st))
            num = 2.0 * num
        else:
            dpsi = [sl(xp[j], st) - x[:, j] for j in range(m)]
            den = sum(dp * dp for dp in dpsi)
            num = 0.0
            for j in range(m):
                dg_j = 0.0
                for i in range(3):
                    dg_j = dg_j + d_i[i] * torch.where(
                        up, g[:, i, j], sl(gp[j][i], st))
                num = num + dg_j * dpsi[j]
            num = 2.0 * num
        rs.append(num / _guard(den) - 1.0)
    return torch.cat(rs)


def _limited_weights(mesh, phi, limiter_psi):
    """Blend upwind and linear weights by the limiter value:
    w = limiter*linearWeights + (1-limiter)*upwindWeights."""
    return limiter_psi * mesh.weights \
        + (1.0 - limiter_psi) * _upwind_weights(mesh, phi)


#: named TVD limiter functions (r -> limiter)
_LIMITERS: dict = {}


def _make_limited(name, limiter):
    """Register a limited scheme under its name and its V and 01 names.
    The reference's V variants limit all components with one scalar
    limiter, which _face_r already does for vectors; the 01 variants
    (Limited01) are the same limiter here, as in the JAX package."""
    def scheme(mesh, vf, phi, *args, g=None):
        if phi is None:
            raise ValueError(f"{name} interpolation requires a flux field")
        r = _face_r(mesh, vf, phi, g)
        return _limited_weights(mesh, phi, limiter(r, *args))
    for word in (name, name + "V", name + "01"):
        SCHEMES[word] = scheme
    _LIMITERS[name] = limiter
    return scheme


def _pos(r, f):
    """f(r) where r > 0, else 0."""
    return torch.where(r > 0, f(r), torch.zeros_like(r))


_make_limited("vanLeer", lambda r: (r + r.abs()) / (1.0 + r.abs()))
_make_limited("Minmod", lambda r: torch.clamp(r, 0.0, 1.0))
_make_limited("vanAlbada",
              lambda r: _pos(r, lambda r: r * (r + 1.0) / (r * r + 1.0)))
_make_limited("MUSCL", lambda r: torch.clamp(torch.clamp(
    torch.minimum(2.0 * r, 0.5 * r + 0.5), max=2.0), min=0.0))
_make_limited("SuperBee", lambda r: torch.maximum(
    torch.clamp(2.0 * r, 0.0, 1.0), torch.clamp(r, 0.0, 2.0)))
_make_limited("OSPRE", lambda r: _pos(
    r, lambda r: 1.5 * r * (r + 1.0) / (r * r + r + 1.0)))
_make_limited("UMIST", lambda r: torch.clamp(torch.minimum(
    torch.minimum(2.0 * r, 0.25 + 0.75 * r),
    torch.clamp(0.75 + 0.25 * r, max=2.0)), min=0.0))
# limitedLinear k: limiter = max(min(2r/k, 1), 0), k in (0, 1]; k comes
# from the scheme's words, so it may be a string
_make_limited("limitedLinear", lambda r, k=1.0: torch.clamp(
    2.0 * r / max(float(k), 1e-6), 0.0, 1.0))


def scheme_weights(mesh: MeshArrays, vf: VolField, scheme="linear",
                   phi: SurfaceField | None = None,
                   g: VolField | None = None) -> torch.Tensor:
    """Owner weights on internal faces (used by fvm::div assembly). g:
    fvc.grad(vf) for the limited schemes, taken by them when not given;
    the other schemes ignore it."""
    scheme = _unwrap(scheme)
    name, args = (scheme[0], scheme[1:]) if isinstance(scheme, tuple) \
        else (scheme, ())
    fn = SCHEMES.get(name)
    if fn is None:
        raise NotImplementedError(
            f"interpolation scheme '{name}' is not ported yet (ported: "
            f"{', '.join(sorted(SCHEMES))})")
    return fn(mesh, vf, phi, *args, g=g)


def interpolate_internal(mesh: MeshArrays, vf: VolField, scheme="linear",
                         phi: SurfaceField | None = None,
                         g: VolField | None = None) -> torch.Tensor:
    """Internal-face values by the named scheme (g as in scheme_weights)."""
    from .fvc import face_own_nei
    w = scheme_weights(mesh, vf, scheme, phi, g)
    own, nei = face_own_nei(mesh, vf.data)
    if own.dim() > w.dim():
        w = w.reshape(w.shape + (1,) * (own.dim() - w.dim()))
    return w * own + (1.0 - w) * nei


#: the running solver's current time step, for Courant-based schemes
#: (CoBlended in the JAX package; none of them is ported yet)
_CURRENT_DT = None


def set_current_dt(dt):
    """Expose dt to Courant-based schemes. The solver step calls it before
    assembling convection terms."""
    global _CURRENT_DT
    _CURRENT_DT = dt
