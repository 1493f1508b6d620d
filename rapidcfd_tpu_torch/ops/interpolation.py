"""Face interpolation of cell fields (port of rapidcfd_tpu/ops/
interpolation.py). Every scheme reduces to owner weights w on internal
faces (faceVal = w*own + (1-w)*nei). The whole JAX registry is here:
linear, upwind, downwind, midPoint, reverseLinear; linearUpwind and LUST
(their weights only: the JAX package applies no explicit correction,
rapidcfd_tpu/ops/interpolation.py:244-252 and 445-452; each scheme that
drops a correction says so by name in the log, once); the limited (TVD)
family vanLeer, Minmod, vanAlbada, MUSCL, SuperBee, OSPRE, UMIST and
limitedLinear k; the NVD/extended family QUICK, SFCD, Gamma k,
limitedCubic k, blended k and filteredLinear(2, 3), each TVD and NVD
scheme also under its V and 01 names; harmonic, clippedLinear, localMax,
localMin, fixedBlended, outletStabilised, skewCorrected and cubic (its
linear base, as in the JAX package); CoBlended (set_current_dt),
localBlended (set_blending_factor), Phi, limitWith,
fixedWeights/weighted, limiterBlended and the coupled
multivariate_weights.

The limiters use the Sweby r-formulation with the reference's stencil
estimate r = 2*(d . gradc)/(psiN - psiO) - 1, gradc the upwind cell
gradient (reference: limitedSchemes/LimitedScheme). The extended family's
V-scheme contraction takes gradf = |psiN - psiO| unsigned, as the JAX
package does (its sign is computed and overwritten,
rapidcfd_tpu/ops/interpolation.py:287-288: ROADMAP Queue 3).
"""

from __future__ import annotations

import torch

from ..fields.field import SurfaceField, VolField
from ..mesh.mesharrays import MeshArrays
from ..utils.logging import info

#: schemes whose dropped explicit correction has been logged
_WARNED: set[str] = set()


def _dropped_correction(name: str, what: str) -> None:
    """Log once per scheme name that its explicit correction is not
    applied (the JAX package applies none either)."""
    if name not in _WARNED:
        _WARNED.add(name)
        info(f"--> FOAM Warning : interpolation scheme {name}: {what} is "
             "not applied (weights only, as in the JAX package)")


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
    _dropped_correction("linearUpwind", "the explicit gradient correction")
    return _upwind_weights(mesh, phi)


def _lust(mesh, vf, phi, *args, g=None):
    """LUST (port of rapidcfd_tpu/ops/interpolation.py:445-452; reference:
    schemes/LUST): 0.75 linear + 0.25 upwind weights. The reference's
    explicit linearUpwind correction is not applied, as in the JAX
    package; the grad(U) word is read and unused."""
    if phi is None:
        raise ValueError("LUST requires a flux field")
    _dropped_correction("LUST", "the linearUpwind gradient correction")
    return 0.75 * mesh.weights + 0.25 * _upwind_weights(mesh, phi)


def _downwind(mesh, vf, phi, g=None):
    if phi is None:
        raise ValueError("downwind interpolation requires a flux field")
    return (phi.data[:mesh.n_internal] < 0.0).to(mesh.weights.dtype)


def _midpoint(mesh, vf, phi, g=None):
    return torch.full_like(mesh.weights, 0.5)


def _reverse_linear(mesh, vf, phi, g=None):
    return 1.0 - mesh.weights


SCHEMES = {"linear": _linear, "upwind": _upwind, "downwind": _downwind,
           "midPoint": _midpoint, "reverseLinear": _reverse_linear,
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
            f"interpolation scheme '{name}' is not in the registry (the JAX "
            f"package's names: {', '.join(sorted(SCHEMES))})")
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


# ---------------------------------------------------------------------------
# NVD/extended limited family (reference: limitedSchemes/{QUICK,SFCD,Gamma,
# limitedCubic,blended,filteredLinear}; rapidcfd_tpu/ops/interpolation.py:
# 255-395)
# ---------------------------------------------------------------------------

def _face_quantities(mesh, vf, phi, g=None):
    """The stencil pieces of the extended limiters on internal faces: the
    cd weight, gradf = psiN - psiO, d & gradcP, d & gradcN and the upwind
    mask. A vector field is contracted along psiN - psiO (the V-scheme
    treatment), gradf then unsigned as in the JAX package. g: fvc.grad(vf)
    (on gdia the C = 3 kernel), computed here when not given."""
    from . import fvc
    if g is None:
        g = fvc.grad(mesh, vf)
    C_o, C_n = fvc.face_own_nei(mesh, mesh.C)
    d = C_n - C_o
    g_o, g_n = fvc.face_own_nei(mesh, g.data)
    v_o, v_n = fvc.face_own_nei(mesh, vf.data)
    up = phi.data[:mesh.n_internal] >= 0.0
    if vf.data.dim() == 1:
        gP = (d * g_o).sum(-1)
        gN = (d * g_n).sum(-1)
        gradf = v_n - v_o
    else:
        dpsi = v_n - v_o
        den = (dpsi * dpsi).sum(-1)
        den = torch.clamp(den, min=1e-30)
        gP = ((d[:, :, None] * g_o).sum(1) * dpsi).sum(-1) / torch.sqrt(den)
        gN = ((d[:, :, None] * g_n).sum(1) * dpsi).sum(-1) / torch.sqrt(den)
        gradf = torch.sqrt(den)
    return mesh.weights, gradf, gP, gN, up


def _stabilise(x, small=1e-30):
    return torch.where(x.abs() < small,
                       torch.where(x >= 0, torch.full_like(x, small),
                                   torch.full_like(x, -small)), x)


def _make_extended(name, fn):
    """Register an NVD scheme under its name and its V and 01 names."""
    def scheme(mesh, vf, phi, *args, g=None):
        if phi is None:
            raise ValueError(f"{name} interpolation requires a flux field")
        lim = fn(mesh, _face_quantities(mesh, vf, phi, g), *args)
        return _limited_weights(mesh, phi, lim)
    for word in (name, name + "V", name + "01"):
        SCHEMES[word] = scheme
    return scheme


def _r_ext(q):
    w, gradf, gP, gN, up = q
    return 2.0 * torch.where(up, gP, gN) / _stabilise(gradf) - 1.0


def _quick(mesh, q, *args):
    """QUICK (reference QUICK.H:69-100): clip((3 + r)/4, 0, 2)."""
    return torch.clamp((3.0 + _r_ext(q)) / 4.0, 0.0, 2.0)


def _phict(q):
    """The NVD normalised variable 1 - 0.5 gradf/gradcf (reference
    NVDTVD.H phict)."""
    w, gradf, gP, gN, up = q
    return 1.0 - 0.5 * gradf / _stabilise(torch.where(up, gP, gN))


def _gamma(mesh, q, k=1.0):
    """Gamma k (reference Gamma.H:80-98): clip(phict/k, 0, 1)."""
    return torch.clamp(_phict(q) / max(float(k), 1e-6), 0.0, 1.0)


def _sfcd(mesh, q, *args):
    """SFCD (reference SFCD.H:66-84): l/(1 - l), l = clip(phict, 0, 0.5)."""
    lp = torch.clamp(_phict(q), 0.0, 0.5)
    return lp / (1.0 - lp)


def _limited_cubic(mesh, q, k=1.0):
    """limitedCubic k (reference limitedCubic.H:78-127): min(2r/k, the
    cubic limiter), clipped to [0, 2]."""
    w, gradf, gP, gN, up = q
    twor = (2.0 / max(float(k), 1e-6)) * _r_ext(q)
    corr = 0.25 * ((1.0 - w) * gP - w * gN)
    cubic = torch.where(up, 1.0 + corr / _stabilise((1.0 - w) * gradf),
                        1.0 + corr / _stabilise(-w * gradf))
    return torch.clamp(torch.minimum(twor, cubic), 0.0, 2.0)


def _filtered_linear(mesh, q, *args):
    """filteredLinear (reference filteredLinear.H:81-92): damps only faces
    with high-frequency content, limiter in [0.8, 1]."""
    w, gradf, gP, gN, up = q
    lim = 2.0 - 0.5 * torch.minimum((gradf - gP).abs(), (gradf - gN).abs()) \
        / (torch.maximum(gP.abs(), gN.abs()) + 1e-30)
    return torch.clamp(lim, 0.8, 1.0)


def _blended(mesh, q, k=0.5):
    """blended k (reference limitedSchemes/blended): the constant blend k
    linear + (1 - k) upwind."""
    return torch.full_like(q[0], float(k))


_make_extended("QUICK", _quick)
_make_extended("Gamma", _gamma)
_make_extended("SFCD", _sfcd)
_make_extended("limitedCubic", _limited_cubic)
_make_extended("filteredLinear", _filtered_linear)
_make_extended("filteredLinear2", _filtered_linear)
_make_extended("filteredLinear3", _filtered_linear)
_make_extended("blended", _blended)


# ---------------------------------------------------------------------------
# value-dependent and wrapper schemes (reference: schemes/;
# rapidcfd_tpu/ops/interpolation.py:398-479)
# ---------------------------------------------------------------------------

def _weights_of(mesh, vf, phi, name, *args, g=None):
    """The weights of a scheme named inside another scheme's words."""
    fn = SCHEMES.get(str(name))
    if fn is None:
        raise NotImplementedError(f"interpolation scheme '{name}' is not "
                                  "in the registry")
    return fn(mesh, vf, phi, *args, g=g)


def _harmonic(mesh, vf, phi, g=None):
    """The harmonic mean 2ab/(a + b) as the owner weight b/(a + b), exact
    for positive scalars; linear for vectors (reference:
    schemes/harmonic)."""
    from .fvc import face_own_nei
    if vf.data.dim() != 1:
        return mesh.weights
    a, b = face_own_nei(mesh, vf.data)
    s = a + b
    small = s.abs() < 1e-30
    return torch.where(small, torch.full_like(s, 0.5),
                       b / torch.where(small, torch.ones_like(s), s))


def _clipped_linear(mesh, vf, phi, ratio=0.5, g=None):
    """clippedLinear cellVolumeRatio (reference schemes/clippedLinear):
    linear weights clipped to [wl, 1 - wl], wl = ratio/(1 + ratio)."""
    wl = float(ratio) / (1.0 + float(ratio))
    return torch.clamp(mesh.weights, wl, 1.0 - wl)


def _local_extremum(pick):
    def scheme(mesh, vf, phi, g=None):
        from .fvc import face_own_nei
        if vf.data.dim() != 1:
            return mesh.weights
        a, b = face_own_nei(mesh, vf.data)
        return pick(a, b).to(mesh.weights.dtype)
    return scheme


def _fixed_blended(mesh, vf, phi, k=0.5, s1="linear", s2="upwind", g=None):
    """fixedBlended k scheme1 scheme2 (reference schemes/fixedBlended): k
    w1 + (1 - k) w2."""
    kk = float(k)
    return kk * _weights_of(mesh, vf, phi, s1, g=g) \
        + (1.0 - kk) * _weights_of(mesh, vf, phi, s2, g=g)


def _inner_scheme(word, what):
    """outletStabilised and skewCorrected <scheme>: the inner scheme's
    weights (the JAX package drops the outlet upwinding and the skewness
    correction: reference schemes/outletStabilised, skewCorrected)."""
    def scheme(mesh, vf, phi, inner="linear", *args, g=None):
        _dropped_correction(word, what)
        return _weights_of(mesh, vf, phi, inner, *args, g=g)
    return scheme


def _cubic(mesh, vf, phi, g=None):
    """cubic (reference schemes/cubic): its linear base, as in the JAX
    package (the explicit cubic correction is not in the weights)."""
    _dropped_correction("cubic", "the explicit cubic correction")
    return mesh.weights


SCHEMES.update({
    "harmonic": _harmonic, "clippedLinear": _clipped_linear,
    "localMax": _local_extremum(lambda a, b: a >= b),
    "localMin": _local_extremum(lambda a, b: a <= b),
    "fixedBlended": _fixed_blended,
    "outletStabilised": _inner_scheme("outletStabilised",
                                      "the outlet-face upwinding"),
    "skewCorrected": _inner_scheme("skewCorrected",
                                   "the skewness correction"),
    "cubic": _cubic})


# ---------------------------------------------------------------------------
# CoBlended, localBlended, Phi, limitWith, multivariate, weighted,
# limiterBlended (rapidcfd_tpu/ops/interpolation.py:482-669)
# ---------------------------------------------------------------------------

#: the running solver's current time step (CoBlended's Courant number)
_CURRENT_DT = None


def set_current_dt(dt):
    """Expose dt to the Courant-based schemes (CoBlended). The solver step
    calls it before assembling convection terms."""
    global _CURRENT_DT
    _CURRENT_DT = dt


#: face blending factors of localBlended, by field name (the reference
#: looks up '<field>BlendingFactor' in the object registry)
_BLENDING_FACTORS: dict = {}


def set_blending_factor(field_name: str, face_values):
    """The (n_internal,) or (n_faces,) blending factor of `localBlended`
    on field_name (1 = scheme1, 0 = scheme2)."""
    _BLENDING_FACTORS[field_name] = face_values


def _co_blended(mesh, vf, phi, co1=1.0, s1="linear", co2=10.0, s2="upwind",
                g=None):
    """CoBlended (reference CoBlended.H): bf = 1 - clip((Co - Co1)/(Co2 -
    Co1), 0, 1), Co = dt deltaCoeffs |phi|/magSf; bf w1 + (1 - bf) w2."""
    if phi is None:
        raise ValueError("CoBlended requires a flux field")
    if _CURRENT_DT is None:
        raise ValueError("CoBlended requires interpolation."
                         "set_current_dt(dt) in the solver step")
    n = mesh.n_internal
    co = _CURRENT_DT * mesh.delta_coeffs * phi.data[:n].abs() \
        / torch.clamp(mesh.mag_sf[:n], min=1e-30)
    bf = 1.0 - torch.clamp((co - float(co1))
                           / max(float(co2) - float(co1), 1e-30), 0.0, 1.0)
    return bf * _weights_of(mesh, vf, phi, s1, g=g) \
        + (1.0 - bf) * _weights_of(mesh, vf, phi, s2, g=g)


def _local_blended(mesh, vf, phi, s1="linear", s2="upwind", g=None):
    """localBlended (reference localBlended.H): blended by the factor set
    with set_blending_factor(vf.name, ...)."""
    bf = _BLENDING_FACTORS.get(vf.name)
    if bf is None:
        raise ValueError(f"localBlended on '{vf.name}': no blending factor "
                         "set (interpolation.set_blending_factor)")
    bf = torch.as_tensor(bf, dtype=mesh.weights.dtype,
                         device=mesh.weights.device)[:mesh.n_internal]
    return bf * _weights_of(mesh, vf, phi, s1, g=g) \
        + (1.0 - bf) * _weights_of(mesh, vf, phi, s2, g=g)


def _phi_scheme(mesh, vf, phi, k=1.0, g=None):
    """Phi limiter of a vector field (reference limitedSchemes/Phi):
    (faceFlux - phiU)/stabilise(phiCD - phiU) + k, clipped to [0, 1],
    phiP/N the owner/neighbour values projected on Sf."""
    if phi is None:
        raise ValueError("Phi interpolation requires a flux field")
    if vf.data.dim() != 2:
        raise ValueError("Phi scheme applies to vector fields (U)")
    from .fvc import face_own_nei
    n = mesh.n_internal
    v_o, v_n = face_own_nei(mesh, vf.data)
    sf = mesh.Sf[:n]
    phi_p = (sf * v_o).sum(-1)
    phi_n = (sf * v_n).sum(-1)
    f = phi.data[:n]
    phi_u = torch.where(f > 0, phi_p, phi_n)
    cd = mesh.weights
    phi_cd = cd * phi_p + (1.0 - cd) * phi_n
    lim = (f - phi_u) / _stabilise(phi_cd - phi_u) + float(k)
    return _limited_weights(mesh, phi, torch.clamp(lim, 0.0, 1.0))


def _limit_with(mesh, vf, phi, s1="linear", s2="vanLeer", *args, g=None):
    """limitWith (reference limitedSchemes/limitWith): scheme1 limited by
    scheme2's TVD limiter, upwind + lim (w1 - upwind)."""
    if phi is None:
        raise ValueError("limitWith requires a flux field")
    lim_fn = _LIMITERS.get(str(s2))
    if lim_fn is None:
        raise ValueError(f"limitWith: unknown limiter '{s2}' "
                         f"(available: {sorted(_LIMITERS)})")
    r = _face_r(mesh, vf, phi, g)
    lim = torch.clamp(lim_fn(r, *[float(a) for a in args]), 0.0, 1.0)
    up = _upwind_weights(mesh, phi)
    return up + lim * (_weights_of(mesh, vf, phi, s1, g=g) - up)


def multivariate_weights(mesh, fields, phi, limiter_name="vanLeer", *args,
                         grads=None):
    """One set of owner weights for a coupled system of fields: the face
    limiter is the minimum over the fields (reference:
    multivariateGaussConvectionScheme, multivariateScheme.H). grads: each
    field's fvc.grad, computed when not given."""
    lim_fn = _LIMITERS.get(str(limiter_name))
    if lim_fn is None:
        base = str(limiter_name).replace("01", "").replace("V", "")
        lim_fn = _LIMITERS.get(base)
    if lim_fn is None:
        raise ValueError(f"multivariate: unknown limiter '{limiter_name}'")
    lim = None
    for i, f in enumerate(fields):
        r = _face_r(mesh, f, phi, None if grads is None else grads[i])
        li = torch.clamp(lim_fn(r, *[float(a) for a in args]), 0.0, 2.0)
        lim = li if lim is None else torch.minimum(lim, li)
    return _limited_weights(mesh, phi, lim)


def _fixed_weights(mesh, vf, phi, w=None, g=None):
    """Owner weights handed in the scheme tuple, ('weighted', w): the
    multivariate pseudo-scheme fixedWeights and the reference's `weighted`
    (schemes/weighted/weighted.H, whose field the JAX package, without an
    object registry, takes from the tuple as well)."""
    if w is None or isinstance(w, str):
        raise ValueError(
            "weighted/fixedWeights requires a weights array in the scheme "
            "tuple, ('weighted', w): a field name is not looked up")
    return torch.as_tensor(w, dtype=mesh.weights.dtype,
                           device=mesh.weights.device)


def _limiter_blended(mesh, vf, phi, *args, g=None):
    """limiterBlended <limitedScheme> [coeffs] <scheme1> <scheme2>
    (reference schemes/limiterBlended): lim w1 + (1 - lim) w2, lim the
    named TVD limiter on the r stencil, clipped to [0, 1]; the tokens
    after scheme2 are scheme2's."""
    if phi is None:
        raise ValueError("limiterBlended requires a flux field")
    if not args:
        raise ValueError("limiterBlended: expected 'limiterBlended "
                         "<limitedScheme> [coeff] <scheme1> <scheme2>'")
    lim_name, rest = str(args[0]), list(args[1:])
    if lim_name not in _LIMITERS:
        raise KeyError(f"limiterBlended: unknown limited scheme "
                       f"'{lim_name}'")
    lim_args = []
    while rest and isinstance(rest[0], (int, float)):
        lim_args.append(float(rest.pop(0)))
    if len(rest) < 2:
        raise ValueError("limiterBlended: needs two schemes to blend")
    r = _face_r(mesh, vf, phi, g)
    lim = torch.clamp(_LIMITERS[lim_name](r, *lim_args), 0.0, 1.0)
    return lim * _weights_of(mesh, vf, phi, rest[0], g=g) \
        + (1.0 - lim) * _weights_of(mesh, vf, phi, rest[1], *rest[2:], g=g)


SCHEMES.update({
    "CoBlended": _co_blended, "localBlended": _local_blended,
    "Phi": _phi_scheme, "limitWith": _limit_with,
    "fixedWeights": _fixed_weights, "weighted": _fixed_weights,
    "limiterBlended": _limiter_blended})
