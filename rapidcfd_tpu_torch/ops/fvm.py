"""fvm — implicit finite-volume operators returning FvMatrix systems
(port of rapidcfd_tpu/ops/fvm.py: Euler, local-Euler, backward,
CrankNicolson and steadyState ddt,
with a density-like coefficient or without, Gauss and bounded Gauss div,
the orthogonal and corrected laplacian, the Sp/Su/SuSp sources, with
negSumDiag as an ELL gather or by gdia plane shifts)."""

from __future__ import annotations

import torch

from ..utils.dimensions import DimensionSet, dim_length, dimless

from ..fields.field import Dimensioned, SurfaceField, VolField
from ..mesh import gdia as gd
from ..mesh.mesharrays import MeshArrays
from .fvmatrix import FvMatrix, _ext
from .interpolation import scheme_weights

_VOL = DimensionSet.of(0, 3)
_TIME = DimensionSet.of(0, 0, 1)
_AREA = dim_length ** 2
#: the local time-stepping ddt schemes: the Euler stencil with a per-cell dt
LTS_SCHEMES = ("localEuler", "CoEuler", "SLTS")


def _pair_gather(mesh: MeshArrays, own_arr, nei_arr):
    """Per-cell-slot gather where owner slots read own_arr[f] and
    neighbour slots read nei_arr[f] (the [0..nInt | nInt..2nInt | zero]
    structure of ell_coeff_idx)."""
    cat = torch.cat([own_arr, nei_arr, own_arr.new_zeros(1)])
    return cat[mesh.ell_coeff_idx]


def _neg_sum_diag(mesh: MeshArrays, lower, upper):
    """diag[own] -= lower[f]; diag[nei] -= upper[f] (lduMatrix::negSumDiag):
    an ELL gather, or per lattice slot on gdia meshes (the fold to primary
    rows happens in component_system)."""
    if mesh.gdia is None:
        return -_pair_gather(mesh, lower, upper).sum(1)
    return gd.neg_sum_diag(mesh.gdia, lower, upper)


def cn_coeff(scheme):
    """ocCoeff of a CrankNicolson ddt scheme (a word, or the case's
    ('CrankNicolson', ocCoeff)), None for any other scheme."""
    name = scheme[0] if isinstance(scheme, tuple) and scheme else scheme
    if name not in ("CrankNicolson", "CrankNicholson"):
        return None
    return float(scheme[1]) if isinstance(scheme, tuple) \
        and len(scheme) > 1 else 1.0


def old_levels(scheme) -> int:
    """Old time levels a ddt scheme reads: 2 for backward and
    CrankNicolson, 1 for the Euler family (and steadyState)."""
    return 2 if scheme == "backward" or cn_coeff(scheme) is not None else 1


def store_old(mesh: MeshArrays, vf: VolField, dt, scheme) -> VolField:
    """Start a time step of vf under a ddt scheme: store its old levels
    (two for backward and CrankNicolson) and, for CrankNicolson, advance
    its ddt0 state once (cn_advance)."""
    vf = vf.store_old(levels=old_levels(scheme), dt=dt)
    oc = cn_coeff(scheme)
    return vf if oc is None else cn_advance(mesh, vf, dt, oc_coeff=oc)


def cn_advance(mesh: MeshArrays, vf: VolField, dt, dt0=None,
               oc_coeff: float = 1.0, coeff: VolField | None = None
               ) -> VolField:
    """Advance the CrankNicolson ddt0 state once per time step, right
    after store_old(levels=2) (port of rapidcfd_tpu/ops/fvm.py:73-115;
    reference: CrankNicolsonDdtScheme.C:417, ddt0 = rDtCoef0*(psi0 -
    psi00) - ocCoeff*ddt0_prev with the start-up blending coef0). dt0 is
    the previous step's size: the old level's step_dt when not given (the
    JAX package takes dt). With coeff (rho) the state tracks
    d(rho*psi)/dt."""
    if vf.old is None:
        return vf
    if dt0 is None:
        dt0 = vf.old.step_dt if vf.old.step_dt is not None else dt
    gamma = float(oc_coeff)
    if vf.ddt0 is None:
        prev_d, prev_b, steps = (torch.zeros_like(vf.data),
                                 torch.zeros_like(vf.bvalues), 0)
    else:
        prev_d, prev_b, steps = vf.ddt0
    if vf.old.old is None:
        # inside the first step: zeros, the step counted
        return vf.replace(ddt0=(prev_d, prev_b, steps + 1))
    coef0 = 1.0 + gamma if steps > 1 else 1.0
    if coeff is None:
        d_old = vf.old.data - vf.old.old.data
        b_old = vf.old.bvalues - vf.old.old.bvalues
    else:
        d_old = _ext(coeff.old.data, vf.old.data) * vf.old.data \
            - _ext(coeff.old.old.data, vf.old.data) * vf.old.old.data
        b_old = _ext(coeff.old.bvalues, vf.old.bvalues) * vf.old.bvalues \
            - _ext(coeff.old.old.bvalues, vf.old.bvalues) \
            * vf.old.old.bvalues
    rdt0 = coef0 / dt0
    return vf.replace(ddt0=(rdt0 * d_old - gamma * prev_d,
                            rdt0 * b_old - gamma * prev_b, steps + 1))


def _two_levels(vf: VolField, scheme: str):
    """A backward or CrankNicolson ddt needs a field stored with two old
    levels, and past its first store the second of them: a field stored
    with one level, or one that lost old.old on the way, raises rather
    than run Euler under the scheme's name."""
    if vf.old is None:
        raise ValueError(f"ddt({vf.name}): no old-time field stored")
    if vf.levels < 2:
        raise ValueError(
            f"ddt({vf.name}): ddtScheme '{scheme}' needs the field stored "
            f"with two old levels (store_old(levels=2)); it keeps "
            f"{vf.levels}")
    if vf.old.old is None and vf.stores > 1:
        raise ValueError(
            f"ddt({vf.name}): ddtScheme '{scheme}' at store {vf.stores} "
            "finds no second old level: the field lost old.old after "
            "its last store_old")


def ddt(mesh: MeshArrays, vf: VolField, dt, scheme="Euler",
        coeff: VolField | None = None) -> FvMatrix:
    """fvm::ddt(psi) or fvm::ddt(rho, psi) (port of rapidcfd_tpu/ops/
    fvm.py:117-207). dt is a Python float or a 0-d tensor; coeff is a
    density-like VolField that carries its own old levels.

    - Euler (EulerDdtScheme::fvmDdt: diag rho V/dt, source rho.old
      psi.old V/dt); localEuler, CoEuler and SLTS (localEulerDdtScheme)
      share its stencil with a per-cell dt: pass dt as an (nCells,)
      tensor of 1/rDeltaT. steadyState is the zero matrix.
    - backward (backwardDdtScheme::fvmDdt): diag coefft rho V/dt, source
      (coefft0 rho0 psi0 - coefft00 rho00 psi00) V/dt with coefft = 1 +
      dt/(dt + dt0), coefft00 = dt^2/(dt0 (dt + dt0)), coefft0 = coefft +
      coefft00 (3/2, 1/2 and 2 at constant dt, the JAX package's
      equal-step form). dt0 is the old level's step_dt. Euler on the
      first step (first store_old) of a field stored with two levels.
    - CrankNicolson ocCoeff (CrankNicolsonDdtScheme.C:713-795): diag
      coef rho V/dt, source (coef rho0 psi0/dt + ocCoeff ddt0) V with
      coef = 1 + ocCoeff after the first step (1 on it); the ddt0 state
      comes from cn_advance.

    A field stored with one level, or past its first store without
    old.old, raises under backward and CrankNicolson (_two_levels), as
    does a CrankNicolson field without its ddt0 state."""
    oc = cn_coeff(scheme)
    if oc is not None:
        scheme = "CrankNicolson"
    if scheme not in ("Euler", "steadyState", "backward", "CrankNicolson") \
            + LTS_SCHEMES:
        raise NotImplementedError(
            f"ddtScheme '{scheme}' is not ported yet (Euler, localEuler, "
            "CoEuler, SLTS, backward, CrankNicolson, steadyState)")
    c_dims = coeff.dims if coeff is not None else DimensionSet()
    m = FvMatrix.zeros(mesh, vf, c_dims * vf.dims * _VOL / _TIME,
                       symmetric=True)
    if scheme == "steadyState":
        return m
    if vf.old is None:
        raise ValueError(f"ddt({vf.name}): no old-time field stored")
    if coeff is not None and coeff.old is None:
        raise ValueError(f"ddt({coeff.name},{vf.name}): coefficient has no "
                         "old-time level")
    if scheme in ("backward", "CrankNicolson"):
        _two_levels(vf, scheme)
        if coeff is not None:
            _two_levels(coeff, scheme)
    first_step = vf.old.old is None or (
        coeff is not None and coeff.old.old is None)
    if scheme == "backward" and not first_step:
        rdt = 1.0 / dt
        dt0 = vf.old.step_dt if vf.old.step_dt is not None else dt
        coefft = 1.0 + dt / (dt + dt0)
        coefft00 = dt * dt / (dt0 * (dt + dt0))
        coefft0 = coefft + coefft00
        vrdt = mesh.V_asm * rdt
        if coeff is None:
            return m.replace(
                diag=coefft * vrdt,
                source=_ext(coefft0 * vrdt, vf.old.data) * vf.old.data
                - _ext(coefft00 * vrdt, vf.old.old.data) * vf.old.old.data)
        return m.replace(
            diag=coefft * vrdt * coeff.data,
            source=_ext(coefft0 * vrdt * coeff.old.data, vf.old.data)
            * vf.old.data
            - _ext(coefft00 * vrdt * coeff.old.old.data, vf.old.old.data)
            * vf.old.old.data)
    if scheme == "CrankNicolson":
        if vf.ddt0 is None:
            raise ValueError(
                f"ddt({vf.name}): ddtScheme 'CrankNicolson' needs the "
                "field's ddt0 state (fvm.cn_advance after store_old)")
        ddt0_d, _, steps = vf.ddt0
        rdt = (1.0 + oc if steps > 1 else 1.0) / dt
        rho0 = 1.0 if coeff is None else _ext(rdt * coeff.old.data,
                                                vf.old.data)
        src = _ext(mesh.V_asm, vf.old.data) * (
            (rdt if coeff is None else rho0) * vf.old.data + oc * ddt0_d)
        diag = mesh.V_asm * rdt if coeff is None \
            else mesh.V_asm * rdt * coeff.data
        return m.replace(diag=diag, source=src)
    # Euler, the local-Euler family, and backward's first step
    rdt = 1.0 / dt
    if coeff is None:
        diag = mesh.V_asm * rdt
        return m.replace(diag=diag,
                         source=_ext(diag, vf.old.data) * vf.old.data)
    diag = mesh.V_asm * rdt * coeff.data
    src = _ext(mesh.V_asm * rdt * coeff.old.data, vf.old.data) * vf.old.data
    return m.replace(diag=diag, source=src)


def _apply_jumps(mesh: MeshArrays, vf: VolField, m: FvMatrix, env):
    """Fold the jump BCs' offsets into the source (rapidcfd_tpu/ops/
    fvm.py:49-64; reference: jumpCyclicFvPatchField::
    updateInterfaceMatrix, the ghost shifted by the signed jump, pnf -=
    jf): coupled_mv adds -boundary_coeffs*ghost to M*x, so the constant
    part goes to the right-hand side as source -= boundary_coeffs*jump."""
    items = []
    for i, (patch, bc, bd) in enumerate(
            zip(mesh.patches, vf.bcs, vf.bcdata)):
        if not getattr(bc, "has_jump", False) or patch.size == 0:
            continue
        jf = bc.jump(mesh, patch, vf, bd, env)
        cc = m.boundary_coeffs[i]
        if cc.dim() > jf.dim():
            jf = jf[:, None]
        items.append((patch, -cc * jf))
    if not items:
        return m
    return m.replace(source=mesh.add_at_patches(m.source, items))


def div(mesh: MeshArrays, phi: SurfaceField, vf: VolField,
        scheme="linear", env=None) -> FvMatrix:
    """fvm::div(phi, psi) — Gauss convection (reference:
    gaussConvectionScheme: lower = -w*phi, upper = lower + phi,
    negSumDiag; boundary via the BC value-coefficient hooks). A
    ('bounded', inner) spec subtracts Sp(div(phi), psi) (reference:
    boundedConvectionScheme), which keeps transport bounded while the
    flux is not yet conservative."""
    if isinstance(scheme, tuple) and scheme and scheme[0] == "bounded":
        from . import fvc
        inner = div(mesh, phi, vf, scheme[1], env)
        div_phi = fvc.surface_sum_faces(mesh, phi.data) / mesh.V
        return inner - Sp(mesh, Dimensioned("div(phi)", phi.dims / _VOL,
                                            div_phi), vf)
    env = dict(env) if env else {}
    env.setdefault("phi", phi)
    w = scheme_weights(mesh, vf, scheme, phi)
    phi_i = phi.data[:mesh.n_internal]
    lower = -w * phi_i
    upper = lower + phi_i
    diag = _neg_sum_diag(mesh, lower, upper)

    m = FvMatrix.zeros(mesh, vf, phi.dims * vf.dims, symmetric=False)
    ics, bcs_ = [], []
    for i, (patch, bc, bd) in enumerate(
            zip(mesh.patches, vf.bcs, vf.bcdata)):
        if not bc.assembles or patch.size == 0:
            ics.append(m.internal_coeffs[i])
            bcs_.append(m.boundary_coeffs[i])
            continue
        phi_b = phi.data[patch.start:patch.start + patch.size]
        if bc.coupled:
            # an implicit interface, upwinded (rapidcfd_tpu/ops/fvm.py:
            # 259-275): the interior runs the requested scheme, the
            # coupled face takes the owner value on outflow and the ghost
            # on inflow; boundary_coeffs holds the ghost coefficient
            up = (phi_b >= 0.0).to(phi_b.dtype)
            shape = (patch.size,) + tuple(vf.data.shape[1:])
            if vf.data.dim() > 1:
                up, phi_b = up[:, None], phi_b[:, None]
            ics.append(torch.broadcast_to(phi_b * up, shape))
            bcs_.append(torch.broadcast_to(-phi_b * (1.0 - up), shape))
            continue
        vic, vbc = bc.value_coeffs(mesh, patch, vf, bd, env=env)
        phi_b = _ext(phi_b, vbc)
        ics.append(phi_b * vic * torch.ones_like(vbc))
        bcs_.append(-phi_b * vbc)
    m = m.replace(diag=diag, lower=lower, upper=upper,
                  internal_coeffs=tuple(ics), boundary_coeffs=tuple(bcs_))
    return _apply_jumps(mesh, vf, m, env)


def _gamma_faces(mesh, gamma):
    from .fvc import face_values
    if isinstance(gamma, VolField):
        return face_values(mesh, gamma), gamma.dims
    if isinstance(gamma, SurfaceField):
        return gamma.data, gamma.dims
    value, dims = (gamma.value, gamma.dims) if isinstance(gamma, Dimensioned) \
        else (gamma, dimless)
    value = torch.as_tensor(value, dtype=mesh.dtype, device=mesh.device)
    return torch.broadcast_to(value, (mesh.n_faces,)), dims


def laplacian(mesh: MeshArrays, gamma, vf: VolField,
              scheme: str = "orthogonal", env=None) -> FvMatrix:
    """fvm::laplacian(gamma, psi) (reference: gaussLaplacianScheme
    fvmLaplacianUncorrected: upper = deltaCoeffs*gamma_f*magSf,
    negSumDiag; boundary via the BC gradient-coefficient hooks).
    'corrected' and 'limited' take the non-orthogonal delta coefficients
    in the implicit part and add the explicit non-orthogonal face-flux
    correction gamma_f*|Sf|*(k . grad_f psi) to the source (rapidcfd_tpu/
    ops/fvm.py:302-365, which applies no limiter for 'limited')."""
    g_f, g_dims = _gamma_faces(mesh, gamma)
    n_int = mesh.n_internal
    corrected = scheme in ("corrected", "limited")
    dc = mesh.nonorth_delta_coeffs if corrected else mesh.delta_coeffs
    g_int = g_f[:n_int] * mesh.mag_sf[:n_int] * dc
    diag = _neg_sum_diag(mesh, g_int, g_int)

    m = FvMatrix.zeros(mesh, vf, g_dims * _AREA * vf.dims / dim_length,
                       symmetric=True)
    ics, bcs_ = [], []
    for i, (patch, bc, bd) in enumerate(
            zip(mesh.patches, vf.bcs, vf.bcdata)):
        if not bc.assembles or patch.size == 0:
            ics.append(m.internal_coeffs[i])
            bcs_.append(m.boundary_coeffs[i])
            continue
        gb = g_f[patch.start:patch.start + patch.size] \
            * mesh.patch_mag_sf(patch)
        if bc.coupled:
            # an implicit interface: snGrad = dc*(ghost - psi_c); the
            # ghost's coefficient goes to boundary_coeffs (= -gb*dc)
            gic = bc.gradient_internal_coeff(mesh, patch, vf, bd, env)
            gbx = _ext(gb, gic) * gic
            ics.append(gbx)
            bcs_.append(gbx)
            continue
        gic, gbc = bc.gradient_coeffs(mesh, patch, vf, bd, env)
        gb = _ext(gb, gbc)
        ics.append(gb * gic * torch.ones_like(gbc))
        bcs_.append(-gb * gbc)
    m = m.replace(diag=diag, lower=g_int, upper=g_int,
                  internal_coeffs=tuple(ics), boundary_coeffs=tuple(bcs_))
    if not corrected:
        return _apply_jumps(mesh, vf, m, env)

    # explicit non-orthogonal correction gamma_f*|Sf|*(k . grad_f psi);
    # it belongs to the operator, so it leaves the source. On gdia meshes
    # the face sum stays per slot (raw): the matrix folds its rows later.
    from . import fvc
    gf = fvc.face_values(mesh, fvc.grad(mesh, vf))[:n_int]
    if vf.data.dim() == 1:
        corr = (mesh.corr_vecs * gf).sum(-1)
    else:
        corr = (mesh.corr_vecs[:, :, None] * gf).sum(1)
    corr = _ext(g_f[:n_int] * mesh.mag_sf[:n_int], corr) * corr
    full = torch.cat([corr, corr.new_zeros((mesh.n_boundary,)
                                           + corr.shape[1:])])
    m = m.replace(
        source=m.source - fvc.surface_sum_faces(mesh, full, raw=True))
    return _apply_jumps(mesh, vf, m, env)


# ---------------------------------------------------------------------------
# sources
# ---------------------------------------------------------------------------

def _coeff(mesh: MeshArrays, x):
    """(cell data or constant as a tensor, dims) of a source coefficient:
    a VolField, a Dimensioned or a plain number."""
    if isinstance(x, VolField):
        return x.data, x.dims
    value, dims = (x.value, x.dims) if isinstance(x, Dimensioned) \
        else (x, dimless)
    return torch.as_tensor(value, dtype=mesh.dtype, device=mesh.device), dims


def Sp(mesh: MeshArrays, sp, vf: VolField) -> FvMatrix:
    """Implicit source fvm::Sp(sp, psi): E += sp*V*psi."""
    sp_data, sp_dims = _coeff(mesh, sp)
    m = FvMatrix.zeros(mesh, vf, sp_dims * vf.dims * _VOL, symmetric=True)
    return m.replace(diag=mesh.V_asm * sp_data)


def Su(mesh: MeshArrays, su, vf: VolField) -> FvMatrix:
    """Explicit source fvm::Su(su, psi): E += su*V."""
    su_data, su_dims = _coeff(mesh, su)
    m = FvMatrix.zeros(mesh, vf, su_dims * _VOL, symmetric=True)
    return m.replace(source=m.source - _ext(mesh.V_asm, m.source) * su_data)


def SuSp(mesh: MeshArrays, sp, vf: VolField) -> FvMatrix:
    """fvm::SuSp: implicit where it stabilises (sp > 0), explicit
    otherwise."""
    sp_data, sp_dims = _coeff(mesh, sp)
    m = FvMatrix.zeros(mesh, vf, sp_dims * vf.dims * _VOL, symmetric=True)
    diag = mesh.V_asm * torch.clamp(sp_data, min=0.0)
    src = -_ext(mesh.V_asm * torch.clamp(sp_data, max=0.0), vf.data) \
        * vf.data
    return m.replace(diag=diag, source=src)
