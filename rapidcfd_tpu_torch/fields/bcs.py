"""Boundary conditions as per-patch coefficient functions (port of
rapidcfd_tpu/fields/bcs.py:34-189 and make_bc).

Each BC type provides:

- ``evaluate``                -> boundary face values
- ``value_internal_coeff``    (vic):  faceVal = vic * psi_c + vbc
- ``gradient_internal_coeff`` (gic):  snGrad  = gic * psi_c + gbc

with vbc/gbc derived generically as ``evaluate - vic*psi_c`` and
``snGrad(evaluate) - gic*psi_c`` (the reference fvPatchField contract,
fvPatchField.H:80). Descriptors are frozen dataclasses; their tensor
parameters live in the field's ``bcdata``. Ported: calculated,
fixedValue, zeroGradient, empty, mixed, noSlip, symmetryPlane
(symmetry) and slip; the open-boundary set
of a pressure-driven flow (rapidcfd_tpu/fields/bcs.py:290-1157):
inletOutlet, totalPressure, uniformTotalPressure (p0 a constant, as in
the JAX package), pressureInletOutletVelocity, flowRateInletVelocity and
the turbulentIntensityKineticEnergyInlet, turbulentMixingLength-
DissipationRateInlet and turbulentMixingLengthFrequencyInlet estimators;
the wall functions of the RAS models: nutkWallFunction (nutWallFunction),
nutUSpaldingWallFunction (nutUWallFunction, nutLowReWallFunction),
kqRWallFunction, epsilonWallFunction, omegaWallFunction, and v2f's
v2WallFunction and fWallFunction (the JAX
package keeps those in models/turbulence.py, which re-exports them
here); and the heat-transfer set: fixedGradient, fixedFluxPressure with
its setSnGrad helpers, prghPressure and the Marshak condition of the P1
radiation model (kept in models/radiation.py by the JAX package); the
rotating frame's SRFVelocity; and, in fields/bcs_derived.py,
turbulentInlet. Other types raise in `make_bc`.

The open-boundary types read the flux, the velocity or k from `env`, as
the JAX call sites pass it; without it they fall back as the JAX package
does (zero flux, the stored value).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class BC:
    patch: int
    #: survives field arithmetic (else the result degrades to calculated)
    preserves_type = False
    #: participates in matrix assembly (empty does not)
    assembles = True
    #: boundary value is imposed, not derived from the interior
    #: (constrainHbyA uses it)
    fixes_value = False
    #: the BC carries no dimensional data of its field, so it survives
    #: with_calculated_bcs on derived fields
    value_free = False
    #: the BC pins the solution level (the reference's needReference)
    fixes_level = False
    #: an implicitly coupled interface (cyclicAMI): assembly puts the ghost
    #: coefficient in boundary_coeffs and the matrix product applies it to
    #: the partner's values (FvMatrix.coupled_mv; the reference's
    #: updateMatrixInterfaces)
    coupled = False
    #: dictionary word (written back by fields/io.py)
    word = ""

    def evaluate(self, mesh, patch, field, bd, env=None):
        raise NotImplementedError

    def value_internal_coeff(self, mesh, patch, field, bd, env=None):
        raise NotImplementedError

    def gradient_internal_coeff(self, mesh, patch, field, bd, env=None):
        raise NotImplementedError

    # -- generic derived coefficients ----------------------------------------
    def value_coeffs(self, mesh, patch, field, bd, env=None):
        vic = self.value_internal_coeff(mesh, patch, field, bd, env)
        psi_c = field.patch_internal(mesh, patch)
        vbc = self.evaluate(mesh, patch, field, bd, env) - vic * psi_c
        return vic, vbc

    def gradient_coeffs(self, mesh, patch, field, bd, env=None):
        gic = self.gradient_internal_coeff(mesh, patch, field, bd, env)
        psi_c = field.patch_internal(mesh, patch)
        dc = _bcast(mesh.patch_delta_coeffs(patch), psi_c)
        sngrad = (self.evaluate(mesh, patch, field, bd, env) - psi_c) * dc
        return gic, sngrad - gic * psi_c

    def snGrad(self, mesh, patch, field, bd, env=None):
        psi_c = field.patch_internal(mesh, patch)
        dc = _bcast(mesh.patch_delta_coeffs(patch), psi_c)
        return (self.evaluate(mesh, patch, field, bd, env) - psi_c) * dc


def _bcast(coef, like):
    """Broadcast a per-face scalar coefficient against a (n,...) field."""
    return coef.reshape(coef.shape + (1,) * (like.dim() - 1))


def _coeff(mesh, patch, field, value: float):
    """(size,) or (size, 1) constant coefficient, in the field's dtype."""
    shape = (patch.size, 1) if field.data.dim() > 1 else (patch.size,)
    return torch.full(shape, value, dtype=field.data.dtype,
                      device=field.data.device)


@dataclass(frozen=True)
class Calculated(BC):
    """Explicitly-stored values; cannot provide matrix coefficients."""
    value_free = True
    word = "calculated"

    def evaluate(self, mesh, patch, field, bd, env=None):
        return field.patch_values(mesh, patch)

    def value_internal_coeff(self, mesh, patch, field, bd, env=None):
        raise TypeError(
            f"patch '{patch.name}': calculated BC on field "
            f"'{field.name}' cannot provide matrix coefficients")

    gradient_internal_coeff = value_internal_coeff


@dataclass(frozen=True)
class FixedValue(BC):
    fixes_level = True
    preserves_type = True
    fixes_value = True
    word = "fixedValue"

    def evaluate(self, mesh, patch, field, bd, env=None):
        return torch.broadcast_to(bd["value"],
                                  field.patch_internal(mesh, patch).shape)

    def value_internal_coeff(self, mesh, patch, field, bd, env=None):
        return _coeff(mesh, patch, field, 0.0)

    def gradient_internal_coeff(self, mesh, patch, field, bd, env=None):
        gic = -mesh.patch_delta_coeffs(patch)
        return gic[:, None] if field.data.dim() > 1 else gic


@dataclass(frozen=True)
class ZeroGradient(BC):
    preserves_type = True
    value_free = True
    word = "zeroGradient"

    def evaluate(self, mesh, patch, field, bd, env=None):
        return field.patch_internal(mesh, patch)

    def value_internal_coeff(self, mesh, patch, field, bd, env=None):
        return _coeff(mesh, patch, field, 1.0)

    def gradient_internal_coeff(self, mesh, patch, field, bd, env=None):
        return _coeff(mesh, patch, field, 0.0)


@dataclass(frozen=True)
class Empty(BC):
    """2D constraint patch: contributes nothing to assembly. Evaluates to
    the patch-internal value (not zeros), which keeps pointwise field
    arithmetic (1/A, rAU*H) finite at empty faces."""
    preserves_type = True
    value_free = True
    assembles = False
    word = "empty"

    def evaluate(self, mesh, patch, field, bd, env=None):
        return field.patch_internal(mesh, patch)

    def value_internal_coeff(self, mesh, patch, field, bd, env=None):
        return torch.zeros(patch.size, dtype=field.data.dtype,
                           device=field.data.device)

    gradient_internal_coeff = value_internal_coeff


@dataclass(frozen=True)
class Mixed(BC):
    """f*refValue + (1-f)*(psi_c + refGradient/deltaCoeffs) (reference:
    basic/mixed)."""
    preserves_type = True
    word = "mixed"

    def _f(self, bd, psi_c):
        return torch.broadcast_to(bd["valueFraction"], psi_c.shape)

    def evaluate(self, mesh, patch, field, bd, env=None):
        psi_c = field.patch_internal(mesh, patch)
        dc = _bcast(mesh.patch_delta_coeffs(patch), psi_c)
        f = self._f(bd, psi_c)
        ref_v = torch.broadcast_to(bd["refValue"], psi_c.shape)
        ref_g = torch.broadcast_to(bd["refGradient"], psi_c.shape)
        return f * ref_v + (1.0 - f) * (psi_c + ref_g / dc)

    def value_internal_coeff(self, mesh, patch, field, bd, env=None):
        return 1.0 - self._f(bd, field.patch_internal(mesh, patch))

    def gradient_internal_coeff(self, mesh, patch, field, bd, env=None):
        psi_c = field.patch_internal(mesh, patch)
        dc = _bcast(mesh.patch_delta_coeffs(patch), psi_c)
        return -self._f(bd, psi_c) * dc


@dataclass(frozen=True)
class NoSlip(FixedValue):
    """U = 0 at a wall, with no stored value."""
    word = "noSlip"

    def evaluate(self, mesh, patch, field, bd, env=None):
        return torch.zeros_like(field.patch_internal(mesh, patch))


@dataclass(frozen=True)
class Symmetry(BC):
    """Mirror condition (reference: basicSymmetry): scalars zeroGradient,
    vectors projected onto the patch plane, with a per-component implicit
    coefficient 1 - n*n (a 3-vector per face)."""
    preserves_type = True
    fixes_value = True
    word = "symmetryPlane"

    def evaluate(self, mesh, patch, field, bd, env=None):
        psi_c = field.patch_internal(mesh, patch)
        if psi_c.dim() == 1:
            return psi_c
        n = mesh.patch_normals(patch)
        return psi_c - (psi_c * n).sum(-1, keepdim=True) * n

    def value_internal_coeff(self, mesh, patch, field, bd, env=None):
        if field.data.dim() == 1:
            return _coeff(mesh, patch, field, 1.0)
        n = mesh.patch_normals(patch)
        return 1.0 - n * n

    def gradient_internal_coeff(self, mesh, patch, field, bd, env=None):
        if field.data.dim() == 1:
            return _coeff(mesh, patch, field, 0.0)
        n = mesh.patch_normals(patch)
        return -(n * n) * mesh.patch_delta_coeffs(patch)[:, None]


@dataclass(frozen=True)
class Slip(Symmetry):
    """Inviscid wall (reference: derived/slip): the symmetry condition."""
    word = "slip"


@dataclass(frozen=True)
class CyclicAMI(BC):
    """Arbitrary-mesh-interface coupling (rapidcfd_tpu/fields/bcs.py:
    188-234; reference: cyclicAMIFvPatchField.H:54): the ghost value is
    the overlap-weighted sum of the partner's face-cell values
    (MeshArrays.ami_ghost), the face value interpolates owner and ghost
    with the distance weight, and the matrix couples implicitly."""
    preserves_type = True
    value_free = True
    coupled = True
    word = "cyclicAMI"

    def _t(self, mesh, patch):
        t = mesh.ami_table(patch)
        if t is None:
            raise ValueError(f"{self.word} patch '{patch.name}' has no AMI "
                             "table: is the partner patch missing?")
        return t

    def _ghost(self, mesh, patch, field, bd, env=None):
        return mesh.ami_ghost(patch, field.data)

    def evaluate(self, mesh, patch, field, bd, env=None):
        t = self._t(mesh, patch)
        psi_c = field.patch_internal(mesh, patch)
        w = _bcast(t.w_face, psi_c)
        return w * psi_c + (1.0 - w) * self._ghost(mesh, patch, field, bd,
                                                   env)

    def value_internal_coeff(self, mesh, patch, field, bd, env=None):
        w = self._t(mesh, patch).w_face
        if field.data.dim() > 1:
            return w[:, None] * torch.ones(field.data.shape[1:],
                                           dtype=w.dtype, device=w.device)
        return w

    def gradient_internal_coeff(self, mesh, patch, field, bd, env=None):
        gic = -self._t(mesh, patch).dc
        return gic[:, None] if field.data.dim() > 1 else gic

    def snGrad(self, mesh, patch, field, bd, env=None):
        t = self._t(mesh, patch)
        psi_c = field.patch_internal(mesh, patch)
        ghost = self._ghost(mesh, patch, field, bd, env)
        return _bcast(t.dc, psi_c) * (ghost - psi_c)


@dataclass(frozen=True)
class CyclicACMI(CyclicAMI):
    """A partially overlapping AMI (rapidcfd_tpu/fields/bcs.py:237-272;
    reference: cyclicACMIFvPatchField.H:56). The face areas were
    apportioned at mesh build (coupled faces mask*|Sf0|, the non-overlap
    twins (1-mask)*|Sf0|), the matrix couples through the raw weights
    (the coupled contribution only, cyclicACMIFvPatchField.C:217-244),
    and evaluated values take the uncovered remainder from the
    non-overlap patch's boundary values."""
    word = "cyclicACMI"

    def _ghost(self, mesh, patch, field, bd, env=None):
        no = mesh.patches[self._t(mesh, patch).non_overlap]
        return mesh.ami_ghost(
            patch, field.data,
            default=field.bvalues[no.bstart:no.bstart + no.size])


@dataclass(frozen=True)
class FixedGradient(BC):
    """psi_b = psi_c + gradient/deltaCoeffs (reference: basic/
    fixedGradient)."""
    preserves_type = True
    word = "fixedGradient"

    def _grad(self, bd, psi_c):
        return torch.broadcast_to(bd["gradient"], psi_c.shape)

    def evaluate(self, mesh, patch, field, bd, env=None):
        psi_c = field.patch_internal(mesh, patch)
        dc = _bcast(mesh.patch_delta_coeffs(patch), psi_c)
        return psi_c + self._grad(bd, psi_c) / dc

    def value_internal_coeff(self, mesh, patch, field, bd, env=None):
        return _coeff(mesh, patch, field, 1.0)

    def gradient_internal_coeff(self, mesh, patch, field, bd, env=None):
        return _coeff(mesh, patch, field, 0.0)


@dataclass(frozen=True)
class FixedFluxPressure(FixedGradient):
    """fixedFluxPressure (port of rapidcfd_tpu/fields/bcs.py:507-535;
    reference: derived/fixedFluxPressure/fixedFluxPressureFvPatchScalar-
    Field.C:115-140): a fixed gradient that the buoyant solvers set at
    every pressure corrector (set_fixed_flux_pressure_gradient, the
    reference's setSnGrad) so that the boundary pressure flux balances
    the body-force and HbyA fluxes:

        gradient = (phiHbyA_b - Sf_b & U_b) / (magSf_b * Dp_b)

    The gradient lives in the field's bcdata as `snGrad`, a tensor on the
    field's device; before the first setSnGrad it is the dictionary's
    `gradient` entry, or zero."""
    value_free = True
    word = "fixedFluxPressure"

    def _grad(self, bd, psi_c):
        g = bd.get("snGrad", bd.get("gradient"))
        if g is None:
            return torch.zeros_like(psi_c)
        return torch.broadcast_to(g, psi_c.shape)


def fixed_flux_pressure_mask(mesh, field) -> torch.Tensor:
    """(nBoundaryFaces,) 1.0 on the faces of fixedFluxPressure patches
    (rapidcfd_tpu/fields/bcs.py:537-548): the buoyant solvers keep the
    body-force boundary flux only where the BC balances it."""
    m = torch.zeros(mesh.n_boundary, dtype=field.data.dtype,
                    device=field.data.device)
    for patch, bc in zip(mesh.patches, field.bcs):
        if isinstance(bc, FixedFluxPressure) and patch.size:
            m[patch.bstart:patch.bstart + patch.size] = 1.0
    return m


def set_fixed_flux_pressure_gradient(mesh, field, sngrad_b):
    """setSnGrad<fixedFluxPressure> (rapidcfd_tpu/fields/bcs.py:550-570):
    store the solver's boundary snGrad ((nBoundaryFaces,), bstart order)
    in every fixedFluxPressure patch's bcdata and re-evaluate the
    boundary values. The field itself when it has no such patch."""
    new_bd = []
    changed = False
    for patch, bc, bd in zip(mesh.patches, field.bcs, field.bcdata):
        if isinstance(bc, FixedFluxPressure) and patch.size:
            d = dict(bd)
            d["snGrad"] = sngrad_b[patch.bstart:patch.bstart + patch.size]
            new_bd.append(d)
            changed = True
        else:
            new_bd.append(bd)
    if not changed:
        return field
    return field.replace(bcdata=tuple(new_bd)) \
        .correct_boundary_conditions(mesh)


@dataclass(frozen=True)
class PrghPressure(FixedValue):
    """p_rgh = p - rho gh at the patch (port of rapidcfd_tpu/fields/
    bcs.py:1160-1175; reference: derived/prghPressure). env carries
    'rho' (a VolField) and 'gh_b' (gh at the boundary faces, bstart
    order); without them the patch holds p, as fixedValue."""
    word = "prghPressure"

    def evaluate(self, mesh, patch, field, bd, env=None):
        p = torch.broadcast_to(bd.get("p", bd.get("value")), (patch.size,))
        if env is None or "rho" not in env or "gh_b" not in env:
            return p
        sl = slice(patch.bstart, patch.bstart + patch.size)
        return p - env["rho"].bvalues[sl] * env["gh_b"][sl]


#: Stefan-Boltzmann constant [W/m2/K4] (the reference's physicoChemical)
SIGMA_SB = 5.670373e-8


@dataclass(frozen=True)
class MarshakRadiation(Mixed):
    """Marshak condition for the incident radiation G (port of
    rapidcfd_tpu/models/radiation.py:35-86; reference: radiationModels/
    derivedFvPatchFields/MarshakRadiation): -gamma dG/dn = e/(2(2 - e))
    (G - 4 sigma Tw^4) as a mixed condition with valueFraction
    alpha/(alpha + gamma deltaCoeffs). P1Radiation.correct stores the
    current wall data in bcdata (marshakRefValue, marshakFraction);
    before that the wall temperature comes from env 'T' and gamma from
    env 'gammaRad' (zero and 1 without them)."""
    word = "MarshakRadiation"

    def _mixed_bd(self, mesh, patch, bd, env, psi_c):
        if "marshakRefValue" in bd:
            return dict(refValue=bd["marshakRefValue"],
                        refGradient=torch.zeros_like(psi_c),
                        valueFraction=bd["marshakFraction"]
                        * torch.ones_like(psi_c))
        e = torch.clamp(bd["emissivity"], 1e-3, 1.0) \
            if "emissivity" in bd else torch.ones_like(psi_c)
        t_env = (env or {}).get("T")
        if t_env is not None:
            tw = t_env.bvalues[patch.bstart:patch.bstart + patch.size]
        else:
            tw = torch.zeros_like(psi_c)
        gamma = (env or {}).get("gammaRad", 1.0)
        alpha = e / (2.0 * (2.0 - e))
        f = alpha / (alpha + gamma * mesh.patch_delta_coeffs(patch))
        return dict(refValue=4.0 * SIGMA_SB * tw ** 4,
                    refGradient=torch.zeros_like(psi_c),
                    valueFraction=f * torch.ones_like(psi_c))

    def evaluate(self, mesh, patch, field, bd, env=None):
        psi_c = field.patch_internal(mesh, patch)
        return Mixed.evaluate(self, mesh, patch, field,
                              self._mixed_bd(mesh, patch, bd, env, psi_c))

    def value_internal_coeff(self, mesh, patch, field, bd, env=None):
        psi_c = field.patch_internal(mesh, patch)
        return Mixed.value_internal_coeff(
            self, mesh, patch, field,
            self._mixed_bd(mesh, patch, bd, env, psi_c))

    def gradient_internal_coeff(self, mesh, patch, field, bd, env=None):
        psi_c = field.patch_internal(mesh, patch)
        return Mixed.gradient_internal_coeff(
            self, mesh, patch, field,
            self._mixed_bd(mesh, patch, bd, env, psi_c))


def _patch_phi(mesh, patch, field, env):
    """The face flux on a patch from env, or zeros before there is one
    (the flux switches then take their zero-gradient branch, as the
    reference keeps the stored values until the first updateCoeffs)."""
    if env is None or "phi" not in env:
        return torch.zeros(patch.size, dtype=field.data.dtype,
                           device=field.data.device)
    phi = env["phi"]
    data = phi.data if hasattr(phi, "data") else phi
    return data[patch.start:patch.start + patch.size]


def _inflow_fraction(mesh, patch, field, env, psi_c):
    """valueFraction 1 on inflow faces (phi < 0), 0 on outflow."""
    f = (_patch_phi(mesh, patch, field, env) < 0.0).to(psi_c.dtype)
    return _bcast(f, psi_c) * torch.ones_like(psi_c)


@dataclass(frozen=True)
class InletOutlet(Mixed):
    """zeroGradient on outflow, inletValue on inflow, switched by the
    face flux (reference: derived/inletOutlet). env carries 'phi'."""
    word = "inletOutlet"

    def _inflow_value(self, mesh, patch, field, bd, env, psi_c):
        return bd["inletValue"]

    def _mixed_bd(self, mesh, patch, field, bd, env):
        psi_c = field.patch_internal(mesh, patch)
        ref = self._inflow_value(mesh, patch, field, bd, env, psi_c)
        return dict(refValue=torch.broadcast_to(ref, psi_c.shape),
                    refGradient=torch.zeros_like(psi_c),
                    valueFraction=_inflow_fraction(mesh, patch, field, env,
                                                   psi_c))

    def evaluate(self, mesh, patch, field, bd, env=None):
        return Mixed.evaluate(self, mesh, patch, field,
                              self._mixed_bd(mesh, patch, field, bd, env))

    def value_internal_coeff(self, mesh, patch, field, bd, env=None):
        return Mixed.value_internal_coeff(
            self, mesh, patch, field,
            self._mixed_bd(mesh, patch, field, bd, env))

    def gradient_internal_coeff(self, mesh, patch, field, bd, env=None):
        return Mixed.gradient_internal_coeff(
            self, mesh, patch, field,
            self._mixed_bd(mesh, patch, field, bd, env))


def _stored_value(bd, psi_c):
    """The patch's stored `value` (1e-8 without one): the inflow value
    of the turbulence inlet estimators when env lacks U or k."""
    v = bd.get("value")
    if v is None:
        return torch.full_like(psi_c, 1e-8)
    return torch.broadcast_to(v, psi_c.shape)


@dataclass(frozen=True)
class TurbulentIntensityKineticEnergyInlet(InletOutlet):
    """k = 1.5 (I |U|)^2 on inflow, zeroGradient on outflow (reference:
    derived/turbulentIntensityKineticEnergyInlet). env: 'U', 'phi'."""
    word = "turbulentIntensityKineticEnergyInlet"

    def _inflow_value(self, mesh, patch, field, bd, env, psi_c):
        if env is None or "U" not in env:
            return _stored_value(bd, psi_c)
        intensity = bd.get("intensity", 0.05)
        u_b = env["U"].bvalues[patch.bstart:patch.bstart + patch.size]
        return 1.5 * intensity ** 2 * (u_b * u_b).sum(-1)


def _mixing_length(bd):
    length = bd.get("mixingLength", 0.01)
    if isinstance(length, torch.Tensor):
        return torch.clamp(length, min=1e-30)
    return max(float(length), 1e-30)


@dataclass(frozen=True)
class TurbulentMixingLengthDissipationRateInlet(InletOutlet):
    """epsilon = Cmu^0.75 k^1.5 / L on inflow (reference:
    derived/turbulentMixingLengthDissipationRateInlet). env: 'k', 'phi'."""
    word = "turbulentMixingLengthDissipationRateInlet"

    def _inflow_value(self, mesh, patch, field, bd, env, psi_c):
        if env is None or "k" not in env:
            return _stored_value(bd, psi_c)
        k_b = torch.clamp(
            env["k"].bvalues[patch.bstart:patch.bstart + patch.size],
            min=0.0)
        return 0.09 ** 0.75 * k_b ** 1.5 / _mixing_length(bd)


@dataclass(frozen=True)
class TurbulentMixingLengthFrequencyInlet(InletOutlet):
    """omega = k^0.5 / (Cmu^0.25 L) on inflow (reference:
    derived/turbulentMixingLengthFrequencyInlet). env: 'k', 'phi'."""
    word = "turbulentMixingLengthFrequencyInlet"

    def _inflow_value(self, mesh, patch, field, bd, env, psi_c):
        if env is None or "k" not in env:
            return _stored_value(bd, psi_c)
        k_b = torch.clamp(
            env["k"].bvalues[patch.bstart:patch.bstart + patch.size],
            min=0.0)
        return torch.sqrt(k_b) / (0.09 ** 0.25 * _mixing_length(bd))


@dataclass(frozen=True)
class TotalPressure(BC):
    """p = p0 - 0.5|U|^2 on inflow, p0 on outflow (incompressible form;
    reference: derived/totalPressure). env carries 'U' and 'phi'; without
    them the patch holds p0."""
    preserves_type = True
    fixes_level = True
    word = "totalPressure"

    def _p0(self, mesh, patch, field, bd, env=None):
        """The total pressure (fanPressure offsets it by its fan curve)."""
        return bd["p0"]

    def evaluate(self, mesh, patch, field, bd, env=None):
        p0 = torch.broadcast_to(self._p0(mesh, patch, field, bd, env),
                                (patch.size,))
        if env is None or "U" not in env or "phi" not in env:
            return p0
        u_b = env["U"].bvalues[patch.bstart:patch.bstart + patch.size]
        phi_b = _patch_phi(mesh, patch, field, env)
        return torch.where(phi_b >= 0.0, p0, p0 - 0.5 * (u_b * u_b).sum(-1))

    def value_internal_coeff(self, mesh, patch, field, bd, env=None):
        return _coeff(mesh, patch, field, 0.0)

    def gradient_internal_coeff(self, mesh, patch, field, bd, env=None):
        return -mesh.patch_delta_coeffs(patch)


@dataclass(frozen=True)
class UniformTotalPressure(TotalPressure):
    """totalPressure with a uniform p0, taken as a constant (reference:
    derived/uniformTotalPressure; a tabulated p0 is not ported, as in the
    JAX package)."""
    word = "uniformTotalPressure"


@dataclass(frozen=True)
class PressureInletOutletVelocity(BC):
    """U on pressure boundaries: zeroGradient on outflow; on inflow the
    velocity normal to the face carries the flux (reference:
    derived/pressureInletOutletVelocity). env carries 'phi'."""
    preserves_type = True
    word = "pressureInletOutletVelocity"

    def evaluate(self, mesh, patch, field, bd, env=None):
        psi_c = field.patch_internal(mesh, patch)
        if env is None or "phi" not in env:
            return psi_c
        phi_b = _patch_phi(mesh, patch, field, env)
        u_in = mesh.patch_normals(patch) * (phi_b / torch.clamp(
            mesh.patch_mag_sf(patch), min=1e-30))[:, None]
        return torch.where((phi_b >= 0.0)[:, None], psi_c, u_in)

    def value_internal_coeff(self, mesh, patch, field, bd, env=None):
        if env is None or "phi" not in env:
            return _coeff(mesh, patch, field, 1.0)
        phi_b = _patch_phi(mesh, patch, field, env)
        return (phi_b >= 0.0).to(field.data.dtype)[:, None]

    def gradient_internal_coeff(self, mesh, patch, field, bd, env=None):
        vic = self.value_internal_coeff(mesh, patch, field, bd, env)
        return (vic - 1.0) * mesh.patch_delta_coeffs(patch)[:, None]


@dataclass(frozen=True)
class FlowRateInletVelocity(BC):
    """Inlet velocity from a constant volumetric flow rate, uniform over
    the patch and against its normals (reference:
    derived/flowRateInletVelocity)."""
    preserves_type = True
    fixes_value = True
    word = "flowRateInletVelocity"

    def evaluate(self, mesh, patch, field, bd, env=None):
        q = bd["volumetricFlowRate"].reshape(-1)[0]
        area = torch.clamp(mesh.patch_mag_sf(patch).sum(), min=1e-30)
        return -mesh.patch_normals(patch) * (q / area)

    def value_internal_coeff(self, mesh, patch, field, bd, env=None):
        return _coeff(mesh, patch, field, 0.0)

    def gradient_internal_coeff(self, mesh, patch, field, bd, env=None):
        return -mesh.patch_delta_coeffs(patch)[:, None]


@dataclass(frozen=True)
class SRFVelocity(FixedValue):
    """Velocity in the single rotating frame (port of rapidcfd_tpu/fields/
    bcs.py:647-664; reference: cfdTools/general/SRF/derivedFvPatchFields/
    SRFVelocityFvPatchVectorField): Urel = inletValue under `relative
    yes`, else inletValue minus the frame velocity at the faces. The frame
    velocity is static per mesh: the SRF solvers put it in
    bd['srfValue'] at start-up (models/srf.SRFModel.patch_bcs)."""
    word = "SRFVelocity"

    def evaluate(self, mesh, patch, field, bd, env=None):
        shape = field.patch_internal(mesh, patch).shape
        val = torch.broadcast_to(bd["inletValue"], shape)
        srf_v = bd.get("srfValue")
        if srf_v is None:
            return val
        rel = bd.get("relative", 0.0)
        return val - (1.0 - rel) * srf_v


# ---------------------------------------------------------------------------
# wall functions (port of rapidcfd_tpu/models/turbulence.py:30-99)
# ---------------------------------------------------------------------------

_KAPPA = 0.41
_E = 9.8
_CMU = 0.09
_CMU25 = _CMU ** 0.25
_CMU75 = _CMU ** 0.75


def _y_plus_lam(kappa=_KAPPA, e=_E, n=10):
    """Fixed point of ypl = ln(E*ypl)/kappa, the log-law/laminar
    crossover (reference: nutWallFunction::yPlusLam)."""
    ypl = 11.0
    for _ in range(n):
        ypl = math.log(max(e * ypl, 1.0 + 1e-6)) / kappa
    return ypl


_YPLUS_LAM = _y_plus_lam()


@dataclass(frozen=True)
class NutkWallFunction(BC):
    """Turbulent viscosity at the wall from the log law in k (reference:
    nutkWallFunctionFvPatchScalarField). Evaluated with env = {"k": k,
    "nu": nu}; without k (field IO) it keeps its current values."""
    preserves_type = True
    value_free = True
    word = "nutkWallFunction"

    def evaluate(self, mesh, patch, field, bd, env=None):
        from .field import Dimensioned, VolField
        if env is None or "k" not in env:
            return field.patch_values(mesh, patch)
        nu = env["nu"]
        cells = mesh.patch_face_cells(patch)
        k_c = env["k"].data[cells]
        y = 1.0 / mesh.patch_delta_coeffs(patch)
        if isinstance(nu, VolField):
            nuw = nu.data[cells]
        else:
            nuw = nu.value if isinstance(nu, Dimensioned) else nu
        y_plus = _CMU25 * torch.sqrt(torch.clamp(k_c, min=0.0)) * y / nuw
        nutw = nuw * (y_plus * _KAPPA
                      / torch.log(torch.clamp(_E * y_plus, min=1.0 + 1e-6))
                      - 1.0)
        return torch.where(y_plus > _YPLUS_LAM, torch.clamp(nutw, min=0.0),
                           torch.zeros_like(nutw))

    def value_internal_coeff(self, mesh, patch, field, bd, env=None):
        return _coeff(mesh, patch, field, 0.0)

    def gradient_internal_coeff(self, mesh, patch, field, bd, env=None):
        return -mesh.patch_delta_coeffs(patch)


@dataclass(frozen=True)
class KqRWallFunction(ZeroGradient):
    """k at a wall: zeroGradient (reference: kqRWallFunction)."""
    word = "kqRWallFunction"


@dataclass(frozen=True)
class EpsilonWallFunction(ZeroGradient):
    """epsilon at a wall: the patch value follows the wall cell; the
    wall cells' epsilon and production are imposed by the model
    (models/turbulence.py KEpsilon._wall_fix, the reference's
    epsilonWallFunction with its matrix manipulation)."""
    word = "epsilonWallFunction"


@dataclass(frozen=True)
class OmegaWallFunction(ZeroGradient):
    """omega at a wall (rapidcfd_tpu/models/turbulence.py:104-107): the
    patch value follows the wall cell; the wall cells' omega and
    production are imposed by the model (models/turbulence.py
    KOmegaSST._wall_fix)."""
    word = "omegaWallFunction"


@dataclass(frozen=True)
class NutUSpaldingWallFunction(NutkWallFunction):
    """The velocity-based nut wall functions nutUSpaldingWallFunction,
    nutUWallFunction and nutLowReWallFunction: the k-based log law, as
    the JAX package takes them (rapidcfd_tpu/models/turbulence.py:108-113;
    the reference fits Spalding's law in U)."""
    word = "nutUSpaldingWallFunction"


@dataclass(frozen=True)
class V2WallFunction(FixedValue):
    """v2 at a wall: a fixed (small) value (rapidcfd_tpu/models/
    turbulence.py:1047-1051; reference: v2f/v2WallFunction)."""
    word = "v2WallFunction"


@dataclass(frozen=True)
class FWallFunction(FixedValue):
    """f at a wall: a fixed value (rapidcfd_tpu/models/turbulence.py:
    1054-1058; reference: v2f/fWallFunction)."""
    word = "fWallFunction"


BC_TYPES = {cls.word: cls for cls in (
    Calculated, FixedValue, ZeroGradient, Empty, Mixed, NoSlip, Symmetry,
    Slip, InletOutlet,
    TurbulentIntensityKineticEnergyInlet,
    TurbulentMixingLengthDissipationRateInlet,
    TurbulentMixingLengthFrequencyInlet, TotalPressure, UniformTotalPressure,
    PressureInletOutletVelocity, FlowRateInletVelocity, SRFVelocity,
    NutkWallFunction,
    KqRWallFunction, EpsilonWallFunction, OmegaWallFunction, FixedGradient,
    FixedFluxPressure, PrghPressure, MarshakRadiation,
    NutUSpaldingWallFunction, V2WallFunction, FWallFunction, CyclicAMI,
    CyclicACMI)}
BC_TYPES["nutWallFunction"] = NutkWallFunction
BC_TYPES["nutUWallFunction"] = NutUSpaldingWallFunction
BC_TYPES["nutLowReWallFunction"] = NutUSpaldingWallFunction
#: the reference's other names of the Marshak condition
BC_TYPES["MarshakRadiationFixedTemperature"] = MarshakRadiation
BC_TYPES["greyDiffusiveRadiation"] = MarshakRadiation
#: the reference's plain `symmetry` patch field: the same condition (it
#: is written back as symmetryPlane)
BC_TYPES["symmetry"] = Symmetry
#: a `cyclic` entry on a patch that exists on the device is a cyclic pair
#: kept coupled (its partner carries a jump BC): the conformal AMI
BC_TYPES["cyclic"] = CyclicAMI


def make_bc(type_word: str, patch_idx: int, pd=None) -> BC:
    """Construct a BC from its dictionary word: the types above, then
    those registered in utils/registry.py's fvPatchField table
    (fields/bcs_derived.py's turbulentInlet, potentialFreeSurfaceFoam's
    waveSurfacePressure); any other word raises."""
    from ..utils.registry import lookup, registered_names
    from . import bcs_coupled, bcs_derived  # noqa: F401  (register types)
    cls = BC_TYPES.get(type_word)
    if cls is None and type_word in registered_names("fvPatchField"):
        cls = lookup("fvPatchField", type_word)
    if cls is None:
        raise NotImplementedError(
            f"boundary condition '{type_word}' is not ported yet (ported: "
            f"{', '.join(sorted(BC_TYPES))})")
    if hasattr(cls, "from_dict"):
        return cls.from_dict(patch_idx, pd)
    return cls(patch_idx)
