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
fixedValue, zeroGradient, empty, and kEpsilon's wall functions
nutkWallFunction, kqRWallFunction and epsilonWallFunction (the JAX
package keeps those in models/turbulence.py, which re-exports them here);
other types raise in `make_bc`.
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


BC_TYPES = {cls.word: cls for cls in (Calculated, FixedValue, ZeroGradient,
                                      Empty, NutkWallFunction,
                                      KqRWallFunction, EpsilonWallFunction)}


def make_bc(type_word: str, patch_idx: int, pd=None) -> BC:
    """Construct a BC from its dictionary word (the types this slice
    ports; any other word raises)."""
    cls = BC_TYPES.get(type_word)
    if cls is None:
        raise NotImplementedError(
            f"boundary condition '{type_word}' is not ported yet (ported: "
            f"{', '.join(sorted(BC_TYPES))})")
    return cls(patch_idx)
