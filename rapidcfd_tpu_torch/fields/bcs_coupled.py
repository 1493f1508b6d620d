"""Jump-cyclic coupled BCs (fixedJump, uniformJump, fan and their AMI
forms) and fanPressure — a port of rapidcfd_tpu/fields/bcs_coupled.py.

Reference: src/finiteVolume/fields/fvPatchFields/constraint/jumpCyclic/
jumpCyclicFvPatchField.C:196-240 (the ghost value seen from a side is
the partner value minus the signed jump: +jump on the owner side, -jump
on the other) and derived/{fan,fixedJump,fixedJumpAMI,uniformJump,
uniformJumpAMI,fanPressure}.

A cyclic pair that carries a jump is not merged: Case scans the start
time's fields and build_mesh_arrays keeps the pair as a conformal
cyclicAMI (mesh/mesharrays.keep_cyclic_pairs). The coupling is the AMI's
implicit one; the jump is a constant of each solve, which assembly moves
into the source (ops/fvm._apply_jumps), the split the reference makes in
updateInterfaceMatrix.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils.registry import register
from .bcs import CyclicAMI, TotalPressure


def _interp_table(times, values, t):
    """Piecewise-linear interpolation in a table, clamped at its ends
    (rapidcfd_tpu/fields/bcs.py:1329-1337)."""
    t = torch.clamp(torch.as_tensor(t, dtype=times.dtype,
                                    device=times.device), times[0],
                    times[-1])
    i = torch.clamp(torch.searchsorted(times, t, right=True) - 1, 0,
                    times.shape[0] - 2)
    t0, t1 = times[i], times[i + 1]
    f = torch.where(t1 > t0, (t - t0) / torch.clamp(t1 - t0, min=1e-30),
                    torch.zeros_like(t))
    v0, v1 = values[i], values[i + 1]
    return v0 + f * (v1 - v0)


def _poly_eval(coeffs, x):
    """A polynomial DataEntry ((c0 e0)(c1 e1)...): sum c_i * x**e_i."""
    y = 0.0
    for ce in coeffs:
        y = y + ce[0] * torch.pow(torch.as_tensor(x, dtype=coeffs.dtype,
                                                  device=coeffs.device),
                                  ce[1])
    return y


def _volumetric_phi(patch, env):
    """The patch's face flux from env['phi'], divided by the boundary rho
    when phi is a mass flux."""
    phi = env["phi"]
    phi_b = (phi.data if hasattr(phi, "data") else phi)[
        patch.start:patch.start + patch.size]
    if hasattr(phi, "dims") and phi.dims.as_tuple()[0] == 1:
        rho = env.get("rho")
        if rho is not None and hasattr(rho, "bvalues"):
            phi_b = phi_b / torch.clamp(
                rho.bvalues[patch.bstart:patch.bstart + patch.size],
                min=1e-30)
    return phi_b


class _JumpCyclic(CyclicAMI):
    """Base of the jump BCs on kept cyclic and cyclicAMI pairs: a
    subclass gives jump_magnitude (the owner side's jump, per face or a
    scalar); the signed jump and the shifted ghost are handled here."""
    has_jump = True

    def _pair_bd(self, mesh, patch, field, bd, key):
        """bd[key], else the partner patch's (the reference reads the
        jump from the owner side's dictionary)."""
        if key in bd:
            return bd[key]
        t = self._t(mesh, patch)
        if 0 <= t.partner < len(field.bcdata):
            return field.bcdata[t.partner].get(key)
        return None

    def jump_magnitude(self, mesh, patch, field, bd, env=None):
        raise NotImplementedError

    def jump(self, mesh, patch, field, bd, env=None):
        """The signed per-face jump jf: the effective ghost is
        ghost - jf."""
        t = self._t(mesh, patch)
        psi_c = field.patch_internal(mesh, patch)
        jf = torch.broadcast_to(
            torch.as_tensor(self.jump_magnitude(mesh, patch, field, bd, env),
                            dtype=psi_c.dtype, device=psi_c.device),
            psi_c.shape)
        return jf if t.owner else -jf

    def _ghost(self, mesh, patch, field, bd, env=None):
        return mesh.ami_ghost(patch, field.data) \
            - self.jump(mesh, patch, field, bd, env)


@dataclass(frozen=True)
class FixedJump(_JumpCyclic):
    """The jump read from the dictionary (`jump uniform 10;`), an offset
    on the owner side (reference: derived/fixedJump)."""
    word = "fixedJump"

    def jump_magnitude(self, mesh, patch, field, bd, env=None):
        j = self._pair_bd(mesh, patch, field, bd, "jump")
        return 0.0 if j is None else j


@dataclass(frozen=True)
class FixedJumpAMI(FixedJump):
    word = "fixedJumpAMI"


@dataclass(frozen=True)
class UniformJump(_JumpCyclic):
    """jump = jumpTable, a Function1 of time, uniform over the patch
    (reference: derived/uniformJump): bd jump_times/jump_values (a
    table), jump_poly or jump_const; env 't' (0 where absent, as in the
    JAX package)."""
    word = "uniformJump"

    def _curve(self, mesh, patch, field, bd, x):
        jt = self._pair_bd(mesh, patch, field, bd, "jump_times")
        if jt is not None:
            return _interp_table(jt, self._pair_bd(mesh, patch, field, bd,
                                                   "jump_values"), x)
        jp = self._pair_bd(mesh, patch, field, bd, "jump_poly")
        if jp is not None:
            return _poly_eval(jp, x)
        return self._pair_bd(mesh, patch, field, bd, "jump_const")

    def jump_magnitude(self, mesh, patch, field, bd, env=None):
        j = self._curve(mesh, patch, field, bd, (env or {}).get("t", 0.0))
        return 0.0 if j is None else j


@dataclass(frozen=True)
class UniformJumpAMI(UniformJump):
    word = "uniformJumpAMI"


@dataclass(frozen=True)
class Fan(UniformJump):
    """A fan curve: on the pressure, the jump is max(jumpTable(Un), 0)
    with Un = max(phi/magSf, 0), the face-normal velocity (a mass flux
    divided by rho); on other fields jumpTable(t), the reference's generic
    template (derived/fan/fanFvPatchFields.C:47-64)."""
    word = "fan"

    def jump_magnitude(self, mesh, patch, field, bd, env=None):
        env = env or {}
        if field.data.dim() > 1 or env.get("phi") is None:
            return super().jump_magnitude(mesh, patch, field, bd, env)
        un = torch.clamp(_volumetric_phi(patch, env)
                         / mesh.patch_mag_sf(patch), min=0.0)
        j = self._curve(mesh, patch, field, bd, un)
        if j is None:
            return torch.zeros_like(un)
        return torch.clamp(torch.broadcast_to(j, un.shape), min=0.0)


@dataclass(frozen=True)
class FanPressure(TotalPressure):
    """Total pressure offset by a fan curve at the patch's volumetric
    flow rate: p0_eff = p0 - dir*fanCurve(max(dir*sum(phi), 0)), dir = +1
    for 'out', -1 for 'in' (reference: derived/fanPressure/
    fanPressureFvPatchScalarField.C:128-165). bd jump_times/jump_values
    hold the curve (a fileName table is read by fields/io.py)."""
    direction: int = 1
    word = "fanPressure"

    @classmethod
    def from_dict(cls, patch_idx, pd):
        return cls(patch_idx, -1 if pd is not None
                   and pd.word("direction", "out") == "in" else 1)

    def _p0(self, mesh, patch, field, bd, env=None):
        p0 = bd.get("p0", bd.get("value", 0.0))
        jt = bd.get("jump_times")
        if jt is None or (env or {}).get("phi") is None:
            return p0
        vdot = torch.clamp(self.direction
                           * _volumetric_phi(patch, env).sum(), min=0.0)
        return p0 - self.direction * _interp_table(jt, bd["jump_values"],
                                                   vdot)


for _cls in (FixedJump, FixedJumpAMI, UniformJump, UniformJumpAMI, Fan,
             FanPressure):
    register("fvPatchField", _cls.word)(_cls)
