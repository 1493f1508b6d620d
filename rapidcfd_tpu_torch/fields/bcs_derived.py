"""Derived boundary conditions (port of rapidcfd_tpu/fields/
bcs_derived.py): turbulentInlet. The file's other types are not ported
(ROADMAP Queue 1 item 11); `make_bc` raises on them."""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from ..utils.registry import register
from ..utils.timecontrol import current_time_index
from .bcs import FixedValue


@register("fvPatchField", "turbulentInlet")
@dataclass(frozen=True)
class TurbulentInlet(FixedValue):
    """Fluctuating inlet (port of rapidcfd_tpu/fields/bcs_derived.py:
    134-159; reference: derived/turbulentInlet/turbulentInletFvPatchField.C
    updateCoeffs): value = (1 - alpha) prev + alpha (ref + rmsCorr (rand -
    0.5) fluctuationScale |ref|), rmsCorr = sqrt(12 (2 alpha - alpha^2))/
    alpha, prev the stored patch values, ref referenceField (else value).

    The inlet draws and relaxes once per time index, as the reference's
    curTimeIndex_ guard does: the first evaluation of a time step
    (utils/timecontrol.current_time_index) makes the new value, later ones
    in the same step return it, so the correlation time does not depend on
    how often a solver evaluates U's boundary. rand is drawn from a
    torch.Generator on the field's device, seeded with 0, so the inlet
    fluctuates from step to step (the JAX package folds t = 0 into one
    key at every call in pimpleFoam and pisoFoam, draws the same numbers
    each step and relaxes at every evaluation: ROADMAP Queue 3). `draw`,
    a (patch size, ...) tensor in [0, 1), takes the generator's place: a
    test hands it the JAX package's numbers."""
    word = "turbulentInlet"
    draw: torch.Tensor | None = field(default=None, compare=False)
    #: per device: [generator, time index of the last update, its value]
    _state: dict = field(default_factory=dict, compare=False, repr=False)

    def _rand(self, like: torch.Tensor, gen) -> torch.Tensor:
        if self.draw is not None:
            return self.draw.to(device=like.device, dtype=like.dtype)
        return torch.rand(like.shape, generator=gen, dtype=like.dtype,
                          device=like.device)

    def evaluate(self, mesh, patch, field, bd, env=None):
        prev = field.patch_values(mesh, patch)
        st = self._state.get(prev.device)
        if st is None:
            st = self._state[prev.device] = [
                torch.Generator(device=prev.device).manual_seed(0), None,
                None]
        index = current_time_index()
        if st[1] != index:
            st[1], st[2] = index, self.relax(prev, bd,
                                             self._rand(prev, st[0]))
        return st[2]

    def relax(self, prev, bd, rand):
        """The updateCoeffs formula: prev relaxed toward ref + the
        fluctuation of the uniform draw rand."""
        ref = torch.broadcast_to(bd.get("referenceField", bd.get("value")),
                                 prev.shape)
        alpha = float(bd["alpha"]) if "alpha" in bd else 0.1
        scale = torch.broadcast_to(
            bd.get("fluctuationScale",
                   torch.tensor(0.02, dtype=prev.dtype, device=prev.device)),
            prev.shape)
        rms_corr = math.sqrt(12.0 * (2.0 * alpha - alpha * alpha)) / alpha
        mag_ref = ref.norm(dim=-1, keepdim=True) if prev.dim() > 1 \
            else ref.abs()
        fluct = rms_corr * (rand - 0.5) * scale * mag_ref
        return (1.0 - alpha) * prev + alpha * (ref + fluct)
