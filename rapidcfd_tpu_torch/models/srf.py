"""Single rotating frame (port of rapidcfd_tpu/models/srf.py; reference:
src/finiteVolume/cfdTools/general/SRF/SRFModel/SRFModel/SRFModel.C):
Fcoriolis = 2 omega ^ Urel, Fcentrifugal = omega ^ (omega ^ r), Su their
sum, the frame velocity omega ^ (r - axis (axis & r)), selected from
constant/SRFProperties (`SRFModel rpm`). SRFSimpleFoam and SRFPimpleFoam
(solvers/srffoam.py) solve for the relative velocity Urel with Su on the
momentum LHS."""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..utils.dictionary import parse_file
from ..utils.logging import info


class SRFModel:
    """`SRFModel rpm;` (reference: SRF/SRFModel/rpm/rpm.C: omega = axis *
    rpm 2 pi/60)."""

    def __init__(self, case):
        d = parse_file(os.path.join(case.dir, "constant", "SRFProperties"))
        model = d.word("SRFModel", "rpm")
        if model != "rpm":
            raise KeyError(f"SRFProperties: unknown SRFModel '{model}' "
                           "(only 'rpm' exists in the reference)")
        axis = np.asarray(d.lookup("axis", [0.0, 0.0, 1.0]), float)
        self.axis = axis / np.linalg.norm(axis)
        self.origin = np.asarray(d.lookup("origin", [0.0, 0.0, 0.0]), float)
        coeffs = d.subdict("rpmCoeffs", required=False)
        rpm = float((coeffs or d).scalar("rpm", 0.0))
        self.omega = self.axis * rpm * 2.0 * math.pi / 60.0
        info(f"Creating SRF model rpm (omega = {rpm * math.pi / 30.0:g} "
             "rad/s)")

    def _t(self, a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(a, dtype=like.dtype, device=like.device)

    def su(self, mesh, U):
        """The acceleration on the momentum LHS (SRFModel::Su): 2 omega ^
        Urel + omega ^ (omega ^ (C - origin)), (n, 3)."""
        r = mesh.C - self._t(self.origin, mesh.C)
        w = torch.broadcast_to(self._t(self.omega, U.data), U.data.shape)
        return 2.0 * torch.linalg.cross(w, U.data) \
            + torch.linalg.cross(w, torch.linalg.cross(w, r))

    def velocity(self, positions: torch.Tensor) -> torch.Tensor:
        """The frame velocity at the positions (SRFModel::velocity): omega
        ^ (r - axis (axis & r)), r relative to the origin."""
        r = positions - self._t(self.origin, positions)
        axis = self._t(self.axis, positions)
        r_perp = r - axis * (r * axis).sum(-1, keepdim=True)
        w = torch.broadcast_to(self._t(self.omega, positions), r.shape)
        return torch.linalg.cross(w, r_perp)

    def patch_bcs(self, mesh, U):
        """U with the static frame velocity in its SRFVelocity patches'
        bcdata (the reference recomputes it in every updateCoeffs) and
        its boundary values re-evaluated (the JAX package's
        srffoam._patch_srf_bcs)."""
        from ..fields.bcs import SRFVelocity
        bcdata = list(U.bcdata)
        changed = False
        for i, bc in enumerate(U.bcs):
            if isinstance(bc, SRFVelocity):
                p = mesh.patches[bc.patch]
                bcdata[i] = dict(bcdata[i], srfValue=self.velocity(
                    mesh.Cf[p.start:p.start + p.size]))
                changed = True
        if not changed:
            return U
        return U.replace(bcdata=tuple(bcdata)) \
            .correct_boundary_conditions(mesh)

    def u_abs(self, mesh, U_rel):
        """Uabs = Urel + the frame velocity (SRFModel::Uabs)."""
        return U_rel.replace(
            data=U_rel.data + self.velocity(mesh.C),
            bvalues=U_rel.bvalues + self.velocity(mesh.Cf)[mesh.n_internal:],
            name="Uabs")
