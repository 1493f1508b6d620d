"""Local time stepping (LTS): a per-cell pseudo-time step for steady
marching (port of rapidcfd_tpu/solvers/lts.py; reference: applications/
solvers/compressible/rhoPimpleFoam/rhoLTSPimpleFoam/setrDeltaT.H with
finiteVolume/ddtSchemes/localEulerDdtScheme).

The reciprocal local step

    rDeltaT = max(1/maxDeltaT, surfaceSum(|phi|) / (2 maxCo V [rho]))

is smoothed with fvc::smooth(rDeltaTSmoothingCoeff) and rate-limited by
rDeltaTDampingCoeff against the previous value; the localEuler ddt then
takes dt = 1/rDeltaT per cell (ops/fvm.py ddt). LTSInterFoam's interface
variant (make_rdelta_t_interface) limits the cells of the interface band
by maxAlphaCo.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import fvc
from ..utils.logging import info


@dataclass(frozen=True)
class LTSControls:
    max_co: float = 0.8
    smoothing_coeff: float = 0.02
    damping_coeff: float = 1.0
    max_delta_t: float = 1e30

    @staticmethod
    def from_dict(d) -> "LTSControls":
        if d is None:
            return LTSControls()
        return LTSControls(
            max_co=float(d.scalar("maxCo", 0.8)),
            smoothing_coeff=float(d.scalar("rDeltaTSmoothingCoeff", 0.02)),
            damping_coeff=float(d.scalar("rDeltaTDampingCoeff", 1.0)),
            max_delta_t=float(d.scalar("maxDeltaT", 1e30)))


def make_rdelta_t(mesh, c: LTSControls):
    """rdelta_t(phi_data, rho_data | None, rdt_prev | None) -> the
    (nCells,) reciprocal time step."""

    def rdelta_t(phi_data, rho_data, rdt_prev):
        sum_phi = fvc.surface_sum_faces(mesh, phi_data.abs(), signed=False)
        den = (2.0 * c.max_co) * mesh.V
        if rho_data is not None:
            den = den * rho_data
        rdt = torch.clamp(sum_phi / den, min=1.0 / c.max_delta_t)
        if c.smoothing_coeff < 1.0:
            # the reference's smoothData limits the ratio of neighbours to
            # 1 + coeff: a propagation factor 1/(1 + coeff)
            rdt = fvc.smooth(mesh, rdt, 1.0 / (1.0 + c.smoothing_coeff),
                             sweeps=12)
        if rdt_prev is not None and c.damping_coeff < 1.0:
            rdt = rdt_prev * torch.clamp(rdt / rdt_prev,
                                         min=1.0 - c.damping_coeff)
        return rdt

    return rdelta_t


def make_rdelta_t_interface(mesh, c: LTSControls,
                            max_alpha_co: float = 0.2):
    """LTSInterFoam's rdelta_t(phi_data, alpha_data, rdt_prev | None)
    (reference: LTSInterFoam/setrDeltaT.H): the cells of the interface
    band (0.01 < alpha < 0.99) are limited by maxAlphaCo as well as by
    maxCo."""

    def rdelta_t(phi_data, alpha_data, rdt_prev):
        sum_phi = fvc.surface_sum_faces(mesh, phi_data.abs(), signed=False)
        rdt = torch.clamp(sum_phi / ((2.0 * c.max_co) * mesh.V),
                          min=1.0 / c.max_delta_t)
        in_band = (alpha_data > 0.01) & (alpha_data < 0.99)
        rdt_a = sum_phi / ((2.0 * max_alpha_co) * mesh.V)
        rdt = torch.where(in_band, torch.maximum(rdt, rdt_a), rdt)
        if c.smoothing_coeff < 1.0:
            rdt = fvc.smooth(mesh, rdt, 1.0 / (1.0 + c.smoothing_coeff),
                             sweeps=12)
        if rdt_prev is not None and c.damping_coeff < 1.0:
            rdt = rdt_prev * torch.clamp(rdt / rdt_prev,
                                         min=1.0 - c.damping_coeff)
        return rdt

    return rdelta_t


def log_time_scale(rdt):
    """Log the flow time scale's range (two host reads)."""
    info(f"Flow time scale min/max = {1.0 / float(rdt.max()):.6g}, "
         f"{1.0 / max(float(rdt.min()), 1e-300):.6g}")
