"""Radiation: the P1 model with constant absorption, emission and scatter
(port of rapidcfd_tpu/models/radiation.py:35-175 and :360-381;
reference: src/thermophysicalModels/radiationModels/radiationModel/P1/
P1.C:213-290).

P1 solves laplacian(gamma, G) - Sp(a, G) == -4 (e sigma T^4 + E) for the
incident radiation G with gamma = 1/(3a + sigma_s), the walls under the
Marshak condition (fields/bcs.py MarshakRadiation, re-exported here),
and couples to the energy equation through radiationModel::Sh = Ru -
Rp T^4, linearised in the energy. The JAX package's linear-anisotropy
coefficient C and its wall flux qr, which no solver reads, are left
out. `make_radiation_model` reads
constant/radiationProperties: none (or no file) and P1 are ported;
fvDOM, opaqueSolid and viewFactor raise NotImplementedError naming the
model.
"""

from __future__ import annotations

import os

import torch

from ..fields.bcs import SIGMA_SB, MarshakRadiation
from ..fields.field import Dimensioned, VolField
from ..linalg.solvers import solve
from ..ops import fvm
from ..utils.dictionary import Dictionary, parse_file
from ..utils.dimensions import DimensionSet
from ..utils.logging import info

__all__ = ["MarshakRadiation", "P1Radiation", "SIGMA_SB",
           "make_radiation_model"]


def _coeff(d: Dictionary, key: str, default: float) -> float:
    """A dimensioned or plain number of a coefficients dictionary."""
    v = d.lookup(key)
    if v is None:
        return default
    return Dimensioned.from_entry(v, key).value if isinstance(v, tuple) \
        else float(v)


class P1Radiation:
    """radiationModel P1 (see the module docstring)."""

    def __init__(self, case, props: Dictionary):
        self.case = case
        ae = props.subdict("constantAbsorptionEmissionCoeffs",
                           required=False) or Dictionary()
        self.a = _coeff(ae, "absorptivity", 0.5)
        self.e = _coeff(ae, "emissivity", 0.5)
        self.E = _coeff(ae, "E", 0.0)
        sc = props.subdict("constantScatterCoeffs",
                           required=False) or Dictionary()
        self.sigma_s = _coeff(sc, "sigma", 0.0)
        self.gamma = 1.0 / (3.0 * self.a + self.sigma_s + 1e-30)
        self.g_controls = case.solver_controls("G")
        self.lap_corr = case.laplacian_scheme()
        info(f"Selecting radiationModel P1 (a={self.a} e={self.e} "
             f"sigma_s={self.sigma_s})")

    def read_g(self) -> VolField:
        return self.case.read_field("G")

    def correct(self, mesh, G: VolField, T: VolField):
        """Solve the G equation (reference: P1.C:236-243); the Marshak
        walls take the current wall temperatures, stored in their bcdata
        for the matrix assembly. Returns (G, perf)."""
        bcdata = list(G.bcdata)
        for i, bc in enumerate(G.bcs):
            if not isinstance(bc, MarshakRadiation):
                continue
            patch = mesh.patches[i]
            bd = dict(bcdata[i])
            e = torch.clamp(bd["emissivity"], 1e-3, 1.0) \
                if "emissivity" in bd else torch.ones(
                    (), dtype=T.data.dtype, device=T.data.device)
            tw = T.bvalues[patch.bstart:patch.bstart + patch.size]
            alpha = e / (2.0 * (2.0 - e))
            bd["marshakRefValue"] = 4.0 * SIGMA_SB * tw ** 4
            bd["marshakFraction"] = alpha / (
                alpha + self.gamma * mesh.patch_delta_coeffs(patch))
            bcdata[i] = bd
        G = G.replace(bcdata=tuple(bcdata))
        rhs = G.with_calculated_bcs(
            -4.0 * (self.e * SIGMA_SB * T.data ** 4 + self.E),
            torch.zeros_like(G.bvalues), G.dims / DimensionSet.of(0, 1))
        gamma = Dimensioned("gammaRad", DimensionSet.of(0, 1), self.gamma)
        eqn = (fvm.laplacian(mesh, gamma, G, self.lap_corr)
               - fvm.Sp(mesh, Dimensioned("a", DimensionSet.of(0, -1),
                                          self.a), G))
        return solve(mesh, eqn.equals(rhs), self.g_controls,
                     env={"T": T, "gammaRad": self.gamma})

    def sh(self, mesh, G: VolField, T: VolField, cpv, he_cur):
        """The energy equation's coupling (reference: radiationModel::Sh):
        Sh = Ru - Rp T^4, linearised in the energy with d(T^4)/d(he) =
        4 T^3/Cpv. Returns (sp, explicit) densities [W/m3]; the caller
        adds diag += V sp and source += V explicit, so that at
        convergence the net source is Ru - Rp T^4."""
        t3 = T.data ** 3
        rp = 4.0 * self.e * SIGMA_SB
        ru = self.a * G.data - 4.0 * self.E
        sp = rp * t3 / torch.clamp(cpv, min=1e-10)
        return sp, ru - rp * t3 * T.data + sp * he_cur


def make_radiation_model(case):
    """radiationModel::New: None when radiation is off or absent (the
    reference's 'none'), a P1Radiation for P1. fvDOM, opaqueSolid and
    viewFactor are not ported and raise."""
    path = os.path.join(case.dir, "constant", "radiationProperties")
    if not os.path.isfile(path):
        return None
    props = parse_file(path)
    if not props.boolean("radiation", True):
        return None
    name = props.word("radiationModel", "none")
    if name in ("none", "noRadiation"):
        return None
    if name == "P1":
        return P1Radiation(case, props)
    if name in ("fvDOM", "opaqueSolid", "viewFactor"):
        raise NotImplementedError(
            f"radiationModel '{name}' is not ported yet (ported: none, P1)")
    raise KeyError(f"radiationProperties: unsupported radiationModel "
                   f"'{name}' (none|P1|fvDOM|opaqueSolid|viewFactor)")
