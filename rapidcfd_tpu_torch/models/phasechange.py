"""Phase-change (cavitation) two-phase mixtures (port of rapidcfd_tpu/
models/phasechange.py; reference: applications/solvers/multiphase/
interPhaseChangeFoam/phaseChangeTwoPhaseMixtures).

A mass-transfer model gives the (condensation, vaporisation) rate pairs
mDotAlphal (for the alpha equation) and mDotP (for the pressure
equation), turned into volume rates by the phase densities. SchnerrSauer
is ported; Kunz and Merkle would share the interface.
"""

from __future__ import annotations

import math

import torch

from ..fields.field import Dimensioned
from ..utils.dictionary import Dictionary
from ..utils.registry import lookup, register


class PhaseChangeMixture:
    """Base: pSat and the vDotAlphal/vDotP pairs (reference:
    phaseChangeTwoPhaseMixture.C:vDotAlphal/vDotP)."""

    def __init__(self, props: Dictionary, rho1: float, rho2: float):
        self.rho1, self.rho2 = rho1, rho2
        self.p_sat = Dimensioned.from_entry(
            props.lookup("pSat", required=True), "pSat").value
        name = str(props.word("phaseChangeTwoPhaseMixture", ""))
        self.coeffs = props.subdict(name + "Coeffs", required=False) \
            or Dictionary()

    def m_dot_alphal(self, alpha1, p):
        raise NotImplementedError

    def m_dot_p(self, alpha1, p):
        raise NotImplementedError

    def v_dot_alphal(self, alpha1, p):
        c = 1.0 / self.rho1 - alpha1 * (1.0 / self.rho1 - 1.0 / self.rho2)
        mc, mv = self.m_dot_alphal(alpha1, p)
        return c * mc, c * mv

    def v_dot_p(self, alpha1, p):
        c = 1.0 / self.rho1 - 1.0 / self.rho2
        mc, mv = self.m_dot_p(alpha1, p)
        return c * mc, c * mv


@register("phaseChangeMixture", "SchnerrSauer")
class SchnerrSauer(PhaseChangeMixture):
    """Schnerr-Sauer bubble-dynamics cavitation model (reference:
    phaseChangeTwoPhaseMixtures/SchnerrSauer/SchnerrSauer.C:55-140)."""

    def __init__(self, props, rho1, rho2):
        super().__init__(props, rho1, rho2)
        c = self.coeffs

        def value(key):
            return Dimensioned.from_entry(c.lookup(key, required=True),
                                          key).value
        self.n, self.d_nuc = value("n"), value("dNuc")
        self.cc, self.cv = value("Cc"), value("Cv")

    def _alpha_nuc(self):
        v_nuc = self.n * math.pi * self.d_nuc ** 3 / 6.0
        return v_nuc / (1.0 + v_nuc)

    def _p_coeff(self, alpha1, p):
        a = torch.clamp(alpha1, 0.0, 1.0)
        rho = a * self.rho1 + (1.0 - a) * self.rho2
        r_rb = ((4.0 * math.pi * self.n / 3.0) * a
                / (1.0 + self._alpha_nuc() - a)) ** (1.0 / 3.0)
        return (3.0 * self.rho1 * self.rho2) \
            * math.sqrt(2.0 / (3.0 * self.rho1)) * r_rb \
            / (rho * torch.sqrt((p - self.p_sat).abs() + 0.01 * self.p_sat))

    def m_dot_alphal(self, alpha1, p):
        a = torch.clamp(alpha1, 0.0, 1.0)
        pc = self._p_coeff(alpha1, p)
        dp = p - self.p_sat
        return (self.cc * a * pc * torch.clamp(dp, min=0.0),
                self.cv * (1.0 + self._alpha_nuc() - a) * pc
                * torch.clamp(dp, max=0.0))

    def m_dot_p(self, alpha1, p):
        a = torch.clamp(alpha1, 0.0, 1.0)
        apc = a * self._p_coeff(alpha1, p)
        dp = p - self.p_sat
        return (self.cc * (1.0 - a) * (dp > 0.0) * apc,
                (-self.cv) * (1.0 + self._alpha_nuc() - a)
                * (dp < 0.0) * apc)


def make_phase_change_mixture(props: Dictionary, rho1: float,
                              rho2: float) -> PhaseChangeMixture:
    name = str(props.word("phaseChangeTwoPhaseMixture", "SchnerrSauer"))
    return lookup("phaseChangeMixture", name)(props, rho1, rho2)
