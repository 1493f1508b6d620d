"""Transport models: the incompressible viscosity-model zoo (port of
rapidcfd_tpu/models/transport.py; reference: incompressible/
viscosityModels + singlePhaseTransportModel.H:56).

Each non-Newtonian model is a function of the strain rate evaluated on
the case's device; the model is selected by transportModel in
constant/transportProperties.
"""

from __future__ import annotations

import torch

from ..fields.field import Dimensioned, VolField
from ..ops import fvc
from ..utils.dictionary import Dictionary
from ..utils.dimensions import dim_viscosity


def _coeff(d: Dictionary, name: str, model: str):
    sub = d.subdict(model + "Coeffs", required=False)
    entry = sub.lookup(name) if sub else None
    if entry is None:
        entry = d.lookup(name)
    if entry is None:
        raise KeyError(f"transportProperties: missing '{name}'")
    return Dimensioned.from_entry(entry, name)


class Newtonian:
    def __init__(self, d: Dictionary):
        self.nu0 = Dimensioned.from_entry(d.lookup("nu", required=True),
                                          "nu")

    def nu(self, mesh, U, strain_rate=None):
        return self.nu0


class _StrainRateModel:
    """nu = f(strain rate), cell and boundary values alike, with
    calculated BCs."""

    def f(self, s):
        raise NotImplementedError

    def nu(self, mesh, U, strain_rate=None):
        sr = strain_rate
        return sr.with_calculated_bcs(self.f(sr.data), self.f(sr.bvalues),
                                      dim_viscosity, "nu")


class PowerLaw(_StrainRateModel):
    """nu = max(nuMin, min(nuMax, k*sr^(n-1))) (reference:
    viscosityModels/powerLaw)."""

    def __init__(self, d: Dictionary):
        self.k = _coeff(d, "k", "powerLaw").value
        self.n = _coeff(d, "n", "powerLaw").value
        self.nu_min = _coeff(d, "nuMin", "powerLaw").value
        self.nu_max = _coeff(d, "nuMax", "powerLaw").value

    def f(self, s):
        return torch.clamp(self.k * torch.clamp_min(s, 1e-30)
                           ** (self.n - 1.0), self.nu_min, self.nu_max)


class BirdCarreau(_StrainRateModel):
    """nu = nuInf + (nu0-nuInf)*(1+(k*sr)^2)^((n-1)/2)."""

    def __init__(self, d: Dictionary):
        self.nu0 = _coeff(d, "nu0", "BirdCarreau").value
        self.nu_inf = _coeff(d, "nuInf", "BirdCarreau").value
        self.k = _coeff(d, "k", "BirdCarreau").value
        self.n = _coeff(d, "n", "BirdCarreau").value

    def f(self, s):
        return self.nu_inf + (self.nu0 - self.nu_inf) * (
            1.0 + (self.k * s) ** 2) ** ((self.n - 1.0) / 2.0)


class CrossPowerLaw(_StrainRateModel):
    """nu = nuInf + (nu0-nuInf)/(1+(m*sr)^n)."""

    def __init__(self, d: Dictionary):
        self.nu0 = _coeff(d, "nu0", "CrossPowerLaw").value
        self.nu_inf = _coeff(d, "nuInf", "CrossPowerLaw").value
        self.m = _coeff(d, "m", "CrossPowerLaw").value
        self.n = _coeff(d, "n", "CrossPowerLaw").value

    def f(self, s):
        return self.nu_inf + (self.nu0 - self.nu_inf) \
            / (1.0 + (self.m * s) ** self.n)


class HerschelBulkley(_StrainRateModel):
    """nu = min(nu0, tau0/sr + k*sr^(n-1))."""

    def __init__(self, d: Dictionary):
        self.nu0 = _coeff(d, "nu0", "HerschelBulkley").value
        self.tau0 = _coeff(d, "tau0", "HerschelBulkley").value
        self.k = _coeff(d, "k", "HerschelBulkley").value
        self.n = _coeff(d, "n", "HerschelBulkley").value

    def f(self, s):
        s = torch.clamp_min(s, 1e-30)
        return torch.clamp_max(self.tau0 / s + self.k * s ** (self.n - 1.0),
                               self.nu0)


VISCOSITY_MODELS = {"Newtonian": Newtonian, "powerLaw": PowerLaw,
                    "BirdCarreau": BirdCarreau,
                    "CrossPowerLaw": CrossPowerLaw,
                    "HerschelBulkley": HerschelBulkley}


def strain_rate(mesh, U: VolField) -> VolField:
    """sqrt(2)*|symm(grad U)| (reference: viscosityModel::strainRate)."""
    g = fvc.grad(mesh, U)
    sym = 0.5 * (g.data + g.data.transpose(1, 2))
    symb = 0.5 * (g.bvalues + g.bvalues.transpose(1, 2))
    mag = torch.sqrt(2.0 * (sym * sym).sum((-2, -1)))
    magb = torch.sqrt(2.0 * (symb * symb).sum((-2, -1)))
    return g.with_calculated_bcs(mag, magb, g.dims, "strainRate")


class SinglePhaseTransportModel:
    """The runtime-selected viscosity model, providing nu()."""

    def __init__(self, props: Dictionary):
        name = props.word("transportModel", "Newtonian")
        cls = VISCOSITY_MODELS.get(name)
        if cls is None:
            raise KeyError(f"Unknown viscosityModel '{name}'.\nValid "
                           f"viscosityModel entries: "
                           f"{', '.join(sorted(VISCOSITY_MODELS))}")
        self.model = cls(props)
        self.is_newtonian = isinstance(self.model, Newtonian)

    def nu(self, mesh, U: VolField):
        if self.is_newtonian:
            return self.model.nu(mesh, U)
        return self.model.nu(mesh, U, strain_rate(mesh, U))
