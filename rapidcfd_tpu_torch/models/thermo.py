"""Thermophysical models: the perfect-gas bundle and the psi thermo (port
of rapidcfd_tpu/models/thermo.py:26-193; reference: src/thermophysical-
Models/specie and basic/psiThermo/hePsiThermo.C:35-110).

`PerfectGasThermo` is pureMixture { perfectGas + hConst or eConst +
const or sutherland transport } with sensible enthalpy or sensible
internal energy; each property is a closed-form elementwise expression
of T (and p). `PsiThermo` owns the field-level part: the energy field
with its boundary conditions derived from T's, and T back from the solved
energy. The general specie stack of the JAX package (janaf,
hPolynomial, the other equations of state: `SpecieThermo`) and the
per-phase `PhaseRhoThermo` are not ported: `read_thermo` raises on a
dictionary that asks for them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..fields.field import VolField
from ..utils.dictionary import Dictionary

R_UNIVERSAL = 8314.47  # J/(kmol K), reference: specie.H RR


def _max(x, floor: float):
    """max(x, floor) of a tensor or a number."""
    if isinstance(x, torch.Tensor):
        return torch.clamp(x, min=floor)
    return max(float(x), floor)


def _sqrt(x):
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else float(x) ** 0.5


@dataclass(frozen=True)
class PerfectGasThermo:
    """pureMixture { perfectGas + hConst + const/sutherland }."""
    mol_weight: float
    cp: float
    hf: float
    mu0: float
    pr: float
    sutherland: bool = False
    as_: float = 0.0
    ts: float = 0.0
    energy: str = "sensibleInternalEnergy"
    t_std: float = 298.15

    @property
    def r(self) -> float:
        return R_UNIVERSAL / self.mol_weight

    @property
    def cv(self) -> float:
        return self.cp - self.r

    @property
    def gamma(self) -> float:
        return self.cp / self.cv

    # -- energy form ---------------------------------------------------------
    def he_from_t(self, T):
        if self.energy == "sensibleEnthalpy":
            return self.cp * (T - self.t_std)
        # sensible internal energy: es = hs - R*T
        return self.cp * (T - self.t_std) - self.r * T

    def t_from_he(self, he):
        if self.energy == "sensibleEnthalpy":
            return he / self.cp + self.t_std
        return (he + self.cp * self.t_std) / (self.cp - self.r)

    # -- state ----------------------------------------------------------------
    def psi(self, T):
        """Compressibility psi = rho/p = 1/(R T)."""
        return 1.0 / (self.r * _max(T, 1e-10))

    def rho(self, p, T):
        return p * self.psi(T)

    def mu(self, T):
        if self.sutherland:
            return self.as_ * _sqrt(T) / (1.0 + self.ts / T)
        return self.mu0

    def alpha_h(self, T):
        """Thermal diffusivity for the energy equation: kappa/Cp = mu/Pr."""
        return self.mu(T) / self.pr

    def c_sound(self, T):
        return _sqrt(self.gamma * self.r * _max(T, 1e-10))


def read_thermo(props: Dictionary) -> PerfectGasThermo:
    """Parse constant/thermophysicalProperties (reference: basicThermo
    dictionary layout, the thermoType dictionary and the 2.x string
    form) into the perfect-gas bundle. A dictionary that asks for janaf,
    a polynomial or another equation of state needs the JAX package's
    general specie stack (`SpecieThermo`), which is not ported: it
    raises."""
    if _wants_general_stack(props):
        raise NotImplementedError(
            "thermophysicalProperties asks for the general specie stack "
            "(SpecieThermo: janaf, hPolynomial, polynomial transport or "
            "another equation of state than perfectGas), which is not "
            "ported yet")
    tt = props.lookup("thermoType", required=True)
    if isinstance(tt, Dictionary):
        energy = tt.word("energy", "sensibleInternalEnergy")
        transport = tt.word("transport", "const")
    else:
        s = str(tt if not isinstance(tt, tuple) else tt[0])
        energy = ("sensibleEnthalpy" if "h" in s.split("<")[0].lower()
                  else "sensibleInternalEnergy")
        transport = "sutherland" if "sutherland" in s else "const"

    mix = props.subdict("mixture", required=False)
    if not mix:
        for _, v in props.items():
            if isinstance(v, Dictionary) and v.lookup("specie") is not None:
                mix = v
                break
    if not mix:
        raise KeyError("thermophysicalProperties: no mixture dictionary")
    specie = mix.subdict("specie")
    thermo_d = mix.subdict("thermodynamics")
    trans = mix.subdict("transport")

    sutherland = transport == "sutherland" or trans.lookup("As") is not None
    return PerfectGasThermo(
        mol_weight=specie.scalar("molWeight"),
        cp=thermo_d.scalar("Cp", 0.0) or
        (thermo_d.scalar("Cv", 0.0)
         + R_UNIVERSAL / specie.scalar("molWeight")),
        hf=thermo_d.scalar("Hf", 0.0),
        mu0=trans.scalar("mu", 0.0),
        pr=trans.scalar("Pr", 1.0),
        sutherland=sutherland,
        as_=trans.scalar("As", 0.0),
        ts=trans.scalar("Ts", 0.0),
        energy=energy,
    )


def _wants_general_stack(props: Dictionary) -> bool:
    """True when thermoType names janaf, a polynomial or an equation of
    state other than perfectGas."""
    tt = props.lookup("thermoType", required=True)
    if isinstance(tt, Dictionary):
        words = [tt.word("thermo", "hConst"),
                 tt.word("equationOfState", "perfectGas"),
                 tt.word("transport", "const")]
    else:
        words = [str(tt if not isinstance(tt, tuple) else tt[0])]
    blob = " ".join(words).lower()
    return any(k.lower() in blob for k in (
        "janaf", "hPolynomial", "polynomial", "icoPolynomial",
        "incompressiblePerfectGas", "perfectFluid", "rhoConst"))


class PsiThermo:
    """Field-level thermo (reference: hePsiThermo): the energy field and
    T from it; the solved energy field's BCs are derived from T's."""

    def __init__(self, case, thermo: PerfectGasThermo):
        self.case = case
        self.model = thermo

    def he_field(self, mesh, T: VolField, name="e") -> VolField:
        """Energy field with BCs mirroring T's: a fixed T gives a fixed
        energy, every other type zeroGradient, empty stays empty."""
        from ..fields.bcs import Empty, FixedValue, make_bc
        from ..utils.dimensions import dim_specific_energy
        m = self.model
        bcs, bcdata = [], []
        for i, (bc, bd) in enumerate(zip(T.bcs, T.bcdata)):
            if isinstance(bc, Empty):
                bcs.append(make_bc("empty", i))
                bcdata.append({})
            elif isinstance(bc, FixedValue):
                bcs.append(make_bc("fixedValue", i))
                bcdata.append({"value": m.he_from_t(bd["value"])})
            else:
                bcs.append(make_bc("zeroGradient", i))
                bcdata.append({})
        he = VolField(m.he_from_t(T.data), m.he_from_t(T.bvalues),
                      tuple(bcs), dim_specific_energy, name, tuple(bcdata))
        return he.correct_boundary_conditions(mesh)

    def update_t(self, mesh, T: VolField, he: VolField) -> VolField:
        """thermo.correct(): T from the solved energy, with T's boundary
        conditions re-evaluated."""
        return T.replace(data=self.model.t_from_he(he.data)) \
            .correct_boundary_conditions(mesh)
