"""Dimension (SI unit) algebra (the port's copy of
rapidcfd_tpu/utils/dimensions.py).

Capability parity with the reference's 7-component dimension checking
(reference: src/OpenFOAM/dimensionSet/dimensionSet.H), but evaluated
*entirely at trace time*: dimensions live in static pytree metadata, so the
checks are free at runtime — a strictly better deal than the reference's
per-operation runtime checks.

Order of exponents follows OpenFOAM: [kg m s K mol A cd].
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction


class DimensionError(Exception):
    """Raised when an operation combines dimensionally-inconsistent fields."""


def _frac(x) -> Fraction:
    return x if isinstance(x, Fraction) else Fraction(x).limit_denominator(1000)


@dataclass(frozen=True)
class DimensionSet:
    mass: Fraction = Fraction(0)
    length: Fraction = Fraction(0)
    time: Fraction = Fraction(0)
    temperature: Fraction = Fraction(0)
    moles: Fraction = Fraction(0)
    current: Fraction = Fraction(0)
    luminous: Fraction = Fraction(0)

    # -- constructors ------------------------------------------------------
    @staticmethod
    def of(*exps) -> "DimensionSet":
        exps = list(exps) + [0] * (7 - len(exps))
        return DimensionSet(*[_frac(e) for e in exps[:7]])

    def as_tuple(self):
        return (self.mass, self.length, self.time, self.temperature,
                self.moles, self.current, self.luminous)

    # -- algebra -----------------------------------------------------------
    def __mul__(self, other: "DimensionSet") -> "DimensionSet":
        return DimensionSet(*[a + b for a, b in
                              zip(self.as_tuple(), other.as_tuple())])

    def __truediv__(self, other: "DimensionSet") -> "DimensionSet":
        return DimensionSet(*[a - b for a, b in
                              zip(self.as_tuple(), other.as_tuple())])

    def __pow__(self, p) -> "DimensionSet":
        p = _frac(p)
        return DimensionSet(*[a * p for a in self.as_tuple()])

    def sqrt(self) -> "DimensionSet":
        return self ** Fraction(1, 2)

    def check_same(self, other: "DimensionSet", what: str = "operation"):
        if self != other:
            raise DimensionError(
                f"dimension mismatch in {what}: {self} vs {other}")
        return self

    @property
    def dimensionless(self) -> bool:
        return all(e == 0 for e in self.as_tuple())

    def __repr__(self):
        def fmt(f: Fraction):
            return str(f.numerator) if f.denominator == 1 else f"{f}"
        return "[" + " ".join(fmt(e) for e in self.as_tuple()) + "]"


_NAMED_UNITS = {
    "kg": (1, 0, 0, 0, 0, 0, 0), "g": (1, 0, 0, 0, 0, 0, 0),
    "m": (0, 1, 0, 0, 0, 0, 0), "cm": (0, 1, 0, 0, 0, 0, 0),
    "mm": (0, 1, 0, 0, 0, 0, 0),
    "s": (0, 0, 1, 0, 0, 0, 0), "K": (0, 0, 0, 1, 0, 0, 0),
    "mol": (0, 0, 0, 0, 1, 0, 0), "kmol": (0, 0, 0, 0, 1, 0, 0),
    "A": (0, 0, 0, 0, 0, 1, 0), "cd": (0, 0, 0, 0, 0, 0, 1),
    "N": (1, 1, -2, 0, 0, 0, 0), "Pa": (1, -1, -2, 0, 0, 0, 0),
    "J": (1, 2, -2, 0, 0, 0, 0), "W": (1, 2, -3, 0, 0, 0, 0),
    "Hz": (0, 0, -1, 0, 0, 0, 0),
}


def parse_named_units(tokens) -> "DimensionSet":
    """Parse the named-unit dimension form, e.g. ``[m s^-1]`` or ``[K]``.

    Matches the reference's unit-name dimensionSet reader used in
    etc/controlDict DimensionedConstants (dimensionSets.C); scaling
    prefixes are ignored (dimensions only, no unit conversion). Names not
    in the base table (e.g. case-defined derived units like ``density``)
    make the whole bracket fall back to the raw token list — such entries
    are carried through but not dimension-checked.
    """
    out = DimensionSet()
    for tok in tokens:
        if not isinstance(tok, str):
            return list(tokens)
        name, _, exp = tok.partition("^")
        if name not in _NAMED_UNITS:
            return list(tokens)
        p = _frac(exp) if exp else Fraction(1)
        out = out * (DimensionSet(*[_frac(e) for e in _NAMED_UNITS[name]]) ** p)
    return out


dimless = DimensionSet()
dim_mass = DimensionSet.of(1)
dim_length = DimensionSet.of(0, 1)
dim_time = DimensionSet.of(0, 0, 1)
dim_temperature = DimensionSet.of(0, 0, 0, 1)
dim_moles = DimensionSet.of(0, 0, 0, 0, 1)
dim_current = DimensionSet.of(0, 0, 0, 0, 0, 1)

dim_area = dim_length ** 2
dim_volume = dim_length ** 3
dim_velocity = dim_length / dim_time
dim_acceleration = dim_velocity / dim_time
dim_density = dim_mass / dim_volume
dim_pressure = dim_mass / (dim_length * dim_time ** 2)
dim_kinematic_pressure = dim_pressure / dim_density  # m2/s2 (incompressible p)
dim_viscosity = dim_area / dim_time  # kinematic
dim_dynamic_viscosity = dim_mass / (dim_length * dim_time)
dim_energy = dim_mass * dim_area / dim_time ** 2
dim_specific_energy = dim_area / dim_time ** 2
dim_flux = dim_volume / dim_time  # volumetric face flux
dim_mass_flux = dim_mass / dim_time
