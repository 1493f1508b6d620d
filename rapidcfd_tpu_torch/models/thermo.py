"""Thermophysical models: the perfect-gas bundle, the general specie
stack and the psi thermo (port of rapidcfd_tpu/models/thermo.py:26-193
and :300-689; reference: src/thermophysicalModels/specie and basic/
psiThermo/hePsiThermo.C:35-110).

`PerfectGasThermo` is pureMixture { perfectGas + hConst or eConst +
const or sutherland transport } with sensible enthalpy or sensible
internal energy. `SpecieThermo` is the layered stack thermo<transport<
EoS<specie>>> as one frozen bundle: hConst, janaf (NASA-7, two ranges)
or a Cp polynomial; perfectGas, incompressiblePerfectGas, perfectFluid,
rhoConst, icoPolynomial, linear, adiabaticPerfectFluid or
PengRobinsonGas; const, sutherland or polynomial transport; the four
energy forms, with T from the energy by a fixed 8 Newton iterations for
the variable-Cp forms (so that fp64 results match the JAX package
iterate for iterate). Every property is a closed-form elementwise
expression of T (and p). `read_thermo` returns the specie stack when
thermoType asks for janaf, a polynomial or another equation of state,
the perfect-gas bundle otherwise. `PsiThermo` owns the field-level part:
the energy field with its boundary conditions derived from T's, and T
back from the solved energy, for either bundle. The per-phase
`PhaseRhoThermo` belongs to the multiphase solvers and is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import math

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

    def t_from_he(self, he, T0=None):
        """T from the energy (closed form; T0 is not needed)."""
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


def read_thermo(props: Dictionary):
    """Parse constant/thermophysicalProperties (reference: basicThermo
    dictionary layout, the thermoType dictionary and the 2.x string
    form): the general specie stack (`SpecieThermo`) when it asks for
    janaf, a polynomial or another equation of state, else the
    perfect-gas bundle."""
    if _wants_general_stack(props):
        return read_specie_thermo(props)
    tt = props.lookup("thermoType", required=True)
    if isinstance(tt, Dictionary):
        energy = tt.word("energy", "sensibleInternalEnergy")
        transport = tt.word("transport", "const")
    else:
        s = str(tt if not isinstance(tt, tuple) else tt[0])
        energy = ("sensibleEnthalpy" if "h" in s.split("<")[0].lower()
                  else "sensibleInternalEnergy")
        transport = "sutherland" if "sutherland" in s else "const"

    mix = _mixture_dict(props)
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

    def __init__(self, case, thermo):
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
        """thermo.correct(): T from the solved energy (the previous T
        seeds the Newton iteration of the variable-Cp models), with T's
        boundary conditions re-evaluated."""
        return T.replace(data=self.model.t_from_he(he.data, T0=T.data)) \
            .correct_boundary_conditions(mesh)


# ---------------------------------------------------------------------------
# the general specie stack (reference: specie/thermo/{hConst,janaf,
# hPolynomial}, equationOfState/*, transport/{const,sutherland,polynomial})
# ---------------------------------------------------------------------------

def _polyval(coeffs, T):
    """Horner evaluation of sum_i c_i T^i (OpenFOAM Polynomial order)."""
    acc = torch.zeros_like(T)
    for c in reversed(list(coeffs)):
        acc = acc * T + float(c)
    return acc


def _polyint(coeffs):
    """Antiderivative coefficients of sum_i c_i T^i (constant 0)."""
    return [0.0] + [float(c) / (i + 1) for i, c in enumerate(coeffs)]


def _f64(x) -> torch.Tensor:
    """A number as a 0-d fp64 tensor (the scalar conveniences)."""
    return torch.as_tensor(x, dtype=torch.float64)


def _cbrt(x):
    return torch.sign(x) * x.abs() ** (1.0 / 3.0)


@dataclass(frozen=True)
class SpecieThermo:
    """The layered property stack as one frozen bundle of elementwise
    functions (reference: species::thermo<Thermo<EoS<specie>>>; the janaf
    polynomials of janafThermo.H, NASA-7). A superset of
    PerfectGasThermo's interface: the scalar .r/.cp/.cv/.gamma stay (Cp
    at t_std for the variable-Cp forms)."""
    mol_weight: float
    energy: str = "sensibleInternalEnergy"
    t_std: float = 298.15
    # -- thermodynamics --
    cp_mode: str = "const"            # const | janaf | polynomial
    cp0: float = 1005.0               # const Cp [J/kg/K]
    hf: float = 0.0
    janaf_low: tuple = ()             # 7 NASA coefficients
    janaf_high: tuple = ()
    t_low: float = 200.0
    t_high: float = 5000.0
    t_common: float = 1000.0
    cp_poly: tuple = ()               # mass-basis Cp(T) polynomial
    # -- equation of state --
    eos: str = "perfectGas"
    p_ref: float = 1e5                # incompressiblePerfectGas pRef
    rho0: float = 0.0                 # rhoConst / perfectFluid
    r_eos: float = 0.0                # perfectFluid R
    rho_poly: tuple = ()              # icoPolynomial rhoCoeffs
    psi0: float = 0.0                 # linear psi
    p0_apf: float = 1e5               # adiabaticPerfectFluid p0
    b_apf: float = 0.0                # adiabaticPerfectFluid B
    gamma_apf: float = 7.15           # adiabaticPerfectFluid gamma
    t_crit: float = 0.0               # PengRobinsonGas Tc
    p_crit: float = 1e5               # PengRobinsonGas Pc
    v_crit: float = 0.0               # PengRobinsonGas Vc
    z_crit: float = 1.0               # PengRobinsonGas Zc
    omega_acc: float = 0.0            # PengRobinsonGas acentric factor
    # -- transport --
    transport: str = "const"          # const | sutherland | polynomial
    mu0: float = 0.0
    pr: float = 1.0
    as_: float = 0.0
    ts: float = 0.0
    mu_poly: tuple = ()
    kappa_poly: tuple = ()

    # -- scalar conveniences ------------------------------------------------
    @property
    def r(self) -> float:
        return R_UNIVERSAL / self.mol_weight

    @property
    def cp(self) -> float:
        return float(self.cp_t(_f64(self.t_std)))

    @property
    def cv(self) -> float:
        return self.cp - self._cp_m_cv()

    @property
    def gamma(self) -> float:
        return self.cp / max(self.cv, 1e-30)

    def _cp_m_cv(self) -> float:
        """Cp - Cv by equation of state (reference: equationOfState
        CpMCv; perfectFluid's is 0, its R being a compressibility)."""
        if self.eos in ("perfectGas", "incompressiblePerfectGas"):
            return self.r
        if self.eos == "PengRobinsonGas":
            return float(self.r * self.z_pr(_f64(self.p_ref),
                                            _f64(self.t_std)))
        return 0.0

    # -- thermodynamics -----------------------------------------------------
    def cp_t(self, T):
        if self.cp_mode == "janaf":
            cp_lo = _polyval(self.janaf_low[:5], T)
            cp_hi = _polyval(self.janaf_high[:5], T)
            return self.r * torch.where(T < self.t_common, cp_lo, cp_hi)
        if self.cp_mode == "polynomial":
            return _polyval(self.cp_poly, T)
        return torch.full_like(T, self.cp0)

    def _ha(self, T):
        """Absolute enthalpy (janaf: R*(T*sum a_i T^i/(i+1) + a5))."""
        if self.cp_mode == "janaf":
            def ha_of(a):
                return self.r * (T * _polyval(
                    [a[0], a[1] / 2, a[2] / 3, a[3] / 4, a[4] / 5], T)
                    + a[5])
            return torch.where(T < self.t_common, ha_of(self.janaf_low),
                               ha_of(self.janaf_high))
        if self.cp_mode == "polynomial":
            return _polyval(_polyint(self.cp_poly), T) + self.hf
        return self.cp0 * T + self.hf

    def he_from_t(self, T):
        ha = self._ha(T)
        if self.energy == "absoluteEnthalpy":
            return ha
        hs = ha - self._ha(torch.full_like(T, self.t_std))
        if self.energy == "sensibleEnthalpy":
            return hs
        if self.energy == "absoluteInternalEnergy":
            return ha - self._cp_m_cv() * T
        return hs - self._cp_m_cv() * T      # sensibleInternalEnergy

    def t_from_he(self, he, T0=None):
        """T from the energy: closed form for constant Cp; for the
        variable-Cp forms a fixed 8 Newton iterations from T0 (1000 K
        without one), clipped to [10, 2e4] K (reference: thermo::T)."""
        if self.cp_mode == "const":
            cmc = self._cp_m_cv()
            h_std = self.cp0 * self.t_std + self.hf
            if self.energy == "sensibleEnthalpy":
                return (he + h_std - self.hf) / self.cp0
            if self.energy == "absoluteEnthalpy":
                return (he - self.hf) / self.cp0
            if self.energy == "absoluteInternalEnergy":
                return (he - self.hf) / (self.cp0 - cmc)
            return (he + h_std - self.hf) / (self.cp0 - cmc)
        T = torch.full_like(he, 1000.0) if T0 is None else T0
        cmc = self._cp_m_cv()
        with_e = self.energy in ("sensibleInternalEnergy",
                                 "absoluteInternalEnergy")
        for _ in range(8):
            f = self.he_from_t(T) - he
            fp = self.cp_t(T) - (cmc if with_e else 0.0)
            T = torch.clamp(T - f / torch.clamp(fp, min=1e-3), 10.0, 2e4)
        return T

    def nasa_g_rt(self, T):
        """Standard-state Gibbs energy g0/(Ru T) from the NASA-7
        coefficients (reference: janafThermo s()/ha()). janaf only."""
        if self.cp_mode != "janaf":
            raise ValueError(
                "reversible-reaction equilibrium needs janaf thermo")

        def g_of(a):
            h_rt = _polyval([a[0], a[1] / 2, a[2] / 3, a[3] / 4,
                             a[4] / 5], T) + a[5] / T
            s_r = a[0] * torch.log(T) + _polyval(
                [0.0, a[1], a[2] / 2, a[3] / 3, a[4] / 4], T) + a[6]
            return h_rt - s_r
        return torch.where(T < self.t_common, g_of(self.janaf_low),
                           g_of(self.janaf_high))

    # -- equation of state --------------------------------------------------
    def z_pr(self, p, T):
        """Peng-Robinson compressibility factor (reference: equationOf-
        State/PengRobinsonGas/PengRobinsonGasI.H:Z): the largest real root
        of the cubic, branch-free."""
        r = self.r
        a = 0.45724 * r ** 2 * self.t_crit ** 2 / self.p_crit
        b = 0.07780 * r * self.t_crit / self.p_crit
        tr = T / self.t_crit
        kappa = 0.37464 + 1.54226 * self.omega_acc \
            - 0.26992 * self.omega_acc ** 2
        alpha = (1.0 + kappa * (1.0 - torch.sqrt(tr))) ** 2
        B = b * p / (r * T)
        A = a * alpha * p / (r * T) ** 2
        a2 = B - 1.0
        a1 = A - 2.0 * B - 3.0 * B ** 2
        a0 = -A * B + B ** 2 + B ** 3
        Q = (3.0 * a1 - a2 * a2) / 9.0
        Rl = (9.0 * a2 * a1 - 27.0 * a0 - 2.0 * a2 ** 3) / 54.0
        D = Q ** 3 + Rl ** 2
        # D <= 0: three real roots, the largest
        q3 = torch.clamp(Q ** 3, max=0.0)
        th = torch.acos(torch.clamp(
            Rl / torch.sqrt(torch.clamp(-q3, min=1e-300)), -1.0, 1.0))
        qm = 2.0 * torch.sqrt(torch.clamp(-Q, min=0.0))
        r3 = torch.maximum(
            qm * torch.cos(th / 3.0),
            torch.maximum(qm * torch.cos((th + 2.0 * math.pi) / 3.0),
                          qm * torch.cos((th + 4.0 * math.pi) / 3.0))) \
            - a2 / 3.0
        # D > 0: one real root
        d05 = torch.sqrt(torch.clamp(D, min=0.0))
        r1 = _cbrt(Rl + d05) + _cbrt(Rl - d05) - a2 / 3.0
        return torch.clamp(torch.where(D <= 0.0, r3, r1), min=1e-3)

    def psi(self, T, p=None):
        if self.eos == "perfectGas":
            return 1.0 / (self.r * _max(T, 1e-10))
        if self.eos == "perfectFluid":
            return 1.0 / (self.r_eos * _max(T, 1e-10))
        if self.eos == "linear":
            return torch.full_like(T, self.psi0)
        if self.eos == "adiabaticPerfectFluid":
            # psi = drho/dp (reference: adiabaticPerfectFluidI.H:117)
            pv = self.p0_apf if p is None else p
            base = (pv + self.b_apf) / (self.p0_apf + self.b_apf)
            return (self.rho0 / (self.gamma_apf
                                 * (self.p0_apf + self.b_apf))
                    * base ** (1.0 / self.gamma_apf - 1.0)) \
                * torch.ones_like(T)
        if self.eos == "PengRobinsonGas":
            pv = self.p_ref if p is None else p
            Tc = _max(T, 1e-10)
            return 1.0 / (self.z_pr(pv, Tc) * self.r * Tc)
        return torch.zeros_like(T)

    def rho(self, p, T):
        if self.eos == "perfectGas":
            return p / (self.r * _max(T, 1e-10))
        if self.eos == "incompressiblePerfectGas":
            return self.p_ref / (self.r * _max(T, 1e-10))
        if self.eos == "perfectFluid":
            return p / (self.r_eos * _max(T, 1e-10)) + self.rho0
        if self.eos == "icoPolynomial":
            return _polyval(self.rho_poly, T)
        if self.eos == "linear":
            return self.psi0 * p + self.rho0
        if self.eos == "adiabaticPerfectFluid":
            # rho0 ((p + B)/(p0 + B))^(1/gamma) (reference:
            # adiabaticPerfectFluidI.H:105-111)
            base = (p + self.b_apf) / (self.p0_apf + self.b_apf)
            return self.rho0 * _max(base, 1e-10) \
                ** (1.0 / self.gamma_apf) * torch.ones_like(T)
        if self.eos == "PengRobinsonGas":
            Tc = _max(T, 1e-10)
            return p / (self.z_pr(p, Tc) * self.r * Tc)
        return torch.full_like(T, self.rho0)   # rhoConst

    def c_sound(self, T):
        g = self.gamma
        if self.eos == "perfectGas":
            return torch.sqrt(g * self.r * _max(T, 1e-10))
        if self.eos == "perfectFluid":
            return torch.sqrt(g * self.r_eos * _max(T, 1e-10))
        if self.eos == "PengRobinsonGas":
            Tc = _max(T, 1e-10)
            z = self.z_pr(torch.full_like(Tc, self.p_ref), Tc)
            return torch.sqrt(g * z * self.r * Tc)
        return torch.full_like(T, 1e3)

    # -- transport ----------------------------------------------------------
    def mu(self, T):
        if self.transport == "sutherland":
            return self.as_ * torch.sqrt(T) / (1.0 + self.ts / T)
        if self.transport == "polynomial":
            return _polyval(self.mu_poly, T)
        return torch.full_like(T, self.mu0)

    def alpha_h(self, T):
        """kappa/Cp, the energy equation's diffusivity."""
        if self.transport == "polynomial" and self.kappa_poly:
            return _polyval(self.kappa_poly, T) / self.cp_t(T)
        return self.mu(T) / self.pr


def _mixture_dict(props: Dictionary) -> Dictionary:
    mix = props.subdict("mixture", required=False)
    if not mix:
        for _, v in props.items():
            if isinstance(v, Dictionary) and v.lookup("specie") is not None:
                return v
        raise KeyError("thermophysicalProperties: no mixture dictionary")
    return mix


def read_specie_thermo(props: Dictionary) -> SpecieThermo:
    """Parse constant/thermophysicalProperties into the specie stack
    (reference: basicThermo::New thermoType dispatch; the thermoType
    dictionary and the 2.x string form)."""
    tt = props.lookup("thermoType", required=True)
    energy = "sensibleInternalEnergy"
    transport = "const"
    thermo_name = "hConst"
    eos = "perfectGas"
    if isinstance(tt, Dictionary):
        energy = tt.word("energy", "sensibleInternalEnergy")
        transport = tt.word("transport", "const")
        thermo_name = tt.word("thermo", "hConst")
        eos = tt.word("equationOfState", "perfectGas")
    else:
        low = str(tt if not isinstance(tt, tuple) else tt[0]).lower()
        energy = "sensibleEnthalpy" if low.startswith("h") \
            else "sensibleInternalEnergy"
        for cand in ("sutherland", "polynomial", "const"):
            if cand.lower() in low:
                transport = cand
                break
        for cand in ("janaf", "hPolynomial"):
            if cand.lower() in low:
                thermo_name = cand
        for cand in ("incompressiblePerfectGas", "adiabaticPerfectFluid",
                     "PengRobinsonGas", "perfectFluid", "rhoConst",
                     "icoPolynomial", "perfectGas"):
            if cand.lower() in low:
                eos = cand
                break
    return specie_from_mixture_dict(_mixture_dict(props), energy=energy,
                                    transport=transport,
                                    thermo_name=thermo_name, eos=eos)


def specie_from_mixture_dict(mix: Dictionary, *, energy, transport,
                             thermo_name, eos) -> SpecieThermo:
    """One SpecieThermo from a specie/thermodynamics/transport bundle
    (the pureMixture dictionary, or one entry of a multi-component
    mixture)."""
    specie = mix.subdict("specie")
    th = mix.subdict("thermodynamics")
    tr = mix.subdict("transport")
    eq = mix.subdict("equationOfState", required=False) or Dictionary()
    mw = specie.scalar("molWeight")
    kw = dict(mol_weight=mw, energy=energy, eos=eos)

    def tuple_of(d, key):
        v = d.lookup(key)
        if v is None:
            return ()
        if isinstance(v, (int, float)):
            return (float(v),)
        return tuple(float(x) for x in v)

    if th.lookup("highCpCoeffs") is not None or thermo_name == "janaf":
        kw.update(cp_mode="janaf",
                  janaf_low=tuple_of(th, "lowCpCoeffs"),
                  janaf_high=tuple_of(th, "highCpCoeffs"),
                  t_low=th.scalar("Tlow", 200.0),
                  t_high=th.scalar("Thigh", 5000.0),
                  t_common=th.scalar("Tcommon", 1000.0))
    elif th.lookup("CpCoeffs<8>") is not None \
            or th.lookup("CpCoeffs") is not None:
        kw.update(cp_mode="polynomial",
                  cp_poly=(tuple_of(th, "CpCoeffs<8>")
                           or tuple_of(th, "CpCoeffs")),
                  hf=th.scalar("Hf", 0.0))
    else:
        cp = th.scalar("Cp", 0.0) or (th.scalar("Cv", 0.0)
                                      + R_UNIVERSAL / mw)
        kw.update(cp_mode="const", cp0=cp, hf=th.scalar("Hf", 0.0))

    if tr.lookup("muCoeffs<8>") is not None \
            or tr.lookup("muCoeffs") is not None:
        kw.update(transport="polynomial",
                  mu_poly=(tuple_of(tr, "muCoeffs<8>")
                           or tuple_of(tr, "muCoeffs")),
                  kappa_poly=(tuple_of(tr, "kappaCoeffs<8>")
                              or tuple_of(tr, "kappaCoeffs")))
    elif transport == "sutherland" or tr.lookup("As") is not None:
        kw.update(transport="sutherland", as_=tr.scalar("As", 0.0),
                  ts=tr.scalar("Ts", 0.0), pr=tr.scalar("Pr", 1.0))
    else:
        kw.update(transport="const", mu0=tr.scalar("mu", 0.0),
                  pr=tr.scalar("Pr", 1.0))

    kw.update(p_ref=eq.scalar("pRef", 1e5),
              rho0=(eq.scalar("rho0", 0.0) or eq.scalar("rho", 0.0)),
              r_eos=eq.scalar("R", 0.0),
              rho_poly=(tuple_of(eq, "rhoCoeffs<8>")
                        or tuple_of(eq, "rhoCoeffs")),
              psi0=eq.scalar("psi", 0.0),
              p0_apf=eq.scalar("p0", 1e5),
              b_apf=eq.scalar("B", 0.0),
              gamma_apf=eq.scalar("gamma", 7.15),
              t_crit=eq.scalar("Tc", 0.0),
              p_crit=eq.scalar("Pc", 1e5),
              v_crit=eq.scalar("Vc", 0.0),
              z_crit=eq.scalar("Zc", 1.0),
              omega_acc=eq.scalar("omega", 0.0))
    return SpecieThermo(**kw)
