"""The port's general specie thermo stack (models/thermo.py SpecieThermo)
against the JAX package's in fp64 on the CPU: Cp, the energy forms, T
from the energy by the fixed 8-iteration Newton inversion, the equations
of state and the transport laws of every model tests/test_thermo_stack.py
covers, on seeded T and p arrays, to 1e-12; read_thermo's dispatch on
the thermoType dictionary and string forms; the radiation model factory;
and 3 rhoPimpleFoam steps with the janaf gas of test_thermo_stack.py:
125-172 on the transient heated channel (ELL), fields to 1e-8 relative,
iteration counts within one (the JAX package with XLA's optimisations
off, for its compile time only). test_thermo_stack.py runs that gas on
hot_channel_case's steady dictionaries (steadyState ddt, so no ddt(psi
p) term, and mu 0), where the first p solve's GAMG count swings with
rounding (the port 42, the JAX package 17, with every field still within
1e-8 after 3 steps); the transient channel's dictionaries are the ones
rhoPimpleFoam is written for."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapidcfd_tpu.models import thermo as jth
from rapidcfd_tpu.solvers import rhopimplefoam as jrp
from rapidcfd_tpu.utils.dictionary import parse_dictionary as jparse
from rapidcfd_tpu_torch.models import thermo as tth
from rapidcfd_tpu_torch.solvers import rhopimplefoam as trp
from rapidcfd_tpu_torch.utils.casegen import (_write_dict,
                                              transient_hot_channel_case)
from rapidcfd_tpu_torch.utils.dictionary import parse_dictionary as tparse
from torch_heat_reference import (cell_errors, counts_close, flux_error,
                                  rel, run_jax, run_port)

N2_LOW = (3.298677, 0.0014082404, -3.963222e-06, 5.641515e-09,
          -2.444854e-12, -1020.8999, 3.950372)
N2_HIGH = (2.92664, 0.0014879768, -5.68476e-07, 1.0097038e-10,
           -6.753351e-15, -922.7977, 5.980528)

#: the models of tests/test_thermo_stack.py, as SpecieThermo keywords
_MODELS = {
    **{f"janaf_{e}": dict(mol_weight=28.0134, cp_mode="janaf",
                          janaf_low=N2_LOW, janaf_high=N2_HIGH, energy=e,
                          transport="sutherland", as_=1.458e-6, ts=110.4)
       for e in ("sensibleEnthalpy", "sensibleInternalEnergy",
                 "absoluteEnthalpy", "absoluteInternalEnergy")},
    "polynomial": dict(mol_weight=28.9, cp_mode="polynomial",
                       cp_poly=(1000.0, 0.05), transport="polynomial",
                       mu_poly=(1e-5, 1e-8), kappa_poly=(0.02, 1e-5),
                       energy="sensibleEnthalpy"),
    "incompressiblePerfectGas": dict(mol_weight=28.9,
                                     eos="incompressiblePerfectGas",
                                     p_ref=1e5, mu0=1.8e-5, pr=0.7),
    "icoPolynomial": dict(mol_weight=18.0, eos="icoPolynomial",
                          rho_poly=(1000.0, -0.1), cp0=4180.0),
    "linear": dict(mol_weight=18.0, eos="linear", psi0=1e-5, rho0=500.0),
    "rhoConst": dict(mol_weight=18.0, eos="rhoConst", rho0=999.0,
                     energy="sensibleEnthalpy"),
    "perfectFluid": dict(mol_weight=18.0, eos="perfectFluid", r_eos=3000.0,
                         rho0=1027.0),
    "adiabaticPerfectFluid": dict(mol_weight=18.0,
                                  eos="adiabaticPerfectFluid", rho0=1000.0,
                                  p0_apf=1e5, b_apf=3.0e8, gamma_apf=7.15),
    "PengRobinsonGas": dict(mol_weight=44.01, eos="PengRobinsonGas",
                            t_crit=304.13, p_crit=7.377e6, v_crit=9.412e-5,
                            z_crit=0.274, omega_acc=0.2239, p_ref=1e5,
                            cp0=846.0),
}


@pytest.mark.parametrize("name", sorted(_MODELS))
def test_specie_thermo_matches_jax(name):
    """Every property of the model on seeded T in [250, 3000] K (across
    the janaf ranges' common temperature) and p in [0.5, 60] bar, and T
    back from the energy from a seeded first guess, to 1e-12."""
    kw = _MODELS[name]
    jm, tm = jth.SpecieThermo(**kw), tth.SpecieThermo(**kw)
    rng = np.random.default_rng(sum(map(ord, name)))
    T = rng.uniform(250.0, 3000.0, 64)
    p = rng.uniform(5e4, 6e6, 64)
    T0 = T * rng.uniform(0.7, 1.3, 64)
    jT, jp, tT, tp = (jnp.asarray(T), jnp.asarray(p), torch.tensor(T),
                      torch.tensor(p))
    for fn in ("cp_t", "he_from_t", "mu", "alpha_h", "psi", "c_sound"):
        a = getattr(tm, fn)(tT)
        b = getattr(jm, fn)(jT)
        assert rel(a.numpy(), np.asarray(b)) <= 1e-12, fn
    assert rel(tm.rho(tp, tT).numpy(), np.asarray(jm.rho(jp, jT))) <= 1e-12
    assert rel(tm.psi(tT, tp).numpy(), np.asarray(jm.psi(jT, jp))) <= 1e-12
    he = jm.he_from_t(jT)
    a = tm.t_from_he(torch.tensor(np.asarray(he)), T0=torch.tensor(T0))
    b = jm.t_from_he(he, T0=jnp.asarray(T0))
    assert rel(a.numpy(), np.asarray(b)) <= 1e-12
    if tm.cp_mode != "const":
        assert rel(a.numpy(), T) <= 1e-9      # 8 Newton iterations suffice
    for attr in ("r", "cp", "cv", "gamma"):
        assert abs(getattr(tm, attr) - getattr(jm, attr)) \
            <= 1e-12 * abs(getattr(jm, attr)), attr
    if tm.cp_mode == "janaf":
        assert rel(tm.nasa_g_rt(tT).numpy(),
                   np.asarray(jm.nasa_g_rt(jT))) <= 1e-12
    if tm.eos == "PengRobinsonGas":
        assert rel(tm.z_pr(tp, tT).numpy(),
                   np.asarray(jm.z_pr(jp, jT))) <= 1e-12


_JANAF_DICT = """
thermoType
{
    type            hePsiThermo;
    mixture         pureMixture;
    transport       sutherland;
    thermo          janaf;
    equationOfState perfectGas;
    specie          specie;
    energy          sensibleEnthalpy;
}
mixture
{
    specie { nMoles 1; molWeight 28.0134; }
    thermodynamics
    {
        Tlow 100; Thigh 5000; Tcommon 1000;
        highCpCoeffs ( 2.92664 0.0014879768 -5.68476e-07 1.0097038e-10
                       -6.753351e-15 -922.7977 5.980528 );
        lowCpCoeffs  ( 3.298677 0.0014082404 -3.963222e-06 5.641515e-09
                       -2.444854e-12 -1020.8999 3.950372 );
    }
    transport { As 1.458e-06; Ts 110.4; }
}
"""

_PR_DICT = """
thermoType
{
    type            hePsiThermo;
    mixture         pureMixture;
    transport       const;
    thermo          hConst;
    equationOfState PengRobinsonGas;
    specie          specie;
    energy          sensibleEnthalpy;
}
mixture
{
    specie { nMoles 1; molWeight 44.01; }
    equationOfState { Tc 304.13; Pc 7.377e6; Vc 9.412e-5;
                      Zc 0.274; omega 0.2239; }
    thermodynamics { Cp 846; Hf 0; }
    transport { mu 1.48e-05; Pr 0.76; }
}
"""

_POLY_STRING = """
thermoType hPolynomialThermo<polynomialTransport<icoPolynomial>>;
mixture
{
    specie { nMoles 1; molWeight 18.0; }
    equationOfState { rhoCoeffs<8> ( 1000 -0.1 0 0 0 0 0 0 ); }
    thermodynamics { Hf 0; Sf 0; CpCoeffs<8> ( 4180 0.5 0 0 0 0 0 0 ); }
    transport { muCoeffs<8> ( 1e-3 -1e-6 0 0 0 0 0 0 );
                kappaCoeffs<8> ( 0.6 1e-4 0 0 0 0 0 0 ); }
}
"""


@pytest.mark.parametrize("text", [_JANAF_DICT, _PR_DICT, _POLY_STRING],
                         ids=["janaf", "PengRobinson", "polynomial-string"])
def test_read_thermo_dispatch_matches_jax(text):
    """read_thermo and read_specie_thermo give the JAX package's bundle,
    field for field. read_thermo takes the specie stack for janaf and
    the polynomials; like the JAX package's, it keeps the perfect-gas
    bundle for a PengRobinsonGas dictionary (its _wants_general_stack
    does not name that equation of state; ROADMAP Queue 3), which
    read_specie_thermo reads in full."""
    def fields(m):
        return {k: getattr(m, k) for k in m.__dataclass_fields__}
    a, b = tth.read_thermo(tparse(text)), jth.read_thermo(jparse(text))
    assert type(a).__name__ == type(b).__name__
    assert fields(a) == fields(b)
    assert isinstance(a, tth.PerfectGasThermo) == ("PengRobinson" in text)
    a = tth.read_specie_thermo(tparse(text))
    assert fields(a) == fields(jth.read_specie_thermo(jparse(text)))
    if "PengRobinson" in text:
        assert a.eos == "PengRobinsonGas" and a.t_crit == 304.13


def test_radiation_factory(tmp_path):
    """none and no file give no model; P1 reads its coefficients; fvDOM,
    opaqueSolid and viewFactor raise naming the model."""
    from rapidcfd_tpu_torch.models.radiation import (P1Radiation,
                                                     make_radiation_model)
    from rapidcfd_tpu_torch.utils.casegen import heated_cavity_case
    from rapidcfd_tpu_torch.utils.logging import captured
    from torch_heat_reference import port_case
    d = str(tmp_path / "p1")
    heated_cavity_case(d, radiation=True)
    case = port_case(d, "gdia")
    with captured():
        rad = make_radiation_model(case)
    assert isinstance(rad, P1Radiation)
    assert (rad.a, rad.e, rad.E, rad.sigma_s) == (0.5, 0.5, 0.0, 0.0)
    path = os.path.join(d, "constant", "radiationProperties")
    text = open(path).read()
    for name in ("fvDOM", "opaqueSolid", "viewFactor"):
        open(path, "w").write(text.replace("radiationModel  P1",
                                           f"radiationModel  {name}"))
        with pytest.raises(NotImplementedError, match=name):
            make_radiation_model(case)
    open(path, "w").write(text.replace("radiationModel  P1",
                                       "radiationModel  none"))
    assert make_radiation_model(case) is None
    os.remove(path)
    assert make_radiation_model(case) is None


_JANAF_CHANNEL = """
thermoType
{
    type            hePsiThermo;
    mixture         pureMixture;
    transport       const;
    thermo          janaf;
    equationOfState perfectGas;
    specie          specie;
    energy          sensibleInternalEnergy;
}
mixture
{
    specie { nMoles 1; molWeight 11640.3; }
    thermodynamics
    {
        Tlow 100; Thigh 5000; Tcommon 1000;
        highCpCoeffs ( 3.5 1e-4 0 0 0 0 0 );
        lowCpCoeffs  ( 3.5 1e-4 0 0 0 0 0 );
    }
    transport { mu 0; Pr 1; }
}
"""


def _rho_its(stats):
    its = [(f"U{c}", int(pf[2])) for c, pf in zip("xyz", stats["u_perf"])]
    its.append(("h", int(stats["h_perf"][0][2])))
    its += [("p", int(pf[2])) for pf in stats["p_perf"]]
    return its + [(k, int(pf[2])) for k, pf in sorted(stats["turb"].items())]


def test_rhopimplefoam_janaf_matches_jax(tmp_path, monkeypatch):
    """3 rhoPimpleFoam steps on the transient heated channel with the
    janaf gas of tests/test_thermo_stack.py (sensible internal energy, T
    by the Newton inversion in the loop), on the ELL: U, p, T, rho and phi
    within 1e-8, iteration counts within one."""
    d = str(tmp_path / "janaf")
    transient_hot_channel_case(d)
    _write_dict(d, "constant", "thermophysicalProperties", _JANAF_CHANNEL)
    record = []
    orig = jrp.make_step

    def make_step(*a, **k):
        step = orig(*a, **k)

        def recorded(U, p, T, rho, *rest):
            if U.old is None:
                U, p, T, rho = (f.store_old() for f in (U, p, T, rho))
            out = step(U, p, T, rho, *rest)
            record.append(_rho_its(out[-1]))
            return out
        return recorded
    monkeypatch.setattr(jrp, "make_step", make_step)
    (jcase, jU, jp, jT, jrho, jphi), _ = run_jax(jrp, d, 3, "ell",
                                                 lambda st: None)
    (tcase, tU, tp, tT, trho, tphi), tits = run_port(trp, d, 3, "ell")
    assert isinstance(tth.read_thermo(tcase.constant_dict(
        "thermophysicalProperties")), tth.SpecieThermo)
    errs = cell_errors(tcase, jcase, dict(U=(tU, jU), p=(tp, jp), T=(tT, jT),
                                          rho=(trho, jrho)))
    errs["phi"] = flux_error(tcase, jcase, tphi, jphi)
    assert max(errs.values()) <= 1e-8, errs
    assert counts_close(tits, record), (tits, record)
    assert 250.0 < float(tT.data.min()) and float(tT.data.max()) < 500.0
