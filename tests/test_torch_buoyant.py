"""The port's full-density heat-transfer solvers against the JAX package
in fp64 on the CPU, on the cavities and the channel of
tests/test_heattransfer.py (written by the port's case writers, 2-D
gdia): buoyantSimpleFoam (closed volume: the pressure-level adjustment),
buoyantSimpleFoam with P1 radiation and Marshak walls and
buoyantPimpleFoam (also on the padded ELL), and thermoFoam (ELL); 3
iterations or steps each.

p_rgh, p, T, rho and G within 1e-8 of the JAX package's, relative to
their largest magnitude, and every solve's iteration count within one.
U and the mass flux phi within 1e-6: these solvers carry p_rgh at its
absolute level (1e5 Pa), so one rounding of p_rgh (1.5e-11 Pa) moves
the velocity the pressure gradient drives by ~1e-7 of its largest value
in these cavities; the JAX package's own jitted and eager evaluations of
the buoyantSimpleFoam cavity part by 1.2e-7 in U after 3 iterations,
and the port follows its eager evaluation to the last bit through the
first 2 (measured: U 6e-8 to 1.2e-7 after 3, phi 1.5e-7 to 3.7e-7).
Each JAX run happens once, in a module-scoped fixture.
"""

import pytest

from rapidcfd_tpu.solvers import buoyantpimplefoam as jbp
from rapidcfd_tpu.solvers import buoyantsimplefoam as jbs
from rapidcfd_tpu.solvers import thermofoam as jtf
from rapidcfd_tpu_torch.solvers import buoyantpimplefoam as tbp
from rapidcfd_tpu_torch.solvers import buoyantsimplefoam as tbs
from rapidcfd_tpu_torch.solvers import thermofoam as ttf
from rapidcfd_tpu_torch.utils.casegen import (heated_cavity_case,
                                              thermo_channel_case)
from torch_heat_reference import (cell_errors, counts_close, flux_error,
                                  run_jax, run_port)

#: the velocity-like fields' bound (see the module docstring)
U_RTOL = 1e-6


def _its(stats):
    """A JAX full-density step's iteration counts, in the port's order."""
    its = [(f"U{c}", int(pf[2])) for c, pf in zip("xyz", stats["u_perf"])]
    if stats.get("g_perf") is not None:
        its.append(("G", int(stats["g_perf"][0][2])))
    its.append(("h", int(stats["h_perf"][0][2])))
    return its + [("p_rgh", int(pf[2])) for pf in stats["p_perf"]]


def _pair(tmp_path_factory, name, solver, radiation=False, layout="gdia"):
    d = str(tmp_path_factory.mktemp(name))
    heated_cavity_case(d, solver, radiation)
    jm, tm, prestore = ((jbs, tbs, ()) if solver == "buoyantSimpleFoam"
                        else (jbp, tbp, (0, 2, 3, 4)))
    return (run_jax(jm, d, 3, layout, _its, prestore=prestore),
            run_port(tm, d, 3, layout))


@pytest.fixture(scope="module")
def simple_cavity(tmp_path_factory):
    return _pair(tmp_path_factory, "bsf", "buoyantSimpleFoam")


@pytest.fixture(scope="module")
def p1_cavity(tmp_path_factory):
    return _pair(tmp_path_factory, "bsf_p1", "buoyantSimpleFoam", True)


@pytest.fixture(scope="module")
def pimple_cavity(tmp_path_factory):
    return _pair(tmp_path_factory, "bpf", "buoyantPimpleFoam")


@pytest.fixture(scope="module")
def pimple_cavity_ell(tmp_path_factory):
    return _pair(tmp_path_factory, "bpf_ell", "buoyantPimpleFoam",
                 layout="ell")


@pytest.mark.parametrize("run", ["simple_cavity", "p1_cavity",
                                 "pimple_cavity", "pimple_cavity_ell"])
def test_buoyant_matches_jax(run, request):
    (jout, jits), (tout, tits) = request.getfixturevalue(run)
    jcase, jU, jp_rgh, jT, jp, jrho, jphi = jout
    tcase, tU, tp_rgh, tT, tp, trho, tphi = tout
    assert (tcase.mesh.gdia is None) == run.endswith("_ell")
    errs = cell_errors(tcase, jcase, dict(p_rgh=(tp_rgh, jp_rgh), T=(tT, jT),
                                          p=(tp, jp), rho=(trho, jrho)))
    assert max(errs.values()) <= 1e-8, errs
    u_errs = cell_errors(tcase, jcase, dict(U=(tU, jU)))
    u_errs["phi"] = flux_error(tcase, jcase, tphi, jphi)
    assert max(u_errs.values()) <= U_RTOL, u_errs
    assert counts_close(tits, jits), (tits, jits)
    assert float(tU.data.abs().max()) > 0.0


def test_p1_radiation_field(p1_cavity):
    """The P1 case's G after 3 iterations (the JAX package returns it only
    through its step) by one more G solve of both packages from the
    compared T: within 1e-8; G near the cavity's blackbody level."""
    from rapidcfd_tpu.models.radiation import make_radiation_model as jmake
    from rapidcfd_tpu_torch import interop
    from rapidcfd_tpu_torch.fields.bcs import SIGMA_SB
    from rapidcfd_tpu_torch.models.radiation import make_radiation_model
    from rapidcfd_tpu_torch.utils.logging import captured
    from torch_heat_reference import CPU, F64, jax_quiet
    (jout, _), (tout, _) = p1_cavity
    jcase, tcase = jout[0], tout[0]
    with jax_quiet(), captured():
        jrad, trad = jmake(jcase), make_radiation_model(tcase)
        jG, _ = jrad.correct(jcase.mesh, jcase.read_field("G", "0"),
                             jout[3])
        tG, perf = trad.correct(tcase.mesh, tcase.read_field("G", "0"),
                                interop.vol_field(jout[3], device=CPU,
                                                  dtype=F64))
    assert cell_errors(tcase, jcase, dict(G=(tG, jG)))["G"] <= 1e-8
    g_bb = 4.0 * SIGMA_SB * 300.0 ** 4
    assert 0.5 * g_bb < float(tcase.G.data.mean()) < 1.5 * g_bb
    assert int(perf[0][2]) > 0


def test_thermofoam_matches_jax(tmp_path):
    d = str(tmp_path / "channel")
    thermo_channel_case(d)
    (jcase, jT), jits = run_jax(jtf, d, 3, "ell",
                                lambda perf: [("h", int(perf[0][2]))])
    (tcase, tT), tits = run_port(ttf, d, 3, "ell")
    assert cell_errors(tcase, jcase, dict(T=(tT, jT)))["T"] <= 1e-8
    assert counts_close(tits, jits), (tits, jits)
    assert float(tT.data.max()) > 300.0


def test_buoyant_solvers_refuse_turbulence(tmp_path):
    """The full-density buoyant solvers are laminar in the JAX package,
    which ignores a RAS model; the port refuses one."""
    from rapidcfd_tpu_torch.utils.casegen import _write_dict
    d = str(tmp_path / "cavity")
    heated_cavity_case(d, "buoyantPimpleFoam")
    _write_dict(d, "constant", "RASProperties",
                "\nRASModel kEpsilon;\nturbulence on;\n")
    with pytest.raises(NotImplementedError, match="laminar"):
        run_port(tbp, d, 1, "gdia")
