"""The port's basic solvers (solvers/basic.py), viscosity models
(models/transport.py) and nonNewtonianIcoFoam against the JAX package in
fp64 on the CPU.

- laplacianFoam (5 steps), scalarTransportFoam (5 steps, vanLeer, the
  velocity frozen) and potentialFoam (a velocity field from a numpy
  seed) on the thermal cavity of tests/test_basic_solvers.py, on the
  gdia lattice and on the padded ELL: fields to 1e-8 relative to their
  largest magnitude, every iteration count within one.
- strain_rate and each viscosity model's nu() (powerLaw, BirdCarreau,
  CrossPowerLaw, HerschelBulkley) on a velocity from a numpy seed,
  carried by interop onto the 12x12 box (gdia and ELL): cell and
  boundary values to 1e-12.
- 5 nonNewtonianIcoFoam steps (CrossPowerLaw) on the 20x20 cavity (gdia)
  against the JAX package's icofoam.run(non_newtonian=True).

Also the dispatcher's new names (32 mains), the CLI runs of the basic
solvers on the CPU, and CrankNicolson's refusal."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rapidcfd_tpu.models import transport as jtr
from rapidcfd_tpu.solvers import basic as jbasic
from rapidcfd_tpu.solvers import icofoam as jico
from rapidcfd_tpu.solvers.case import Case as JCase
from rapidcfd_tpu.utils.dictionary import parse_dictionary as jparse
from rapidcfd_tpu_torch import interop
from rapidcfd_tpu_torch.mesh.polymesh import read_polymesh
from rapidcfd_tpu_torch.models import transport as ttr
from rapidcfd_tpu_torch.solvers import basic as tbasic
from rapidcfd_tpu_torch.solvers import icofoam as tico
from rapidcfd_tpu_torch.utils.casegen import (VISCOSITY_COEFFS, cavity_case,
                                              dam_break_case,
                                              thermal_cavity_case,
                                              write_viscosity_model)
from rapidcfd_tpu_torch.utils.dictionary import parse_dictionary as tparse
from rapidcfd_tpu_torch.utils.logging import captured
from rapidcfd_tpu_torch.utils.unstructured import detect_lattice
import torch_heat_reference as R
from torch_heat_reference import (CPU, F64, cell_errors, counts_close,
                                  flux_error, jax_quiet, jax_switches,
                                  port_case, rel, run_jax, run_port)

RUN_TOL = 1e-8
TOL = 1e-12
LAYOUTS = ("gdia", "ell")


class _WholeOut(R.RecordingJax):
    """RecordingJax that hands its_of a jitted call's whole output (the
    basic solvers' perf is not their last output)."""

    def jit(self, fn, **kw):
        jitted = jax.jit(fn, **kw)

        def recorded(*a):
            out = jitted(*a)
            self.record.append(self.its_of(out))
            return out
        return recorded


def _jax_basic(fn, d, layout, steps):
    """A JAX basic solver's outputs and per-call iteration counts."""
    def its_of(out):
        perf = out[3] if fn == "run_potential_foam" else out[1]
        return [("Phi" if fn == "run_potential_foam" else "T",
                 int(perf[0][2]))]

    def run(case_dir, write, max_steps):
        f = getattr(jbasic, fn)
        return f(case_dir, write=write) if fn == "run_potential_foam" \
            else f(case_dir, write=write, max_steps=max_steps)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(R, "RecordingJax", _WholeOut)
        mp.setattr(jbasic, "run", run, raising=False)
        return run_jax(jbasic, d, steps, layout, its_of)


@pytest.fixture(scope="module")
def cavities(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("thermal"))
    dp = str(tmp_path_factory.mktemp("potential"))
    u = np.random.default_rng(5).uniform(-0.5, 0.5, (400, 2))
    with captured():
        thermal_cavity_case(d)
        thermal_cavity_case(dp, u_internal="nonuniform List<vector>\n400\n"
                            "(\n" + "\n".join(f"({a!r} {b!r} 0)"
                                               for a, b in u.tolist())
                            + "\n)\n")
    return d, dp


@pytest.fixture(scope="module", params=LAYOUTS)
def basic_runs(request, cavities):
    layout = request.param
    d, dp = cavities
    out = {}
    for fn, case_dir, steps in (("run_laplacian_foam", d, 5),
                                ("run_scalar_transport_foam", d, 5),
                                ("run_potential_foam", dp, 1)):
        jout, jits = _jax_basic(fn, case_dir, layout, steps)
        kw = {} if fn == "run_potential_foam" else dict(max_steps=steps)
        tcase = port_case(case_dir, layout)
        with captured():
            tout = getattr(tbasic, fn)(case_dir, device=CPU, dtype=F64,
                                       write=False, case=tcase, **kw)
        out[fn] = (jout, jits, tout, [s["iterations"]
                                     for s in tcase.step_log])
    return layout, out


@pytest.mark.parametrize("fn", ["run_laplacian_foam",
                                "run_scalar_transport_foam",
                                "run_potential_foam"])
def test_basic_solver_matches_jax(basic_runs, fn):
    """T (U and phi for potentialFoam) within 1e-8 of the JAX package's,
    every solve's count within one; the physics holds: T within the wall
    temperatures and heated from the lid, potentialFoam's flux
    divergence-free."""
    layout, runs = basic_runs
    (jcase, *jf), jits, (tcase, *tf), tits = runs[fn]
    assert (tcase.mesh.gdia is not None) == (layout == "gdia")
    if fn == "run_potential_foam":
        (jU, jphi), (tU, tphi) = jf, tf
        errs = cell_errors(tcase, jcase, dict(U=(tU, jU)))
        errs["phi"] = flux_error(tcase, jcase, tphi, jphi)
        assert tcase.step_log[0]["cont"] < 1e-8
        assert tits[0][0][1] > 0
    else:
        (jT,), (tT,) = jf, tf
        errs = cell_errors(tcase, jcase, dict(T=(tT, jT)))
        assert 300.0 - 1e-6 <= float(tT.data.min()) \
            and float(tT.data.max()) <= 350.0 + 1e-6
        assert float(tT.data.max()) > 301.0
    assert max(errs.values()) <= RUN_TOL, errs
    assert counts_close(tits, jits), (tits, jits)


# -- the viscosity models ------------------------------------------------------

_MODELS = VISCOSITY_COEFFS


@pytest.fixture(scope="module")
def boxes(tmp_path_factory):
    """layout -> (JAX mesh, port mesh, JAX U, port U): the 12x12 box with
    a velocity from a numpy seed."""
    box = str(tmp_path_factory.mktemp("box12"))
    with captured():
        dam_break_case(box, n=12)
    out = {}
    with jax_quiet():
        jcases = {"gdia": JCase(box, lattice=detect_lattice(
            read_polymesh(box), full_box=True))}
        with jax_switches(GDIA_AUTO="0", FORCE_RCM="1"):
            jcases["ell"] = JCase(box)
        for layout, jc in jcases.items():
            jmesh = jc.mesh
            rng = np.random.default_rng(3)
            jU = jc.read_field("U")
            jU = jU.replace(data=jnp.asarray(rng.uniform(
                -1, 1, (jmesh.n_cells, 3)))).correct_boundary_conditions(
                jmesh)
            out[layout] = (jmesh, interop.mesh_arrays(jmesh, device=CPU,
                                                      dtype=F64),
                           jU, interop.vol_field(jU, device=CPU, dtype=F64))
    return out


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("model", sorted(_MODELS) + ["Newtonian"])
def test_viscosity_model_matches_jax(boxes, layout, model):
    """nu() of the model selected from transportProperties: cell and
    boundary values (and the strain rate under them) to 1e-12; the
    non-Newtonian ones vary with the strain rate."""
    jmesh, tmesh, jU, tU = boxes[layout]
    text = (f"transportModel {model}; nu nu [0 2 -1 0 0 0 0] 1e-3; "
            + _MODELS.get(model, ""))
    jm = jtr.SinglePhaseTransportModel(jparse(text))
    tm = ttr.SinglePhaseTransportModel(tparse(text))
    assert tm.is_newtonian == (model == "Newtonian")
    with jax_quiet():
        jnu = jm.nu(jmesh, jU)
    tnu = tm.nu(tmesh, tU)
    if model == "Newtonian":
        assert tnu.value == jnu.value == 1e-3
        return
    with jax_quiet():
        jsr = jtr.strain_rate(jmesh, jU)
    tsr = ttr.strain_rate(tmesh, tU)
    for a, b in ((tsr, jsr), (tnu, jnu)):
        assert rel(a.data.numpy(), np.asarray(b.data)) <= TOL
        assert rel(a.bvalues.numpy(), np.asarray(b.bvalues)) <= TOL
    live = tnu.data[tmesh.V > 0]
    assert float(live.max()) > 1.01 * float(live.min())


def test_unknown_viscosity_model_raises():
    with pytest.raises(KeyError, match="Carreau"):
        ttr.SinglePhaseTransportModel(tparse("transportModel Carreau;"))


# -- nonNewtonianIcoFoam -------------------------------------------------------

def _ico_its(stats):
    its = [(f"U{c}", int(pf[2])) for c, pf in zip("xyz", stats["u_perf"])]
    return its + [("p", int(pf[2])) for pf in stats["p_perf"]]


@pytest.fixture(scope="module")
def non_newtonian(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("nonnewt"))
    with captured():
        cavity_case(d, end_time=0.05)
        write_viscosity_model(d, "CrossPowerLaw")
    jrun = run_jax(jico, d, 5, "gdia", _ico_its, prestore=(1,),
                   non_newtonian=True)
    return jrun, run_port(tico, d, 5, "gdia", non_newtonian=True)


def test_non_newtonian_ico_foam_matches_jax(non_newtonian):
    """U, p and phi after 5 steps within 1e-8 of the JAX package's, every
    solve's count within one; the lid's shear thins the fluid."""
    ((jcase, jU, jp, jphi), jits), ((tcase, tU, tp, tphi), tits) = \
        non_newtonian
    errs = cell_errors(tcase, jcase, dict(U=(tU, jU), p=(tp, jp)))
    errs["phi"] = flux_error(tcase, jcase, tphi, jphi)
    assert max(errs.values()) <= RUN_TOL, errs
    assert counts_close(tits, jits), (tits, jits)
    assert tcase.mesh.gdia is not None
    nu = ttr.SinglePhaseTransportModel(tcase.transport_properties()).nu(
        tcase.mesh, tU)
    assert float(nu.data.min()) < 0.99 * float(nu.data.max())


# -- the dispatcher ------------------------------------------------------------

def test_dispatcher_lists_32_mains():
    from rapidcfd_tpu_torch.__main__ import SOLVERS
    assert len(SOLVERS) == 34           # with SRFSimpleFoam, SRFPimpleFoam
    for name in ("nonNewtonianIcoFoam", "laplacianFoam",
                 "scalarTransportFoam", "potentialFoam", "porousSimpleFoam",
                 "porousInterFoam", "rhoPorousSimpleFoam", "SRFSimpleFoam",
                 "SRFPimpleFoam"):
        assert name in SOLVERS


@pytest.mark.parametrize("solver", ["laplacianFoam", "scalarTransportFoam",
                                    "potentialFoam", "nonNewtonianIcoFoam"])
def test_cli_runs_on_cpu(tmp_path, solver):
    """`python -m rapidcfd_tpu_torch <solver> -case D -device cpu
    -gdiaBox`: the run reads the gdia lattice and ends."""
    from rapidcfd_tpu_torch.__main__ import main
    d = str(tmp_path / "case")
    with captured():
        thermal_cavity_case(d)
        if solver == "nonNewtonianIcoFoam":
            write_viscosity_model(d, "powerLaw")
    with captured() as buf:
        main([solver, "-case", d, "-device", "cpu", "-gdiaBox",
              "-precision", "fp64"])
    out = buf.getvalue()
    assert "lattice 20x20x1" in out and out.rstrip().endswith("End")
    if solver == "potentialFoam":
        assert "continuity error" in out and "Solving for Phi" in out
    else:
        assert "Time = 0.05" in out


def test_crank_nicolson_raises(tmp_path):
    """CrankNicolson reads two old levels and its ddt0 state: fvm.ddt
    raises on a field stored with one level and on one without ddt0
    (laplacianFoam and scalarTransportFoam store both and run the scheme:
    test_crank_nicolson_laplacian_matches_jax)."""
    from rapidcfd_tpu_torch.ops import fvm as tfvm
    d = str(tmp_path / "cn")
    with captured():
        thermal_cavity_case(d)
    case = port_case(d, "gdia")
    T = case.read_field("T")
    with pytest.raises(ValueError, match="CrankNicolson"):
        tfvm.ddt(case.mesh, T.store_old(), 0.01, ("CrankNicolson", 0.9))
    with pytest.raises(ValueError, match="ddt0"):
        tfvm.ddt(case.mesh, T.store_old(levels=2), 0.01,
                 ("CrankNicolson", 0.9))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_crank_nicolson_laplacian_matches_jax(tmp_path, layout):
    """5 laplacianFoam steps with CrankNicolson 0.9 at constant dt: T
    within 1e-8 of the JAX package's (its basic solvers keep two levels
    and the ddt0 state under CrankNicolson), counts within one."""
    d = str(tmp_path / "cn")
    with captured():
        thermal_cavity_case(d)
    path = os.path.join(d, "system", "fvSchemes")
    text = open(path).read().replace("default Euler;",
                                     "default CrankNicolson 0.9;")
    with open(path, "w") as f:
        f.write(text)
    (jcase, jT), jits = _jax_basic("run_laplacian_foam", d, layout, 5)
    tcase = port_case(d, layout)
    with captured():
        _, tT = tbasic.run_laplacian_foam(d, device=CPU, dtype=F64,
                                          write=False, max_steps=5,
                                          case=tcase)
    assert tT.levels == 2 and int(tT.ddt0[2]) == 5
    assert cell_errors(tcase, jcase, dict(T=(tT, jT)))["T"] <= RUN_TOL
    assert counts_close([s["iterations"] for s in tcase.step_log], jits)
