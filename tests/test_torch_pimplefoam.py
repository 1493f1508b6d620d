"""The port's pimpleFoam/pisoFoam slice against the JAX package in fp64 on
the CPU. Both packages read the same case directories, written by the
port's case writers; random inputs come from numpy seeds.

- Each open-boundary BC (mixed, noSlip, inletOutlet, totalPressure,
  uniformTotalPressure, pressureInletOutletVelocity,
  flowRateInletVelocity and the three turbulence inlet estimators): its
  evaluate, value_internal_coeff and gradient_internal_coeff on a patch
  whose face flux has both signs, with the env the solvers pass and
  without one, to 1e-12 relative.
- KEpsilon.correct(dt=) and KOmegaSST.correct(dt=) on a flowing
  T-junction state carried from the JAX package: k, epsilon or omega and
  nut to 1e-8 relative, iteration counts within one, the old time level
  stored.
- 10 pimpleFoam steps of the open channel of tests/test_open_boundaries.py
  (flowRateInletVelocity in, totalPressure out, laminar), 10 pisoFoam
  steps of the cavity of tests/test_basic_solvers.py, and 5 adaptive
  steps of the small T-junction (kEpsilon, the open-boundary set) on the
  gdia lattice and on the padded ELL: fields to 1e-8 relative to their
  largest magnitude, iteration counts within one per solve, the dt
  sequence to 1e-12.

The JAX package logs only the last pressure corrector's p solves; the
port logs every one, so the JAX counts are held against the port's last
ones. The T-junction's maxCo is small so that the Courant limit sets dt
from the third step on."""

import contextlib
import os

import jax
import numpy as np
import pytest
import torch

from rapidcfd_tpu.fields import bcs as jbcs
from rapidcfd_tpu.fields.field import SurfaceField as JSurface
from rapidcfd_tpu.fields.field import VolField as JVol
from rapidcfd_tpu.models.transport import \
    SinglePhaseTransportModel as JTransport
from rapidcfd_tpu.models.turbulence import make_ras_model as jmake_ras
from rapidcfd_tpu.solvers import pimplefoam as jpimple
from rapidcfd_tpu.solvers.case import Case as JCase
from rapidcfd_tpu.utils import logging as jlog
from rapidcfd_tpu.utils import switches
from rapidcfd_tpu.utils.dimensions import dimless as jdimless
from rapidcfd_tpu_torch import interop
from rapidcfd_tpu_torch.fields import bcs as tbcs
from rapidcfd_tpu_torch.fields.field import Dimensioned as TDimensioned
from rapidcfd_tpu_torch.models.turbulence import (KEpsilon, KOmegaSST,
                                                  make_ras_model)
from rapidcfd_tpu_torch.solvers import pimplefoam as tpimple
from rapidcfd_tpu_torch.solvers.case import Case
from rapidcfd_tpu_torch.utils.casegen import (_write, box_mesh,
                                              cavity_case, tjunction_case,
                                              write_field)
from rapidcfd_tpu_torch.utils.dictionary import foamfile_header
from rapidcfd_tpu_torch.utils.dimensions import DimensionSet
from rapidcfd_tpu_torch.mesh.polymesh import write_polymesh
from rapidcfd_tpu_torch.utils.logging import captured

CPU = torch.device("cpu")
F64 = torch.float64
_SMALL_TJ = dict(section=4, leg=12, bar=12, depth=4, delta_t=1e-3,
                 max_co=0.02, end_time=10.0)


@contextlib.contextmanager
def jax_switches(**env):
    """Set RCFD_<name> for the JAX package, clearing its switch cache on
    the way in and out."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv("RCFD_" + k, v)
            switches._CACHE.pop(k, None)
        try:
            yield
        finally:
            for k in env:
                switches._CACHE.pop(k, None)


def _jax_its(stats):
    its = [(f"U{c}", int(pf[2])) for c, pf in zip("xyz", stats["u_perf"])]
    its += [("p", int(pf[2])) for pf in stats["p_perf"]]
    return its + [(k, int(pf[2])) for k, pf in sorted(stats["turb"].items())]


def _run_jax(d, steps, piso=False, **env):
    """jpimple.run on a case, recording each step's dt and stats. An ELL
    mesh takes RCM always (RCFD_FORCE_RCM=1), as in the port, so both
    packages share one device order."""
    env.setdefault("FORCE_RCM", "1")
    record = []
    orig = jpimple.make_step

    def make_step(case, transport, turb, ctrl, piso_mode):
        if case.mesh.gdia is None:
            # the JAX package pins p at the device row pRefCell names
            # (ROADMAP Queue 3); give it the row the port maps the file
            # label to
            perm = np.asarray(case.maps.cell_perm)
            ctrl.p_ref_cell = int(np.nonzero(perm == ctrl.p_ref_cell)[0][0])
        step = orig(case, transport, turb, ctrl, piso_mode)

        def recorded(U, p, phi, ts, dt):
            # the step's outputs carry old time levels its first inputs
            # lack, which would compile it twice; every old level is
            # overwritten (U, k, epsilon) or unread (nut), so give them
            # one from the start
            if U.old is None:
                U = U.store_old()
                ts = {k: v.store_old() for k, v in ts.items()}
            out = step(U, p, phi, ts, dt)
            record.append(dict(dt=float(dt), iterations=_jax_its(out[4]),
                               co=float(out[4]["co"][1])))
            return out
        return recorded
    jpimple.make_step = make_step
    old = jlog.Info.enabled
    jlog.Info.enabled = False
    try:
        with jax_switches(**env):
            case, U, p, phi, ts = jpimple.run(d, write=False,
                                              max_steps=steps,
                                              piso_mode=piso)
    finally:
        jpimple.make_step = orig
        jlog.Info.enabled = old
    return case, dict(U=U, p=p, phi=phi, **ts), record


def _run_port(d, steps, piso=False, gdia=True):
    with captured():
        case = Case(d, device=CPU, dtype=F64, gdia_auto=gdia)
        case, U, p, phi, ts = tpimple.run(d, device=CPU, dtype=F64,
                                          write=False, max_steps=steps,
                                          piso_mode=piso, case=case)
    return case, dict(U=U, p=p, phi=phi, **ts), case.step_log


def _field_errors(jrun, trun):
    """name -> largest difference relative to the largest magnitude;
    cells in file order; phi in file order and orientation on gdia
    meshes (where the port keeps it in slot orientation), in the device
    order both packages share on ELL meshes (the JAX package's
    faces_to_file loses the orientation under RCM)."""
    jcase, jf, _ = jrun
    tcase, tf, _ = trun
    out = {}
    for name, jv in jf.items():
        a, b = tf[name].data.numpy(), np.asarray(jv.data)
        if name != "phi":
            a, b = tcase.maps.cells_to_file(a), jcase.maps.cells_to_file(b)
        elif tcase.mesh.gdia is not None:
            nf = tcase.maps.n_file_faces
            a = tcase.maps.faces_to_file(a, flux=True)
            b = jcase.maps.faces_to_file(b)[:nf]
        assert a.shape == b.shape and np.isfinite(a).all()
        out[name] = np.abs(a - b).max() / np.abs(b).max()
    return out


def _check_steps(jlog_, tlog_):
    assert len(jlog_) == len(tlog_)
    for j, t in zip(jlog_, tlog_):
        assert abs(t["dt"] - j["dt"]) <= 1e-12 * j["dt"]
        jits, tits = j["iterations"], t["iterations"]
        jp = [n for f, n in jits if f == "p"]
        tp = [n for f, n in tits if f == "p"]
        assert len(tp) >= len(jp) and len(jp) > 0
        pairs = [(n1, n2) for (f, n1), (_, n2) in zip(
            [x for x in jits if x[0] != "p"],
            [x for x in tits if x[0] != "p"])]
        pairs += list(zip(jp, tp[len(tp) - len(jp):]))
        assert [f for f, _ in jits if f != "p"] == \
            [f for f, _ in tits if f != "p"]
        assert all(abs(a - b) <= 1 for a, b in pairs), (jits, tits)


# -- the solver runs ----------------------------------------------------------

@pytest.fixture(scope="module")
def tjunction(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tjunction"))
    tjunction_case(d, **_SMALL_TJ)
    return d


@pytest.fixture(scope="module")
def tj_gdia(tjunction):
    return _run_jax(tjunction, 5), _run_port(tjunction, 5)


@pytest.fixture(scope="module")
def tj_ell(tjunction):
    return (_run_jax(tjunction, 5, GDIA_AUTO="0"),
            _run_port(tjunction, 5, gdia=False))


def _open_channel(d):
    """tests/test_open_boundaries.py's channel, written by the port."""
    write_polymesh(box_mesh(30, 8, 1, size=(0.3, 0.05, 0.01), patch_spec={
        "xmin": ("inlet", "patch"), "xmax": ("outlet", "patch"),
        "ymin": ("walls", "wall"), "ymax": ("walls", "wall"),
        "zmin": ("frontAndBack", "empty"),
        "zmax": ("frontAndBack", "empty")}), d)
    _write(os.path.join(d, "system", "controlDict"),
           foamfile_header("dictionary", "controlDict", "system"), """
application pimpleFoam; startFrom startTime; startTime 0;
stopAt endTime; endTime 0.05; deltaT 0.001;
writeControl timeStep; writeInterval 1000; writeFormat ascii;
""")
    _write(os.path.join(d, "system", "fvSchemes"),
           foamfile_header("dictionary", "fvSchemes", "system"), """
ddtSchemes { default Euler; }
gradSchemes { default Gauss linear; }
divSchemes { default none; div(phi,U) Gauss upwind; }
laplacianSchemes { default Gauss linear orthogonal; }
interpolationSchemes { default linear; }
snGradSchemes { default orthogonal; }
""")
    _write(os.path.join(d, "system", "fvSolution"),
           foamfile_header("dictionary", "fvSolution", "system"), """
solvers
{
    p { solver PCG; preconditioner DIC; tolerance 1e-07; relTol 0.01; }
    pFinal { solver PCG; preconditioner DIC; tolerance 1e-07; relTol 0; }
    U { solver smoothSolver; smoother symGaussSeidel; tolerance 1e-06;
        relTol 0; }
}
PIMPLE { nOuterCorrectors 1; nCorrectors 2;
         nNonOrthogonalCorrectors 0; momentumPredictor yes; }
""")
    _write(os.path.join(d, "constant", "transportProperties"),
           foamfile_header("dictionary", "transportProperties", "constant"),
           "\nnu              nu [0 2 -1 0 0 0 0] 1e-05;\n")
    _laminar(d)
    write_field(d, "0", "U", "volVectorField", "[0 1 -1 0 0 0 0]",
                "uniform (0.1 0 0)", {
                    "inlet":
                        "        type            flowRateInletVelocity;\n"
                        "        volumetricFlowRate 5e-05;\n"
                        "        value           uniform (0.1 0 0);\n",
                    "outlet": "        type            zeroGradient;\n",
                    "walls": "        type            fixedValue;\n"
                             "        value           uniform (0 0 0);\n",
                    "frontAndBack": "        type            empty;\n"})
    write_field(d, "0", "p", "volScalarField", "[0 2 -2 0 0 0 0]",
                "uniform 0", {
                    "inlet": "        type            zeroGradient;\n",
                    "outlet": "        type            totalPressure;\n"
                              "        p0              uniform 0;\n"
                              "        value           uniform 0;\n",
                    "walls": "        type            zeroGradient;\n",
                    "frontAndBack": "        type            empty;\n"})


def _laminar(d):
    _write(os.path.join(d, "constant", "RASProperties"),
           foamfile_header("dictionary", "RASProperties", "constant"),
           "\nRASModel        laminar;\nturbulence      off;\n")


@pytest.fixture(scope="module")
def open_channel(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("open"))
    _open_channel(d)
    return _run_jax(d, 10), _run_port(d, 10)


@pytest.fixture(scope="module")
def piso_cavity(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("piso"))
    cavity_case(d, end_time=0.05)
    _laminar(d)
    return _run_jax(d, 10, piso=True), _run_port(d, 10, piso=True)


_RUNS = {"tj_gdia": ("U", "p", "phi", "k", "epsilon", "nut"),
         "tj_ell": ("U", "p", "phi", "k", "epsilon", "nut"),
         "open_channel": ("U", "p", "phi"),
         "piso_cavity": ("U", "p", "phi")}


@pytest.mark.parametrize("run", sorted(_RUNS))
def test_fields_match_jax(run, request):
    jrun, trun = request.getfixturevalue(run)
    err = _field_errors(jrun, trun)
    assert sorted(err) == sorted(_RUNS[run])
    assert max(err.values()) <= 1e-8, err


@pytest.mark.parametrize("run", sorted(_RUNS))
def test_steps_match_jax(run, request):
    """Per step: dt to 1e-12, every solve's iterations within one."""
    (_, _, jsteps), (_, _, tsteps) = request.getfixturevalue(run)
    _check_steps(jsteps, tsteps)


def test_tjunction_layouts_and_courant_limit(tj_gdia, tj_ell):
    """The T-junction runs on the gdia lattice by default and on the
    padded ELL without gdia_auto; the Courant limit cuts dt in both."""
    (_, _, jsteps), (tcase, tf, tsteps) = tj_gdia
    assert tcase.mesh.gdia is not None and tj_ell[1][0].mesh.gdia is None
    dts = [s["dt"] for s in tsteps]
    assert dts[1] == pytest.approx(1.2 * dts[0]) and dts[-1] < dts[-2]
    assert all(s["co"][1] <= 1.5 * 0.02 for s in tsteps[3:])
    assert float(tf["k"].data.min()) > 0
    assert float(tf["epsilon"].data.min()) > 0


def test_open_channel_outlet_carries_the_inflow(open_channel):
    """Mass through the open boundaries: the outlet flux is the inlet's
    volumetric flow rate."""
    _, (tcase, tf, _) = open_channel
    phi = tf["phi"].data
    flux = {p.name: float(phi[p.start:p.start + p.size].sum())
            for p in tcase.mesh.patches}
    assert flux["inlet"] == pytest.approx(-5e-5, rel=1e-9)
    assert flux["outlet"] == pytest.approx(5e-5, rel=1e-6)


# -- the boundary conditions -------------------------------------------------

_BC_CASES = [
    ("mixed", 1), ("mixed", 3), ("noSlip", 3), ("inletOutlet", 1),
    ("inletOutlet", 3), ("totalPressure", 1), ("uniformTotalPressure", 1),
    ("pressureInletOutletVelocity", 3), ("flowRateInletVelocity", 3),
    ("turbulentIntensityKineticEnergyInlet", 1),
    ("turbulentMixingLengthDissipationRateInlet", 1),
    ("turbulentMixingLengthFrequencyInlet", 1)]


@pytest.fixture(scope="module")
def bc_mesh(tj_gdia):
    jmesh = tj_gdia[0][0].mesh
    return jmesh, interop.mesh_arrays(jmesh, device=CPU, dtype=F64)


def _bc_inputs(jmesh, word, ncomp, seed):
    """A field on the T-junction with `word` on the inlet patch and
    zeroGradient elsewhere, its BC data, and an env with a face flux of
    both signs on that patch (JAX objects)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    shape = (jmesh.n_cells,) if ncomp == 1 else (jmesh.n_cells, 3)
    pi = [p.name for p in jmesh.patches].index("inlet")
    patch = jmesh.patches[pi]
    n_b = int(jmesh.n_faces - jmesh.n_internal)
    size = (patch.size,) if ncomp == 1 else (patch.size, 3)
    bd = dict(value=rng.uniform(0.1, 1.0, size),
              refValue=rng.standard_normal(size),
              refGradient=rng.standard_normal(size),
              valueFraction=rng.uniform(0.0, 1.0, size),
              inletValue=rng.standard_normal(size),
              p0=rng.standard_normal(patch.size),
              volumetricFlowRate=np.full(patch.size, 3e-4),
              intensity=np.asarray(0.07), mixingLength=np.asarray(0.02))
    bd = {k: jnp.asarray(v) for k, v in bd.items()}
    bcs = tuple(jbcs.make_bc(word if i == pi else "zeroGradient", i)
                for i in range(len(jmesh.patches)))
    field = JVol(jnp.asarray(rng.standard_normal(shape)),
                 jnp.asarray(rng.standard_normal((n_b,) + shape[1:])),
                 bcs, jdimless, "f",
                 tuple(bd if i == pi else {} for i in range(len(bcs))))
    phi = rng.standard_normal(jmesh.n_faces)
    sl = slice(patch.start, patch.start + patch.size)
    phi[sl] = np.where(np.arange(patch.size) % 2 == 0, 1.0, -1.0) \
        * np.abs(phi[sl])
    zg = tuple(jbcs.make_bc("zeroGradient", i) for i in range(len(bcs)))
    env = dict(
        phi=JSurface(jnp.asarray(phi), jdimless, "phi"),
        U=JVol(jnp.asarray(rng.standard_normal((jmesh.n_cells, 3))),
               jnp.asarray(rng.standard_normal((n_b, 3))), zg, jdimless,
               "U", tuple({} for _ in zg)),
        k=JVol(jnp.asarray(rng.uniform(0.0, 1.0, jmesh.n_cells)),
               jnp.asarray(rng.uniform(0.0, 1.0, n_b)), zg, jdimless, "k",
               tuple({} for _ in zg)))
    return pi, field, env


def _to_port(env):
    return dict(phi=interop.surface_field(env["phi"], device=CPU, dtype=F64),
                **{k: interop.vol_field(env[k], device=CPU, dtype=F64)
                   for k in ("U", "k")})


@pytest.mark.parametrize("with_env", [True, False],
                         ids=["env", "no-env"])
@pytest.mark.parametrize("word,ncomp", _BC_CASES,
                         ids=[f"{w}-{n}" for w, n in _BC_CASES])
def test_bc_matches_jax(bc_mesh, word, ncomp, with_env):
    jmesh, tmesh = bc_mesh
    pi, jfield, jenv = _bc_inputs(jmesh, word, ncomp,
                                  seed=len(word) * 7 + ncomp)
    tfield = interop.vol_field(jfield, device=CPU, dtype=F64)
    tenv = _to_port(jenv) if with_env else None
    jenv = jenv if with_env else None
    jbc, tbc = jfield.bcs[pi], tfield.bcs[pi]
    assert type(tbc).__name__ == type(jbc).__name__
    assert tbc == tbcs.make_bc(word, pi)
    jbd, tbd = jfield.bcdata[pi], tfield.bcdata[pi]
    jp, tp = jmesh.patches[pi], tmesh.patches[pi]
    for hook in ("evaluate", "value_internal_coeff",
                 "gradient_internal_coeff", "value_coeffs",
                 "gradient_coeffs"):
        a = getattr(tbc, hook)(tmesh, tp, tfield, tbd, tenv)
        b = getattr(jbc, hook)(jmesh, jp, jfield, jbd, jenv)
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            x, y = np.broadcast_arrays(np.asarray(x), np.asarray(y))
            scale = max(1.0, np.abs(y).max())
            assert np.abs(x - y).max() <= 1e-12 * scale, hook
    for flag in ("fixes_value", "fixes_level", "preserves_type",
                 "value_free", "assembles"):
        assert getattr(tbc, flag) == getattr(jbc, flag), flag


def test_new_bc_words_read_from_a_case(tjunction):
    """The T-junction's dictionaries give the open-boundary BCs with
    their data (p0, inletValue, intensity, mixingLength) on both sides."""
    with captured():
        case = Case(tjunction, device=CPU, dtype=F64)
    p, k = case.read_field("p"), case.read_field("k")
    words = {case.mesh.patches[bc.patch].name: bc.word for bc in p.bcs}
    assert words == {"inlet": "uniformTotalPressure",
                     "outlet1": "totalPressure", "outlet2": "totalPressure",
                     "walls": "zeroGradient"}
    inlet = [p.name for p in case.mesh.patches].index("inlet")
    assert float(p.bcdata[inlet]["p0"][0]) == 10.0
    assert float(k.bcdata[inlet]["intensity"]) == 0.05
    assert isinstance(k.bcs[inlet],
                      tbcs.TurbulentIntensityKineticEnergyInlet)


# -- the transient turbulence corrections -----------------------------------

def _carried_correct(jcase, jturb, tturb, jstate, jU, jphi, dt):
    jnu = JTransport(jcase.transport_properties()).nu(jcase.mesh, None)
    tnu = TDimensioned("nu", DimensionSet(*jnu.dims.as_tuple()),
                       float(jnu.value))
    jcorrect = jax.jit(lambda mesh, st, U, phi, dt_: jturb.correct(
        mesh, st, U, phi, jnu, dt=dt_))
    jst, jperf = jcorrect(jcase.mesh, jstate, jU, jphi, dt)
    tmesh = interop.mesh_arrays(jcase.mesh, device=CPU, dtype=F64)
    tst, tperf = tturb.correct(
        tmesh, interop.turb_state(jstate, device=CPU, dtype=F64),
        interop.vol_field(jU, device=CPU, dtype=F64),
        interop.surface_field(jphi, device=CPU, dtype=F64), tnu, dt=dt)
    assert sorted(tst) == sorted(jst)
    for name in tst:
        for part in ("data", "bvalues"):
            a = getattr(tst[name], part).numpy()
            b = np.asarray(getattr(jst[name], part))
            assert np.abs(a - b).max() <= 1e-8 * np.abs(b).max(), name
    for name, pf in jperf.items():
        assert abs(int(tperf[name][2]) - int(pf[2])) <= 1
    for name in tperf:     # the solved fields keep their old time level
        assert tst[name].old is not None
        assert torch.equal(tst[name].old.data,
                           interop.vol_field(jstate[name], device=CPU,
                                             dtype=F64).data)


def test_kepsilon_correct_dt_matches_jax(tjunction, tj_gdia):
    jcase, jf, jsteps = tj_gdia[0]
    jturb = jmake_ras(jcase, jf["U"])
    with captured():
        tturb = make_ras_model(Case(tjunction, device=CPU, dtype=F64), None)
    assert isinstance(tturb, KEpsilon) and tturb.ddt_scheme == "Euler"
    _carried_correct(jcase, jturb, tturb,
                     {k: jf[k] for k in ("k", "epsilon", "nut")},
                     jf["U"], jf["phi"], jsteps[-1]["dt"])


def test_komegasst_correct_dt_matches_jax(tmp_path, tj_gdia):
    """kOmegaSST on the same lattice (omega from the case's files), with
    the flow the kEpsilon T-junction reached."""
    d = str(tmp_path / "sst")
    tjunction_case(d, model="kOmegaSST", **_SMALL_TJ)
    jflow = tj_gdia[0][1]
    jcase = JCase(d)
    jturb = jmake_ras(jcase, None)
    jstate = jturb.init_state(None)
    with captured():
        tturb = make_ras_model(Case(d, device=CPU, dtype=F64), None)
    assert isinstance(tturb, KOmegaSST)
    tturb.y = interop.wall_distance(jturb, device=CPU, dtype=F64)
    _carried_correct(jcase, jturb, tturb, jstate, jflow["U"], jflow["phi"],
                     2e-3)


# -- the command line ---------------------------------------------------------

@pytest.mark.parametrize("solver", ["pimpleFoam", "pisoFoam"])
def test_cli_runs_on_cpu(tmp_path, solver):
    """`python -m rapidcfd_tpu_torch pimpleFoam|pisoFoam -case D -device
    cpu` runs the case to its endTime (pisoFoam on the cavity's PISO
    dictionary) and writes its last time directory."""
    from rapidcfd_tpu_torch.__main__ import main
    d = str(tmp_path / "case")
    if solver == "pisoFoam":
        cavity_case(d, end_time=0.02, write_interval=4)
        last = "0.02"
    else:
        tjunction_case(d, section=4, leg=12, bar=12, depth=4,
                       end_time=2.5e-3, write_interval=2)
        last = "0.0022"
    with captured() as buf:
        main([solver, "-case", d, "-device", "cpu", "-precision", "fp64"])
    assert "End" in buf.getvalue()
    assert os.path.isfile(os.path.join(d, last, "U"))


def test_cli_default_device_is_cuda(tmp_path):
    """Without -device the dispatcher asks for cuda, and without a card
    that raises rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot be shown")
    from rapidcfd_tpu_torch.__main__ import main
    d = str(tmp_path / "case")
    tjunction_case(d, section=4, leg=12, bar=12, depth=4)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["pimpleFoam", "-case", d, "-noWrite"])
