"""The port's LES models against the JAX package in fp64 on the CPU.

Both packages read the same case directories, written by the port's
writers (utils/casegen.les_model_channel_case: the JAX tests' 30x10x1
LES channel with each model's dictionaries and fields); velocities and
model states are perturbed from numpy seeds on the JAX side and carried
into the port by interop.

- simple_filter of scalar, vector and tensor data and every LES delta
  (cubeRootVol, maxDeltaxyz, smooth, Prandtl) on the channel as the
  padded ELL and as a gdia box: to 1e-12.
- Every LES model's correct(), steady and transient (Euler), on the
  channel (ELL), the models with a layout-specific path (GDIA) on the
  gdia box too, and the explicit nonlinear stress of the
  scale-similarity family on both: cell and boundary values to 1e-10 of
  the field's largest magnitude, iteration counts within one.
- 5 Euler steps of pimpleFoam with oneEqEddy and with dynOneEqEddy on
  the channel (ELL) against the JAX package's run(): fields to 1e-8,
  counts within one.
- The LES registry holds every name the JAX package registers under
  LESModel; pitz_daily_les_case writes pisoFoam's LES tutorial (its
  in-memory mesh and lattice are pitz_daily_case's).

The JAX package runs with XLA's optimisations off
(torch_heat_reference.jax_quiet), which also keeps its compiles short;
the correct() references compile together in a thread pool, one program
per model for both forms (test_torch_turbulence.compile_all and
correct_program)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rapidcfd_tpu.models import turbulence as jturb
from rapidcfd_tpu.models.transport import \
    SinglePhaseTransportModel as JTransport
from rapidcfd_tpu.solvers import pimplefoam as jpimple
from rapidcfd_tpu.solvers.case import Case as JCase
from rapidcfd_tpu.utils.registry import registered_names
from rapidcfd_tpu_torch import interop
from rapidcfd_tpu_torch.fields.field import Dimensioned as TDimensioned
from rapidcfd_tpu_torch.mesh.polymesh import read_polymesh
from rapidcfd_tpu_torch.models import turbulence as tturb
from rapidcfd_tpu_torch.solvers import pimplefoam as tpimple
from rapidcfd_tpu_torch.utils import casegen
from rapidcfd_tpu_torch.utils.dictionary import parse_file
from rapidcfd_tpu_torch.utils.dimensions import DimensionSet
from rapidcfd_tpu_torch.utils.unstructured import detect_lattice
from test_torch_turbulence import compile_all, correct_program, perturbed
from torch_heat_reference import (CPU, F64, jax_quiet, jax_switches,
                                  port_case, rel)

TOL = 1e-10
RUN_TOL = 1e-8
DT = 5e-4
LAYOUTS = ("ell", "gdia")
#: one name per LES class (kEqn, homogeneousDynOneEqEddy and the LES
#: SpalartAllmaras are aliases of oneEqEddy, dynOneEqEddy and
#: SpalartAllmarasDES)
LES = ("Smagorinsky", "oneEqEddy", "dynOneEqEddy", "SpalartAllmarasDES",
       "SpalartAllmarasDDES", "SpalartAllmarasIDDES", "kOmegaSSTSAS",
       "dynLagrangian", "scaleSimilarity", "mixedSmagorinsky",
       "Smagorinsky2", "homogeneousDynSmagorinsky", "spectEddyVisc")
STRESS = ("scaleSimilarity", "mixedSmagorinsky", "Smagorinsky2")
#: the models whose correct() takes a layout-specific path beyond the
#: gradient and the solves every model shares (the test filter on cells
#: and on a filtered velocity's gradient, maxDeltaxyz and the wall
#: distance), held on the gdia box too
GDIA = ("dynOneEqEddy", "dynLagrangian", "SpalartAllmarasIDDES")
CASES = [(m, "ell") for m in LES] + [(m, "gdia") for m in GDIA] \
    + [(m, "gdia") for m in STRESS if m not in GDIA]


def _jax_case(d, layout):
    """The JAX package's Case of a full box: on the port's gdia lattice,
    or on the RCM-ordered ELL (as the port's)."""
    if layout == "gdia":
        return JCase(d, lattice=detect_lattice(read_polymesh(d),
                                               full_box=True))
    with jax_switches(GDIA_AUTO="0", FORCE_RCM="1"):
        return JCase(d)


def _port_nu(jnu):
    return TDimensioned("nu", DimensionSet(*jnu.dims.as_tuple()),
                        float(jnu.value))


def _close(tf, jf, what):
    for part in ("data", "bvalues"):
        a = getattr(tf, part).numpy()
        b = np.asarray(getattr(jf, part))
        assert a.shape == b.shape, (what, part)
        assert np.abs(a - b).max() <= TOL * max(np.abs(b).max(), 1e-300), \
            (what, part, rel(a, b))


def _select(d, model):
    """Write the channel's constant/turbulenceProperties for a model (its
    LES_CHANNEL_SPECS coefficients); the other files serve every model."""
    from rapidcfd_tpu_torch.utils.dictionary import foamfile_header
    coeffs = casegen.LES_CHANNEL_SPECS[model][0]
    casegen._write(f"{d}/constant/turbulenceProperties",
                   foamfile_header("dictionary", "turbulenceProperties",
                                   "constant"),
                   f"\nsimulationType LES;\nLES\n{{\n    LESModel {model};\n"
                   f"    turbulence on;\n    {coeffs}\n}}\n")


@pytest.fixture(scope="module")
def channels(tmp_path_factory):
    """layout -> (directory, JAX case, port case) of one channel that
    carries every LES model's fields (k, omega, nuTilda; flm and fmm
    start uniform) and solver entries; _select picks the model."""
    d = str(tmp_path_factory.mktemp("channel"))
    k = casegen._les_field("k", "[0 2 -2 0 0 0 0]", 2e-05, 0)
    omega = casegen._les_field("omega", "[0 0 -1 0 0 0 0]", 100.0, 100.0)
    casegen.les_channel_case(
        d, "Smagorinsky",
        extra_schemes="div(phi,nuTilda) Gauss upwind; div(phi,omega) Gauss "
                      "upwind; div(phi,flm) Gauss upwind; div(phi,fmm) "
                      "Gauss upwind;",
        solver_fields="U|k|omega|nuTilda|flm|fmm",
        fields=(k, omega, casegen._LES_NUTILDA))
    return {lay: (d, _jax_case(d, lay), port_case(d, lay))
            for lay in LAYOUTS}


@pytest.fixture(scope="module")
def corrected(channels):
    """(model, layout) -> the JAX and the port's (steady, transient)
    correct() outputs on the same perturbed inputs, and the nonlinear
    stresses; one JAX program per model and layout
    (test_torch_turbulence.correct_program: the steady result at dt =
    inf)."""
    jobs, ports = [], []
    with jax_quiet():
        for model, lay in CASES:
            d, jcase, tcase = channels[lay]
            _select(d, model)
            jmesh = jcase.mesh
            jm = jturb.make_ras_model(jcase, None)
            tm = tturb.make_ras_model(tcase, None)
            assert type(tm).__name__ == type(jm).__name__
            jm.ddt_scheme = tm.ddt_scheme = "Euler"
            if hasattr(jm, "y"):
                tm.y = interop.wall_distance(jm, device=CPU, dtype=F64)
            jU, jphi, jst = perturbed(jcase, jm.init_state(None),
                                      len(model) + 7 * len(lay),
                                      u_mean=2.0, u_sd=0.3, v_sd=0.2)
            jnu = JTransport(jcase.transport_properties()).nu(jmesh, None)
            tmesh = interop.mesh_arrays(jmesh, device=CPU, dtype=F64)
            args = (tmesh, interop.turb_state(jst, device=CPU, dtype=F64),
                    interop.vol_field(jU, device=CPU, dtype=F64),
                    interop.surface_field(jphi, device=CPU, dtype=F64),
                    _port_nu(jnu))
            tres = stress = None
            if lay == "ell" or model in GDIA:
                jobs.append(((model, lay), (correct_program(jm, jnu),
                                            (jmesh, jst, jU, jphi, DT))))
                tres = (tm.correct(*args), tm.correct(*args, dt=DT))
            if model in STRESS:
                stress = (jm.nonlinear_stress(jmesh, jst, jU),
                          tm.nonlinear_stress(tmesh, args[1], args[2]))
            ports.append(((model, lay), tres, stress))
        progs = compile_all([j for _, j in jobs])
        jres = {key: (prog(*a[:-1], np.inf), prog(*a[:-1], DT))
                for (key, (_, a)), prog in zip(jobs, progs)}
    out = {key: (jres.get(key), tres, stress)
           for key, tres, stress in ports}
    return out


@pytest.mark.parametrize("model,layout", [c for c in CASES
                                          if c[1] == "ell" or c[0] in GDIA])
def test_les_correct_matches_jax(corrected, model, layout):
    """Steady and transient correct(): every state field's cell and
    boundary values to 1e-10, counts within one, the transient solved
    fields with their old level."""
    jres, tres, _ = corrected[model, layout]
    for (jst, jperf), (tst, tperf), dt in zip(jres, tres, (None, DT)):
        assert sorted(tst) == sorted(jst)
        for name in tst:
            _close(tst[name], jst[name], f"{model} {name} dt={dt}")
        assert sorted(tperf) == sorted(jperf)
        for name, pf in jperf.items():
            assert abs(int(tperf[name][2]) - int(pf[2])) <= 1, name
            if dt is not None:
                assert tst[name].old is not None and tst[name].levels == 1


def test_steady_correct_is_the_program_at_infinite_dt(channels):
    """JAX's correct(dt=None) (steadyState) equals
    test_torch_turbulence.correct_program at dt = inf, bit for bit
    (oneEqEddy on the ELL channel): so the steady comparisons hold the
    port to JAX's steady correct()."""
    d, jcase, _ = channels["ell"]
    _select(d, "oneEqEddy")
    jm = jturb.make_ras_model(jcase, None)
    jm.ddt_scheme = "Euler"
    jnu = JTransport(jcase.transport_properties()).nu(jcase.mesh, None)
    jU, jphi, jst = perturbed(jcase, jm.init_state(None), 3, u_mean=2.0,
                              u_sd=0.3, v_sd=0.2)
    with jax_quiet():
        steady = jax.jit(lambda m_, s, U, phi: jm.correct(
            m_, s, U, phi, jnu))(jcase.mesh, jst, jU, jphi)
        inf = correct_program(jm, jnu)(jcase.mesh, jst, jU, jphi, np.inf)
    for name in steady[0]:
        assert np.array_equal(np.asarray(steady[0][name].data),
                              np.asarray(inf[0][name].data)), name
    assert {k: int(v[2]) for k, v in steady[1].items()} == \
        {k: int(v[2]) for k, v in inf[1].items()}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("model", STRESS)
def test_nonlinear_stress_matches_jax(corrected, model, layout):
    jst, tst = corrected[model, layout][2]
    _close(tst, jst, model)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_simple_filter_and_deltas_match_jax(channels, layout):
    """simple_filter on scalar, vector and tensor cell data, and the four
    LES deltas (with their coefficients), on the same mesh."""
    _, jcase, tcase = channels[layout]
    jmesh = jcase.mesh
    tmesh = interop.mesh_arrays(jmesh, device=CPU, dtype=F64)
    rng = np.random.default_rng(11)
    for shape in ((), (3,), (3, 3)):
        x = rng.standard_normal((jmesh.n_cells,) + shape)
        a = tturb.simple_filter(tmesh, torch.as_tensor(x)).numpy()
        b = np.asarray(jturb.simple_filter(jmesh, jnp.asarray(x)))
        assert rel(a, b) <= 1e-12, shape
    from rapidcfd_tpu.utils.dictionary import parse_dictionary as jparse
    from rapidcfd_tpu_torch.utils.dictionary import parse_dictionary
    for text in ("delta cubeRootVol; deltaCoeff 2;", "delta maxDeltaxyz;",
                 "delta smooth; smoothCoeffs { maxDeltaRatio 1.05; }",
                 "delta Prandtl; PrandtlCoeffs { Cdelta 0.2; }",
                 "delta vanDriest;"):
        if layout == "gdia" and "maxDeltaxyz" in text:
            # the JAX package's maxDeltaxyz reads the ELL's cell_faces,
            # which its gdia meshes lack: the port's own ELL value
            ecase = channels["ell"][2]
            ell = tturb.max_delta_xyz(ecase.mesh)
            got = tturb.max_delta_xyz(tcase.mesh)
            assert rel(tcase.maps.cells_to_file(got.numpy()),
                       ecase.maps.cells_to_file(ell.numpy())) <= 1e-12
            continue
        a = tturb.les_delta(tcase, parse_dictionary(text)).numpy()
        b = np.asarray(jturb.les_delta(jcase, jparse(text)))
        assert rel(a, b) <= 1e-12, text


# -- full runs ----------------------------------------------------------------

def _run_jax(d, steps):
    """pimpleFoam of the JAX package on the channel's RCM-ordered ELL,
    each step's iteration counts recorded (old levels pre-stored so the
    jitted step compiles once)."""
    record = []
    orig = jpimple.make_step

    def make_step(case, transport, turb, ctrl, piso_mode):
        perm = np.asarray(case.maps.cell_perm)
        ctrl.p_ref_cell = int(np.nonzero(perm == ctrl.p_ref_cell)[0][0])
        step = orig(case, transport, turb, ctrl, piso_mode)

        def recorded(U, p, phi, ts, dt):
            if U.old is None:
                U = U.store_old()
                ts = {k: v.store_old() for k, v in ts.items()}
            out = step(U, p, phi, ts, dt)
            st = out[4]
            record.append(
                [(f"U{c}", int(pf[2])) for c, pf in zip("xyz",
                                                        st["u_perf"])]
                + [("p", int(pf[2])) for pf in st["p_perf"]]
                + [(k, int(pf[2])) for k, pf in sorted(st["turb"].items())])
            return out
        return recorded
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpimple, "make_step", make_step)
        with jax_switches(GDIA_AUTO="0", FORCE_RCM="1"), jax_quiet():
            case, U, p, phi, ts = jpimple.run(d, write=False,
                                              max_steps=steps)
    return case, dict(U=U, p=p, **ts), record


@pytest.fixture(scope="module", params=["oneEqEddy", "dynOneEqEddy"])
def les_run(request, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("run_" + request.param))
    casegen.les_model_channel_case(d, request.param, u_seed=5)
    jcase, jf, jsteps = _run_jax(d, 5)
    tcase = port_case(d, "ell")
    from rapidcfd_tpu_torch.utils.logging import captured
    with captured():
        _, U, p, phi, ts = tpimple.run(d, device=CPU, dtype=F64,
                                       write=False, max_steps=5, case=tcase)
    return jcase, jf, jsteps, tcase, dict(U=U, p=p, **ts), tcase.step_log


def test_les_pimplefoam_matches_jax(les_run):
    """5 Euler steps: U, p, k and nut to 1e-8 of their largest magnitude;
    the JAX package logs the last corrector's p solves, held against the
    port's last ones; every other count within one."""
    jcase, jf, jsteps, tcase, tf, tsteps = les_run
    assert sorted(jf) == sorted(tf) == ["U", "k", "nut", "p"]
    for name in jf:
        a = tcase.maps.cells_to_file(tf[name].data.numpy())
        b = jcase.maps.cells_to_file(np.asarray(jf[name].data))
        assert rel(a, b) <= RUN_TOL, name
    assert len(jsteps) == len(tsteps) == 5
    for j, t in zip(jsteps, tsteps):
        t = t["iterations"]
        jo = [x for x in j if x[0] != "p"]
        to = [x for x in t if x[0] != "p"]
        assert [f for f, _ in jo] == [f for f, _ in to]
        jp = [n for f, n in j if f == "p"]
        tp = [n for f, n in t if f == "p"][-len(jp):]
        assert all(abs(a - b) <= 1 for (_, a), (_, b) in zip(jo, to))
        assert all(abs(a - b) <= 1 for a, b in zip(jp, tp))


# -- registry and case writers ---------------------------------------------

def test_les_registry_holds_every_jax_name():
    assert set(registered_names("LESModel")) <= set(tturb.LES_MODELS)
    assert set(registered_names("RASModel")) <= set(tturb.RAS_MODELS)


def test_les_model_selected_from_turbulence_properties(tmp_path):
    """pitz_daily_les_case's turbulenceProperties selects dynOneEqEddy,
    with the cubeRootVol delta of deltaCoeff 1 (cbrt of the volume)."""
    d = str(tmp_path / "les")
    casegen.pitz_daily_les_case(d, scale=1, end_time=1e-5)
    case = port_case(d, "gdia")
    model = tturb.make_ras_model(case, None)
    assert type(model) is tturb.DynOneEqEddy
    assert rel(model.delta.numpy(), case.mesh.V.numpy() ** (1 / 3)) < 1e-14
    assert case.ddt_scheme() == "backward"
    assert case.div_scheme("div(phi,U)")[0] == "LUST"
    props = parse_file(f"{d}/constant/turbulenceProperties")
    assert props.word("LESModel") == "dynOneEqEddy"
    jm = jturb.make_ras_model(JCase(d), None)
    assert type(jm).__name__ == "DynOneEqEddy"


def _same_mesh(mesh, ref):
    for name in ("points", "face_points", "face_offsets", "owner",
                 "neighbour"):
        assert np.array_equal(getattr(mesh, name), getattr(ref, name)), name
    assert [(p.name, p.type, p.start_face, p.n_faces) for p in mesh.patches] \
        == [(p.name, p.type, p.start_face, p.n_faces) for p in ref.patches]


def _jax_writer_mesh(writer, tmp_path, **kw):
    """The PolyMesh a JAX package writer builds with its own patch rule
    through its cell-loop masked_grid_mesh."""
    from rapidcfd_tpu.utils import casegen as jcasegen
    built = []
    orig = jcasegen.masked_grid_mesh

    def recording(*a):
        built.append(orig(*a))
        return built[-1]
    with pytest.MonkeyPatch.context() as mp, jax_quiet():
        mp.setattr(jcasegen, "masked_grid_mesh", recording)
        getattr(jcasegen, writer)(str(tmp_path / "jax"), **kw)
    return built[0]


@pytest.mark.parametrize("scale", [1, 2])
def test_pitz_daily_arrays_is_the_masked_grid(scale, tmp_path):
    """The port's pitzDaily mesh, built by array operations, is the JAX
    package's (its cell-loop masked_grid_mesh with its pitz_daily_case
    patch rule) face for face, and its lattice is detect_lattice's."""
    ref = _jax_writer_mesh("pitz_daily_case", tmp_path, scale=scale)
    lattice = {}
    mesh = casegen._pitz_daily_mesh(scale, lattice)
    _same_mesh(mesh, ref)
    det = detect_lattice(mesh)
    assert sorted(det) == sorted(lattice)
    for key, val in det.items():
        assert np.array_equal(np.asarray(val), np.asarray(lattice[key])), key


def test_masked_grid_writers_match_jax(tmp_path):
    """The forward step is the JAX package's forward_step_case mesh face
    for face; the T-junction (no JAX writer) is the JAX package's
    cell-loop masked_grid_mesh given the port's rule, face for face, and
    its lattice_out is detect_lattice's."""
    from rapidcfd_tpu.utils import casegen as jcasegen
    ref = _jax_writer_mesh("forward_step_case", tmp_path, scale=1)
    mesh = casegen.forward_step_case(str(tmp_path / "fs"), write_mesh=False)
    _same_mesh(mesh, ref)
    args = []
    orig = casegen.masked_grid_mesh

    def recording(xs, ys, zs, mask, rule, lattice_out=None):
        args.append((xs, ys, zs, mask, rule))
        return orig(xs, ys, zs, mask, rule, lattice_out)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(casegen, "masked_grid_mesh", recording)
        tj = casegen._tjunction_mesh(4, 12, 12, 3, 0.05)
    xs, ys, zs, mask, rule = args[0]

    def scalar_rule(i, j, side):
        return rule(np.array([i]), np.array([j]), side)[0]
    scalar_rule.order, scalar_rule.types = rule.order, rule.types
    _same_mesh(tj, jcasegen.masked_grid_mesh(xs, ys, zs, mask, scalar_rule))
    lattice = {}
    orig(xs, ys, zs, mask, rule, lattice)
    det = detect_lattice(tj)
    assert sorted(det) == sorted(lattice)
    for key, val in det.items():
        assert np.array_equal(np.asarray(val), np.asarray(lattice[key])), key


def test_les_case_runs_bounded_on_the_cpu(tmp_path):
    """pisoFoam LES on pitzDaily x1 in memory (write_mesh=False,
    lattice_out): 3 fp32 steps from rest stay finite and bounded, k and
    nut non-negative."""
    from rapidcfd_tpu_torch.solvers.case import Case
    from rapidcfd_tpu_torch.utils.logging import captured
    d = str(tmp_path / "les")
    lat = {}
    pm = casegen.pitz_daily_les_case(d, scale=1, write_mesh=False,
                                     lattice_out=lat)
    with captured():
        case = Case(d, device=CPU, dtype=torch.float32, pmesh=pm,
                    lattice=lat)
        _, U, p, phi, ts = tpimple.run(d, device=CPU, dtype=torch.float32,
                                       write=False, max_steps=3,
                                       piso_mode=True, case=case)
    live = torch.as_tensor(case.maps.cell_primary)
    assert case.mesh.gdia is not None and int(live.sum()) == 4240
    assert torch.isfinite(U.data[live]).all()
    assert float(U.data[live].norm(dim=-1).max()) < 30.0
    assert float(ts["nut"].data[live].min()) >= 0.0
    assert float(ts["k"].data[live].min()) > 0.0
    assert U.levels == 2 and U.old.old is not None
