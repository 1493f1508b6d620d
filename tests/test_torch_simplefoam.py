"""The port's simpleFoam slice against the JAX package on pitzDaily x1
(BASELINE config 2's case: gdia lattice, kEpsilon with wall functions,
GAMG p, smoothSolver U/k/epsilon, SIMPLE with residualControl; fp64,
every linear solve to 1e-12).

- After 1 SIMPLE iteration U, p, phi (file order and orientation), k,
  epsilon and nut agree to 1e-8 relative to their largest magnitude, and
  every iteration count to within one.
- After 3 iterations the same fields agree to 1e-10 relative (measured:
  ~1e-13) and every iteration count to within one.
- KEpsilon.correct on the state the JAX package reached after one
  iteration, carried into the port: k, epsilon and nut to 1e-10, equal
  iteration counts; its wall-cell fix (one lowerWall cell has two wall
  faces, the step's corner) to 1e-12.

Also: the padded-ELL path against the gdia path, residualControl with
regex keys, the CLI on the CPU, written fields reading back, and the
refusals of what is not ported."""

import contextlib
import os
import re

import jax
import numpy as np
import pytest
import torch

from rapidcfd_tpu.models.transport import \
    SinglePhaseTransportModel as JTransport
from rapidcfd_tpu.models.turbulence import make_ras_model as jmake_ras
from rapidcfd_tpu.ops import fvc as jfvc
from rapidcfd_tpu.solvers import simplefoam as jsimple
from rapidcfd_tpu.solvers.case import Case as JCase
from rapidcfd_tpu.solvers.controls import SimpleControl as JSimpleControl
from rapidcfd_tpu_torch import interop
from rapidcfd_tpu_torch.fields import io as tio
from rapidcfd_tpu_torch.fields.field import Dimensioned as TDimensioned
from rapidcfd_tpu_torch.models.turbulence import (KEpsilon,
                                                  NutkWallFunction,
                                                  make_ras_model)
from rapidcfd_tpu_torch.solvers import simplefoam as tsimple
from rapidcfd_tpu_torch.solvers.case import Case
from rapidcfd_tpu_torch.solvers.controls import SimpleControl
from rapidcfd_tpu_torch.utils.casegen import pitz_daily_case
from rapidcfd_tpu_torch.utils.dimensions import DimensionSet
from rapidcfd_tpu_torch.utils.logging import captured

CPU = torch.device("cpu")
F64 = torch.float64
_ITER_RE = re.compile(r"Solving for (\w+),.*No Iterations (\d+)")
_FIELDS = ["U", "p", "phi", "k", "epsilon", "nut"]


def _logged(fn, *args, **kw):
    with captured() as buf:
        out = fn(*args, **kw)
    return out, [(m.group(1), int(m.group(2)))
                 for m in _ITER_RE.finditer(buf.getvalue())]


def _jax_its(stats):
    """A JAX step's iteration counts in the order the port logs them."""
    its = [(f"U{c}", int(pf[2])) for c, pf in zip("xyz", stats["u_perf"])]
    its += [("p", int(pf[2])) for pf in stats["p_perf"]]
    return its + [(k, int(pf[2])) for k, pf in sorted(stats["turb"].items())]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pitz1simple"))
    pitz_daily_case(d, scale=1, tight_tol=True)
    # the JAX package, driven as its simplefoam.run drives it, keeping the
    # states after iterations 1 and 3
    jcase = JCase(d)
    U, p = jcase.read_field("U"), jcase.read_field("p")
    phi = jfvc.flux(jcase.mesh, U)
    transport = JTransport(jcase.transport_properties())
    turb = jmake_ras(jcase, U)
    ts = turb.init_state(U)
    step = jsimple.make_step(jcase, transport, turb, JSimpleControl(jcase))
    jout, jits = [], []
    for _ in range(3):
        U, p, phi, ts, stats = step(U, p, phi, ts)
        jout.append(dict(U=U, p=p, phi=phi, **ts))
        jits.append(_jax_its(stats))
    port = {}
    for n in (1, 3):
        (case, U, p, phi, ts), its = _logged(
            tsimple.run, d, device=CPU, dtype=F64, write=False, max_steps=n)
        port[n] = (case, dict(U=U, p=p, phi=phi, **ts), its)
    return dict(dir=d, jcase=jcase, jturb=turb,
                jnu=transport.nu(jcase.mesh, None), jout=jout, jits=jits,
                port=port)


def _rel_err(runs, n, name):
    case, tf, _ = runs["port"][n]
    jf = runs["jout"][n - 1][name]
    jmaps, tmaps = runs["jcase"].maps, case.maps
    if name == "phi":
        nf = tmaps.n_file_faces
        a = tmaps.faces_to_file(tf[name].data.numpy(), flux=True)
        b = jmaps.faces_to_file(np.asarray(jf.data))[:nf]
    else:
        a = tmaps.cells_to_file(tf[name].data.numpy())
        b = jmaps.cells_to_file(np.asarray(jf.data))
    assert np.isfinite(a).all()
    return np.abs(a - b).max() / np.abs(b).max()


def _its_within_one(port_its, jax_its):
    assert [f for f, _ in port_its] == [f for f, _ in jax_its]
    off = [(i, j, t) for i, (j, t) in enumerate(zip(jax_its, port_its))
           if j != t]
    for i, j, t in off:
        print(f"solve {i} ({j[0]}): JAX {j[1]} iterations, port {t[1]}")
    assert all(abs(j[1] - t[1]) <= 1 for _, j, t in off)


@pytest.mark.parametrize("name", _FIELDS)
def test_one_iteration_matches_jax(runs, name):
    assert _rel_err(runs, 1, name) <= 1e-8


def test_one_iteration_counts_match_jax(runs):
    _its_within_one(runs["port"][1][2], runs["jits"][0])
    assert [f for f, _ in runs["port"][1][2]] == \
        ["Ux", "Uy", "Uz", "p", "epsilon", "k"]


@pytest.mark.parametrize("name", _FIELDS)
def test_three_iterations_match_jax(runs, name):
    assert _rel_err(runs, 3, name) <= 1e-10


def test_three_iteration_counts_match_jax(runs):
    _its_within_one(runs["port"][3][2], sum(runs["jits"], []))


@pytest.fixture(scope="module")
def carried(runs):
    """The JAX state after one iteration, in both packages, with the
    port's kEpsilon built from the case's dictionaries."""
    jcase = runs["jcase"]
    jmesh = jcase.mesh
    j = runs["jout"][0]
    jstate = {k: j[k] for k in ("k", "epsilon", "nut")}
    tcase = Case(runs["dir"], device=CPU, dtype=F64)
    turb = make_ras_model(tcase, None)
    assert isinstance(turb, KEpsilon)
    jnu = runs["jnu"]
    return dict(
        jmesh=jmesh, jstate=jstate, jU=j["U"], jphi=j["phi"], jnu=jnu,
        tmesh=interop.mesh_arrays(jmesh, device=CPU, dtype=F64),
        tstate=interop.turb_state(jstate, device=CPU, dtype=F64),
        tU=interop.vol_field(j["U"], device=CPU, dtype=F64),
        tphi=interop.surface_field(j["phi"], device=CPU, dtype=F64),
        tnu=TDimensioned("nu", DimensionSet(*jnu.dims.as_tuple()),
                         float(jnu.value)),
        turb=turb)


def test_kepsilon_correct_matches_jax(runs, carried):
    c = carried
    assert isinstance(c["tstate"]["nut"].bcs[2], NutkWallFunction)
    jcorrect = jax.jit(lambda mesh, st, U, phi: runs["jturb"].correct(
        mesh, st, U, phi, c["jnu"]))
    jst, jperf = jcorrect(c["jmesh"], c["jstate"], c["jU"], c["jphi"])
    tst, tperf = c["turb"].correct(c["tmesh"], c["tstate"], c["tU"],
                                   c["tphi"], c["tnu"])
    for k in ("k", "epsilon", "nut"):
        for part in ("data", "bvalues"):
            a = getattr(tst[k], part).numpy()
            b = np.asarray(getattr(jst[k], part))
            assert np.abs(a - b).max() <= 1e-10 * np.abs(b).max(), (k, part)
    for k in ("k", "epsilon"):
        assert int(tperf[k][2]) == int(jperf[k][2]) > 0


def test_wall_fix_matches_jax(runs, carried):
    """G, the fix mask and the wall epsilon of the wall cells, the
    step's corner cell (two lowerWall faces) included."""
    c = carried
    tmesh = c["tmesh"]
    lower = tmesh.patches[3]
    cells = tmesh.patch_face_cells(lower).numpy()
    uniq, count = np.unique(cells, return_counts=True)
    assert lower.name == "lowerWall" and (count == 2).sum() == 1
    rng = np.random.default_rng(7)
    G = rng.uniform(0.0, 1.0, tmesh.n_cells)
    jout = jax.jit(lambda mesh, st, U, G: runs["jturb"]._wall_fix(
        mesh, st, U, c["jnu"], G))(c["jmesh"], c["jstate"], c["jU"],
                                  jax.numpy.asarray(G))
    tout = c["turb"]._wall_fix(tmesh, c["tstate"], c["tU"], c["tnu"],
                               torch.from_numpy(G))
    for a, b in zip(tout, jout):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-12 * np.abs(b).max()
    corner = uniq[count == 2][0]
    assert float(tout[1][corner]) == 1.0


def test_ell_path_matches_gdia(runs):
    """The same iteration on the padded-ELL path (gdia_auto=False: the
    generic divDevReff chain, GAMG by pair agglomeration) reaches the
    fields of the gdia path: both solve the same discrete system to
    1e-12."""
    from rapidcfd_tpu_torch.models.transport import \
        SinglePhaseTransportModel
    from rapidcfd_tpu_torch.ops import fvc
    case = Case(runs["dir"], device=CPU, dtype=F64, gdia_auto=False)
    assert case.mesh.gdia is None
    U, p = case.read_field("U"), case.read_field("p")
    turb = make_ras_model(case, U)
    step = tsimple.make_step(
        case, SinglePhaseTransportModel(case.transport_properties()), turb,
        SimpleControl(case))
    with captured():
        U, p, _, ts, _ = step(U, p, fvc.flux(case.mesh, U),
                              turb.init_state(U))
    gcase, gout, _ = runs["port"][1]
    for name, f in [("U", U), ("p", p), ("k", ts["k"]),
                    ("epsilon", ts["epsilon"])]:
        a = case.maps.cells_to_file(f.data.numpy())
        b = gcase.maps.cells_to_file(gout[name].data.numpy())
        assert np.abs(a - b).max() <= 1e-8 * np.abs(b).max(), name


def test_residual_control(runs):
    """residualControl's regex key "(k|epsilon)" and fvSolution's quoted
    regex solver key resolve; the criteria need every matched field below
    its target."""
    case = runs["port"][1][0]
    for name in ("U", "k", "epsilon"):
        assert case.solver_controls(name).solver == "smoothSolver"
    assert case.solver_controls("p").solver == "GAMG"
    assert case.relaxation_factor("p", "fields") == 0.3
    assert case.relaxation_factor("epsilon") == 0.7
    assert case.ddt_scheme() == "steadyState"
    assert case.div_scheme("div(phi,k)") == ("bounded", "upwind")
    sc = SimpleControl(case)
    ok = dict(Ux=1e-5, Uy=1e-5, U=1e-5, p=1e-4, k=1e-5, epsilon=1e-5)
    assert sc.criteria_satisfied(ok)
    assert not sc.criteria_satisfied(dict(ok, epsilon=1e-3))
    assert not sc.criteria_satisfied(dict(ok, p=2e-3))
    assert not sc.criteria_satisfied({})


def test_cli_writes_fields_that_read_back(tmp_path):
    """`python -m rapidcfd_tpu_torch simpleFoam -case D -device cpu`: two
    iterations, the time directory holds U, p, k, epsilon and nut (the
    wall functions written by name), and they read back."""
    from rapidcfd_tpu_torch.__main__ import main
    d = str(tmp_path / "case")
    pitz_daily_case(d, scale=1, end_time=2)
    with captured() as buf:
        main(["simpleFoam", "-case", d, "-device", "cpu", "-precision",
              "fp64"])
    assert "Time = 2" in buf.getvalue() and "End" in buf.getvalue()
    assert "nutkWallFunction" in open(os.path.join(d, "2", "nut")).read()
    case = Case(d, device=CPU, dtype=F64)
    for name in ("U", "p", "k", "epsilon", "nut"):
        f = tio.read_vol_field(d, "2", name, case.mesh, case.maps)
        assert torch.isfinite(f.data).all()
        if name in ("k", "epsilon"):
            live = torch.as_tensor(case.maps.cell_primary)
            assert (f.data[live] > 0).all()


@contextlib.contextmanager
def _edited(path, old, new):
    text = open(path).read()
    assert old in text
    with open(path, "w") as f:
        f.write(text.replace(old, new))
    try:
        yield
    finally:
        with open(path, "w") as f:
            f.write(text)


def test_unported_options_raise(tmp_path):
    """Other RAS models, fvOptions entries and function objects raise
    and name themselves."""
    d = str(tmp_path / "case")
    pitz_daily_case(d, scale=1)
    ras = os.path.join(d, "constant", "RASProperties")
    with _edited(ras, "RASModel        kEpsilon;",
                 "RASModel        RNGkEpsilon;"):
        with pytest.raises(NotImplementedError, match="RNGkEpsilon"):
            make_ras_model(Case(d, device=CPU, dtype=F64), None)
    with open(os.path.join(d, "system", "fvOptions"), "w") as f:
        f.write("disk { type actuationDiskSource; }\n")
    with pytest.raises(NotImplementedError, match="actuationDiskSource"):
        tsimple.run(d, device=CPU, dtype=F64, write=False, max_steps=1)
    os.remove(os.path.join(d, "system", "fvOptions"))
    cdict = os.path.join(d, "system", "controlDict")
    with _edited(cdict, "runTimeModifiable true;",
                 "runTimeModifiable true;\nfunctions { probes { type "
                 "probes; } }"):
        with pytest.raises(NotImplementedError, match="functionObjects"):
            tsimple.run(d, device=CPU, dtype=F64, write=False, max_steps=1)
