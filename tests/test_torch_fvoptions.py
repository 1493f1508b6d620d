"""The port's fvOptions (models/fvoptions.py) and the porous mains against
the JAX package in fp64 on the CPU.

- Every option type's add_sup or constrain on an FvMatrix the JAX package
  built and interop carried into the port, on the 12x12 box (gdia and
  ELL) and on pitzDaily x1 (a masked gdia lattice), with the options'
  selection modes cycling through all, box, cellSet and cellZone (the set
  and the zone drawn from a numpy seed and written to the case):
  diag, source, lower and upper to 1e-12 relative to their largest
  magnitude; every selection mask equal to the JAX package's on every
  mesh.
- porousSimpleFoam on the 24x6x6 porous duct (the cellZone on gdia, the
  box on ELL), 3 iterations against the JAX package's simplefoam.run.
- pisoFoam with actuationDiskSource on the JAX test's 40x8 channel and
  with rotorDiskSource on its cavity (ELL), 5 steps each.
- buoyantBoussinesqSimpleFoam on the JAX test's channel with
  semiImplicitSource, limitTemperature and solidificationMeltingSource
  (casegen.boussinesq_channel_case), 3 iterations: the env the solver
  hands its options (T for the blockage) shows here.

The runs hold fields to 1e-8 relative and every iteration count within
one. Also: the dispatcher's porous names, and the refusal of an
fvOptions entry by interFoam and rhoSimpleFoam (the JAX package applies
none there)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapidcfd_tpu.fields.field import Dimensioned as JDimensioned
from rapidcfd_tpu.models import fvoptions as jfv  # noqa: F401 (registers)
from rapidcfd_tpu.ops import fvc as jfvc
from rapidcfd_tpu.ops import fvm as jfvm
from rapidcfd_tpu.solvers import buoyantfoam as jbf
from rapidcfd_tpu.solvers import simplefoam as jsimple
from rapidcfd_tpu.solvers.case import Case as JCase
from rapidcfd_tpu.utils.dictionary import parse_dictionary as jparse
from rapidcfd_tpu.utils.dimensions import dim_viscosity as jdim_viscosity
from rapidcfd_tpu.utils.registry import lookup as jlookup
from rapidcfd_tpu_torch import interop
from rapidcfd_tpu_torch.fields.field import Dimensioned
from rapidcfd_tpu_torch.mesh.polymesh import read_polymesh
from rapidcfd_tpu_torch.models import fvoptions as tfv
from rapidcfd_tpu_torch.solvers import buoyantfoam as tbf
from rapidcfd_tpu_torch.solvers import simplefoam as tsimple
from rapidcfd_tpu_torch.utils.casegen import (_write, boussinesq_channel_case,
                                              cavity_case, dam_break_case,
                                              disk_channel_case,
                                              hot_channel_case,
                                              pitz_daily_case,
                                              porous_duct_case)
from rapidcfd_tpu_torch.utils.dictionary import foamfile_header
from rapidcfd_tpu_torch.utils.dictionary import parse_dictionary as tparse
from rapidcfd_tpu_torch.utils.dimensions import dim_viscosity
from rapidcfd_tpu_torch.utils.logging import captured
from rapidcfd_tpu_torch.utils.registry import lookup as tlookup
from rapidcfd_tpu_torch.utils.unstructured import detect_lattice
from torch_heat_reference import (CPU, F64, cell_errors, counts_close,
                                  flux_error, jax_quiet, jax_switches,
                                  port_case, rel, run_jax, run_port)
from test_torch_pimplefoam import (_check_steps, _field_errors, _laminar,
                                   _run_jax, _run_port)

TOL = 1e-12
RUN_TOL = 1e-8
MODES = ("all", "box", "cellSet", "cellZone")


# -- the option types on carried matrices ---------------------------------

def _write_selections(d, n_file_cells, n_internal_faces, seed):
    """A cellSet `sel`, a cellZone `zone1` and a faceZone `hx` of the
    case's file labels, drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
    pm = os.path.join(d, "constant", "polyMesh")
    sel = np.sort(rng.choice(n_file_cells, n_file_cells // 3, replace=False))
    zone = np.sort(rng.choice(n_file_cells, n_file_cells // 4,
                              replace=False))
    faces = np.sort(rng.choice(n_internal_faces, 12, replace=False))
    os.makedirs(os.path.join(pm, "sets"), exist_ok=True)
    _write(os.path.join(pm, "sets", "sel"),
           foamfile_header("cellSet", "sel", "constant/polyMesh/sets"),
           f"\n{sel.size}\n(\n" + "\n".join(map(str, sel)) + "\n)\n")
    _write(os.path.join(pm, "cellZones"),
           foamfile_header("regIOobject", "cellZones", "constant/polyMesh"),
           f"\n1\n(\nzone1\n{{\n    type cellZone;\ncellLabels List<label>"
           f"\n{zone.size}\n(\n" + "\n".join(map(str, zone))
           + "\n)\n;\n}\n)\n")
    _write(os.path.join(pm, "faceZones"),
           foamfile_header("regIOobject", "faceZones", "constant/polyMesh"),
           f"\n1\n(\nhx\n{{\n    type faceZone;\nfaceLabels List<label>"
           f"\n{faces.size}\n(\n" + "\n".join(map(str, faces))
           + "\n)\n;\n}\n)\n")


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """name -> (JAX case, port Case on the same layout, port MeshArrays
    carried from the JAX mesh, the scalar field's name)."""
    box = str(tmp_path_factory.mktemp("box12"))
    pitz = str(tmp_path_factory.mktemp("pitz1"))
    with captured():
        dam_break_case(box, n=12)
        pitz_daily_case(pitz, scale=1)
    for i, d in enumerate((box, pitz)):
        pm = read_polymesh(d)
        _write_selections(d, pm.n_cells, pm.n_internal_faces, 10 + i)
    out = {}
    with jax_quiet():
        out["box-gdia"] = (JCase(box, lattice=detect_lattice(
            read_polymesh(box), full_box=True)), port_case(box, "gdia"),
            "p_rgh")
        out["pitz-gdia"] = (JCase(pitz), port_case(pitz, "gdia"), "p")
        with jax_switches(GDIA_AUTO="0", FORCE_RCM="1"):
            out["box-ell"] = (JCase(box), port_case(box, "ell"), "p_rgh")
    return {k: (jc, tc, interop.mesh_arrays(jc.mesh, device=CPU, dtype=F64),
                name) for k, (jc, tc, name) in out.items()}


@pytest.fixture(scope="module")
def inputs(meshes):
    """mesh id -> the JAX inputs of _inputs, one seed per mesh."""
    return {k: _inputs(jc, name, 100 + i)
            for i, (k, (jc, _, _, name)) in enumerate(sorted(meshes.items()))}


def _selection(mode, jmesh):
    if mode == "all":
        return "selectionMode all;"
    if mode == "box":
        C = np.asarray(jmesh.C)
        lo, hi = C.min(0), C.max(0)
        a, b = lo + 0.2 * (hi - lo), lo + 0.6 * (hi - lo)
        a[2], b[2] = lo[2] - 1.0, hi[2] + 1.0
        return (f"selectionMode box; box (({float(a[0])!r} {float(a[1])!r} {float(a[2])!r}) "
                f"({float(b[0])!r} {float(b[1])!r} {float(b[2])!r}));")
    if mode == "cellSet":
        return "selectionMode cellSet; cellSet sel;"
    return "selectionMode cellZone; cellZone zone1;"


def _upstream(jmesh):
    C = np.asarray(jmesh.C)
    p = C.min(0) + 0.1 * (C.max(0) - C.min(0))
    return f"({float(p[0])!r} {float(p[1])!r} {float(p[2])!r})"


_ROTOR = """rotorDiskSource; axis (1 0 0); origin {origin}; rpm 600;
    nBlades 3; tipEffect 0.96; inletFlowType local;
    blade {{ data ( (p1 (0.0 8.0 0.01)) (p2 (0.02 4.0 0.008))
                    (p1 (0.5 2.0 0.006)) ); }}
    profiles {{ p1 {{ type lookup; data ( (-90 0.2 -1.0) (-10 0.02 -0.6)
                    (0 0.01 0.0) (10 0.02 0.6) (90 0.2 1.0) ); }}
                p2 {{ type lookup; data ( (-90 0.3 -0.8) (0 0.02 0.1)
                    (90 0.3 0.8) ); }} }}
    fixedTrimCoeffs {{ theta0 4.0; theta1c 1.0; theta1s 0.5; }}
    flapCoeffs {{ beta0 2.0; beta1c 0.5; beta2s 0.3; }}"""

#: (case id, option type and its entries, the equation's field, hook)
OPTIONS = [
    ("porosity", "explicitPorositySource; DarcyForchheimerCoeffs { d d "
     "[0 -2 0 0 0 0 0] (1e5 2e5 3e5); f f [0 -1 0 0 0 0 0] (1 2 3); }",
     "U", "add_sup"),
    ("semi-scalar", "scalarSemiImplicitSource; volumeMode absolute; "
     "injectionRateSuSp { T (10 -2); }", "T", "add_sup"),
    ("semi-vector", "vectorSemiImplicitSource; volumeMode specific; "
     "injectionRateSuSp { U ((1 2 0) -0.5); }", "U", "add_sup"),
    ("pressure-gradient", "pressureGradientExplicitSource; Ubar (0.5 0.1 "
     "0); gradientInitial 0.1;", "U", "add_sup"),
    ("actuation-disk", "actuationDiskSource; diskDir (1 0.2 0); Cp 0.386; "
     "Ct 0.58; diskArea 0.002; upstreamPoint {up};", "U", "add_sup"),
    ("fixed-temperature", "fixedTemperatureConstraint; temperature 0.3;",
     "T", "constrain"),
    ("limit-temperature", "limitTemperature; Tmin 0.2; Tmax 0.7;", "T",
     "constrain"),
    ("mrf", "MRFSource; axis (0 0 1); omega omega [0 0 -1 0 0 0 0] 10;",
     "U", "add_sup"),
    ("set-value-vector", "vectorExplicitSetValue; injectionRate { U (0.1 "
     "0.2 0); }", "U", "constrain"),
    ("set-value-scalar", "scalarExplicitSetValue; injectionRate { T 0.4; }",
     "T", "constrain"),
    ("radial-disk", "radialActuationDiskSource; diskDir (1 0 0); Cp 0.386; "
     "Ct 0.58; diskArea 0.002; upstreamPoint {up}; coeffs (0.1 0.5 0.01);",
     "U", "add_sup"),
    ("rotor-disk", _ROTOR, "U", "add_sup"),
    ("melting-U", "solidificationMeltingSource; Tmelt 0.5; L 2.0; beta 3e-3; "
     "rhoRef 1000; Cp 1.5;", "U", "add_sup"),
    ("melting-T", "solidificationMeltingSource; Tmelt 0.5; L 2.0; beta 3e-3; "
     "rhoRef 1000; Cp 1.5;", "T", "add_sup"),
    ("heat-exchanger", "effectivenessHeatExchangerSource; faceZone hx; "
     "secondaryMassFlowRate 1.0; secondaryInletT 400; primaryInletT 300; "
     "Cp 1000; table ( (0.0 ( (0.5 0.3) (2.0 0.6) )) (1e-3 ( (0.5 0.5) "
     "(2.0 0.8) )) );", "T", "add_sup"),
]


def _inputs(jcase, scalar, seed):
    """JAX U, T (with an old level) and their matrices, from a seed."""
    jmesh = jcase.mesh
    rng = np.random.default_rng(seed)
    n = jmesh.n_cells
    with jax_quiet():
        jU = jcase.read_field("U")
        jT = jcase.read_field(scalar)
    jU = jU.replace(data=jnp.asarray(rng.uniform(-1, 1, (n, 3)))) \
        .correct_boundary_conditions(jmesh)
    jT = jT.replace(data=jnp.asarray(rng.uniform(0, 1, n))) \
        .correct_boundary_conditions(jmesh).store_old()
    jT = jT.replace(data=jnp.asarray(rng.uniform(0, 1, n))) \
        .correct_boundary_conditions(jmesh)
    nu = JDimensioned("nu", jdim_viscosity, 1e-3)

    @jax.jit
    def build(jmesh, jU, jT):
        jphi = jfvc.flux(jmesh, jU)
        return jphi, {"U": jfvm.div(jmesh, jphi, jU, "upwind")
                      - jfvm.laplacian(jmesh, nu, jU),
                      "T": jfvm.div(jmesh, jphi, jT, "upwind")
                      - jfvm.laplacian(jmesh, nu, jT)}
    with jax_quiet():
        jphi, jeqn = build(jmesh, jU, jT)
    return jU, jT, jphi, jeqn


def _option_pair(mesh_id, meshes, case_id, spec, i):
    jcase, tcase, tmesh, scalar = meshes[mesh_id]
    mode = MODES[i % 4]
    typ, _, rest = spec.partition(";")
    origin = np.asarray(jcase.mesh.C).mean(0)
    body = (rest.replace("{up}", _upstream(jcase.mesh))
            .replace("{origin}", "(%r %r %r)" % tuple(map(float, origin)))
            .replace("{{", "{").replace("}}", "}"))
    text = (f"opt {{ type {typ.strip()}; {_selection(mode, jcase.mesh)} "
            f"{body} }}")
    with jax_quiet():
        jopt = jlookup("fvOption", typ.strip())(
            case_id, jparse(text)["opt"], jcase.mesh, jcase)
    topt = tlookup("fvOption", typ.strip())(
        case_id, tparse(text)["opt"], tcase.mesh, tcase)
    return jopt, topt, mode


def _set_vector_by_components(jmesh, jopt, jeqn):
    """The JAX package's set_values takes a scalar system only (a vector
    explicitSetValue fails there: ROADMAP Queue 3); its vector result is
    that of each component's scalar system."""
    vals = np.broadcast_to(jopt.values["U"], (jmesh.n_cells, 3))
    parts = [jeqn.replace(source=jeqn.source[:, c]).set_values(
        jmesh, jopt.mask, jnp.asarray(vals[:, c])) for c in range(3)]
    return parts[0].replace(source=jnp.stack([p.source for p in parts], 1))


@pytest.mark.parametrize("mesh_id", ["box-gdia", "box-ell", "pitz-gdia"])
@pytest.mark.parametrize("i", range(len(OPTIONS)),
                         ids=[o[0] for o in OPTIONS])
def test_option_matches_jax(meshes, inputs, mesh_id, i):
    """The option's mask, then its add_sup or constrain on the carried
    matrix, with the env the solvers pass (nu, T with its old level, phi,
    U, dt), to 1e-12."""
    case_id, spec, field, hook = OPTIONS[i]
    jcase, tcase, tmesh, scalar = meshes[mesh_id]
    jopt, topt, mode = _option_pair(mesh_id, meshes, case_id, spec, i)
    jmask = np.asarray(jopt.mask)
    assert np.array_equal(topt.mask.numpy(), jmask), mode
    if mode != "all":
        assert 0 < jmask.sum() < jmask.size
    assert topt.applies_to(field) and jopt.applies_to(field)
    jU, jT, jphi, jeqn = inputs[mesh_id]
    jnu = JDimensioned("nu", jdim_viscosity, 1.5e-2)
    jenv = dict(nu=jnu, T=jT, phi=jphi, U=jU, dt=0.01)
    tenv = dict(nu=Dimensioned("nu", dim_viscosity, 1.5e-2),
                T=interop.vol_field(jT, device=CPU, dtype=F64),
                phi=interop.surface_field(jphi, device=CPU, dtype=F64),
                U=interop.vol_field(jU, device=CPU, dtype=F64), dt=0.01)
    assert tenv["T"].old is not None
    teqn = interop.fv_matrix(jeqn[field], device=CPU, dtype=F64)
    with jax_quiet():
        if case_id == "set-value-vector":
            jout = _set_vector_by_components(jcase.mesh, jopt, jeqn[field])
        else:
            jout = getattr(jopt, hook)(jcase.mesh, field, jeqn[field], jenv)
    tout = getattr(topt, hook)(tmesh, field, teqn, tenv)
    changed = False
    for part in ("diag", "source", "lower", "upper"):
        a, b = getattr(tout, part).numpy(), np.asarray(getattr(jout, part))
        assert a.shape == b.shape
        assert rel(a, b) <= TOL, (part, rel(a, b))
        changed |= not np.array_equal(b, np.asarray(getattr(jeqn[field],
                                                           part)))
    assert changed, "the option left the matrix as it was"


@pytest.mark.parametrize("mesh_id", ["box-gdia", "box-ell", "pitz-gdia"])
def test_selection_masks_match_jax(meshes, mesh_id):
    """The four selection modes give the JAX package's mask on every
    layout: dead and ghost slots included."""
    jcase, tcase, _, _ = meshes[mesh_id]
    for mode in MODES:
        text = f"opt {{ {_selection(mode, jcase.mesh)} }}"
        jm = jfv._selection_mask(jcase.mesh, jparse(text)["opt"], jcase)
        tm = tfv._selection_mask(tcase.mesh, tparse(text)["opt"], tcase)
        assert np.array_equal(tm.numpy(), np.asarray(jm)), mode


def test_unknown_option_type_raises(meshes, tmp_path):
    """An fvOptions entry of a type neither package has raises and names
    itself (the JAX package logs and skips it)."""
    tcase = meshes["box-ell"][1]
    d = str(tmp_path / "c")
    os.makedirs(os.path.join(d, "system"))
    with open(os.path.join(d, "system", "fvOptions"), "w") as f:
        f.write("src1 { type noSuchSource; }\n")
    tcase_dir = tcase.dir
    try:
        tcase.dir = d
        with pytest.raises(NotImplementedError, match="noSuchSource"):
            tfv.FvOptions(tcase)
    finally:
        tcase.dir = tcase_dir


# -- porousSimpleFoam on the duct ----------------------------------------------

def _simple_its(stats):
    its = [(f"U{c}", int(pf[2])) for c, pf in zip("xyz", stats["u_perf"])]
    its += [("p", int(pf[2])) for pf in stats["p_perf"]]
    return its + [(k, int(pf[2])) for k, pf in sorted(stats["turb"].items())]


@pytest.fixture(scope="module", params=["gdia", "ell"])
def duct(request, tmp_path_factory):
    layout = request.param
    d = str(tmp_path_factory.mktemp("duct_" + layout))
    with captured():
        porous_duct_case(d, 24, 6, 6,
                         zone="cellZone" if layout == "gdia" else "box")
    jrun = run_jax(jsimple, d, 3, layout, _simple_its)
    return layout, jrun, run_port(tsimple, d, 3, layout)


def test_porous_duct_matches_jax(duct):
    """U, p, k, epsilon and nut after 3 iterations within 1e-8 of the JAX
    package's, phi on the faces a sum reads; counts within one; the
    porous block holds back the flow (Darcy's pressure drop)."""
    layout, ((jcase, jU, jp, jphi, jts), jits), \
        ((tcase, tU, tp, tphi, tts), tits) = duct
    errs = cell_errors(tcase, jcase, dict(
        U=(tU, jU), p=(tp, jp), **{k: (tts[k], jts[k]) for k in tts}))
    errs["phi"] = flux_error(tcase, jcase, tphi, jphi)
    assert sorted(tts) == ["epsilon", "k", "nut"]
    assert max(errs.values()) <= RUN_TOL, errs
    assert counts_close(tits, jits), (tits, jits)
    assert (tcase.mesh.gdia is not None) == (layout == "gdia")
    C = tcase.mesh.C[:, 0]
    p_in = float(tp.data[C < 0.15].mean())
    p_out = float(tp.data[C > 0.25].mean())
    assert p_in > p_out > -1.0


def test_porous_zone_written_without_mesh(tmp_path):
    """write_mesh=False still writes the porosity cellZone, and the
    lattice the writer hands out is the one detect_lattice finds."""
    from rapidcfd_tpu_torch.mesh.toposet import read_cell_zones
    d = str(tmp_path / "duct")
    lat = {}
    with captured():
        pm = porous_duct_case(d, 24, 6, 6, write_mesh=False,
                              lattice_out=lat)
    assert not os.path.exists(os.path.join(d, "constant", "polyMesh",
                                           "points"))
    zone = read_cell_zones(d)["porosity"]
    assert zone.size == 7 * 36
    found = detect_lattice(pm, full_box=True)
    for key in lat:
        assert np.array_equal(np.asarray(found[key]), np.asarray(lat[key]))


# -- pisoFoam with the disks ---------------------------------------------------

_CAVITY_ROTOR = """
rotor1
{
    type            rotorDiskSource;
    selectionMode   box;
    box             ((0.03 0.03 0) (0.07 0.07 0.01));
    origin          (0.05 0.05 0.005);
    axis            (0 0 1);
    rpm             600;
    nBlades         2;
    tipEffect       0.96;
    inletFlowType   local;
    blade
    {
        data ( (profile1 (0.001 8.0 0.01))
               (profile1 (0.05 4.0 0.008)) );
    }
    profiles
    {
        profile1
        {
            type lookup;
            data ( (-90 0.2 -1.0) (-10 0.02 -0.6) (0 0.01 0.0)
                   (10 0.02 0.6) (90 0.2 1.0) );
        }
    }
    fixedTrimCoeffs { theta0 4.0; theta1c 0.0; theta1s 0.0; }
}
"""


@pytest.fixture(scope="module", params=["actuation-disk", "rotor-disk"])
def disk_run(request, tmp_path_factory):
    d = str(tmp_path_factory.mktemp(request.param))
    if request.param == "actuation-disk":
        with captured():
            disk_channel_case(d)
    else:
        cavity_case(d, end_time=0.05)
        _laminar(d)
        _write(os.path.join(d, "system", "fvOptions"),
               foamfile_header("dictionary", "fvOptions", "system"),
               _CAVITY_ROTOR)
    return (request.param, _run_jax(d, 5, piso=True),
            _run_port(d, 5, piso=True, gdia=False))


def test_piso_disk_matches_jax(disk_run):
    """U, p and phi after 5 steps within 1e-8 of the JAX package's, every
    step's dt and counts; the disk shows: a pressure jump across the
    actuation disk, angular momentum about the rotor's hub."""
    which, jrun, trun = disk_run
    err = _field_errors(jrun, trun)
    assert max(err.values()) <= RUN_TOL, err
    _check_steps(jrun[2], trun[2])
    tcase, tf, _ = trun
    assert tcase.mesh.gdia is None
    C = tcase.mesh.C
    if which == "actuation-disk":
        p = tf["p"].data
        up = (C[:, 0] > 0.1) & (C[:, 0] < 0.4)
        down = (C[:, 0] > 0.6) & (C[:, 0] < 0.9)
        assert float(p[up].mean() - p[down].mean()) > 0.1
    else:
        r = C - torch.tensor([0.05, 0.05, 0.005], dtype=F64)
        u = tf["U"].data
        lz = (tcase.mesh.V * (r[:, 0] * u[:, 1] - r[:, 1] * u[:, 0])).sum()
        assert abs(float(lz)) > 1e-10


# -- buoyantBoussinesqSimpleFoam with sources ----------------------------------

def _boussinesq_its(stats):
    its = [(f"U{c}", int(pf[2])) for c, pf in zip("xyz", stats["u_perf"])]
    its.append(("T", int(stats["t_perf"][0][2])))
    return its + [("p_rgh", int(pf[2])) for pf in stats["p_perf"]]


@pytest.fixture(scope="module")
def boussinesq_run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("bsources"))
    with captured():
        boussinesq_channel_case(d)
    return (run_jax(jbf, d, 3, "ell", _boussinesq_its),
            run_port(tbf, d, 3, "ell"))


def test_boussinesq_sources_match_jax(boussinesq_run):
    """U, p_rgh and T after 3 iterations within 1e-8 of the JAX
    package's, phi on the faces a sum reads, counts within one: the
    melting source sees T (the solid box blocks the flow), the heating
    and the clamp act on T. The clamp fixes the cells that the second
    iteration took above Tmax (the first stays below it): a cell fixed at
    Tmax in two iterations in a row would be left free or fixed again by
    the rounding of its solved value, in both packages."""
    ((jcase, jU, jp, jT, jphi, _), jits), \
        ((tcase, tU, tp, tT, tphi, _), tits) = boussinesq_run
    errs = cell_errors(tcase, jcase, dict(U=(tU, jU), p_rgh=(tp, jp),
                                          T=(tT, jT)))
    errs["phi"] = flux_error(tcase, jcase, tphi, jphi)
    assert max(errs.values()) <= RUN_TOL, errs
    assert counts_close(tits, jits), (tits, jits)
    C = tcase.mesh.C
    mid = (C[:, 0] > 0.45) & (C[:, 0] < 0.75)
    solid = float(tU.data[mid & (C[:, 1] < 0.1)][:, 0].abs().max())
    bypass = float(tU.data[mid & (C[:, 1] > 0.1)][:, 0].abs().max())
    assert solid < 0.1 * bypass
    # the same 3 iterations without limit1 reach 300.689 (a CPU run)
    assert 300.0 < float(tT.data.max()) < 300.35


# -- the dispatcher and the refusals -------------------------------------------

def test_porous_mains_in_the_dispatcher(tmp_path):
    """porousSimpleFoam, porousInterFoam and rhoPorousSimpleFoam map onto
    simpleFoam, interFoam and rhoSimpleFoam; porousSimpleFoam runs the
    duct through the CLI on the gdia lattice."""
    from rapidcfd_tpu_torch.__main__ import SOLVERS, main
    assert SOLVERS["porousSimpleFoam"] == SOLVERS["simpleFoam"]
    assert SOLVERS["porousInterFoam"] == SOLVERS["interFoam"]
    assert SOLVERS["rhoPorousSimpleFoam"] == SOLVERS["rhoSimpleFoam"]
    d = str(tmp_path / "duct")
    with captured():
        porous_duct_case(d, 24, 6, 6, end_time=2)
    with captured() as buf:
        main(["porousSimpleFoam", "-case", d, "-device", "cpu", "-gdiaBox",
              "-noWrite"])
    out = buf.getvalue()
    assert "lattice 24x6x6" in out and "Time = 2" in out
    assert "Creating fvOption porosity1 of type explicitPorositySource" \
        in out


@pytest.mark.parametrize("solver", ["interFoam", "porousInterFoam",
                                    "rhoSimpleFoam", "rhoPorousSimpleFoam"])
def test_porous_aliases_refuse_options(tmp_path, solver):
    """interFoam and rhoSimpleFoam (and their porous aliases) refuse an
    fvOptions entry and say why; an empty file is no entry."""
    from rapidcfd_tpu_torch.__main__ import main
    d = str(tmp_path / "case")
    with captured():
        if "nterFoam" in solver:
            dam_break_case(d, n=8, end_time=0.002)
        else:
            hot_channel_case(d, end_time=1)
    path = os.path.join(d, "system", "fvOptions")
    _write(path, foamfile_header("dictionary", "fvOptions", "system"), "\n")
    with captured():
        main([solver, "-case", d, "-device", "cpu", "-noWrite"])
    _write(path, foamfile_header("dictionary", "fvOptions", "system"),
           "porosity1 { type explicitPorositySource; d (1e5 1e5 1e5); }\n")
    with pytest.raises(NotImplementedError,
                       match="JAX package applies no fvOptions"):
        with captured():
            main([solver, "-case", d, "-device", "cpu", "-noWrite"])
