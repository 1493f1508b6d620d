"""The port's compressible slice against the JAX package in fp64 on the
CPU: sonicFoam on the Mach-3 forward step and rhoSimpleFoam on the heated
channel. Both packages read the same case directories, written by the
port's case writers; random inputs come from numpy seeds.

- read_thermo, PerfectGasThermo and PsiThermo on both cases'
  thermophysicalProperties (and a Sutherland variant): every property
  and the energy field with its boundary conditions to 1e-13 relative.
- The eight limited schemes (and linearUpwind) on a scalar and a vector
  field with a face flux of both signs, on the forward step's gdia
  lattice (scale 1) and on the same mesh as a padded ELL: the owner
  weights to 1e-12, on gdia in file order through faces_to_file.
- slip and symmetryPlane: evaluate and the coefficient hooks, and the
  per-component implicit coefficients through the gdia fold
  (FvMatrix.component_system_all); fvm.ddt with a density coefficient.
- 5 sonicFoam steps on the forward step (gdia, and ELL under gdia_auto=
  False, the JAX run with RCFD_GDIA_AUTO=0), 5 rhoSimpleFoam iterations
  on the heated channel, laminar and with kEpsilon (the files of
  tests/test_compressible.py): fields to 1e-8 relative to their largest
  magnitude, iteration counts within one per solve.

Each JAX solver step gets inputs that already carry the old time levels
its outputs carry, so it compiles once."""

import contextlib
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from rapidcfd_tpu.fields import bcs as jbcs
from rapidcfd_tpu.fields.field import SurfaceField as JSurface
from rapidcfd_tpu.models import thermo as jthermo
from rapidcfd_tpu.ops import fvm as jfvm
from rapidcfd_tpu.ops import interpolation as jinterp
from rapidcfd_tpu.solvers import rhosimplefoam as jrhosimple
from rapidcfd_tpu.solvers import sonicfoam as jsonic
from rapidcfd_tpu.solvers.case import Case as JCase
from rapidcfd_tpu.utils import logging as jlog
from rapidcfd_tpu.utils import switches
from rapidcfd_tpu.utils.dictionary import parse_file as jparse
from rapidcfd_tpu.utils.dimensions import DimensionSet as JDims
from rapidcfd_tpu.utils.registry import lookup as jlookup
from rapidcfd_tpu_torch import interop
from rapidcfd_tpu_torch.fields import bcs as tbcs
from rapidcfd_tpu_torch.fields.field import shift_level
from rapidcfd_tpu_torch.models import thermo as tthermo
from rapidcfd_tpu_torch.ops import fvm as tfvm
from rapidcfd_tpu_torch.ops import interpolation as tinterp
from rapidcfd_tpu_torch.solvers import rhosimplefoam as trhosimple
from rapidcfd_tpu_torch.solvers import sonicfoam as tsonic
from rapidcfd_tpu_torch.solvers.case import Case
from rapidcfd_tpu_torch.utils.casegen import (_write, forward_step_case,
                                              hot_channel_case, write_field)
from rapidcfd_tpu_torch.utils.dictionary import foamfile_header, parse_file
from rapidcfd_tpu_torch.utils.logging import captured

CPU = torch.device("cpu")
F64 = torch.float64
LIMITED = ("vanLeer", "Minmod", "vanAlbada", "MUSCL", "SuperBee", "OSPRE",
           "UMIST", "limitedLinear")


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


@contextlib.contextmanager
def xla_unoptimized():
    """JAX with XLA's optimisations off (jax_disable_most_optimizations),
    restored on the way out. The limited schemes' r is set by rounding
    wherever a field is uniform (the 1e-30 guard on psiN - psiO), and XLA's
    fused, reassociated arithmetic rounds otherwise than op-by-op
    evaluation: the JAX package's own jitted and eager sonicFoam runs of
    the forward step differ by 1e-3 after one step
    (tests/crosscheck_compressible.py --jit-spread). Unoptimised, the
    jitted step rounds as eager evaluation does (within 1e-12), which is
    how the port evaluates, and it compiles faster."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", old)


@contextlib.contextmanager
def jax_quiet():
    old = jlog.Info.enabled
    jlog.Info.enabled = False
    try:
        yield
    finally:
        jlog.Info.enabled = old


def _rel(a, b) -> float:
    a, b = np.broadcast_arrays(np.asarray(a, dtype=float),
                               np.asarray(b, dtype=float))
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# -- cases --------------------------------------------------------------------

@pytest.fixture(scope="module")
def fstep(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("fstep"))
    forward_step_case(d)
    return d


@pytest.fixture(scope="module")
def hot(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("hot"))
    hot_channel_case(d)
    return d


def _add_kepsilon(d):
    """tests/test_compressible.py's kEpsilon files for the heated
    channel."""
    _write(os.path.join(d, "constant", "RASProperties"),
           foamfile_header("dictionary", "RASProperties", "constant"),
           "\nRASModel        kEpsilon;\nturbulence      on;\n")
    fs = os.path.join(d, "system", "fvSolution")
    s = open(fs).read().replace('"(U|h)"', '"(U|h|k|epsilon)"')
    open(fs, "w").write(s)
    fsch = os.path.join(d, "system", "fvSchemes")
    s = open(fsch).read().replace(
        "div(phi,U)      bounded Gauss upwind;",
        "div(phi,U)      bounded Gauss upwind;\n"
        "    div(phi,k)      bounded Gauss upwind;\n"
        "    div(phi,epsilon) bounded Gauss upwind;")
    open(fsch, "w").write(s)
    k_in = 1.5 * (0.05 * 10.0) ** 2
    eps_in = 0.09 ** 0.75 * k_in ** 1.5 / 0.01
    write_field(d, "0", "k", "volScalarField", "[0 2 -2 0 0 0 0]",
                f"uniform {k_in}", {
                    "inlet": "        type            fixedValue;\n"
                             f"        value           uniform {k_in};\n",
                    "outlet": "        type            zeroGradient;\n",
                    "walls": "        type            kqRWallFunction;\n"
                             f"        value           uniform {k_in};\n",
                    "frontAndBack": "        type            empty;\n"})
    write_field(d, "0", "epsilon", "volScalarField", "[0 2 -3 0 0 0 0]",
                f"uniform {eps_in}", {
                    "inlet": "        type            fixedValue;\n"
                             f"        value           uniform {eps_in};\n",
                    "outlet": "        type            zeroGradient;\n",
                    "walls":
                        "        type            epsilonWallFunction;\n"
                        f"        value           uniform {eps_in};\n",
                    "frontAndBack": "        type            empty;\n"})
    write_field(d, "0", "nut", "volScalarField", "[0 2 -1 0 0 0 0]",
                "uniform 0", {
                    "inlet": "        type            calculated;\n"
                             "        value           uniform 0;\n",
                    "outlet": "        type            calculated;\n"
                              "        value           uniform 0;\n",
                    "walls": "        type            nutkWallFunction;\n"
                             "        value           uniform 0;\n",
                    "frontAndBack": "        type            empty;\n"})


@pytest.fixture(scope="module")
def hot_ke(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("hot_ke"))
    hot_channel_case(d)
    _add_kepsilon(d)
    return d


_ELL = dict(GDIA_AUTO="0", FORCE_RCM="1")


@pytest.fixture(scope="module")
def meshes(fstep):
    """The forward step (scale 1) as the JAX package builds it, on the
    gdia lattice and on the padded ELL, with the port's copy of each."""
    out = {}
    for layout, env in (("gdia", {}), ("ell", _ELL)):
        with jax_switches(**env), jax_quiet():
            jcase = JCase(fstep)
        assert (jcase.mesh.gdia is not None) == (layout == "gdia")
        out[layout] = (jcase, interop.mesh_arrays(jcase.mesh, device=CPU,
                                                  dtype=F64))
    return out


# -- thermo -------------------------------------------------------------------

_SUTHERLAND = """
thermoType
{
    type            hePsiThermo;
    mixture         pureMixture;
    transport       sutherland;
    thermo          hConst;
    equationOfState perfectGas;
    specie          specie;
    energy          sensibleEnthalpy;
}
mixture
{
    specie         { nMoles 1; molWeight 28.9; }
    thermodynamics { Cp 1007; Hf 0; }
    transport      { As 1.4792e-06; Ts 116; }
}
"""


def _thermo_dicts(fstep, hot, tmp_path):
    path = str(tmp_path / "sutherland")
    _write(path, foamfile_header("dictionary", "thermophysicalProperties",
                                 "constant"), _SUTHERLAND)
    return [os.path.join(fstep, "constant", "thermophysicalProperties"),
            os.path.join(hot, "constant", "thermophysicalProperties"), path]


def test_read_thermo_matches_jax(fstep, hot, tmp_path):
    """The perfect-gas bundle of each dictionary: the same fields, and
    every property on random states to 1e-13."""
    rng = np.random.default_rng(11)
    T = rng.uniform(0.5, 900.0, 257)
    p = rng.uniform(0.1, 2e5, 257)
    he = rng.uniform(-3e3, 3e5, 257)
    for path in _thermo_dicts(fstep, hot, tmp_path):
        jm = jthermo.read_thermo(jparse(path))
        tm = tthermo.read_thermo(parse_file(path))
        assert type(jm).__name__ == "PerfectGasThermo"
        assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
        for prop in ("r", "cv", "gamma"):
            assert getattr(tm, prop) == getattr(jm, prop)
        tt, tp, th = (torch.tensor(a, dtype=F64) for a in (T, p, he))
        for name, targs, jargs in (
                ("he_from_t", (tt,), (T,)), ("t_from_he", (th,), (he,)),
                ("psi", (tt,), (T,)), ("rho", (tp, tt), (p, T)),
                ("mu", (tt,), (T,)), ("alpha_h", (tt,), (T,)),
                ("c_sound", (tt,), (T,))):
            a = getattr(tm, name)(*targs)
            b = getattr(jm, name)(*jargs)
            assert _rel(a, b) <= 1e-13, (path, name)
    assert float(tm.rho(1e5, 300.0)) == pytest.approx(
        float(jm.rho(1e5, 300.0)), rel=1e-14)


def test_read_thermo_refuses_the_general_stack(tmp_path):
    """janaf (and the other stacks the JAX package's SpecieThermo
    serves) goes to the general specie stack in both packages; it raised
    in the port until the stack was ported (tests/test_torch_thermo.py
    holds the stack itself): the port's bundle has the JAX package's
    fields."""
    path = str(tmp_path / "janaf")
    _write(path, foamfile_header("dictionary", "thermophysicalProperties",
                                 "constant"),
           _SUTHERLAND.replace("hConst", "janaf"))
    assert jthermo._wants_general_stack(jparse(path))
    assert tthermo._wants_general_stack(parse_file(path))
    a = tthermo.read_thermo(parse_file(path))
    b = jthermo.read_thermo(jparse(path))
    assert isinstance(a, tthermo.SpecieThermo) and a.cp_mode == "janaf"
    assert {k: getattr(a, k) for k in a.__dataclass_fields__} \
        == {k: getattr(b, k) for k in b.__dataclass_fields__}


@pytest.mark.parametrize("layout", ["gdia", "ell"])
def test_psi_thermo_matches_jax(meshes, layout):
    """he_field (the energy field with BCs from T's: fixed T -> fixed e,
    others zeroGradient, empty kept) and update_t on a random T."""
    import jax.numpy as jnp
    jcase, tmesh = meshes[layout]
    jm = jthermo.read_thermo(jcase.constant_dict("thermophysicalProperties"))
    with jax_quiet():
        jT = jcase.read_field("T")
    rng = np.random.default_rng(5)
    jT = jT.replace(data=jnp.asarray(rng.uniform(0.8, 3.0, jT.data.shape)))
    jT = jT.correct_boundary_conditions(jcase.mesh)
    tT = interop.vol_field(jT, device=CPU, dtype=F64)
    jpt = jthermo.PsiThermo(jcase, jm)
    tpt = tthermo.PsiThermo(None, tthermo.read_thermo(
        parse_file(os.path.join(jcase.dir, "constant",
                                "thermophysicalProperties"))))
    je, te = jpt.he_field(jcase.mesh, jT), tpt.he_field(tmesh, tT)
    assert [type(b).__name__ for b in te.bcs] == \
        [type(b).__name__ for b in je.bcs]
    assert _rel(te.data, je.data) <= 1e-13
    assert _rel(te.bvalues, je.bvalues) <= 1e-13
    for tb, jb in zip(te.bcdata, je.bcdata):
        assert sorted(tb) == sorted(jb or {})
        for k in tb:
            assert _rel(tb[k], jb[k]) <= 1e-13
    he = rng.uniform(-800.0, -700.0, jT.data.shape)
    jT2 = jpt.update_t(jcase.mesh, jT, je.replace(data=jnp.asarray(he)))
    tT2 = tpt.update_t(tmesh, tT, te.replace(data=torch.tensor(he)))
    assert _rel(tT2.data, jT2.data) <= 1e-13
    assert _rel(tT2.bvalues, jT2.bvalues) <= 1e-13


# -- the limited schemes -----------------------------------------------------

def _random_fields(jcase, seed):
    """(scalar p, vector U) with random internal and boundary values and
    a face flux of both signs, as JAX objects."""
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    mesh = jcase.mesh
    with jax_quiet():
        jp, jU = jcase.read_field("p"), jcase.read_field("U")
    out = []
    for f in (jp, jU):
        f = f.replace(data=jnp.asarray(rng.standard_normal(f.data.shape)),
                      bvalues=jnp.asarray(rng.standard_normal(
                          f.bvalues.shape)))
        out.append(f.correct_boundary_conditions(mesh))
    phi = JSurface(jnp.asarray(rng.standard_normal(mesh.n_faces)),
                   JDims.of(1, 0, -1), "phi")
    return out, phi


def _weights_in_file_order(jcase, tmesh, a):
    """Owner weights of the real internal faces in polyMesh order (gdia:
    slots through faces_to_file) or in the device order both packages
    share under RCM (ELL)."""
    a = np.asarray(a)
    if tmesh.gdia is None:
        return a
    from rapidcfd_tpu_torch.mesh.polymesh import read_polymesh
    n_int = read_polymesh(jcase.dir).n_internal_faces
    full = np.concatenate([a, np.zeros(jcase.mesh.n_faces - a.shape[0])])
    return np.asarray(jcase.maps.faces_to_file(full))[:n_int]


@pytest.fixture(scope="module")
def limited_weights(meshes):
    """Every limited scheme's owner weights by the port (the whole scheme
    through scheme_weights) and by the JAX package (its r, computed once
    per field, through its limiter and _limited_weights, which is what
    its registered scheme returns), on both layouts, for a scalar and a
    vector field: {(layout, rank, scheme): (port, JAX)} in file order;
    the port's raw slot arrays; and both packages' r per (layout,
    rank)."""
    out, raw, rs = {}, {}, {}
    for layout, (jcase, tmesh) in meshes.items():
        (jp, jU), jphi = _random_fields(jcase, seed=17)
        tphi = interop.surface_field(jphi, device=CPU, dtype=F64)
        for rank, jf in (("scalar", jp), ("vector", jU)):
            tf = interop.vol_field(jf, device=CPU, dtype=F64)
            with xla_unoptimized():
                jr = jax.jit(jinterp._face_r)(jcase.mesh, jf, jphi)
            rs[layout, rank] = (tinterp._face_r(tmesh, tf, tphi).numpy(),
                                np.asarray(jr))
            for name in LIMITED + ("limitedLinear 0.5", "vanLeerV",
                                   "Minmod01", "linearUpwind"):
                word, *args = name.split()
                # the scheme's words as the dictionary parser gives them
                tw = tinterp.scheme_weights(tmesh, tf, (word, *args) if args
                                            else word, tphi)
                if word == "linearUpwind":
                    jw = jlookup("surfaceInterpolation", word)(
                        jcase.mesh, jf, jphi)
                else:
                    base = word[:-1] if word.endswith("V") else \
                        word[:-2] if word.endswith("01") else word
                    jw = jinterp._limited_weights(
                        jcase.mesh, jphi, jinterp._LIMITERS[base](jr, *args))
                raw[layout, rank, name] = tw
                out[layout, rank, name] = tuple(
                    _weights_in_file_order(jcase, tmesh, w)
                    for w in (tw.numpy(), jw))
    return out, raw, rs


@pytest.mark.parametrize("layout", ["gdia", "ell"])
@pytest.mark.parametrize("rank", ["scalar", "vector"])
def test_limited_weights_match_jax(limited_weights, layout, rank):
    out, raw, _ = limited_weights
    for (lay, rk, name), (a, b) in out.items():
        if (lay, rk) != (layout, rank):
            continue
        assert a.shape == b.shape and a.size > 0
        assert np.abs(a - b).max() <= 1e-12, name
        assert bool(torch.isfinite(raw[lay, rk, name]).all()), name


def test_limited_schemes_are_the_jax_registry():
    """The JAX package registers each limited scheme (and its V and 01
    names) as _limited_weights of its limiter, which is what the
    comparison above takes; both registries hold the same limiters."""
    import inspect
    assert sorted(jinterp._LIMITERS) == sorted(tinterp._LIMITERS)
    for name in LIMITED:
        for word in (name, name + "V", name + "01"):
            src = inspect.getsource(jlookup("surfaceInterpolation", word))
            assert "_limited_weights(mesh, phi, limiter(r, *args))" in src


def test_limiters_blend_upwind_and_linear(limited_weights):
    """limitedLinear (any k) keeps its limiter in [0, 1], so its weights
    lie between the upwind and the linear ones; linearUpwind takes the
    upwind weights of a flux of both signs."""
    out, _, _ = limited_weights
    for (layout, rank, name), (a, _) in out.items():
        if name.startswith("limitedLinear"):
            assert a.min() >= -1e-12 and a.max() <= 1.0 + 1e-12, name
    a = out["ell", "scalar", "linearUpwind"][0]
    assert set(np.unique(a)) == {0.0, 1.0}


def test_limited_scheme_registry():
    assert sorted(tinterp._LIMITERS) == sorted(LIMITED)
    for name in LIMITED:
        for word in (name, name + "V", name + "01"):
            assert word in tinterp.SCHEMES
    with pytest.raises(NotImplementedError, match="not in the registry"):
        tinterp.scheme_weights(None, None, "noSuchScheme", None)


@pytest.mark.parametrize("layout", ["gdia", "ell"])
@pytest.mark.parametrize("rank", ["scalar", "vector"])
def test_face_r_matches_jax(limited_weights, layout, rank):
    """The gradient ratio itself, on every slot of the gdia lattice
    (dummy and dead faces included: finite, not NaN) and on ELL; faces
    where the 1e-30 guard sets r agree in sign."""
    a, b = limited_weights[2][layout, rank]
    assert np.isfinite(a).all() and a.shape == b.shape
    real = np.abs(b) < 1e20
    assert _rel(a[real], b[real]) <= 1e-12
    assert np.array_equal(np.sign(a[~real]), np.sign(b[~real]))


# -- slip and symmetryPlane --------------------------------------------------

@pytest.mark.parametrize("word", ["slip", "symmetryPlane", "symmetry"])
@pytest.mark.parametrize("ncomp", [1, 3])
def test_slip_symmetry_match_jax(meshes, word, ncomp):
    """evaluate and the value/gradient coefficient hooks on the forward
    step's obstacle patch (normals along x and y) for a random field."""
    import jax.numpy as jnp
    jcase, tmesh = meshes["gdia"]
    jmesh = jcase.mesh
    pi = [p.name for p in jmesh.patches].index("obstacle")
    rng = np.random.default_rng(3 + ncomp)
    shape = (jmesh.n_cells,) if ncomp == 1 else (jmesh.n_cells, 3)
    n_b = int(jmesh.n_faces - jmesh.n_internal)
    with jax_quiet():
        jU = jcase.read_field("U")
    bcs = tuple(jbcs.make_bc(word if i == pi else "zeroGradient", i)
                for i in range(len(jmesh.patches)))
    jf = jU.replace(data=jnp.asarray(rng.standard_normal(shape)),
                    bvalues=jnp.asarray(rng.standard_normal(
                        (n_b,) + shape[1:])),
                    bcs=bcs, bcdata=tuple({} for _ in bcs))
    tf = interop.vol_field(jf, device=CPU, dtype=F64)
    jbc, tbc = jf.bcs[pi], tf.bcs[pi]
    assert type(tbc).__name__ == type(jbc).__name__
    assert tbc == tbcs.make_bc(word, pi)
    jp, tp = jmesh.patches[pi], tmesh.patches[pi]
    for hook in ("evaluate", "value_internal_coeff",
                 "gradient_internal_coeff", "value_coeffs",
                 "gradient_coeffs", "snGrad"):
        a = getattr(tbc, hook)(tmesh, tp, tf, {})
        b = getattr(jbc, hook)(jmesh, jp, jf, {})
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            x = x.numpy()
            assert x.shape == np.asarray(y).shape, hook
            assert np.abs(x - np.asarray(y)).max() <= 1e-12 * max(
                1.0, np.abs(np.asarray(y)).max()), hook
    if ncomp == 3:
        assert tuple(tbc.value_internal_coeff(tmesh, tp, tf, {}).shape) \
            == (tp.size, 3)
    for flag in ("fixes_value", "fixes_level", "preserves_type",
                 "value_free", "assembles"):
        assert getattr(tbc, flag) == getattr(jbc, flag), flag


@pytest.mark.parametrize("layout", ["gdia", "ell"])
def test_slip_system_and_ddt_coeff_match_jax(meshes, layout):
    """ddt(rho, U) + div(phi, U, limitedLinear 1) - laplacian(mu, U) with
    slip walls: the per-component patch coefficients survive the gdia
    fold in component_system_all (diag and source per column), and the
    matrix's A and H match; ddt(rho, e) alone too."""
    import jax.numpy as jnp
    from rapidcfd_tpu.fields.field import Dimensioned as JDim
    from rapidcfd_tpu_torch.fields.field import Dimensioned as TDim
    jcase, tmesh = meshes[layout]
    jmesh = jcase.mesh
    (jp, jU), jphi = _random_fields(jcase, seed=29)
    rng = np.random.default_rng(31)
    with jax_quiet():
        jT = jcase.read_field("T")
    jrho = jT.replace(data=jnp.asarray(rng.uniform(0.5, 2.0, jT.data.shape)),
                      dims=JDims.of(1, -3), name="rho")
    jrho = jrho.replace(old=jrho.replace(data=jnp.asarray(
        rng.uniform(0.5, 2.0, jT.data.shape))))
    jU = jU.store_old()
    jp = jp.store_old()
    t = {k: interop.vol_field(v, device=CPU, dtype=F64)
         for k, v in dict(U=jU, p=jp, rho=jrho).items()}
    tphi = interop.surface_field(jphi, device=CPU, dtype=F64)
    dt = 3.125e-5
    mu_dims = JDims.of(1, -1, -1)

    def jax_system(jmesh, jU, jp, jrho, jphi):
        jm = (jfvm.ddt(jmesh, jU, dt, "Euler", coeff=jrho)
              + jfvm.div(jmesh, jphi, jU, ("limitedLinear", 1))
              - jfvm.laplacian(jmesh, JDim("mu", mu_dims, 0.3), jU))
        jd = jfvm.ddt(jmesh, jp, dt, "Euler", coeff=jrho)
        return (jm.component_system_all(jmesh), jm.A(jmesh).data,
                jm.H(jmesh).data, jm.internal_coeffs, jd.diag, jd.source)

    with xla_unoptimized():
        j_sys, j_a, j_h, j_ic, j_dd, j_ds = jax.jit(jax_system)(
            jmesh, jU, jp, jrho, jphi)
    tm = (tfvm.ddt(tmesh, t["U"], dt, "Euler", coeff=t["rho"])
          + tfvm.div(tmesh, tphi, t["U"], ("limitedLinear", 1))
          - tfvm.laplacian(tmesh, TDim("mu", interop.dims(mu_dims), 0.3),
                           t["U"]))
    for a, b in zip(tm.component_system_all(tmesh), j_sys):
        assert a.shape == b.shape and _rel(a, b) <= 1e-12
    assert _rel(tm.A(tmesh).data, j_a) <= 1e-12
    assert _rel(tm.H(tmesh).data, j_h) <= 1e-12
    for a, b in zip(tm.internal_coeffs, j_ic):
        assert tuple(a.shape) == np.asarray(b).shape
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-12 * max(
            1.0, np.abs(np.asarray(b)).max())
    td = tfvm.ddt(tmesh, t["p"], dt, "Euler", coeff=t["rho"])
    assert _rel(td.diag, j_dd) <= 1e-13
    assert _rel(td.source, j_ds) <= 1e-13
    assert td.dims == t["rho"].dims * t["p"].dims * interop.dims(
        JDims.of(0, 3, -1))
    with pytest.raises(ValueError, match="old-time level"):
        tfvm.ddt(tmesh, t["p"], dt, "Euler",
                 coeff=t["rho"].replace(old=None))


def test_shift_level_moves_every_level_entry(meshes):
    jcase, tmesh = meshes["gdia"]
    with captured():
        case = Case(jcase.dir, device=CPU, dtype=F64)
    p = case.read_field("p")
    q = shift_level(p, -1.0)
    assert float((q.data - p.data + 1.0).abs().max()) == 0.0
    inlet = [i for i, pt in enumerate(case.mesh.patches)
             if pt.name == "inlet"][0]
    assert float(q.bcdata[inlet]["value"].max()) == 0.0
    back = shift_level(q, 1.0)
    assert float((back.bvalues - p.bvalues).abs().max()) == 0.0


# -- the solver runs ----------------------------------------------------------

def _jax_sonic_its(stats):
    its = [(f"U{c}", int(pf[2])) for c, pf in zip("xyz", stats["u_perf"])]
    its.append(("e", int(stats["e_perf"][0][2])))
    return its + [("p", int(pf[2])) for pf in stats["p_perf"]]


def _run_jax_sonic(d, steps, **env):
    record = []
    orig = jsonic.make_step

    def make_step(case, thermo, ctrl, dym=False):
        step = orig(case, thermo, ctrl, dym)

        def recorded(U, p, T, rho, phi, dt):
            # the outputs carry old levels; give the inputs one so the
            # step compiles once (store_old overwrites them)
            if U.old is None:
                U, p, T, rho = (f.store_old() for f in (U, p, T, rho))
            out = step(U, p, T, rho, phi, dt)
            st = out[-1]
            record.append(dict(
                iterations=_jax_sonic_its(st), mach=float(st["mach_max"]),
                co=float(st["co"][1]), cont=float(st["cont"][0])))
            return out
        return recorded
    jsonic.make_step = make_step
    try:
        with jax_switches(**env), jax_quiet(), xla_unoptimized():
            case, U, p, T, rho, phi = jsonic.run(d, write=False,
                                                 max_steps=steps)
    finally:
        jsonic.make_step = orig
    return case, dict(U=U, p=p, T=T, rho=rho, phi=phi), record


def _run_port_sonic(d, steps, gdia=True):
    with captured():
        case = Case(d, device=CPU, dtype=F64, gdia_auto=gdia)
        case, U, p, T, rho, phi = tsonic.run(d, device=CPU, dtype=F64,
                                             write=False, max_steps=steps,
                                             case=case)
    return case, dict(U=U, p=p, T=T, rho=rho, phi=phi), case.step_log


def _jax_rho_its(stats):
    its = [(f"U{c}", int(pf[2])) for c, pf in zip("xyz", stats["u_perf"])]
    its.append(("h", int(stats["h_perf"][0][2])))
    its += [("p", int(pf[2])) for pf in stats["p_perf"]]
    return its + [(k, int(pf[2])) for k, pf in sorted(stats["turb"].items())]


def _run_jax_rho(d, steps):
    record = []
    orig = jrhosimple.make_step

    def make_step(*a, **kw):
        step = orig(*a, **kw)

        def recorded(*state):
            out = step(*state)
            st = out[-1]
            record.append(dict(iterations=_jax_rho_its(st),
                               cont=float(st["cont"][0])))
            return out
        return recorded
    jrhosimple.make_step = make_step
    try:
        with jax_switches(FORCE_RCM="1"), jax_quiet(), xla_unoptimized():
            case, U, p, T, rho, phi = jrhosimple.run(d, write=False,
                                                     max_steps=steps)
    finally:
        jrhosimple.make_step = orig
    return case, dict(U=U, p=p, T=T, rho=rho, phi=phi), record


def _run_port_rho(d, steps):
    with captured():
        case, U, p, T, rho, phi = trhosimple.run(d, device=CPU, dtype=F64,
                                                 write=False,
                                                 max_steps=steps)
    return case, dict(U=U, p=p, T=T, rho=rho, phi=phi), case.step_log


@pytest.fixture(scope="module")
def sonic_gdia(fstep):
    return _run_jax_sonic(fstep, 5), _run_port_sonic(fstep, 5)


@pytest.fixture(scope="module")
def sonic_ell(fstep):
    return _run_jax_sonic(fstep, 5, **_ELL), _run_port_sonic(fstep, 5, False)


@pytest.fixture(scope="module")
def rho_laminar(hot):
    return _run_jax_rho(hot, 5), _run_port_rho(hot, 5)


@pytest.fixture(scope="module")
def rho_kepsilon(hot_ke):
    return _run_jax_rho(hot_ke, 5), _run_port_rho(hot_ke, 5)


def _field_errors(jrun, trun):
    """name -> largest difference relative to the largest magnitude;
    cells in file order; phi in file order and orientation on gdia
    meshes, in the device order both packages share on ELL meshes."""
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
        assert a.shape == b.shape and np.isfinite(a).all(), name
        out[name] = np.abs(a - b).max() / np.abs(b).max()
    return out


_RUNS = ("sonic_gdia", "sonic_ell", "rho_laminar", "rho_kepsilon")


@pytest.mark.parametrize("run", _RUNS)
def test_fields_match_jax(run, request):
    jrun, trun = request.getfixturevalue(run)
    err = _field_errors(jrun, trun)
    assert sorted(err) == ["T", "U", "p", "phi", "rho"]
    assert max(err.values()) <= 1e-8, err


@pytest.mark.parametrize("run", _RUNS)
def test_iterations_match_jax(run, request):
    """Per step: the same solves in the same order, each within one
    iteration of the JAX package's, and the continuity error to 1e-6."""
    (_, _, jsteps), (_, _, tsteps) = request.getfixturevalue(run)
    assert len(jsteps) == len(tsteps) == 5
    for j, t in zip(jsteps, tsteps):
        assert [f for f, _ in j["iterations"]] == \
            [f for f, _ in t["iterations"]]
        assert all(abs(a - b) <= 1 for (_, a), (_, b) in
                   zip(j["iterations"], t["iterations"])), (j, t)
        assert t["cont"][0] == pytest.approx(j["cont"], rel=1e-6)


@pytest.mark.parametrize("run", ["sonic_gdia", "sonic_ell"])
def test_sonic_readings_match_jax(run, request):
    """Courant max and max Mach per step to 1e-9; the flow is Mach 3 and
    the layouts are what they say."""
    (_, _, jsteps), (tcase, _, tsteps) = request.getfixturevalue(run)
    assert (tcase.mesh.gdia is not None) == (run == "sonic_gdia")
    for j, t in zip(jsteps, tsteps):
        assert t["co"][1] == pytest.approx(j["co"], rel=1e-9)
        assert t["mach"] == pytest.approx(j["mach"], rel=1e-9)
    assert tsteps[0]["mach"] == pytest.approx(3.0, rel=1e-3)


def test_rho_kepsilon_is_turbulent(rho_kepsilon):
    """The kEpsilon run solves k and epsilon at every iteration (the
    laminar one does not)."""
    (_, _, jsteps), (_, tf, tsteps) = rho_kepsilon
    assert [f for f, _ in tsteps[0]["iterations"]][-2:] == ["epsilon", "k"]
    assert float(tf["T"].data.max()) <= 350.0 + 1e-6


def test_rho_deviation_form_in_fp32(hot):
    """In fp32 run() solves p in deviation form and returns it absolute:
    p stays near 1e5 and the EoS density near air's."""
    with captured() as buf:
        case, U, p, T, rho, phi = trhosimple.run(
            hot, device=CPU, dtype=torch.float32, write=False, max_steps=2)
    assert "deviation form (p_offset = 100000)" in buf.getvalue()
    assert abs(float(p.data.mean()) / 1e5 - 1.0) < 1e-3
    assert 1.0 < float(rho.data.mean()) < 1.3
    assert trhosimple.deviation_offset(p.replace(
        data=p.data.double())) == 0.0


def test_consistent_and_dym_raise(hot, fstep):
    """rhoSimplecFoam (consistent=True) builds its step now that
    FvMatrix.H1 is ported (held against the JAX package in
    tests/test_torch_rhofoams.py); sonicDyMFoam still raises."""
    from rapidcfd_tpu_torch.solvers.controls import SimpleControl
    with captured():
        case = Case(hot, device=CPU, dtype=F64)
        thermo, _, _, _ = trhosimple.setup(case)
        assert callable(trhosimple.make_step(case, thermo,
                                             SimpleControl(case),
                                             consistent=True))
        case = Case(fstep, device=CPU, dtype=F64)
        with pytest.raises(NotImplementedError, match="sonicDyMFoam"):
            tsonic.make_step(case, None, None, dym=True)
