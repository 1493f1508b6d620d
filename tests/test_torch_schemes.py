"""The interpolation schemes this slice ports, and turbulentInlet, against
the JAX package on the CPU in fp64.

- The owner weights of every newly ported scheme name (the NVD/extended
  family with its V and 01 names, the value-dependent and wrapper
  schemes, CoBlended, localBlended, Phi, limitWith, weighted and
  fixedWeights, limiterBlended) and multivariate_weights, for a seeded
  random scalar and vector field and a flux of both signs on pitzDaily x1,
  on the gdia lattice and on the padded ELL (the JAX mesh carried over by
  interop): to 1e-12 on the real internal faces, in file order. The port
  passes the field's gradient through g= as a solver does.
- turbulentInlet: the formula against the JAX package's BC on the case of
  tests/test_bc_zoo3.py:301-322 (alpha 1, a PRNGKey(7) draw) and with
  alpha 0.1 from random patch values, the JAX draw handed to the port, to
  1e-14; the port's own generator fluctuates from one evaluation to the
  next and repeats from its seed.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapidcfd_tpu.fields.bcs_derived import TurbulentInlet as JTurbInlet
from rapidcfd_tpu.fields.field import SurfaceField as JSurface
from rapidcfd_tpu.ops import fvc as jfvc
from rapidcfd_tpu.ops import interpolation as jinterp
from rapidcfd_tpu.solvers.case import Case as JCase
from rapidcfd_tpu.utils import logging as jlog
from rapidcfd_tpu.utils import switches
from rapidcfd_tpu.utils.dimensions import DimensionSet as JDims
from rapidcfd_tpu.utils.registry import lookup as jlookup
from rapidcfd_tpu_torch import interop
from rapidcfd_tpu_torch.fields.bcs import make_bc
from rapidcfd_tpu_torch.fields.bcs_derived import TurbulentInlet
from rapidcfd_tpu_torch.ops import fvc as tfvc
from rapidcfd_tpu_torch.ops import interpolation as tinterp
from rapidcfd_tpu_torch.utils import timecontrol
from rapidcfd_tpu_torch.utils.casegen import pitz_daily_ico_case
from rapidcfd_tpu_torch.utils.logging import captured

CPU = torch.device("cpu")
F64 = torch.float64

#: scheme specs as the dictionary parser gives them (word, args...)
EXTENDED = ("QUICK", "SFCD", "Gamma", "limitedCubic", "blended",
            "filteredLinear", "filteredLinear2", "filteredLinear3")
NEW_SCHEMES = tuple(
    [(w + suf,) for w in EXTENDED for suf in ("", "V", "01")]
    + [("Gamma", 0.5), ("limitedCubic", 0.5), ("blended", 0.3),
       ("harmonic",), ("clippedLinear", 0.5), ("localMax",), ("localMin",),
       ("fixedBlended", 0.3, "linear", "upwind"),
       ("outletStabilised", "QUICK"), ("skewCorrected", "linear"),
       ("cubic",), ("downwind",), ("midPoint",), ("reverseLinear",),
       ("CoBlended", 1, "linear", 10, "upwind"),
       ("localBlended", "QUICK", "upwind"),
       ("limitWith", "linear", "vanLeer"),
       ("limiterBlended", "vanLeer", "linear", "upwind"),
       ("limiterBlended", "limitedLinear", 1, "QUICK", "upwind"),
       ("Phi", 1)])
_ELL = dict(GDIA_AUTO="0", FORCE_RCM="1")
_DT = 3e-3


@contextlib.contextmanager
def jax_switches(**env):
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv("RCFD_" + k, v)
            switches._CACHE.pop(k, None)
        old = jlog.Info.enabled
        jlog.Info.enabled = False
        try:
            yield
        finally:
            jlog.Info.enabled = old
            for k in env:
                switches._CACHE.pop(k, None)


@pytest.fixture(scope="module")
def pitz(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pitz"))
    pitz_daily_ico_case(d, scale=1)
    return d


@pytest.fixture(scope="module")
def meshes(pitz):
    out = {}
    for layout, env in (("gdia", {}), ("ell", _ELL)):
        with jax_switches(**env):
            jcase = JCase(pitz)
        assert (jcase.mesh.gdia is not None) == (layout == "gdia")
        out[layout] = (jcase, interop.mesh_arrays(jcase.mesh, device=CPU,
                                                  dtype=F64))
    return out


def _random_fields(jcase, seed):
    rng = np.random.default_rng(seed)
    mesh = jcase.mesh
    with jax_switches():
        jp, jU = jcase.read_field("p"), jcase.read_field("U")
    out = []
    for f in (jp, jU):
        f = f.replace(data=jnp.asarray(rng.standard_normal(f.data.shape)),
                      bvalues=jnp.asarray(rng.standard_normal(
                          f.bvalues.shape)))
        out.append(f.correct_boundary_conditions(mesh))
    phi = JSurface(jnp.asarray(rng.standard_normal(mesh.n_faces)),
                   JDims.of(1, 0, -1), "phi")
    return out, phi, rng


def _file_order(jcase, a):
    """Owner weights of the real internal faces in polyMesh order."""
    a = np.asarray(a)
    full = np.concatenate([a, np.zeros(jcase.mesh.n_faces - a.shape[0])])
    from rapidcfd_tpu_torch.mesh.polymesh import read_polymesh
    n_int = read_polymesh(jcase.dir).n_internal_faces
    return np.asarray(jcase.maps.faces_to_file(full))[:n_int]


@contextlib.contextmanager
def jax_grad_once():
    """The JAX package's fvc.grad evaluated once per field: its extended
    schemes take grad(vf) at every call, each an eager dispatch of jitted
    pieces (most of this file's time otherwise)."""
    memo = {}
    grad = jfvc.grad

    def once(mesh, vf, *args, **kw):
        key = (id(mesh), id(vf.data), args, tuple(sorted(kw.items())))
        if key not in memo:
            memo[key] = (vf, grad(mesh, vf, *args, **kw))
        return memo[key][1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfvc, "grad", once)
        yield


@pytest.fixture(scope="module")
def weights(meshes):
    """{(layout, rank, spec): (port, JAX)} in file order."""
    with jax_grad_once():
        return _weights(meshes)


def _weights(meshes):
    out = {}
    for layout, (jcase, tmesh) in meshes.items():
        (jp, jU), jphi, rng = _random_fields(jcase, seed=29)
        tphi = interop.surface_field(jphi, device=CPU, dtype=F64)
        bf = rng.uniform(0.0, 1.0, jcase.mesh.n_internal)
        w_fixed = rng.uniform(0.0, 1.0, jcase.mesh.n_internal)
        for rank, jf in (("scalar", jp), ("vector", jU)):
            tf = interop.vol_field(jf, device=CPU, dtype=F64)
            g = tfvc.grad(tmesh, tf)
            jinterp.set_blending_factor(jf.name, jnp.asarray(bf))
            tinterp.set_blending_factor(tf.name, torch.as_tensor(bf))
            jinterp.set_current_dt(_DT)
            tinterp.set_current_dt(_DT)
            specs = NEW_SCHEMES + (("weighted", w_fixed),
                                   ("fixedWeights", w_fixed))
            for spec in specs:
                if spec[0] == "Phi" and rank == "scalar":
                    continue
                tw = tinterp.scheme_weights(tmesh, tf, spec if len(spec) > 1
                                            else spec[0], tphi, g=g)
                jw = jlookup("surfaceInterpolation", spec[0])(
                    jcase.mesh, jf, jphi, *spec[1:])
                key = spec[0] if spec[0] in ("weighted", "fixedWeights") \
                    else " ".join(map(str, spec))
                out[layout, rank, key] = (_file_order(jcase, tw.numpy()),
                                          _file_order(jcase, jw))
            jw = jinterp.multivariate_weights(jcase.mesh, [jf, jf], jphi,
                                              "vanLeer")
            tw = tinterp.multivariate_weights(tmesh, [tf, tf], tphi,
                                              "vanLeer", grads=[g, g])
            out[layout, rank, "multivariate"] = (
                _file_order(jcase, tw.numpy()), _file_order(jcase, jw))
    return out


@pytest.mark.parametrize("layout", ["gdia", "ell"])
@pytest.mark.parametrize("rank", ["scalar", "vector"])
def test_new_scheme_weights_match_jax(weights, layout, rank):
    names = [k for (lay, rk, k) in weights if (lay, rk) == (layout, rank)]
    assert len(names) == len(NEW_SCHEMES) + 3 - (rank == "scalar")
    for name in names:
        a, b = weights[layout, rank, name]
        assert a.shape == b.shape and a.size > 0
        assert np.isfinite(a).all(), name
        assert np.abs(a - b).max() <= 1e-12, name


def test_registry_is_the_jax_registry():
    """Every name the JAX package registers as a surfaceInterpolation
    scheme is in the port's registry, and nothing else; an unknown name
    raises."""
    from rapidcfd_tpu.utils.registry import registered_names
    assert sorted(registered_names("surfaceInterpolation")) \
        == sorted(tinterp.SCHEMES)
    with pytest.raises(NotImplementedError, match="noSuchScheme"):
        tinterp.scheme_weights(None, None, "noSuchScheme", None)


def test_coblended_needs_dt(meshes):
    jcase, tmesh = meshes["ell"]
    (jp, _), jphi, _ = _random_fields(jcase, seed=3)
    tf = interop.vol_field(jp, device=CPU, dtype=F64)
    tphi = interop.surface_field(jphi, device=CPU, dtype=F64)
    old = tinterp._CURRENT_DT
    tinterp._CURRENT_DT = None
    try:
        with pytest.raises(ValueError, match="set_current_dt"):
            tinterp.scheme_weights(tmesh, tf, ("CoBlended", 1, "linear", 10,
                                               "upwind"), tphi)
    finally:
        tinterp._CURRENT_DT = old


@pytest.mark.parametrize("spec,what", [
    (("linearUpwind", "grad(U)"), "the explicit gradient correction"),
    (("LUST", "grad(U)"), "the linearUpwind gradient correction"),
    (("outletStabilised", "linear"), "the outlet-face upwinding"),
    (("skewCorrected", "linear"), "the skewness correction"),
    (("cubic",), "the explicit cubic correction")])
def test_dropped_correction_is_logged(meshes, spec, what):
    """A scheme whose explicit correction the weights leave out says so
    by name, once (the JAX package applies none either)."""
    jcase, tmesh = meshes["ell"]
    (jp, _), jphi, _ = _random_fields(jcase, seed=3)
    tf = interop.vol_field(jp, device=CPU, dtype=F64)
    tphi = interop.surface_field(jphi, device=CPU, dtype=F64)
    with pytest.MonkeyPatch.context() as mp, captured() as log:
        mp.setattr(tinterp, "_WARNED", set())
        for _ in range(2):
            tinterp.scheme_weights(tmesh, tf, spec, tphi)
    lines = [ln for ln in log.getvalue().splitlines() if "Warning" in ln]
    assert lines == [f"--> FOAM Warning : interpolation scheme {spec[0]}: "
                     f"{what} is not applied (weights only, as in the JAX "
                     "package)"]


# -- turbulentInlet -----------------------------------------------------------

def _inlet(jcase):
    i = next(i for i, p in enumerate(jcase.mesh.patches)
             if p.name == "inlet")
    return i, jcase.mesh.patches[i]


@pytest.mark.parametrize("alpha", [1.0, 0.1])
def test_turbulent_inlet_formula(meshes, alpha):
    jcase, tmesh = meshes["ell"]
    (_, jU), _, rng = _random_fields(jcase, seed=11)
    i, patch = _inlet(jcase)
    ref = np.array([10.0, 0.0, 0.0])
    scale = np.array([0.1, 0.05, 0.05] if alpha == 1.0
                     else [0.02, 0.01, 0.01])
    jbd = {"referenceField": jnp.asarray(ref),
           "fluctuationScale": jnp.asarray(scale),
           "alpha": jnp.asarray(alpha)}
    key = jax.random.PRNGKey(7)
    jval = np.asarray(JTurbInlet(i).evaluate(jcase.mesh, patch, jU, jbd,
                                             env={"rng_key": key}))
    draw = np.asarray(jax.random.uniform(key, (patch.size, 3),
                                         jnp.float64))
    tU = interop.vol_field(jU, device=CPU, dtype=F64)
    tbd = {k: torch.tensor(np.asarray(v)) for k, v in jbd.items()}
    bc = TurbulentInlet(i, draw=torch.as_tensor(draw))
    tval = bc.evaluate(tmesh, tmesh.patches[i], tU, tbd).numpy()
    assert np.abs(tval - jval).max() <= 1e-14 * np.abs(jval).max()
    if alpha == 1.0:        # the JAX test's statistics
        assert abs(tval[:, 0].mean() - 10.0) < 1.5
        assert tval[:, 1].std() > 0.01


def test_turbulent_inlet_generator_fluctuates(meshes):
    jcase, tmesh = meshes["gdia"]
    (_, jU), _, _ = _random_fields(jcase, seed=5)
    i, _ = _inlet(jcase)
    tU = interop.vol_field(jU, device=CPU, dtype=F64)
    bd = {"referenceField": torch.tensor([10.0, 0.0, 0.0], dtype=F64),
          "fluctuationScale": torch.tensor([0.02, 0.01, 0.01], dtype=F64),
          "alpha": torch.tensor(0.1, dtype=F64)}

    p = tmesh.patches[i]

    def run(bc, n):
        bcs = list(tU.bcs)
        bcs[i] = bc
        bcd = list(tU.bcdata)
        bcd[i] = bd
        f = tU.replace(bcs=tuple(bcs), bcdata=tuple(bcd))
        out = []
        for step in range(1, n + 1):
            timecontrol._set_current_index(step)
            # a solver evaluates U's boundary several times a step
            vals = []
            for _ in range(3):
                f = f.correct_boundary_conditions(tmesh)
                vals.append(f.bvalues[p.bstart:p.bstart + p.size].clone())
            assert all(torch.equal(v, vals[0]) for v in vals)
            out.append(vals[0])
        return out

    index = timecontrol.current_time_index()
    try:
        bc = make_bc("turbulentInlet", i)
        assert isinstance(bc, TurbulentInlet)
        a = run(bc, 3)
        b = run(make_bc("turbulentInlet", i), 3)
    finally:
        timecontrol._set_current_index(index)
    # once per step, the value relaxes toward ref + the generator's next
    # draw (seeded with 0)
    gen = torch.Generator().manual_seed(0)
    prev = tU.bvalues[p.bstart:p.bstart + p.size]
    for x in a:
        prev = bc.relax(prev, bd, torch.rand(prev.shape, generator=gen,
                                             dtype=F64))
        assert torch.equal(x, prev)
    fl = [x - 0.9 * y for x, y in zip(a[1:], a[:-1])]
    assert not torch.allclose(fl[0], fl[1])
    for x, y in zip(a, b):        # the seed repeats the sequence
        assert torch.equal(x, y)
    assert all(bool(torch.isfinite(x).all()) for x in a)
