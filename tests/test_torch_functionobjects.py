"""The port's function objects and solver hooks against the JAX package on
the CPU in fp64.

- The controlDict of the JAX package's tests/test_functionobjects.py:12-77
  (probes, fieldMinMax, forces, forceCoeffs, sets, fieldValue, faceSource,
  yPlusRAS, wallShearStress) and the per-step Peclet,
  surfaceInterpolateFields and nearWallFields on 6 simpleFoam iterations
  of pitzDaily x1 (every solve to 1e-12): the fields to 1e-10 and every
  number of every file each hook writes to a unit in its 8th written
  digit, against the JAX package on the padded ELL (RCFD_GDIA_AUTO=0);
  the port's gdia run against its own ELL run the same way (the port
  reduces and searches over live cells only).
- The derived fields written at write times (vorticity, Q, Lambda2,
  CourantNo, pressureTools, turbulenceFields) the same way; blendingFactor
  on a perturbed state whose fluxes are nowhere near zero (on the run's
  state, faces of near-zero flux take their upwind side by rounding);
  `surfaces` and `streamLine` raise by name, an unknown type is skipped.
- The LES tutorial case (pitz_daily_les_case(tutorial=True), scale 1,
  binary and compressed, Euler: the JAX package runs backward as Euler)
  through 5 pisoFoam steps on the padded ELL with
  the JAX package's turbulentInlet draw handed to the port, in the JAX
  package's form (relaxed at every evaluation): U, p, k and nut to 1e-8,
  iteration counts within one, the probes file to 1e-8, from a seeded
  nonuniform start; fieldAverage's mean and prime2Mean against the
  averages of the steps' fields, and the JAX package's averages against
  its own formula on the same fields (ROADMAP Queue 3).
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapidcfd_tpu.postprocess import functionobjects as jfo
from rapidcfd_tpu.solvers import pimplefoam as jpimple
from rapidcfd_tpu.solvers import simplefoam as jsimple
from rapidcfd_tpu_torch.fields.bcs_derived import TurbulentInlet
from rapidcfd_tpu_torch.postprocess import functionobjects as tfo
from rapidcfd_tpu_torch.solvers import pimplefoam as tpimple
from rapidcfd_tpu_torch.solvers import simplefoam as tsimple
from rapidcfd_tpu_torch.solvers.case import Case
from rapidcfd_tpu_torch.utils.casegen import (pitz_daily_case,
                                              pitz_daily_les_case,
                                              pitz_daily_les_dt)
from rapidcfd_tpu_torch.utils.logging import captured
from torch_heat_reference import CPU, F64, jax_quiet, jax_switches, rel

_FUNCTIONS = """
functions
{
    probes1
    {
        type probes;
        fields (p U);
        probeLocations ((0.05 0.001 0) (0.2 0.02 0));
    }
    minmax { type fieldMinMax; fields (U p); log false; }
    wallForces
    {
        type forces;
        patches (lowerWall upperWall);
        rhoInf 1.2;
        CofR (0 0 0);
    }
    coeffs
    {
        type forceCoeffs;
        patches (lowerWall);
        rhoInf 1.2; magUInf 10; Aref 0.001; lRef 0.1;
        liftDir (0 1 0); dragDir (1 0 0); pitchAxis (0 0 1);
    }
    centreline
    {
        type sets;
        fields (U p);
        setFormat csv;
        sets
        {
            mid { type uniform; axis x; start (0 0.0101 0);
                  end (0.28 0.0101 0); nPoints 50; }
        }
    }
    avgP { type fieldValue; source all; operation volAverage; fields (p); }
    inletFlux
    {
        type faceSource;
        source patch;
        sourceName inlet;
        operation areaAverage;
        fields (U);
    }
    yp   { type yPlusRAS; }
    wss  { type wallShearStress; }
    pe   { type Peclet; }
    interp { type surfaceInterpolateFields; fields ((p pf) (U Uf)); }
    near { type nearWallFields; fields ((U UNear)); distance 0.001; }
    vort { type vorticity; }
    q    { type Q; }
    l2   { type Lambda2; }
    co   { type CourantNo; }
    p0   { type pressureTools; }
    turb { type turbulenceFields; }
    unknown { type noSuchFunctionObject; }
}
"""
#: the fields the write-time hooks write
_DERIVED = ("vorticity", "Q", "Lambda2", "Co", "total(p)", "R")
_ITERATIONS = 6


def _numbers(path):
    """Every number of a written file, in order (text columns and
    punctuation dropped)."""
    out = []
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            for tok in line.replace("(", " ").replace(")", " ").replace(
                    ",", " ").split():
                try:
                    out.append(float(tok))
                except ValueError:
                    pass
    return np.asarray(out)


def _files(d):
    base = os.path.join(d, "postProcessing")
    out = {}
    for root, _, files in os.walk(base):
        for f in files:
            out[os.path.relpath(os.path.join(root, f), base)] = \
                os.path.join(root, f)
    return out


def _case(tmp_path_factory, name):
    d = str(tmp_path_factory.mktemp(name))
    with captured():
        pitz_daily_case(d, end_time=_ITERATIONS, tight_tol=True)
    cd = os.path.join(d, "system", "controlDict")
    with open(cd) as f:
        text = f.read()
    text = text.replace("writeInterval   100;",
                        f"writeInterval   {_ITERATIONS};")
    with open(cd, "w") as f:
        f.write(text + _FUNCTIONS)
    return d


@pytest.fixture(scope="module")
def fo_runs(tmp_path_factory):
    """(JAX ELL dir, port ELL dir, port gdia dir) and the runs' final
    fields in file order, in the same order."""
    dj = _case(tmp_path_factory, "fo_jax")
    with jax_switches(GDIA_AUTO="0", FORCE_RCM="1"), jax_quiet():
        jc, *jout = jsimple.run(dj, write=True)
    dirs = [dj]
    fields = [{k: np.asarray(jc.maps.cells_to_file(np.asarray(f.data)))
               for k, f in dict(U=jout[0], p=jout[1], **jout[3]).items()}]
    for layout in ("ell", "gdia"):
        d = _case(tmp_path_factory, "fo_" + layout)
        with captured():
            case = Case(d, device=CPU, dtype=F64,
                        gdia_auto=layout == "gdia")
            assert (case.mesh.gdia is not None) == (layout == "gdia")
            _, U, p, _, ts = tsimple.run(d, device=CPU, dtype=F64,
                                         case=case)
        dirs.append(d)
        fields.append({k: case.maps.cells_to_file(f.data.numpy())
                       for k, f in dict(U=U, p=p, **ts).items()})
    return dirs, fields


def _close_numbers(a, b, what):
    """Two files' numbers, written at 8 significant digits: equal to a
    unit in the 8th digit of each."""
    assert a.shape == b.shape and a.size, what
    scale = max(np.abs(b).max(), 1e-300)
    assert (np.abs(a - b) <= 1e-7 * np.abs(b) + 1e-10 * scale).all(), what


def test_simplefoam_fields_match_jax(fo_runs):
    _, (jf, ef, gf) = fo_runs
    assert sorted(jf) == sorted(ef) == sorted(gf)
    for name in jf:
        assert rel(ef[name], jf[name]) <= 1e-10, name
        assert rel(gf[name], ef[name]) <= 1e-10, name


def _field_file(d, name):
    from rapidcfd_tpu_torch.utils.dictionary import parse_file
    t = str(_ITERATIONS)
    return parse_file(os.path.join(d, t, name))


def test_function_object_files_match_jax(fo_runs):
    (dj, de, dg), _ = fo_runs
    fj, fe, fg = _files(dj), _files(de), _files(dg)
    assert sorted(fj) == sorted(fe) == sorted(fg)
    assert len(fj) >= 15
    for rel_path in fj:
        a, b, c = (_numbers(f[rel_path]) for f in (fe, fj, fg))
        _close_numbers(a, b, rel_path)
        _close_numbers(c, a, rel_path)


@pytest.mark.parametrize("name", _DERIVED)
def test_derived_fields_match_jax(fo_runs, name):
    from rapidcfd_tpu_torch.fields.io import _parse_value
    (dj, de, dg), _ = fo_runs
    vals = []
    for d in (dj, de, dg):
        fd = _field_file(d, name)
        entry = fd.lookup("internalField")
        n = entry[2] if entry[0] == "nonuniform" else 1
        vals.append(np.asarray(_parse_value(entry, n, np.float64)))
    a, b, c = vals
    _close_numbers(a, b, name)
    _close_numbers(c, a, name)


def test_blending_factor_matches_jax(tmp_path):
    """Both packages' blendingFactor of U on the same perturbed field
    (the JAX package on its ELL), the written files to their 8 digits."""
    from rapidcfd_tpu.solvers.case import Case as JCase
    from rapidcfd_tpu.ops import fvc as jfvc
    from rapidcfd_tpu_torch.fields.io import _parse_value, write_vol_field
    from rapidcfd_tpu_torch.ops import fvc as tfvc
    dirs = {}
    rng = np.random.default_rng(41)
    for who in ("jax", "port"):
        d = dirs[who] = str(tmp_path / who)
        with captured():
            pitz_daily_case(d, end_time=1)
            case = Case(d, device=CPU, dtype=F64, gdia_auto=False)
            U = case.read_field("U")
        if who == "jax":
            noise = rng.standard_normal((case.maps.n_file_cells, 3))
        U = U.replace(data=U.data + torch.as_tensor(
            case.maps.cells_to_device(noise)))
        write_vol_field(U.correct_boundary_conditions(case.mesh), d, "0",
                        case.mesh, case.maps, prec=17)
    d_ = {}
    with jax_switches(GDIA_AUTO="0", FORCE_RCM="1"), jax_quiet():
        jc = JCase(dirs["jax"])
        jU = jc.read_field("U")
        jphi = jfvc.flux(jc.mesh, jU)
        jc.time.write_time = lambda: True
        jfo.BlendingFactor("bf", _dict("U"), jc).execute(
            0.0, {"U": jU, "phi": jphi, "p": jc.read_field("p")}, jc.mesh)
    flux = np.abs(np.asarray(jphi.data[:jc.mesh.n_internal]))
    assert flux.min() > 1e-9 * flux.max()
    with captured():
        tc = Case(dirs["port"], device=CPU, dtype=F64, gdia_auto=False)
        tU = tc.read_field("U")
        tc.time.write_time = lambda: True
        tfo.BlendingFactor("bf", _dict("U"), tc).execute(
            0.0, {"U": tU, "phi": tfvc.flux(tc.mesh, tU),
                  "p": tc.read_field("p")}, tc.mesh)
    for who, d in dirs.items():
        from rapidcfd_tpu_torch.utils.dictionary import parse_file
        fd = parse_file(os.path.join(d, "0", "blendingFactor(U)"))
        e = fd.lookup("internalField")
        d_[who] = np.asarray(_parse_value(e, e[2], np.float64))
    _close_numbers(d_["port"], d_["jax"], "blendingFactor(U)")
    assert 0.0 <= d_["port"].min() and d_["port"].max() <= 1.0


def _dict(field):
    from rapidcfd_tpu.utils.dictionary import parse_dictionary
    return parse_dictionary(f"type blendingFactor; field {field};")


def test_not_ported_types_raise(tmp_path):
    d = str(tmp_path)
    with captured():
        pitz_daily_case(d, end_time=1)
    cd = os.path.join(d, "system", "controlDict")
    for typ in ("surfaces", "streamLine"):
        with open(cd) as f:
            text = f.read().split("functions")[0]
        with open(cd, "w") as f:
            f.write(text + "functions { s { type %s; fields (p); } }\n" % typ)
        with captured(), pytest.raises(NotImplementedError, match=typ):
            tsimple.run(d, device=CPU, dtype=F64, write=False)


# -- the LES tutorial ---------------------------------------------------------

_LES_STEPS = 5


def _jax_les(d):
    """pisoFoam of the JAX package on its RCM-ordered ELL (on its gdia
    lattice the JAX package's pisoFoam LES of pitzDaily gives NaN from the
    first step: ROADMAP Queue 3), each step's
    iteration counts recorded (old levels pre-stored, so the step compiles
    once); its FunctionObjectList kept."""
    record, kept = [], {}
    orig, orig_fos = jpimple.make_step, jfo.FunctionObjectList

    def make_step(case, transport, turb, ctrl, piso_mode):
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

    class Kept(orig_fos):
        def __init__(self, case):
            super().__init__(case)
            kept["fos"] = self
    import rapidcfd_tpu.postprocess as jpost
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpimple, "make_step", make_step)
        mp.setattr(jpost, "FunctionObjectList", Kept)
        with jax_switches(GDIA_AUTO="0", FORCE_RCM="1"), jax_quiet():
            case, U, p, phi, ts = jpimple.run(d, write=False, piso_mode=True)
    return case, dict(U=U, p=p, **ts), record, kept["fos"]


class JaxFormInlet(TurbulentInlet):
    """The JAX package's turbulentInlet in pimpleFoam and pisoFoam: one
    fixed draw, relaxed at every evaluation (ROADMAP Queue 3); the port's
    own inlet updates once per time step."""

    def evaluate(self, mesh, patch, field, bd, env=None):
        prev = field.patch_values(mesh, patch)
        return self.relax(prev, bd, self.draw.to(prev))


@pytest.fixture(scope="module")
def les_runs(tmp_path_factory):
    dt = pitz_daily_les_dt(1)
    dirs = {}
    for who in ("jax", "port"):
        d = dirs[who] = str(tmp_path_factory.mktemp("les_" + who))
        with captured():
            pitz_daily_les_case(d, 1, tutorial=True, fmt="binary",
                                compress=True, end_time=_LES_STEPS * dt,
                                write_interval=1000, ddt="Euler", u_seed=23)
    jcase, jf, jsteps, jfos = _jax_les(dirs["jax"])
    i = next(i for i, p in enumerate(jcase.mesh.patches)
             if p.name == "inlet")
    jp = jcase.mesh.patches[i]
    key = jax.random.fold_in(jax.random.PRNGKey(0),
                             jnp.asarray(0, jnp.int32) + jp.bstart)
    draw = torch.as_tensor(np.array(jax.random.uniform(
        key, (jp.size, 3), jnp.float64)))

    read = Case.read_field

    def read_field(self, name, time=None):
        f = read(self, name, time)
        if name == "U":
            assert self.mesh.patches[i].size == jp.size
            bcs = list(f.bcs)
            assert isinstance(bcs[i], TurbulentInlet)
            bcs[i] = JaxFormInlet(i, draw=draw)
            # the inlet evaluated once from the file's values, as the JAX
            # reader does (read_field's own evaluation used the generator)
            p_ = self.mesh.patches[i]
            bv = f.bvalues.clone()
            bv[p_.bstart:p_.bstart + p_.size] = f.bcdata[i]["value"]
            f = f.replace(bcs=tuple(bcs), bvalues=bv) \
                .correct_boundary_conditions(self.mesh)
        return f
    kept = {}
    orig_fos = tfo.FunctionObjectList

    class Kept(orig_fos):
        def __init__(self, case):
            super().__init__(case)
            kept["fos"] = self
            case.hook_fields = []

        def execute(self, fields):
            self.case.hook_fields.append(
                {k: fields[k].data.numpy().copy() for k in ("U", "p")})
            super().execute(fields)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Case, "read_field", read_field)
        mp.setattr(tpimple, "FunctionObjectList", Kept)
        with captured():
            tcase = Case(dirs["port"], device=CPU, dtype=F64,
                         gdia_auto=False)
            np.testing.assert_array_equal(
                tcase.mesh.Cf[jp.start:jp.start + jp.size].numpy(),
                np.asarray(jcase.mesh.Cf[jp.start:jp.start + jp.size]))
            tcase, U, p, phi, ts = tpimple.run(
                dirs["port"], device=CPU, dtype=F64, write=False,
                piso_mode=True, case=tcase)
    return (jcase, jf, jsteps, jfos, dirs, tcase, dict(U=U, p=p, **ts),
            kept["fos"])


def test_les_tutorial_matches_jax(les_runs):
    jcase, jf, jsteps, _, _, tcase, tf, _ = les_runs
    assert tcase.mesh.gdia is None and jcase.mesh.gdia is None
    assert sorted(jf) == sorted(tf) == ["U", "k", "nut", "p"]
    for name in jf:
        a = tcase.maps.cells_to_file(tf[name].data.numpy())
        b = np.asarray(jcase.maps.cells_to_file(np.asarray(jf[name].data)))
        assert rel(a, b) <= 1e-8, name
    tsteps = [s["iterations"] for s in tcase.step_log]
    assert len(jsteps) == len(tsteps) == _LES_STEPS
    for j, t in zip(jsteps, tsteps):
        jo = [x for x in j if x[0] != "p"]
        to = [x for x in t if x[0] != "p"]
        assert [f for f, _ in jo] == [f for f, _ in to]
        jp_ = [n for f, n in j if f == "p"]
        tp_ = [n for f, n in t if f == "p"][-len(jp_):]
        assert all(abs(a - b) <= 1 for (_, a), (_, b) in zip(jo, to))
        assert all(abs(a - b) <= 1 for a, b in zip(jp_, tp_))


def test_les_tutorial_function_objects(les_runs):
    jcase, _, _, jfos, dirs, tcase, _, tfos = les_runs
    rel_path = os.path.join("probes", "0", "p")
    a = _numbers(os.path.join(dirs["port"], "postProcessing", rel_path))
    b = _numbers(os.path.join(dirs["jax"], "postProcessing", rel_path))
    assert a.shape == b.shape == (_LES_STEPS * 8,)
    assert rel(a, b) <= 1e-8
    (tavg,) = [o for o in tfos.objects if isinstance(o, tfo.FieldAverage)]
    (javg,) = [o for o in jfos.objects if isinstance(o, jfo.FieldAverage)]
    seen = tcase.hook_fields
    assert len(seen) == _LES_STEPS
    for name in ("U", "p"):
        xs = np.stack([tcase.maps.cells_to_file(f[name]) for f in seen])
        tm = tcase.maps.cells_to_file(tavg.mean(name).numpy())
        tp2 = tcase.maps.cells_to_file(tavg.prime2_mean(name).numpy())
        # the reference's averages of the steps (dt fixed: equal weights)
        mean = xs.mean(0)
        assert rel(tm, mean) <= 1e-12, name
        if name == "U":       # the symmTensor's xx, yy and zz
            tp2 = tp2[:, [0, 3, 5]]
        assert rel(tp2, (xs * xs).mean(0) - mean * mean) <= 1e-9, name
        # the JAX package's: its shared counter is 2 after the first step,
        # so the first sample weighs twice (ROADMAP Queue 3), and its
        # prime2Mean is the mean of x x
        jm = np.asarray(jcase.maps.cells_to_file(np.asarray(
            javg.mean(name))))
        jp2 = np.asarray(jcase.maps.cells_to_file(np.asarray(
            javg.p2means[name])))
        w = np.array([2.0] + [1.0] * (_LES_STEPS - 1))[:, None]
        if name == "U":
            w = w[:, :, None]
        n = _LES_STEPS + 1
        assert rel(jm, (w * xs).sum(0) / n) <= 1e-8, name
        assert rel(jp2, (w * xs * xs).sum(0) / n) <= 1e-8, name


def test_les_inlet_updates_once_per_step(tmp_path):
    """In the port's pisoFoam the tutorial's turbulentInlet relaxes once
    per time step, as the reference's does, though the momentum solve and
    both PISO correctors evaluate U's boundary: with a fixed draw, after
    n steps the inlet holds the file's value relaxed n + 1 times (once
    more when the field is read)."""
    d = str(tmp_path / "les")
    steps = 2
    with captured():
        pitz_daily_les_case(d, 1, tutorial=True, end_time=steps
                            * pitz_daily_les_dt(1), write_interval=1000,
                            ddt="Euler")
    read = Case.read_field
    kept = {}

    def read_field(self, name, time=None):
        f = read(self, name, time)
        if name == "U":
            i = next(i for i, p in enumerate(self.mesh.patches)
                     if p.name == "inlet")
            p_ = self.mesh.patches[i]
            draw = torch.as_tensor(np.random.default_rng(5).uniform(
                size=(p_.size, 3)))
            bcs = list(f.bcs)
            bcs[i] = TurbulentInlet(i, draw=draw)
            bv = f.bvalues.clone()
            bv[p_.bstart:p_.bstart + p_.size] = f.bcdata[i]["value"]
            kept.update(bc=bcs[i], bd=f.bcdata[i], patch=p_,
                        file=bv[p_.bstart:p_.bstart + p_.size].clone())
            f = f.replace(bcs=tuple(bcs), bvalues=bv) \
                .correct_boundary_conditions(self.mesh)
        return f
    with pytest.MonkeyPatch.context() as mp, captured():
        mp.setattr(Case, "read_field", read_field)
        tcase, U, _, _, _ = tpimple.run(d, device=CPU, dtype=F64,
                                        write=False, piso_mode=True)
    assert len(tcase.step_log) == steps
    expect = kept["file"]
    for _ in range(steps + 1):
        expect = kept["bc"].relax(expect, kept["bd"], kept["bc"].draw)
    p_ = kept["patch"]
    got = U.bvalues[p_.bstart:p_.bstart + p_.size]
    assert not torch.equal(got, kept["file"])
    assert torch.equal(got, expect)
