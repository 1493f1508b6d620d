"""The port's RAS models, its second-order ddt schemes and LUST against
the JAX package in fp64 on the CPU.

- Every RAS model's correct(), steady and transient (Euler), on
  pitzDaily x1 (the gdia masked lattice; utils/casegen.pitz_daily_ras_case
  writes each model's fields), on a numpy-seeded velocity and state
  carried from the JAX package by interop: cell and boundary values to
  1e-10 of the field's largest magnitude, iteration counts within one.
- 3 simpleFoam iterations with realizableKE and with SpalartAllmaras on
  pitzDaily x1 and 5 pimpleFoam steps with CrankNicolson 0.9 at constant
  dt on the laminar cavity, against the JAX package's run(): fields to
  1e-8, counts within one.
- backward: fvm.ddt equals the JAX package's on identical three-level
  fields (with and without a density-like coefficient); the decay-ODE
  orders of tests/test_ddt_schemes.py hold for the port's Euler,
  backward and CrankNicolson; the ddt matrix the port's pimpleFoam
  assembles at step 3 equals the JAX package's fvm.ddt(..., "backward")
  on the port's own three levels (the true backward the JAX run, which
  keeps one level, does not take); a varying dt takes the deltaT/deltaT0
  coefficients.
- Refusals: a field stored with one level, or one that lost old.old
  after a store, raises under backward and CrankNicolson, and every
  other transient solver refuses both schemes by name; 3 backward
  pimpleFoam steps bring U and every field of seven models (kEpsilon
  and kOmegaSST on the T-junction, five LES models on the channel) to
  fvm.ddt with two levels and old.old from the second store on.
- LUST's weights equal the JAX package's; RAS_MODELS holds every name
  the JAX package registers under RASModel; neither the port nor
  chip_smoke.py imports jax or rapidcfd_tpu.

The JAX package runs with XLA's optimisations off (jax_quiet); the
correct() references compile together in a thread pool (compile_all),
one program per model for both forms (correct_program; that its dt = inf
result is its steady one is held in tests/test_torch_les.py)."""

import os
import re
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rapidcfd_tpu.models import turbulence as jturb
from rapidcfd_tpu.models.transport import \
    SinglePhaseTransportModel as JTransport
from rapidcfd_tpu.ops import fvc as jfvc
from rapidcfd_tpu.ops import fvm as jfvm
from rapidcfd_tpu.ops import interpolation as jinterp
from rapidcfd_tpu.solvers import pimplefoam as jpimple
from rapidcfd_tpu.solvers import simplefoam as jsimple
from rapidcfd_tpu.solvers.case import Case as JCase
from rapidcfd_tpu.utils.registry import registered_names
from rapidcfd_tpu_torch import interop
from rapidcfd_tpu_torch.fields.field import Dimensioned as TDimensioned
from rapidcfd_tpu_torch.models import turbulence as tturb
from rapidcfd_tpu_torch.ops import fvm as tfvm
from rapidcfd_tpu_torch.ops import interpolation as tinterp
from rapidcfd_tpu_torch.solvers import pimplefoam as tpimple
from rapidcfd_tpu_torch.solvers import simplefoam as tsimple
from rapidcfd_tpu_torch.solvers.case import Case
from rapidcfd_tpu_torch.utils import casegen
from rapidcfd_tpu_torch.utils.dimensions import DimensionSet, dimless
from rapidcfd_tpu_torch.utils.logging import captured
from torch_heat_reference import CPU, F64, jax_quiet, jax_switches, rel

TOL = 1e-10
RUN_TOL = 1e-8
DT = 2e-3
RAS = ("RNGkEpsilon", "realizableKE", "kOmega", "SpalartAllmaras",
       "LaunderSharmaKE", "qZeta", "v2f", "kkLOmega", "LienCubicKE")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_nu(jnu):
    return TDimensioned("nu", DimensionSet(*jnu.dims.as_tuple()),
                        float(jnu.value))


def perturbed(jcase, state, seed, u_mean=8.0, u_sd=2.0, v_sd=0.5):
    """A numpy-seeded velocity about (u_mean 0 0), its boundary values and
    flux (evaluated by the port on the carried mesh, and carried back: the
    two packages' BCs and fluxes agree to rounding, and the JAX side then
    runs no eager operation), and the state with every field scaled by a
    positive seeded factor (nut, and any field at zero, filled with a
    seeded small value). JAX objects."""
    from rapidcfd_tpu.fields.field import SurfaceField as JSurface
    from rapidcfd_tpu_torch.ops import fvc as tfvc
    rng = np.random.default_rng(seed)
    jU = jcase.read_field("U")
    u = np.zeros(np.asarray(jU.data).shape)
    u[:, 0] = u_mean + u_sd * rng.standard_normal(u.shape[0])
    u[:, 1] = v_sd * rng.standard_normal(u.shape[0])
    tmesh = interop.mesh_arrays(jcase.mesh, device=CPU, dtype=F64)
    tU = interop.vol_field(jU, device=CPU, dtype=F64)
    tU = tU.replace(data=torch.as_tensor(u)).correct_boundary_conditions(
        tmesh)
    U = jU.replace(data=jnp.asarray(u), bvalues=jnp.asarray(
        tU.bvalues.numpy()))
    phi = tfvc.flux(tmesh, tU)
    new = {}
    for name, f in state.items():
        x = np.asarray(f.data)
        fac = rng.uniform(0.5, 1.5, x.shape)
        x = np.where(x == 0.0, 1e-4 * fac, x * fac)
        new[name] = f.replace(data=jnp.asarray(x))
    return U, JSurface(jnp.asarray(phi.data.numpy()), jU.dims * jfvc._AREA,
                       "phi"), new


def compile_all(jobs):
    """[(jitted function, example args)] -> their compiled programs: each
    lowered in turn, the lowered programs compiled in a thread pool
    (XLA's compile leaves the interpreter free), so the JAX references of
    a fixture share the compile time."""
    lowered = [fn.lower(*args) for fn, args in jobs]
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        return list(pool.map(lambda lo: lo.compile(), lowered))


def correct_program(jm, jnu):
    """The JAX model's transient correct() with dt an argument, the ddt
    scheme Euler. At dt = inf its ddt is the zero matrix (V/dt = 0 on the
    diagonal and in the source), the steadyState form: one program gives
    the steady result and the transient one."""
    return jax.jit(lambda m_, s, U, phi, dt: jm.correct(m_, s, U, phi, jnu,
                                                        dt=dt))


def _close(tf, jf, what):
    for part in ("data", "bvalues"):
        a = getattr(tf, part).numpy()
        b = np.asarray(getattr(jf, part))
        assert a.shape == b.shape, (what, part)
        assert np.abs(a - b).max() <= TOL * max(np.abs(b).max(), 1e-300), \
            (what, part, rel(a, b))


def _select(d, model):
    """Write constant/RASProperties for a model; the case's other files
    serve every model."""
    from rapidcfd_tpu_torch.utils.dictionary import foamfile_header
    casegen._write(os.path.join(d, "constant", "RASProperties"),
                   foamfile_header("dictionary", "RASProperties",
                                   "constant"),
                   f"\nRASModel        {model};\nturbulence      on;\n")


@pytest.fixture(scope="module")
def ras_corrected(tmp_path_factory):
    """model -> the JAX and the port's (steady, transient) correct() on
    pitzDaily x1, one case carrying every model's fields (kkLOmega's and
    v2f's over kEpsilon's, and kOmega's omega); one JAX program per model
    (correct_program: the steady result at dt = inf)."""
    d = str(tmp_path_factory.mktemp("pitz"))
    with captured():
        casegen.pitz_daily_ras_case(d, "kkLOmega")
        extra = str(tmp_path_factory.mktemp("v2f"))
        casegen.pitz_daily_ras_case(extra, "v2f")
        for name in ("epsilon", "v2", "f"):
            os.replace(os.path.join(extra, "0", name),
                       os.path.join(d, "0", name))
        casegen.pitz_daily_ras_case(extra, "SpalartAllmaras")
        os.replace(os.path.join(extra, "0", "nuTilda"),
                   os.path.join(d, "0", "nuTilda"))
        tcase = Case(d, device=CPU, dtype=F64)
    jcase = JCase(d)
    tmesh = interop.mesh_arrays(jcase.mesh, device=CPU, dtype=F64)
    jnu = JTransport(jcase.transport_properties()).nu(jcase.mesh, None)
    jobs, ports = [], []
    with jax_quiet():
        for model in RAS:
            _select(d, model)
            jm = jturb.make_ras_model(jcase, None)
            tm = tturb.make_ras_model(tcase, None)
            assert type(tm).__name__ == type(jm).__name__
            jm.ddt_scheme = tm.ddt_scheme = "Euler"
            if hasattr(jm, "y"):
                tm.y = interop.wall_distance(jm, device=CPU, dtype=F64)
            jU, jphi, jst = perturbed(jcase, jm.init_state(None),
                                       seed=len(model))
            jargs = (jcase.mesh, jst, jU, jphi)
            jobs.append((correct_program(jm, jnu), jargs + (DT,)))
            args = (tmesh, interop.turb_state(jst, device=CPU, dtype=F64),
                    interop.vol_field(jU, device=CPU, dtype=F64),
                    interop.surface_field(jphi, device=CPU, dtype=F64),
                    _port_nu(jnu))
            stress = None
            if model == "LienCubicKE":
                stress = (jm.nonlinear_stress(jcase.mesh, jst, jU),
                          tm.nonlinear_stress(tmesh, args[1], args[2]))
            ports.append((jargs, (tm.correct(*args),
                                  tm.correct(*args, dt=DT)), stress))
        progs = compile_all(jobs)
        return {model: ((prog(*jargs, np.inf), prog(*jargs, DT)), t, stress)
                for model, prog, (jargs, t, stress) in zip(RAS, progs,
                                                           ports)}


@pytest.mark.parametrize("model", RAS)
def test_ras_correct_matches_jax(ras_corrected, model):
    """Steady and transient correct(): every state field to 1e-10, counts
    within one; the transient solved fields keep one old level (Euler)."""
    jres, tres, stress = ras_corrected[model]
    for (jst, jperf), (tst, tperf), dt in zip(jres, tres, (None, DT)):
        assert sorted(tst) == sorted(jst)
        for name in tst:
            _close(tst[name], jst[name], f"{model} {name} dt={dt}")
        assert sorted(tperf) == sorted(jperf)
        for name, pf in jperf.items():
            assert abs(int(tperf[name][2]) - int(pf[2])) <= 1, name
            if dt is not None and jst[name].old is not None:
                assert tst[name].old is not None and tst[name].levels == 1
    if stress is not None:
        _close(stress[1], stress[0], f"{model} nonlinear stress")


# -- full runs ----------------------------------------------------------------

def _its(st):
    its = [(f"U{c}", int(pf[2])) for c, pf in zip("xyz", st["u_perf"])]
    its += [("p", int(pf[2])) for pf in st["p_perf"]]
    return its + [(k, int(pf[2])) for k, pf in sorted(st["turb"].items())]


def _compare(jcase, jf, jsteps, tcase, tf, tsteps):
    for name in jf:
        a = tcase.maps.cells_to_file(tf[name].data.numpy())
        b = jcase.maps.cells_to_file(np.asarray(jf[name].data))
        assert rel(a, b) <= RUN_TOL, name
    assert len(jsteps) == len(tsteps)
    for j, t in zip(jsteps, tsteps):
        jo = [x for x in j if x[0] != "p"]
        to = [x for x in t if x[0] != "p"]
        assert [f for f, _ in jo] == [f for f, _ in to]
        jp = [n for f, n in j if f == "p"]
        tp = [n for f, n in t if f == "p"][-len(jp):]
        assert all(abs(a - b) <= 1 for (_, a), (_, b) in zip(jo, to))
        assert all(abs(a - b) <= 1 for a, b in zip(jp, tp))


SIMPLE_MODELS = ("realizableKE", "SpalartAllmaras")


@pytest.fixture(scope="module")
def simple_runs(tmp_path_factory):
    """3 simpleFoam iterations of both packages on pitzDaily x1 (gdia)
    for each of SIMPLE_MODELS; the JAX package driven as its
    simplefoam.run drives it, its two jitted steps compiled together."""
    import inspect
    from rapidcfd_tpu.solvers.controls import SimpleControl as JSimple
    setups = []
    for model in SIMPLE_MODELS:
        d = str(tmp_path_factory.mktemp("simple_" + model))
        casegen.pitz_daily_ras_case(d, model, end_time=3)
        jcase = JCase(d)
        U, p = jcase.read_field("U"), jcase.read_field("p")
        phi = jfvc.flux(jcase.mesh, U)
        transport = JTransport(jcase.transport_properties())
        jm = jturb.make_ras_model(jcase, U)
        step = jsimple.make_step(jcase, transport, jm, JSimple(jcase))
        env = inspect.getclosurevars(step).nonlocals
        setups.append((d, jcase, env["_step"], env["mesh"],
                       (U, p, phi, jm.init_state(U))))
    out = {}
    with jax_quiet():
        progs = compile_all([(fn, (mesh,) + state)
                             for _, _, fn, mesh, state in setups])
        for model, prog, (d, jcase, _, mesh, state) in zip(
                SIMPLE_MODELS, progs, setups):
            jits = []
            for _ in range(3):
                *state, st = prog(mesh, *state)
                jits.append(_its(st))
            U, p, _, ts = state
            with captured():
                tcase, tU, tp, _, tts = tsimple.run(
                    d, device=CPU, dtype=F64, write=False, max_steps=3)
            out[model] = (jcase, dict(U=U, p=p, **ts), jits, tcase,
                          dict(U=tU, p=tp, **tts),
                          [s["iterations"] for s in tcase.step_log])
    return out


@pytest.mark.parametrize("model", SIMPLE_MODELS)
def test_simplefoam_ras_matches_jax(simple_runs, model):
    """3 SIMPLE iterations: U, p and the model's fields to 1e-8."""
    _compare(*simple_runs[model])


@pytest.fixture(scope="module")
def cn_run(tmp_path_factory):
    """5 pimpleFoam steps with CrankNicolson 0.9 at constant dt on the
    laminar cavity. The JAX step's first input carries two old levels
    and a zero ddt0 at step 0, which cn_advance turns into the same
    first step as none (so the jitted step compiles once)."""
    d = str(tmp_path_factory.mktemp("cn"))
    casegen.cavity_case(d, end_time=0.05)
    _ddt(d, "CrankNicolson 0.9")
    _laminar(d)
    record = []
    orig = jpimple.make_step

    def make_step(case, transport, turb, ctrl, piso_mode):
        step = orig(case, transport, turb, ctrl, piso_mode)

        def recorded(U, p, phi, ts, dt):
            if U.old is None:
                U = U.store_old(levels=2)
                U = U.replace(ddt0=(jnp.zeros_like(U.data),
                                    jnp.zeros_like(U.bvalues),
                                    jnp.asarray(0, jnp.int32)))
            out = step(U, p, phi, ts, dt)
            record.append(_its(out[4]))
            return out
        return recorded
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpimple, "make_step", make_step)
        with jax_quiet():
            jcase, U, p, phi, _ = jpimple.run(d, write=False, max_steps=5)
    with captured():
        tcase, tU, tp, _, _ = tpimple.run(d, device=CPU, dtype=F64,
                                          write=False, max_steps=5)
    return (jcase, dict(U=U, p=p), record, tcase, dict(U=tU, p=tp),
            [s["iterations"] for s in tcase.step_log], U, tU)


def test_cranknicolson_pimplefoam_matches_jax(cn_run):
    """U and p to 1e-8, counts within one, and the ddt0 state with it."""
    _compare(*cn_run[:6])
    jU, tU = cn_run[6:]
    assert tU.levels == 2 and int(tU.ddt0[2]) == int(jU.ddt0[2]) == 5
    jcase, tcase = cn_run[0], cn_run[3]
    a = tcase.maps.cells_to_file(tU.ddt0[0].numpy())
    b = jcase.maps.cells_to_file(np.asarray(jU.ddt0[0]))
    assert rel(a, b) <= RUN_TOL


# -- the ddt schemes ----------------------------------------------------------

def _ddt(d, scheme):
    path = os.path.join(d, "system", "fvSchemes")
    with open(path) as fh:
        txt = fh.read()
    txt = re.sub(r"default\s+Euler;", f"default {scheme};", txt, count=1)
    with open(path, "w") as fh:
        fh.write(txt)


def _laminar(d):
    from rapidcfd_tpu_torch.utils.dictionary import foamfile_header
    casegen._write(os.path.join(d, "constant", "RASProperties"),
                   foamfile_header("dictionary", "RASProperties",
                                   "constant"),
                   "\nRASModel        laminar;\nturbulence      off;\n")


def _jax_ell_case(d):
    """The JAX package's Case of a full box on the RCM-ordered ELL (its
    structured layout is not ported)."""
    with jax_switches(GDIA_AUTO="0", FORCE_RCM="1"):
        return JCase(d)


@pytest.fixture(scope="module")
def small_cavity(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ddt"))
    casegen.cavity_case(d, n=4)
    with captured():
        return _jax_ell_case(d), Case(d, device=CPU, dtype=F64)


def _three_levels(jcase, seed, coeff=False):
    """A JAX VolField with two old levels (numpy-seeded values), or a
    density-like one."""
    rng = np.random.default_rng(seed)
    mesh = jcase.mesh
    p = jcase.read_field("p")
    f = None
    for _ in range(3):
        data = rng.uniform(1.0, 2.0, mesh.n_cells) if coeff \
            else rng.standard_normal(mesh.n_cells)
        new = p.replace(data=jnp.asarray(data),
                        bvalues=jnp.asarray(rng.standard_normal(
                            np.asarray(p.bvalues).shape)))
        f = new if f is None else new.replace(old=f.replace(
            old=None if f.old is None else f.old.replace(old=None)))
    return f


@pytest.mark.parametrize("coeff", [False, True], ids=["plain", "rho"])
def test_backward_ddt_matches_jax(small_cavity, coeff):
    """The port's backward fvm.ddt (two stored levels, constant dt) is
    the JAX package's equal-step form, diag and source."""
    jcase, tcase = small_cavity
    jf = _three_levels(jcase, 1)
    jrho = _three_levels(jcase, 2, coeff=True) if coeff else None
    jm = jfvm.ddt(jcase.mesh, jf, 0.01, "backward", coeff=jrho)
    tmesh = interop.mesh_arrays(jcase.mesh, device=CPU, dtype=F64)
    tf = interop.vol_field(jf, device=CPU, dtype=F64)
    trho = interop.vol_field(jrho, device=CPU, dtype=F64) if coeff else None
    assert tf.levels == 2
    tm = tfvm.ddt(tmesh, tf, 0.01, "backward", coeff=trho)
    assert rel(tm.diag.numpy(), np.asarray(jm.diag)) <= 1e-14
    assert rel(tm.source.numpy(), np.asarray(jm.source)) <= 1e-14


def test_cranknicolson_ddt_matches_jax(small_cavity):
    """cn_advance and the CrankNicolson fvm.ddt over three steps at
    constant dt equal the JAX package's on the same levels."""
    jcase, _ = small_cavity
    tmesh = interop.mesh_arrays(jcase.mesh, device=CPU, dtype=F64)
    rng = np.random.default_rng(4)
    jf = jcase.read_field("p")
    tf = interop.vol_field(jf, device=CPU, dtype=F64)
    for _ in range(3):
        jf = jfvm.cn_advance(jcase.mesh, jf.store_old(levels=2), 0.01, 0.01,
                             0.9)
        tf = tfvm.store_old(tmesh, tf, 0.01, ("CrankNicolson", 0.9))
        jm = jfvm.ddt(jcase.mesh, jf, 0.01, ("CrankNicolson", 0.9))
        tm = tfvm.ddt(tmesh, tf, 0.01, ("CrankNicolson", 0.9))
        assert rel(tm.diag.numpy(), np.asarray(jm.diag)) <= 1e-14
        assert rel(tm.source.numpy(), np.asarray(jm.source)) <= 1e-12
        x = rng.standard_normal(np.asarray(jf.data).shape)
        jf = jf.replace(data=jnp.asarray(x))
        tf = tf.replace(data=torch.as_tensor(x))


def _decay(tmesh, tcase, scheme, n_steps, lam=3.0, t_end=1.0):
    """psi' = -lam psi from psi = 1 by the port's fvm.ddt + Sp (a
    diagonal solve), as tests/test_ddt_schemes.py integrates it."""
    p = tcase.read_field("p")
    psi = p.with_calculated_bcs(torch.ones(tmesh.n_cells, dtype=F64),
                                torch.ones(p.bvalues.shape, dtype=F64),
                                dimless, "psi")
    dt = t_end / n_steps
    lam_ = TDimensioned("lam", DimensionSet.of(0, 0, -1), lam)
    for _ in range(n_steps):
        psi = tfvm.store_old(tmesh, psi, dt, scheme)
        eqn = tfvm.ddt(tmesh, psi, dt, scheme) + tfvm.Sp(tmesh, lam_, psi)
        psi = psi.replace(data=eqn.source / eqn.diag)
    return float(psi.data[0])


@pytest.mark.parametrize("scheme,order", [
    ("Euler", 1), ("backward", 2), (("CrankNicolson", 1.0), 2)],
    ids=["Euler", "backward", "CrankNicolson"])
def test_decay_orders(small_cavity, scheme, order):
    """The decay ODE's error falls with the scheme's order (the JAX
    package's bounds), CrankNicolson after its Euler first step with the
    trapezium amplification."""
    _, tcase = small_cavity
    tmesh = tcase.mesh
    exact = np.exp(-3.0)
    errs = [abs(_decay(tmesh, tcase, scheme, n) - exact)
            for n in (16, 32, 64)]
    slope = np.log2(errs[1] / errs[2])
    assert order - 0.2 < slope < order + 0.3, errs
    if scheme != "Euler" and scheme != "backward":
        dt = 1.0 / 32
        g = (1.0 - 1.5 * dt) / (1.0 + 1.5 * dt)
        expect = 1.0 / (1.0 + 3.0 * dt) * g ** 31
        assert abs(_decay(tmesh, tcase, scheme, 32) - expect) \
            < 5e-6 * expect


def test_backward_varying_dt_coefficients(small_cavity):
    """With dt0 = 2 dt the backward coefficients are OpenFOAM's: coefft =
    1 + dt/(dt + dt0), coefft00 = dt^2/(dt0 (dt + dt0)), coefft0 their
    sum (1 + 1/3, 1/6 and 3/2)."""
    _, tcase = small_cavity
    tmesh = tcase.mesh
    p = tcase.read_field("p")
    f = p.replace(data=torch.full((tmesh.n_cells,), 1.0, dtype=F64))
    f = f.store_old(levels=2, dt=0.02)
    f = f.replace(data=torch.full((tmesh.n_cells,), 2.0, dtype=F64))
    f = f.store_old(levels=2, dt=0.01)
    assert f.old.step_dt == 0.02 and f.old.old is not None
    m = tfvm.ddt(tmesh, f, 0.01, "backward")
    V = tmesh.V_asm
    torch.testing.assert_close(m.diag, (4.0 / 3.0) * V / 0.01, rtol=1e-14,
                               atol=0)
    torch.testing.assert_close(
        m.source, (1.5 * 2.0 - (1.0 / 6.0) * 1.0) * V / 0.01, rtol=1e-14,
        atol=0)


def test_pimplefoam_backward_matrix_at_step_3(tmp_path):
    """The ddt matrix the port's pimpleFoam assembles for U at its third
    backward step equals the JAX package's fvm.ddt(..., "backward") on
    the port's own three levels: U, U.old and U.old.old carried back to
    a JAX VolField. (The JAX run keeps one level, so its backward is
    Euler on every step.)"""
    d = str(tmp_path / "cav")
    casegen.cavity_case(d, end_time=0.05)
    _ddt(d, "backward")
    _laminar(d)
    seen = []
    ddt = tfvm.ddt

    def recording(mesh, vf, dt, scheme="Euler", coeff=None):
        m = ddt(mesh, vf, dt, scheme, coeff)
        if vf.name == "U":
            seen.append((vf, dt, m))
        return m
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfvm, "ddt", recording)
        with captured():
            tcase, *_ = tpimple.run(d, device=CPU, dtype=F64, write=False,
                                    max_steps=3)
    vf, dt, m = seen[-1]
    assert vf.levels == 2 and vf.old.old is not None
    jcase = _jax_ell_case(d)

    def to_jax(f):
        src = interop.vol_field(jcase.read_field("U"), device=CPU, dtype=F64)
        assert [type(b) for b in src.bcs] == [type(b) for b in f.bcs]
        return jcase.read_field("U").replace(
            data=jnp.asarray(f.data.numpy()),
            bvalues=jnp.asarray(f.bvalues.numpy()))
    jU = to_jax(vf).replace(old=to_jax(vf.old).replace(
        old=to_jax(vf.old.old)))
    jm = jfvm.ddt(jcase.mesh, jU, dt, "backward")
    perm = tcase.maps
    assert rel(perm.cells_to_file(m.diag.numpy()),
               jcase.maps.cells_to_file(np.asarray(jm.diag))) <= 1e-14
    assert rel(perm.cells_to_file(m.source.numpy()),
               jcase.maps.cells_to_file(np.asarray(jm.source))) <= 1e-14
    euler = jfvm.ddt(jcase.mesh, jU, dt, "Euler")
    assert rel(np.asarray(jm.diag), np.asarray(euler.diag)) > 0.3


@pytest.mark.parametrize("scheme", ["backward", ("CrankNicolson", 0.9)],
                         ids=["backward", "CrankNicolson"])
def test_one_level_field_refuses_second_order(small_cavity, scheme):
    """A field stored with one level raises rather than run Euler under
    backward's or CrankNicolson's name; CrankNicolson without its ddt0
    state raises too; backward's first step of a two-level field is
    Euler."""
    _, tcase = small_cavity
    tmesh = tcase.mesh
    p = tcase.read_field("p")
    with pytest.raises(ValueError, match="two old levels"):
        tfvm.ddt(tmesh, p.store_old().store_old(), 0.01, scheme)
    two = p.store_old(levels=2)
    if scheme == "backward":
        got = tfvm.ddt(tmesh, two, 0.01, scheme)
        want = tfvm.ddt(tmesh, p.store_old(), 0.01, "Euler")
        assert torch.equal(got.diag, want.diag)
        assert torch.equal(got.source, want.source)
    else:
        with pytest.raises(ValueError, match="ddt0"):
            tfvm.ddt(tmesh, two, 0.01, scheme)


@pytest.mark.parametrize("scheme", ["backward", ("CrankNicolson", 0.9)],
                         ids=["backward", "CrankNicolson"])
def test_lost_old_level_raises(small_cavity, scheme):
    """A two-level field that loses old.old after a store (here rebuilt
    by with_calculated_bcs, which keeps no old level) raises at its next
    ddt rather than take the first step's Euler again."""
    _, tcase = small_cavity
    tmesh = tcase.mesh
    p = tcase.read_field("p")
    two = tfvm.store_old(tmesh, tfvm.store_old(tmesh, p, 0.01, scheme),
                         0.01, scheme)
    assert two.stores == 2 and two.old.old is not None
    tfvm.ddt(tmesh, two, 0.01, scheme)
    lost = tfvm.store_old(
        tmesh, two.with_calculated_bcs(two.data, two.bvalues, two.dims),
        0.01, scheme)
    assert lost.stores == 3 and lost.old.old is None
    with pytest.raises(ValueError, match="lost old.old"):
        tfvm.ddt(tmesh, lost, 0.01, scheme)


#: case writers of pimpleFoam runs with transported model fields, and the
#: fields each model solves with fvm.ddt
_TRANSPORTED = {
    "kEpsilon": (lambda d: casegen.tjunction_case(
        d, section=4, leg=12, bar=12, end_time=0.02), {"k", "epsilon"}),
    "kOmegaSST": (lambda d: casegen.tjunction_case(
        d, section=4, leg=12, bar=12, end_time=0.02, model="kOmegaSST"),
        {"k", "omega"}),
    "oneEqEddy": (lambda d: casegen.les_model_channel_case(
        d, "oneEqEddy", u_seed=3), {"k"}),
    "dynOneEqEddy": (lambda d: casegen.les_model_channel_case(
        d, "dynOneEqEddy", u_seed=3), {"k"}),
    "SpalartAllmarasDDES": (lambda d: casegen.les_model_channel_case(
        d, "SpalartAllmarasDDES", u_seed=3), {"nuTilda"}),
    "kOmegaSSTSAS": (lambda d: casegen.les_model_channel_case(
        d, "kOmegaSSTSAS", u_seed=3), {"k", "omega"}),
    "dynLagrangian": (lambda d: casegen.les_model_channel_case(
        d, "dynLagrangian", u_seed=3), {"flm", "fmm"}),
}


@pytest.mark.parametrize("model", sorted(_TRANSPORTED))
def test_backward_keeps_two_levels_in_every_transported_field(tmp_path,
                                                              model):
    """3 pimpleFoam steps under backward: U and every field the model
    solves reach fvm.ddt stored with two levels, and from their second
    store on with old.old set (the true backward, never the first
    step's Euler again)."""
    d = str(tmp_path / "case")
    write, fields = _TRANSPORTED[model]
    with captured():
        write(d)
    _ddt(d, "backward")
    seen = []
    ddt = tfvm.ddt

    def recording(mesh, vf, dt, scheme="Euler", coeff=None):
        seen.append((vf.name, scheme, vf.levels, vf.stores,
                     vf.old.old is not None))
        return ddt(mesh, vf, dt, scheme, coeff)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfvm, "ddt", recording)
        with captured():
            tpimple.run(d, device=CPU, dtype=F64, write=False, max_steps=3)
    assert {name for name, *_ in seen} >= fields | {"U"}
    for name, scheme, levels, stores, has_old_old in seen:
        assert scheme == "backward" and levels == 2, (name, scheme, levels)
        assert has_old_old == (stores > 1), (name, stores)
    for name in fields | {"U"}:
        assert max(st for n, _, _, st, _ in seen if n == name) == 3, name


#: each transient solver that keeps one old level, with a writer of a
#: small case it runs
_REFUSING = {
    "icoFoam": lambda d: casegen.cavity_case(d),
    "nonNewtonianIcoFoam": lambda d: (casegen.cavity_case(d),
                                      casegen.write_viscosity_model(
                                          d, "CrossPowerLaw")),
    "interFoam": lambda d: casegen.dam_break_case(d, n=8),
    "twoLiquidMixingFoam": lambda d: casegen.mixing_dam_break_case(d, n=8),
    "interMixingFoam": lambda d: casegen.intermixing_case(d, n=8),
    "interPhaseChangeFoam": lambda d: casegen.cavitating_channel_case(d),
    "multiphaseInterFoam": lambda d: casegen.multiphase_dam_break_case(
        d, n=8),
    "driftFluxFoam": lambda d: casegen.settling_column_case(d),
    "potentialFreeSurfaceFoam": lambda d: casegen.sloshing_tank_case(d),
    "cavitatingFoam": lambda d: casegen.cavitating_expansion_case(d),
    "buoyantBoussinesqPimpleFoam": lambda d: casegen.boussinesq_cavity_case(
        d, transient=True),
    "buoyantPimpleFoam": lambda d: casegen.heated_cavity_case(
        d, "buoyantPimpleFoam"),
    "rhoPimpleFoam": lambda d: casegen.transient_hot_channel_case(d),
    "rhoCentralFoam": lambda d: casegen.rhocentral_forward_step_case(d),
    "sonicFoam": lambda d: casegen.forward_step_case(d),
}


@pytest.mark.parametrize("scheme", ["backward", "CrankNicolson 0.9"],
                         ids=["backward", "CrankNicolson"])
@pytest.mark.parametrize("solver", sorted(_REFUSING))
def test_other_transient_solvers_refuse(tmp_path, solver, scheme):
    """Through the dispatcher, on the CPU: NotImplementedError naming the
    solver and the scheme, before any step."""
    from rapidcfd_tpu_torch.__main__ import main
    d = str(tmp_path / "case")
    with captured():
        _REFUSING[solver](d)
    _ddt(d, scheme)
    with pytest.raises(NotImplementedError,
                       match=f"{solver}.*{scheme.split()[0]}"):
        with captured():
            main([solver, "-case", d, "-device", "cpu", "-noWrite"])


def test_thermofoam_refuses_second_order(tmp_path):
    """thermoFoam, with the case's own writer and backward."""
    from rapidcfd_tpu_torch.__main__ import main
    d = str(tmp_path / "case")
    with captured():
        casegen.thermo_channel_case(d)
    _ddt(d, "backward")
    with pytest.raises(NotImplementedError, match="thermoFoam.*backward"):
        with captured():
            main(["thermoFoam", "-case", d, "-device", "cpu", "-noWrite"])


# -- LUST, the registry, the imports -----------------------------------------

def test_lust_weights_match_jax(small_cavity):
    """0.75 linear + 0.25 upwind on a flux of both signs; the grad(U)
    word is read and unused by both."""
    jcase, _ = small_cavity
    tmesh = interop.mesh_arrays(jcase.mesh, device=CPU, dtype=F64)
    rng = np.random.default_rng(7)
    phi = rng.standard_normal(jcase.mesh.n_faces)
    from rapidcfd_tpu.fields.field import SurfaceField as JSurface
    jphi = JSurface(jnp.asarray(phi), jcase.read_field("U").dims, "phi")
    jU = jcase.read_field("U")
    a = tinterp.scheme_weights(
        tmesh, interop.vol_field(jU, device=CPU, dtype=F64),
        ("LUST", "grad(U)"), interop.surface_field(jphi, device=CPU,
                                                   dtype=F64)).numpy()
    b = np.asarray(jinterp.scheme_weights(jcase.mesh, jU,
                                          ("LUST", "grad(U)"), jphi))
    assert rel(a, b) <= 1e-15
    assert set(np.round(a, 12)) - {0.375, 0.625} == set()


def test_ras_registry_holds_every_jax_name():
    assert set(registered_names("RASModel")) <= set(tturb.RAS_MODELS)
    assert set(registered_names("LESModel")) <= set(tturb.LES_MODELS)


def test_unknown_model_raises_naming_it(tmp_path):
    d = str(tmp_path / "pz")
    casegen.pitz_daily_case(d, model="noSuchModel")
    with captured():
        case = Case(d, device=CPU, dtype=F64)
    with pytest.raises(NotImplementedError, match="noSuchModel"):
        tturb.make_ras_model(case, None)


def test_port_and_smoke_import_no_jax():
    """No module of rapidcfd_tpu_torch and no line of chip_smoke.py
    imports jax or rapidcfd_tpu (a source scan: the repair check of the
    slices so far)."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|rapidcfd_tpu)(\.|\s|$)")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "rapidcfd_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    hits = []
    for path in files:
        with open(path) as fh:
            hits += [f"{path}:{i}" for i, line in enumerate(fh, 1)
                     if pat.match(line)]
    assert len(files) > 40 and hits == []
