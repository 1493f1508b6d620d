"""The port's transient and density-based compressible solvers against the
JAX package in fp64 on the CPU: rhoPimpleFoam with its PIMPLEC and LTS
forms and rhoSimplecFoam on the heated channel, rhoCentralFoam on the
Mach-3 forward step. Both packages read the same case directories,
written by the port's case writers; random inputs come from numpy seeds.

- FvMatrix.H1 of a scalar and a vector matrix on gdia (pitzDaily x1) and
  ELL (cavity20) to 1e-12; fvc.smooth, the localEuler ddt with and without
  a coefficient and make_rdelta_t to 1e-12.
- 5 steps each of rhoPimpleFoam, rhoPimplecFoam, rhoLTSPimpleFoam and 5
  rhoSimplecFoam iterations on the 50x10 heated channel (ELL): fields to
  1e-8 relative to their largest magnitude, iteration counts within one.
  The JAX package runs these with XLA's optimisations off
  (jax_disable_most_optimizations), which only shortens its compiles here:
  upwind schemes have no rounding-set limiter.
- 5 inviscid rhoCentralFoam steps at scale 1 on gdia (fixed dt) and on
  ELL (adjustTimeStep yes: the dt sequence equals the JAX package's), and
  3 viscous steps on gdia, the JAX package with XLA's optimisations on:
  the reconstructions' limiters multiply only psiN - psiO, which is zero
  wherever rounding sets r, so its optimised evaluation agrees with the
  port's to rounding.
- fp32 rhoPimpleFoam tracks fp64 over 20 steps (the bounds of
  tests/test_compressible_fp32.py), port only; the dispatcher's entry
  points and the refusals.

Each JAX run happens once, in a module-scoped fixture."""

import contextlib
import os

import jax
import numpy as np
import pytest
import torch

from rapidcfd_tpu.fields.field import Dimensioned as JDim
from rapidcfd_tpu.fields.field import SurfaceField as JSurface
from rapidcfd_tpu.ops import fvc as jfvc
from rapidcfd_tpu.ops import fvm as jfvm
from rapidcfd_tpu.solvers import lts as jlts
from rapidcfd_tpu.solvers import rhocentralfoam as jrc
from rapidcfd_tpu.solvers import rhopimplefoam as jrp
from rapidcfd_tpu.solvers import rhosimplefoam as jrs
from rapidcfd_tpu.solvers.case import Case as JCase
from rapidcfd_tpu.utils import logging as jlog
from rapidcfd_tpu.utils import switches
from rapidcfd_tpu.utils.dimensions import DimensionSet as JDims
from rapidcfd_tpu_torch import interop
from rapidcfd_tpu_torch.__main__ import main as dispatch
from rapidcfd_tpu_torch.fields.field import Dimensioned as TDim
from rapidcfd_tpu_torch.ops import fvc as tfvc
from rapidcfd_tpu_torch.ops import fvm as tfvm
from rapidcfd_tpu_torch.solvers import lts as tlts
from rapidcfd_tpu_torch.solvers import rhocentralfoam as trc
from rapidcfd_tpu_torch.solvers import rhopimplefoam as trp
from rapidcfd_tpu_torch.solvers import rhosimplefoam as trs
from rapidcfd_tpu_torch.solvers.case import Case
from rapidcfd_tpu_torch.utils.casegen import (
    cavity_case, hot_channel_case, pitz_daily_ico_case,
    rhocentral_forward_step_case, transient_hot_channel_case)
from rapidcfd_tpu_torch.utils.logging import captured

CPU = torch.device("cpu")
F64 = torch.float64
_ELL = dict(GDIA_AUTO="0", FORCE_RCM="1")


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
def jax_quiet(unoptimized: bool = False):
    """The JAX package's log off and, with unoptimized, XLA's
    optimisations off (restored on the way out)."""
    old = jlog.Info.enabled, jax.config.read("jax_disable_most_optimizations")
    jlog.Info.enabled = False
    if unoptimized:
        jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jlog.Info.enabled = old[0]
        jax.config.update("jax_disable_most_optimizations", old[1])


def _rel(a, b) -> float:
    a, b = np.broadcast_arrays(np.asarray(a, dtype=float),
                               np.asarray(b, dtype=float))
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# -- meshes for the operator tests --------------------------------------------

@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """pitzDaily x1 (gdia) and the 20x20 cavity (ELL) as the JAX package
    builds them, with the port's copy of each mesh."""
    out = {}
    for layout, writer, env in (
            ("gdia", lambda d: pitz_daily_ico_case(d, scale=1), {}),
            ("ell", lambda d: cavity_case(d, n=20), dict(FORCE_RCM="1"))):
        d = str(tmp_path_factory.mktemp(layout))
        writer(d)
        with jax_switches(**env), jax_quiet():
            jcase = JCase(d)
        assert (jcase.mesh.gdia is not None) == (layout == "gdia")
        out[layout] = (jcase, interop.mesh_arrays(jcase.mesh, device=CPU,
                                                  dtype=F64))
    return out


def _random_state(jcase, seed):
    """(p, U) with random values and old levels, a face flux of both
    signs, as JAX objects."""
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    mesh = jcase.mesh
    with jax_quiet():
        jp, jU = jcase.read_field("p"), jcase.read_field("U")
    out = []
    for f in (jp, jU):
        f = f.replace(data=jnp.asarray(rng.standard_normal(f.data.shape)))
        f = f.correct_boundary_conditions(mesh)
        out.append(f.replace(old=f.replace(data=jnp.asarray(
            rng.standard_normal(f.data.shape)))))
    phi = JSurface(jnp.asarray(rng.standard_normal(mesh.n_faces)),
                   JDims.of(0, 3, -1), "phi")
    return out, phi


@pytest.mark.parametrize("layout", ["gdia", "ell"])
@pytest.mark.parametrize("rank", ["scalar", "vector"])
def test_h1_matches_jax(meshes, layout, rank):
    """H1 (minus the off-diagonal row sums over V, folded and synced on
    gdia) of ddt + div(phi, psi, upwind) - laplacian(nu, psi): the port's
    H1 of the converted matrix against the JAX package's, data and
    boundary values, to 1e-12."""
    jcase, tmesh = meshes[layout]
    jmesh = jcase.mesh
    (jp, jU), jphi = _random_state(jcase, seed=41)
    jf = jp if rank == "scalar" else jU
    nu = JDim("nu", JDims.of(0, 2, -1), 0.37)

    def jax_h1(jmesh, jf, jphi):
        jm = (jfvm.ddt(jmesh, jf, 0.01, "Euler")
              + jfvm.div(jmesh, jphi, jf, "upwind")
              - jfvm.laplacian(jmesh, nu, jf))
        return jm, jm.H1(jmesh)
    with jax_quiet(unoptimized=True):
        jm, jh = jax.jit(jax_h1)(jmesh, jf, jphi)
    tm = interop.fv_matrix(jm, device=CPU, dtype=F64)
    th = tm.H1(tmesh)
    assert _rel(th.data, jh.data) <= 1e-12
    assert _rel(th.bvalues, jh.bvalues) <= 1e-12
    assert th.dims == interop.dims(jh.dims)
    assert float(th.data.abs().max()) > 0.0


def test_smooth_matches_jax(meshes):
    """fvc.smooth on the ELL cavity (cell_nbr pads with the cell itself in
    both packages) and on the pitzDaily gdia lattice (its plane shifts,
    the slot itself across dummy faces and at dead slots, against the
    JAX package's cell_nbr there) to 1e-12."""
    import jax.numpy as jnp
    jcase, tmesh = meshes["ell"]
    assert np.array_equal(np.asarray(jcase.mesh.cell_nbr),
                          tmesh.cell_nbr.numpy())
    rng = np.random.default_rng(7)
    for layout in ("ell", "gdia"):
        jcase, tmesh = meshes[layout]
        data = np.exp(3.0 * rng.standard_normal(jcase.mesh.n_cells))
        for coeff, sweeps in ((1.0 / 1.02, 12), (0.5, 3)):
            a = tfvc.smooth(tmesh, torch.tensor(data), coeff, sweeps)
            b = jfvc.smooth(jcase.mesh, jnp.asarray(data), coeff, sweeps)
            assert _rel(a, b) <= 1e-12
            assert bool((a >= torch.tensor(data)).all())


@pytest.mark.parametrize("layout", ["gdia", "ell"])
def test_local_euler_ddt_matches_jax(meshes, layout):
    """fvm.ddt with a per-cell dt (localEuler, CoEuler, SLTS), with and
    without a density coefficient, scalar and vector: diag and source to
    1e-12; backward raises on a field stored with one level."""
    import jax.numpy as jnp
    jcase, tmesh = meshes[layout]
    jmesh = jcase.mesh
    (jp, jU), _ = _random_state(jcase, seed=43)
    rng = np.random.default_rng(47)
    dt = rng.uniform(1e-4, 1e-2, jmesh.n_cells)
    jrho = jp.replace(data=jnp.asarray(rng.uniform(0.5, 2.0, dt.shape)),
                      dims=JDims.of(1, -3), name="rho")
    jrho = jrho.replace(old=jrho.replace(data=jnp.asarray(
        rng.uniform(0.5, 2.0, dt.shape))))
    trho = interop.vol_field(jrho, device=CPU, dtype=F64)
    for jf in (jp, jU):
        tf = interop.vol_field(jf, device=CPU, dtype=F64)
        for scheme in ("localEuler", "CoEuler", "SLTS"):
            for jc, tc in ((None, None), (jrho, trho)):
                jm = jfvm.ddt(jmesh, jf, jnp.asarray(dt), scheme, coeff=jc)
                tm = tfvm.ddt(tmesh, tf, torch.tensor(dt), scheme, coeff=tc)
                assert _rel(tm.diag, jm.diag) <= 1e-12
                assert _rel(tm.source, jm.source) <= 1e-12
                assert tm.dims == interop.dims(jm.dims)
    with pytest.raises(ValueError, match="backward"):
        tfvm.ddt(tmesh, tf.store_old(), 0.01, "backward")


def test_make_rdelta_t_matches_jax(meshes):
    """The LTS reciprocal step on the ELL cavity: with and without a
    density, smoothing and damping, the first step (no previous value)
    and a later one, to 1e-12."""
    import jax.numpy as jnp
    jcase, tmesh = meshes["ell"]
    rng = np.random.default_rng(53)
    phi = rng.standard_normal(jcase.mesh.n_faces) * 1e-3
    rho = rng.uniform(0.9, 1.3, jcase.mesh.n_cells)
    prev = rng.uniform(50.0, 500.0, jcase.mesh.n_cells)
    for kw in (dict(max_co=0.5, smoothing_coeff=0.02, damping_coeff=0.5,
                    max_delta_t=0.01), {}):
        jf = jlts.make_rdelta_t(jcase.mesh, jlts.LTSControls(**kw))
        tf = tlts.make_rdelta_t(tmesh, tlts.LTSControls(**kw))
        for r, pv in ((rho, None), (None, prev), (rho, prev)):
            a = tf(torch.tensor(phi), None if r is None else torch.tensor(r),
                   None if pv is None else torch.tensor(pv))
            b = jf(jnp.asarray(phi), None if r is None else jnp.asarray(r),
                   None if pv is None else jnp.asarray(pv))
            assert _rel(a, b) <= 1e-12, kw


def test_lts_controls_read_the_pimple_dict(tmp_path):
    d = str(tmp_path / "lts")
    transient_hot_channel_case(d, lts=True)
    with captured():
        case = Case(d, device=CPU, dtype=F64)
    from rapidcfd_tpu_torch.solvers.controls import PimpleControl
    c = tlts.LTSControls.from_dict(PimpleControl(case).dict)
    assert c == tlts.LTSControls(max_co=0.5, smoothing_coeff=0.02,
                                 damping_coeff=0.5, max_delta_t=0.01)
    assert tlts.LTSControls.from_dict(None) == tlts.LTSControls()


# -- the pressure-based solvers on the heated channel ------------------------

def _jax_rho_its(stats):
    its = [(f"U{c}", int(pf[2])) for c, pf in zip("xyz", stats["u_perf"])]
    its.append(("h", int(stats["h_perf"][0][2])))
    its += [("p", int(pf[2])) for pf in stats["p_perf"]]
    return its + [(k, int(pf[2])) for k, pf in sorted(stats["turb"].items())]


def _run_jax_pressure_based(module, d, steps, **kw):
    """The JAX package's run of rhoPimpleFoam (or rhoSimpleFoam) on the
    heated channel (ELL, RCM), recording each step's iteration counts,
    continuity error and (transient) Courant max. The step's inputs get
    old levels before its first call, so it compiles once."""
    record = []
    orig = module.make_step

    def make_step(*a, **k):
        step = orig(*a, **k)

        def recorded(U, p, T, rho, *rest):
            if module is jrp and U.old is None:
                U, p, T, rho = (f.store_old() for f in (U, p, T, rho))
            out = step(U, p, T, rho, *rest)
            st = out[-1]
            record.append(dict(
                iterations=_jax_rho_its(st), cont=float(st["cont"][0]),
                co=float(st["co"][1]) if "co" in st else None))
            return out
        return recorded
    module.make_step = make_step
    try:
        with jax_switches(FORCE_RCM="1"), jax_quiet(unoptimized=True):
            case, U, p, T, rho, phi = module.run(d, write=False,
                                                 max_steps=steps, **kw)
    finally:
        module.make_step = orig
    return case, dict(U=U, p=p, T=T, rho=rho, phi=phi), record


def _run_port_pressure_based(module, d, steps, **kw):
    with captured():
        case, U, p, T, rho, phi = module.run(d, device=CPU, dtype=F64,
                                             write=False, max_steps=steps,
                                             **kw)
    steps_ = [dict(iterations=s["iterations"], cont=s["cont"][0],
                   co=s["co"][1] if "co" in s else None)
              for s in case.step_log]
    return case, dict(U=U, p=p, T=T, rho=rho, phi=phi), steps_


@pytest.fixture(scope="module")
def rho_pimple(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("rhopimple"))
    transient_hot_channel_case(d)
    return (_run_jax_pressure_based(jrp, d, 5),
            _run_port_pressure_based(trp, d, 5))


@pytest.fixture(scope="module")
def rho_pimplec(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("rhopimplec"))
    transient_hot_channel_case(d)
    return (_run_jax_pressure_based(jrp, d, 5, consistent=True),
            _run_port_pressure_based(trp, d, 5, consistent=True))


@pytest.fixture(scope="module")
def rho_lts(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("rholts"))
    transient_hot_channel_case(d, lts=True)
    # lts=None in both: picked from ddtSchemes default localEuler
    return (_run_jax_pressure_based(jrp, d, 5),
            _run_port_pressure_based(trp, d, 5))


@pytest.fixture(scope="module")
def rho_simplec(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("rhosimplec"))
    hot_channel_case(d)
    return (_run_jax_pressure_based(jrs, d, 5, consistent=True),
            _run_port_pressure_based(trs, d, 5, consistent=True))


# -- rhoCentralFoam on the forward step ---------------------------------------

class _RecordingJax:
    """The jax module for the JAX rhoCentralFoam's run, whose jit records
    each step's dt and stats (its step is a closure of run())."""

    def __init__(self, record):
        self.record = record

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kw):
        jitted = jax.jit(fn, **kw)

        def recorded(*a):
            out = jitted(*a)
            st = out[-1]
            its = []
            if st["u_perf"] is not None:
                its = [(f"U{c}", int(pf[2]))
                       for c, pf in zip("xyz", st["u_perf"])]
                its.append(("e", int(st["e_perf"][0][2])))
            self.record.append(dict(dt=float(a[4]), co=float(st["co_max"]),
                                    mach=float(st["mach_max"]),
                                    iterations=its))
            return out
        return recorded


def _run_central(d, steps, ell=False):
    record = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrc, "jax", _RecordingJax(record))
        with jax_switches(**(_ELL if ell else {})), jax_quiet():
            jcase, U, p, T, phi = jrc.run(d, write=False, max_steps=steps)
    jrun = (jcase, dict(U=U, p=p, T=T, phi=phi), record)
    with captured():
        case = Case(d, device=CPU, dtype=F64, gdia_auto=not ell)
        case, U, p, T, phi = trc.run(d, device=CPU, dtype=F64, write=False,
                                     max_steps=steps, case=case)
    return jrun, (case, dict(U=U, p=p, T=T, phi=phi), case.step_log)


@pytest.fixture(scope="module")
def central_gdia(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("central"))
    rhocentral_forward_step_case(d)
    return _run_central(d, 5)


@pytest.fixture(scope="module")
def central_ell_adjusted(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("central_adj"))
    rhocentral_forward_step_case(d, adjust_time_step=True)
    return _run_central(d, 5, ell=True)


@pytest.fixture(scope="module")
def central_viscous(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("central_visc"))
    rhocentral_forward_step_case(d, viscous=True)
    return _run_central(d, 3)


# -- the comparisons -----------------------------------------------------------

def _field_errors(jrun, trun, nan_on_empty=False):
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
        # the JAX package's consistent forms and rhoCentralFoam leave NaN
        # in phi on the empty patch's faces (the port's flux is 0 there):
        # compare the rest
        keep = np.isfinite(b)
        assert keep.all() or (name == "phi" and nan_on_empty), name
        out[name] = np.abs(a - b)[keep].max() / np.abs(b[keep]).max()
    return out


_PRESSURE_BASED = ("rho_pimple", "rho_pimplec", "rho_lts", "rho_simplec")
_CENTRAL = ("central_gdia", "central_ell_adjusted", "central_viscous")


@pytest.mark.parametrize("run", _PRESSURE_BASED + _CENTRAL)
def test_fields_match_jax(run, request):
    jrun, trun = request.getfixturevalue(run)
    err = _field_errors(jrun, trun, run not in ("rho_pimple", "rho_lts"))
    names = ["T", "U", "p", "phi"] + (["rho"] if run in _PRESSURE_BASED
                                      else [])
    assert sorted(err) == sorted(names)
    assert max(err.values()) <= 1e-8, err


@pytest.mark.parametrize("run", _PRESSURE_BASED + ("central_viscous",))
def test_iterations_match_jax(run, request):
    """Per step: the same solves in the same order, each within one
    iteration of the JAX package's."""
    (_, _, jsteps), (_, _, tsteps) = request.getfixturevalue(run)
    n = 3 if run == "central_viscous" else 5
    assert len(jsteps) == len(tsteps) == n
    for j, t in zip(jsteps, tsteps):
        assert [f for f, _ in j["iterations"]] == \
            [f for f, _ in t["iterations"]]
        assert all(abs(a - b) <= 1 for (_, a), (_, b) in
                   zip(j["iterations"], t["iterations"])), (j, t)
    assert tsteps[0]["iterations"]


@pytest.mark.parametrize("run", _PRESSURE_BASED)
def test_continuity_and_courant_match_jax(run, request):
    """The local continuity error to 1e-6 relative plus 1e-12 kg/s (it
    sits at the rounding of the ddt(rho) terms, ~4e-13 kg/s after 5 steps,
    where eps sum(rho V)/dt is 1.3e-15 kg/s) and, for the transient forms,
    the Courant max to 1e-9."""
    (_, _, jsteps), (_, _, tsteps) = request.getfixturevalue(run)
    for j, t in zip(jsteps, tsteps):
        assert t["cont"] == pytest.approx(j["cont"], rel=1e-6, abs=1e-12)
        if run != "rho_simplec":
            assert t["co"] == pytest.approx(j["co"], rel=1e-9)


def test_pimplec_and_lts_differ_from_pimple(rho_pimple, rho_pimplec, rho_lts):
    """The PIMPLEC and LTS forms take their own paths: their p iteration
    counts and fields are not rhoPimpleFoam's, and LTS's local Courant
    number sits at its maxCo 0.5."""
    base = rho_pimple[1]
    for other in (rho_pimplec[1], rho_lts[1]):
        assert float((other[1]["U"].data - base[1]["U"].data).abs().max()) \
            > 1e-9
    assert rho_lts[1][2][-1]["co"] == pytest.approx(0.5, rel=1e-3)
    assert rho_lts[1][0].step_log[0]["dt"] is None


@pytest.mark.parametrize("run", _CENTRAL)
def test_central_readings_match_jax(run, request):
    """Per step: dt (the adjusted sequence included) to 1e-12, Courant max
    and max Mach to 1e-9; the layouts are what they say."""
    (_, _, jsteps), (tcase, tf, tsteps) = request.getfixturevalue(run)
    assert (tcase.mesh.gdia is None) == (run == "central_ell_adjusted")
    assert [t["dt"] for t in tsteps] == pytest.approx(
        [j["dt"] for j in jsteps], rel=1e-12)
    for j, t in zip(jsteps, tsteps):
        assert t["co"] == pytest.approx(j["co"], rel=1e-9)
        assert t["mach"] == pytest.approx(j["mach"], rel=1e-9)
    assert tsteps[0]["mach"] == pytest.approx(3.0, rel=1e-3)
    if run == "central_ell_adjusted":
        dts = [t["dt"] for t in tsteps]
        assert dts[1] > dts[0] and max(dts) <= 0.003 + 1e-15
    p = tf["p"].data[torch.as_tensor(tcase.maps.cell_primary)]
    assert float(p.min()) > 0.0
    # phi is finite on every face, the gdia dummies and empty faces too
    assert bool(torch.isfinite(tf["phi"].data).all())


@pytest.mark.parametrize("viscous", [False, True])
def test_central_shift_mac_calls(central_gdia, central_viscous, monkeypatch,
                                 viscous):
    """On gdia the inviscid step takes one gradient per reconstructed
    field: 7 K = 5, C = 3 shift-MAC calls (rho, the three components of
    rhoU, rPsi, e and c) and no C = 1. The viscous step adds grad(U) and
    the corrected laplacians' gradients of U and e (7 more C = 3) and
    div(tauMC) (9 C = 1). Counted at the wrapper, whose plain version
    runs here."""
    from rapidcfd_tpu_torch.ops import gdia_mac
    calls = {}
    plain = gdia_mac.shift_mac_cols

    def counted(x, coeffs, offsets):
        out = plain(x, coeffs, offsets)
        kc = (coeffs.shape[0], out.shape[0])
        calls[kc] = calls.get(kc, 0) + 1
        return out
    monkeypatch.setattr(gdia_mac, "shift_mac_cols", counted)
    tcase = (central_viscous if viscous else central_gdia)[1][0]
    with captured():
        _, (U, p, T), step = trc.setup(Case(tcase.dir, device=CPU,
                                            dtype=F64))
        step(U, p, T, 0.002)
    assert calls == ({(5, 3): 14, (5, 1): 9} if viscous else {(5, 3): 7})


def test_rho_pimple_fp32_tracks_fp64(tmp_path):
    """fp32 rhoPimpleFoam (p in deviation form with the p_offset ddt(psi)
    source) tracks fp64 over 20 steps on the 50x10 channel, with the
    bounds of tests/test_compressible_fp32.py: the deviation of p to 2e-2,
    T to 2e-3 and U to 2e-2 of their fp64 scales, the mean of p within 2
    Pa."""
    d = str(tmp_path / "hot")
    transient_hot_channel_case(d)
    out = {}
    for dtype in (torch.float32, F64):
        with captured() as buf:
            case, U, p, T, rho, phi = trp.run(d, device=CPU, dtype=dtype,
                                              write=False, max_steps=20)
        assert len(case.step_log) == 20
        assert ("deviation form" in buf.getvalue()) == (dtype
                                                        == torch.float32)
        out[dtype] = [case.maps.cells_to_file(f.data.double().numpy())
                      for f in (p, T, U)]
    (p32, t32, u32), (p64, t64, u64) = out[torch.float32], out[F64]
    dp32, dp64 = p32 - p32.mean(), p64 - p64.mean()
    assert np.isfinite(p32).all() and np.isfinite(u32).all()
    assert np.abs(dp32 - dp64).max() / max(np.abs(dp64).max(), 1e-30) < 2e-2
    assert np.abs(t32 - t64).max() / np.abs(t64).max() < 2e-3
    assert np.abs(u32 - u64).max() < 2e-2 * np.abs(u64).max()
    assert abs(p32.mean() - p64.mean()) < 2.0


# -- entry points and refusals --------------------------------------------------

@pytest.mark.parametrize("name", ["rhoCentralFoam", "rhoPimpleFoam",
                                  "rhoPimplecFoam", "rhoLTSPimpleFoam",
                                  "rhoSimplecFoam"])
def test_dispatcher_runs_on_the_cpu(tmp_path, name):
    """python -m rapidcfd_tpu_torch NAME -case D -device cpu runs two steps
    to its endTime (the cases write every 1000 or more steps, so nothing
    yet); without -device the card is asked for, which raises here."""
    d = str(tmp_path / name)
    if name == "rhoCentralFoam":
        rhocentral_forward_step_case(d, end_time=0.004)
    elif name == "rhoSimplecFoam":
        hot_channel_case(d, end_time=2)
    else:
        lts = name == "rhoLTSPimpleFoam"
        transient_hot_channel_case(d, end_time=0.001 if lts else 0.0004,
                                   lts=lts)
    with captured() as buf:
        dispatch([name, "-case", d, "-device", "cpu"])
    log = buf.getvalue()
    assert log.count("\nTime = ") == 2 and "End" in log
    assert "nan" not in log.lower()
    if name != "rhoCentralFoam":
        assert log.count("Solving for p") >= 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            dispatch([name, "-case", d])


def test_defaults_and_refusals(tmp_path):
    """rhoCentralFoam defaults to fp64 as in the JAX dispatcher, the
    pressure-based forms to fp32; the dynamic-mesh forms and an unknown
    fluxScheme raise."""
    from rapidcfd_tpu_torch import solver_dtype
    assert solver_dtype("rhoCentralFoam") == F64
    for name in ("rhoPimpleFoam", "rhoPimplecFoam", "rhoLTSPimpleFoam",
                 "rhoSimplecFoam"):
        assert solver_dtype(name) == torch.float32
    d = str(tmp_path / "fs")
    rhocentral_forward_step_case(d)
    h = str(tmp_path / "hot")
    transient_hot_channel_case(h)
    with captured():
        case = Case(d, device=CPU, dtype=F64)
        with pytest.raises(NotImplementedError, match="rhoCentralDyMFoam"):
            trc.setup(case, dym=True)
        hcase = Case(h, device=CPU, dtype=F64)
        with pytest.raises(NotImplementedError, match="rhoPimpleDyMFoam"):
            trp.make_step(hcase, None, None, dym=True)
    fs = os.path.join(d, "system", "fvSchemes")
    with open(fs) as f:
        body = f.read()
    with open(fs, "w") as f:
        f.write(body.replace("Kurganov", "HLLC"))
    with captured():
        case = Case(d, device=CPU, dtype=F64)
        with pytest.raises(ValueError, match="Kurganov or Tadmor"):
            trc.setup(case)
    with pytest.raises(ValueError, match="PCG or GAMG"):
        transient_hot_channel_case(h, p_solver="DIC")
