"""The port's Boussinesq heat-transfer slice against the JAX package in
fp64 on the CPU: buoyantBoussinesqSimpleFoam on the 2-D heated cavity
(gdia and ELL) and, with kEpsilon, on an 8 x 6 x 4 hot room (3-D gdia,
both K = 7 shift-MAC forms), buoyantBoussinesqPimpleFoam on the cavity
with fixedFluxPressure walls (ELL); the room's routing onto the gdia
lattice; fvc.reconstruct, average and domain_integrate; the
fixedFluxPressure and prghPressure conditions.

Both packages read the same case directories, written by the port's
case writers. 3 iterations or steps of each solver: every field within
1e-8 of the JAX package's, relative to its largest magnitude (measured
~1e-14), iteration counts within one. The JAX package's gdia pipeline
fails on a laminar case (its fvc.div_dev_t_grad reads `.data` of the
Dimensioned nuEff; ROADMAP Queue 3), so the laminar cavity's JAX run on
gdia takes its generic pipeline (RCFD_GDIA_MAC=0); the port's fused
kernel path agrees with it to rounding. Each JAX run happens once, in a
module-scoped fixture.
"""

import numpy as np
import pytest
import torch

from rapidcfd_tpu.fields import bcs as jbcs
from rapidcfd_tpu.fields.field import SurfaceField as JSurface
from rapidcfd_tpu.ops import fvc as jfvc
from rapidcfd_tpu.solvers import buoyantfoam as jbf
from rapidcfd_tpu.solvers.case import Case as JCase
from rapidcfd_tpu.utils.dimensions import DimensionSet as JDims
from rapidcfd_tpu_torch import interop
from rapidcfd_tpu_torch.fields import bcs as tbcs
from rapidcfd_tpu_torch.mesh.polymesh import read_polymesh
from rapidcfd_tpu_torch.ops import fvc as tfvc
from rapidcfd_tpu_torch.ops import gdia_mac
from rapidcfd_tpu_torch.solvers import buoyantfoam as tbf
from rapidcfd_tpu_torch.utils.casegen import (boussinesq_cavity_case,
                                              cavity_case, hot_room_case)
from rapidcfd_tpu_torch.utils.unstructured import detect_lattice
from torch_heat_reference import (CPU, F64, cell_errors, counts_close,
                                  flux_error, jax_quiet, jax_switches,
                                  port_case, rel, run_jax, run_port)


def _its(stats):
    """A JAX Boussinesq step's iteration counts, in the port's order."""
    its = [(f"U{c}", int(pf[2])) for c, pf in zip("xyz", stats["u_perf"])]
    its.append(("T", int(stats["t_perf"][0][2])))
    its += [("p_rgh", int(pf[2])) for pf in stats["p_perf"]]
    return its + [(k, int(pf[2]))
                  for k, pf in sorted(stats.get("turb", {}).items())]


def _pair(d, layout, transient=False, mac=True):
    kw = dict(transient=True) if transient else {}
    jrun = run_jax(jbf, d, 3, layout, _its, prestore=(0, 2) if transient
                   else (), mac=mac, **kw)
    return jrun, run_port(tbf, d, 3, layout, **kw)


@pytest.fixture(scope="module")
def cavity(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("bcavity"))
    boussinesq_cavity_case(d)
    return d


@pytest.fixture(scope="module")
def cavity_gdia(cavity):
    return _pair(cavity, "gdia", mac=False)


@pytest.fixture(scope="module")
def cavity_ell(cavity):
    return _pair(cavity, "ell")


@pytest.fixture(scope="module")
def room(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("room"))
    hot_room_case(d, 8, 6, 4)
    return d


@pytest.fixture(scope="module")
def room_run(room):
    return _pair(room, "gdia")


@pytest.fixture(scope="module")
def pimple_ffp(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("bpimple"))
    boussinesq_cavity_case(d, transient=True, p_bc="fixedFluxPressure")
    return _pair(d, "ell", transient=True)


_RUNS = ["cavity_gdia", "cavity_ell", "room_run", "pimple_ffp"]


@pytest.mark.parametrize("run", _RUNS)
def test_boussinesq_matches_jax(run, request):
    """U, p_rgh, T (and k, epsilon, nut on the room) after 3 iterations
    or steps within 1e-8 of the JAX package's; phi on the faces a sum
    reads; every solve's iteration count within one."""
    (jout, jits), (tout, tits) = request.getfixturevalue(run)
    jcase, jU, jp, jT, jphi, jts = jout
    tcase, tU, tp, tT, tphi, tts = tout
    assert sorted(tts) == sorted(jts)
    errs = cell_errors(tcase, jcase, dict(
        U=(tU, jU), p_rgh=(tp, jp), T=(tT, jT),
        **{k: (tts[k], jts[k]) for k in tts}))
    errs["phi"] = flux_error(tcase, jcase, tphi, jphi)
    assert max(errs.values()) <= 1e-8, errs
    assert counts_close(tits, jits), (tits, jits)
    assert float(tU.data.abs().max()) > 0.0
    assert (tcase.mesh.gdia is not None) == (run != "cavity_ell"
                                            and run != "pimple_ffp")


def test_room_routes_to_gdia(room):
    """The room read from disk is a full box: detect_lattice takes it
    with full_box (the heater's split of the floor changes nothing) and
    gives the writer's embedding; Case(gdia_box=True) routes it onto the
    gdia lattice (K = 7 planes), the default onto the padded ELL."""
    pm = read_polymesh(room)
    assert [p.name for p in pm.patches] == ["floor", "heater", "ceiling",
                                            "fixedWalls"]
    assert pm.patches[1].n_faces == 4
    assert detect_lattice(pm) is None
    lat = detect_lattice(pm, full_box=True)
    lat_w = {}
    hot_room_case(room + "_w", 8, 6, 4, write_mesh=False, lattice_out=lat_w)
    assert lat["shape"] == lat_w["shape"] == (4, 6, 8)
    for key in lat_w:
        assert np.array_equal(np.asarray(lat[key]), np.asarray(lat_w[key]))
    tcase = port_case(room, "gdia")
    assert tcase.mesh.gdia is not None and tcase.mesh.gdia.steps == (1, 8, 48)
    assert len(tcase.mesh.gauss.offsets) == 7
    assert port_case(room, "ell").mesh.gdia is None


def test_room_shift_mac_calls(room, monkeypatch):
    """One kEpsilon iteration of the room launches both K = 7 forms:
    the gradients of fvc.grad(U) (magsqr_symm_grad) and of
    div_dev_t_grad's U (3 each, C = 3) and the 9 C = 1 contractions of
    its divergence; no K = 5 form."""
    calls = {}
    plain = gdia_mac.shift_mac_cols

    def counted(x, coeffs, offsets):
        kc = (coeffs.shape[0], coeffs.shape[1])
        calls[kc] = calls.get(kc, 0) + 1
        return plain(x, coeffs, offsets)
    monkeypatch.setattr(gdia_mac, "shift_mac_cols", counted)
    run_port(tbf, room, 1, "gdia")
    assert calls == {(7, 3): 6, (7, 1): 9}


def _random_ssf(jmesh, seed):
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    return JSurface(jnp.asarray(rng.standard_normal(jmesh.n_faces)),
                    JDims.of(0, 3, -1), "ssf")


@pytest.mark.parametrize("layout", ["gdia", "ell"])
def test_reconstruct_average_integrate_match_jax(room, cavity, layout):
    """fvc.reconstruct and fvc.average of a random face field, and
    domain_integrate, against the JAX package's on the room (3-D gdia)
    and the cavity (2-D ELL), to 1e-12 over the live cells (the JAX
    package's dummy plane faces carry the random values, which no sum
    reads)."""
    if layout == "gdia":
        jcase = JCase(room, lattice=detect_lattice(read_polymesh(room),
                                                   full_box=True))
    else:
        with jax_switches(GDIA_AUTO="0", FORCE_RCM="1"), jax_quiet():
            jcase = JCase(cavity)
    tmesh = interop.mesh_arrays(jcase.mesh, device=CPU, dtype=F64)
    jssf = _random_ssf(jcase.mesh, 11)
    tssf = interop.surface_field(jssf, device=CPU, dtype=F64)
    live = jcase.maps.cells_to_file
    for jf, tf in ((jfvc.reconstruct, tfvc.reconstruct),
                   (jfvc.average, tfvc.average)):
        a, b = tf(tmesh, tssf), jf(jcase.mesh, jssf)
        assert rel(live(a.data.numpy()), live(np.asarray(b.data))) <= 1e-12
        assert a.dims == interop.dims(b.dims)
    with jax_quiet():
        jT = jcase.read_field("T")
    tT = interop.vol_field(jT, device=CPU, dtype=F64)
    assert rel(tfvc.domain_integrate(tmesh, tT).numpy(),
               jfvc.domain_integrate(jcase.mesh, jT)) <= 1e-12


def test_fixed_flux_pressure_and_prgh_match_jax(room):
    """setSnGrad on the room's fixedFluxPressure walls, the mask, and a
    prghPressure patch with rho and gh_b in env, against the JAX
    package's, to 1e-12; the gradient stays a tensor in bcdata."""
    import jax.numpy as jnp
    jcase = JCase(room, lattice=detect_lattice(read_polymesh(room),
                                               full_box=True))
    jmesh = jcase.mesh
    tmesh = interop.mesh_arrays(jmesh, device=CPU, dtype=F64)
    with jax_quiet():
        jp = jcase.read_field("p_rgh")
    tp = interop.vol_field(jp, device=CPU, dtype=F64)
    rng = np.random.default_rng(5)
    jp = jp.replace(data=jnp.asarray(rng.standard_normal(jmesh.n_cells)))
    tp = tp.replace(data=torch.tensor(np.asarray(jp.data)))
    g = rng.standard_normal(jmesh.n_faces - jmesh.n_internal)
    assert np.array_equal(tbcs.fixed_flux_pressure_mask(tmesh, tp).numpy(),
                          np.asarray(jbcs.fixed_flux_pressure_mask(jmesh, jp)))
    a = tbcs.set_fixed_flux_pressure_gradient(tmesh, tp, torch.tensor(g))
    b = jbcs.set_fixed_flux_pressure_gradient(jmesh, jp, jnp.asarray(g))
    assert rel(a.bvalues.numpy(), np.asarray(b.bvalues)) <= 1e-12
    assert all(isinstance(bd["snGrad"], torch.Tensor) for bd in a.bcdata)
    # prghPressure on the heater patch, rho and gh_b from random values
    patch = 1
    tbc, jbc = tbcs.PrghPressure(patch), jbcs.PrghPressure(patch)
    rho_b = rng.uniform(0.9, 1.3, g.shape)
    gh_b = rng.standard_normal(g.shape)
    jrho = jp.replace(bvalues=jnp.asarray(rho_b))
    trho = tp.replace(bvalues=torch.tensor(rho_b))
    val = rng.standard_normal(4)
    ta = tbc.evaluate(tmesh, tmesh.patches[patch], tp,
                      {"value": torch.tensor(val)},
                      {"rho": trho, "gh_b": torch.tensor(gh_b)})
    jb = jbc.evaluate(jmesh, jmesh.patches[patch], jp,
                      {"value": jnp.asarray(val)},
                      {"rho": jrho, "gh_b": jnp.asarray(gh_b)})
    assert rel(ta.numpy(), np.asarray(jb)) <= 1e-12
    assert torch.equal(tbc.evaluate(tmesh, tmesh.patches[patch], tp,
                                    {"value": torch.tensor(val)}),
                       torch.tensor(val))


def test_boussinesq_writes_and_dispatches(room, tmp_path):
    """The dispatcher runs the room (-gdiaBox) and the transient cavity
    on the CPU and writes their fields; -gdiaBox reaches every solver
    (icoFoam's run takes a Case too since the basic solvers' slice); cuda
    is the default device."""
    import os

    from rapidcfd_tpu_torch import solver_dtype
    from rapidcfd_tpu_torch.__main__ import main as dispatch
    from rapidcfd_tpu_torch.utils.logging import captured
    assert solver_dtype("buoyantBoussinesqSimpleFoam") == torch.float32
    for name in ("buoyantSimpleFoam", "buoyantPimpleFoam", "thermoFoam"):
        assert solver_dtype(name) == torch.float64
    d = str(tmp_path / "room")
    hot_room_case(d, 8, 6, 4, end_time=2)
    with captured() as log:
        dispatch(["buoyantBoussinesqSimpleFoam", "-case", d, "-device",
                  "cpu", "-gdiaBox"])
    assert "gdia: lattice 8x6x4 detected (0 dead slots)" in log.getvalue()
    for name in ("U", "p_rgh", "T", "k", "epsilon", "nut"):
        assert os.path.isfile(os.path.join(d, "2", name))
    c = str(tmp_path / "cavity")
    boussinesq_cavity_case(c, n=6, transient=True)
    with captured():
        dispatch(["buoyantBoussinesqPimpleFoam", "-case", c, "-device",
                  "cpu", "-noWrite"])
    ico = str(tmp_path / "ico")
    cavity_case(ico, n=6, end_time=0.01)
    with captured() as log:
        dispatch(["icoFoam", "-case", ico, "-device", "cpu", "-gdiaBox",
                  "-noWrite"])
    assert "gdia: lattice 6x6x1 detected" in log.getvalue()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            dispatch(["buoyantBoussinesqSimpleFoam", "-case", d])
