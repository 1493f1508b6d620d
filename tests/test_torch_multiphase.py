"""The rest of the port's incompressible multiphase family against the JAX
package in fp64 on the CPU, 5 steps each: multiphaseInterFoam on the
16x16 three-phase dam break (gdia and ELL) and on the 20x12 stratified
water/oil/air tank (gdia), driftFluxFoam on the 4x40 settling column
(gdia and ELL), potentialFreeSurfaceFoam on the 20x10 sloshing tank and
cavitatingFoam on the 40x4 expansion channel (gdia): the cases of
tests/test_phasechange.py (:375, :278, :195, :114), written by the port's
writers, and the three-phase form of the dam break.

Every field and phi within 1e-8 of the JAX package's relative to their
largest magnitude (the tank's U, the rounding of a hydrostatic balance,
aside), each solve's iteration count within one, and the bounds each
JAX test asserts. The port corrects the phase fractions' sum as the
reference does and the JAX package does not (ROADMAP Queue 3): 1.4e-9
of difference on the dam break. The pieces that the JAX solvers keep in
closures of run() (nHatf, the drift velocity and tauDm, the barotropic
closure, the zeta update) are held to the JAX operators composed as those
closures compose them, to 1e-12. Each JAX run happens once, with XLA's
optimisations off (the limiters' rounding, as in
test_torch_compressible.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapidcfd_tpu.ops import fvc as jfvc
from rapidcfd_tpu.solvers import cavitatingfoam as jcav
from rapidcfd_tpu.solvers import driftfluxfoam as jdf
from rapidcfd_tpu.solvers import multiphaseinterfoam as jmp
from rapidcfd_tpu.solvers import potentialfreesurfacefoam as jpfs
from rapidcfd_tpu.solvers.case import Case as JCase
from rapidcfd_tpu_torch import interop
from rapidcfd_tpu_torch.fields.field import SurfaceField, VolField
from rapidcfd_tpu_torch.mesh.polymesh import read_polymesh
from rapidcfd_tpu_torch.ops import fvc as tfvc
from rapidcfd_tpu_torch.ops import gdia_mac
from rapidcfd_tpu_torch.solvers import cavitatingfoam as tcav
from rapidcfd_tpu_torch.solvers import driftfluxfoam as tdf
from rapidcfd_tpu_torch.solvers.interfoam import interface_curvature
from rapidcfd_tpu_torch.solvers import multiphaseinterfoam as tmp
from rapidcfd_tpu_torch.solvers import potentialfreesurfacefoam as tpfs
from rapidcfd_tpu_torch.utils.casegen import (cavitating_expansion_case,
                                              multiphase_dam_break_case,
                                              settling_column_case,
                                              sloshing_tank_case,
                                              stratified_tank_case)
from rapidcfd_tpu_torch.utils.dimensions import DimensionSet
from rapidcfd_tpu_torch.utils.logging import captured
from rapidcfd_tpu_torch.utils.unstructured import detect_lattice
from torch_heat_reference import (CPU, F64, cell_errors, counts_close,
                                  flux_error, jax_quiet, jax_switches,
                                  port_case, rel, run_jax, run_port)

STEPS = 5
RTOL = 1e-8
TOL = 1e-12


def _compare(tout, jout, names, t_its, j_its):
    """The fields named `names` (the outputs between the case and phi)
    within RTOL, phi on the faces a sum reads, counts within one."""
    tcase, jcase = tout[0], jout[0]
    errs = cell_errors(tcase, jcase, {n: (a, b) for n, a, b in zip(
        names, tout[1:], jout[1:])})
    errs["phi"] = flux_error(tcase, jcase, tout[len(names) + 1],
                             jout[len(names) + 1])
    assert all(v <= RTOL for v in errs.values()), errs
    assert counts_close(t_its, j_its), (t_its, j_its)
    return errs


def _volumes(case, fields, names):
    """(integral now, integral of the case's 0/ field) per field."""
    V = case.mesh.V_asm
    return [(float((f.data * V).sum()),
             float((case.read_field(n, "0").data * V).sum()))
            for f, n in zip(fields, names)]


# -- the four solvers against the JAX package's run() --------------------------

@pytest.fixture(scope="module")
def tank(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tank"))
    with captured():
        stratified_tank_case(d)
    return d


@pytest.fixture(scope="module")
def dam3(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dam3"))
    with captured():
        multiphase_dam_break_case(d, n=16, delta_t=1e-3)
    return d


def _multiphase_pair(d, layout):
    jout, j_its = run_jax(jmp, d, STEPS, layout, lambda st: [
        ("p_rgh", int(pf[2])) for pf in st["p_perf"]], prestore=(1, 2))
    tout, t_its = run_port(tmp, d, STEPS, layout)
    # the alphas as fields of their own: (case, water, oil, air, U, p_rgh,
    # phi)
    return ((tout[0], *tout[1], *tout[2:]), (jout[0], *jout[1], *jout[2:]),
            t_its, j_its)


PHASES = ("water", "oil", "air")


def _check_phases(case, alphas, vol_rtol):
    """Each alpha within [-1e-6, 1 + 1e-6], their sum 1 within 1e-6,
    each phase's volume within vol_rtol of the box's of its start."""
    for a in alphas:
        assert -1e-6 <= float(a.data.min()) <= float(a.data.max()) < 1 + 1e-6
    assert float((sum(a.data for a in alphas) - 1.0).abs().max()) < 1e-6
    v_total = float(case.mesh.V_asm.sum())
    for now, start in _volumes(case, alphas,
                               [f"alpha{n}" for n in PHASES]):
        assert abs(now - start) < vol_rtol * v_total


@pytest.mark.parametrize("layout", ["gdia", "ell"])
def test_multiphase_inter_matches_jax(dam3, layout):
    """multiphaseInterFoam, three phases with the pairwise compression and
    surface tension, on the 16x16 three-phase dam break (water and oil
    columns collapsing in air): the three alphas, U, p_rgh and phi within
    1e-8, p_rgh counts within one; the JAX test's bounds (alphas within
    1e-6 of [0, 1], the sum 1, each volume within 2e-3 of the box's)."""
    tout, jout, t_its, j_its = _multiphase_pair(dam3, layout)
    _compare(tout, jout, (*PHASES, "U", "p_rgh"), t_its, j_its)
    case = tout[0]
    assert (case.mesh.gdia is not None) == (layout == "gdia")
    _check_phases(case, tout[1:4], 2e-3)


def test_multiphase_stratified_tank_matches_jax(tank):
    """The JAX test's own case (tests/test_phasechange.py:375-462), the
    stable stratification on gdia: the three alphas and p_rgh within 1e-8,
    p_rgh counts within one, its bounds. U stays at the rounding of the
    hydrostatic balance (|U| ~7e-7 m/s after 5 steps), where the two
    packages part at ~7e-8 of it: U and phi are held on the dam break
    above, not here."""
    tout, jout, t_its, j_its = _multiphase_pair(tank, "gdia")
    errs = cell_errors(tout[0], jout[0], {n: (a, b) for n, a, b in zip(
        (*PHASES, "U", "p_rgh"), tout[1:6], jout[1:6]) if n != "U"})
    assert all(v <= RTOL for v in errs.values()), errs
    assert counts_close(t_its, j_its), (t_its, j_its)
    assert float(tout[4].data.abs().max()) < 1e-5
    _check_phases(tout[0], tout[1:4], 2e-3)


@pytest.fixture(scope="module")
def column(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("column"))
    with captured():
        settling_column_case(d)
    return d


@pytest.fixture(scope="module", params=["gdia", "ell"])
def drift_runs(request, column):
    jout, j_its = run_jax(jdf, column, STEPS, request.param, lambda st: [
        ("alpha", int(st["a_perf"][0][2]))] + [
        ("p_rgh", int(pf[2])) for pf in st["p_perf"]], prestore=(0, 1))
    tout, t_its = run_port(tdf, column, STEPS, request.param)
    return request.param, tout, jout, t_its, j_its


def test_drift_flux_matches_jax(drift_runs):
    """driftFluxFoam (simple relative velocity, plastic viscosity, tauDm
    through fvc.div_tensor): alpha, U, p_rgh and phi within 1e-8, the
    alpha and p_rgh counts within one; alpha within [-1e-9, 1 + 1e-6],
    the dispersed volume within 1e-6 of its start and the sludge moving
    down (tests/test_phasechange.py:361-371)."""
    layout, tout, jout, t_its, j_its = drift_runs
    _compare(tout, jout, ("alpha", "U", "p_rgh"), t_its, j_its)
    case, alpha, U = tout[:3]
    assert (case.mesh.gdia is not None) == (layout == "gdia")
    assert -1e-9 <= float(alpha.data.min())
    assert float(alpha.data.max()) <= 1.0 + 1e-6
    (now, start), = _volumes(case, [alpha], ["alpha1"])
    assert abs(now - start) < 1e-6 * float(case.mesh.V_asm.sum())
    assert float(U.data[:, 1].min()) < 0.0


@pytest.fixture(scope="module")
def sloshing_runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("slosh"))
    with captured():
        sloshing_tank_case(d)
    jout, j_its = run_jax(jpfs, d, STEPS, "gdia", lambda st: [
        (f"U{c}", int(pf[2])) for c, pf in zip("xyz", st["u_perf"])] + [
        ("p_gh", int(pf[2])) for pf in st["p_perf"]], prestore=(1,))
    tout, t_its = run_port(tpfs, d, STEPS, "gdia")
    return tout, jout, t_its, j_its


def test_potential_free_surface_matches_jax(sloshing_runs):
    """potentialFreeSurfaceFoam (waveSurfacePressure, the zeta update, 2
    PISO correctors) on gdia: U, p_gh and phi within 1e-8, zeta within
    1e-8 of its largest value, U and p_gh counts within one; zeta moved
    and stays under 0.05 m, |U| under 2 m/s (tests/test_phasechange.py:
    270-276)."""
    tout, jout, t_its, j_its = sloshing_runs
    _compare(tout, jout, ("U", "p_gh"), t_its, j_its)
    case, U, _, _, zeta = tout
    nb = case.mesh.n_boundary
    assert rel(zeta.numpy(), np.asarray(jout[4])[:nb]) <= RTOL
    assert 1e-6 < float(zeta.abs().max()) < 0.05
    assert float(U.data.abs().max()) < 2.0


@pytest.fixture(scope="module")
def expansion_runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("expansion"))
    with captured():
        cavitating_expansion_case(d)
    jout, j_its = run_jax(jcav, d, STEPS, "gdia", lambda st: [
        ("p", int(pf[2])) for pf in st["p_perf"]], prestore=(1, 2, 3))
    tout, t_its = run_port(tcav, d, STEPS, "gdia")
    return tout, jout, t_its, j_its


def test_cavitating_foam_matches_jax(expansion_runs):
    """cavitatingFoam (the implicit rhoEqn, the compressible pEqn and the
    barotropic closure, 2 outer correctors) on gdia: p, U, rho and phi
    within 1e-8 (p at 3e5 Pa sets no looser rounding here), p counts
    within one; rho at or above rhoMin and alphav within [0, 1]
    (tests/test_phasechange.py:186-193)."""
    tout, jout, t_its, j_its = expansion_runs
    _compare(tout, jout, ("p", "U", "rho"), t_its, j_its)
    rho = tout[3].data
    assert float(rho.min()) >= 0.001 - 1e-12
    av = torch.clamp((rho - 830.0) / (2.5e-6 * 8000 - 830.0), 0.0, 1.0)
    assert float(av.min()) >= 0.0 and float(av.max()) <= 1.0


# -- the pieces, against the JAX functions ---------------------------------------

def test_read_phases_and_sigmas_match_jax(tank):
    """read_phases / read_sigmas against the JAX package's _read_phases /
    _read_sigmas on the tank's transportProperties."""
    jc = JCase(tank)
    tc = port_case(tank, "ell")
    names = [p[0] for p in jmp._read_phases(jc.transport_properties())]
    assert tmp.read_phases(tc.transport_properties()) == [
        (n, float(r), float(nu)) for n, r, nu in jmp._read_phases(
            jc.transport_properties())]
    assert tmp.read_sigmas(tc.transport_properties(), names) == \
        jmp._read_sigmas(jc.transport_properties(), names) == {
            (0, 1): 0.01, (0, 2): 0.07, (1, 2): 0.03}


@pytest.fixture(scope="module")
def box12(tmp_path_factory):
    """layout -> (JAX case, port MeshArrays, JAX alphas, port alphas) on
    the 12x12 three-phase tank, the alphas smoothed random fractions
    that sum to one."""
    d = str(tmp_path_factory.mktemp("box12"))
    with captured():
        stratified_tank_case(d, nx=12, ny=12)
    out = {}
    with jax_quiet():
        out["gdia"] = JCase(d, lattice=detect_lattice(read_polymesh(d),
                                                      full_box=True))
        with jax_switches(GDIA_AUTO="0", FORCE_RCM="1"):
            out["ell"] = JCase(d)
    res = {}
    for layout, jc in out.items():
        rng = np.random.default_rng(7)
        raw = rng.uniform(0.0, 1.0, (3, jc.mesh.n_cells)) ** 3
        frac = raw / raw.sum(0)
        with jax_quiet():
            ja = [jc.read_field(f"alpha{n}").replace(data=jnp.asarray(f))
                  .correct_boundary_conditions(jc.mesh)
                  for n, f in zip(("water", "oil", "air"), frac)]
        res[layout] = (jc, interop.mesh_arrays(jc.mesh, device=CPU,
                                               dtype=F64),
                       ja, [interop.vol_field(a, device=CPU, dtype=F64)
                            for a in ja])
    return res


@pytest.mark.parametrize("layout", ["gdia", "ell"])
def test_nhatf_matches_jax(box12, layout):
    """The pairwise normal flux nHatf (multiphaseinterfoam.py:117-126's
    closure, composed of the JAX operators) for phase pairs both ways, and
    the pairwise curvature on the real faces (:204-211), to 1e-12."""
    jc, tmesh, ja, ta = box12[layout]
    jmesh = jc.mesh
    with jax_quiet():
        for i, j in ((0, 1), (0, 2), (1, 2), (1, 0)):
            a, b = ja[i], ja[j]
            ga = jfvc.face_values(jmesh, jfvc.grad(jmesh, a))
            gb = jfvc.face_values(jmesh, jfvc.grad(jmesh, b))
            a_f, b_f = jfvc.face_values(jmesh, a), jfvc.face_values(jmesh, b)
            v = b_f[:, None] * ga - a_f[:, None] * gb
            nv = v / (jnp.linalg.norm(v, axis=-1) + jmp._DELTA_N)[:, None]
            jnhf = (nv * jmesh.Sf).sum(-1)
            kappa = -jfvc.surface_sum_faces(jmesh, jnhf) / jmesh.V
            own = jmesh.owner[:jmesh.n_internal]
            w = jmesh.weights
            jk = jnp.concatenate([
                w * kappa[own] + (1 - w) * kappa[jmesh.neighbour],
                kappa[jmesh.owner[jmesh.n_internal:]]])
            gf = [tfvc.face_values(tmesh, tfvc.grad(tmesh, x))
                  for x in (ta[i], ta[j])]
            tnhf, _, _ = tmp.nhatf(tmesh, ta[i], ta[j], *gf)
            live = np.asarray(jmesh.mag_sf) > 0
            assert rel(tnhf.numpy(), np.asarray(jnhf)) <= TOL
            tk = interface_curvature(tmesh, tnhf)
            assert rel(tk.numpy()[live], np.asarray(jk)[live]) <= TOL


@pytest.mark.parametrize("layout", ["gdia", "ell"])
@pytest.mark.parametrize("model", ["simple", "general"])
def test_drift_velocity_and_tau_dm_match_jax(box12, layout, model):
    """The drift velocity Udm (driftfluxfoam.py:101-107, both models) of a
    random dispersed fraction and div(tauDm) through fvc.div_tensor
    (:150-164; nine C = 1 contractions on gdia), to 1e-12."""
    jc, tmesh, ja, ta = box12[layout]
    jmesh = jc.mesh
    m = tdf.DriftModel.__new__(tdf.DriftModel)
    m.rhod, m.rhoc, m.model = 1996.0, 996.0, model
    m.v0, m.a, m.a1, m.residual_alpha = [0.01, -0.05, 0.0], 5.0, 0.1, 0.05
    a = 0.6 * np.asarray(ja[0].data)
    rho = a * m.rhod + (1.0 - a) * m.rhoc
    ad = np.maximum(a - m.residual_alpha, 0.0)
    mag = (np.exp(-m.a * ad) - np.exp(-m.a1 * ad)) if model == "general" \
        else 10.0 ** (-m.a * np.maximum(a, 0.0))
    judm = (m.rhoc / rho)[:, None] * np.asarray(m.v0)[None, :] * mag[:, None]
    ta0 = ta[0].replace(data=torch.as_tensor(a))
    tudm = m.udm(ta0.data, torch.as_tensor(rho))
    assert rel(tudm.numpy(), judm) <= TOL
    betad = a * m.rhod
    betac = np.maximum((1.0 - a) * m.rhoc, 1e-10)
    ucm = (betad / betac)[:, None] * judm
    tau = betad[:, None, None] * judm[:, :, None] * judm[:, None, :] \
        + betac[:, None, None] * ucm[:, :, None] * ucm[:, None, :]
    with jax_quiet():
        jtau = jfvc._extrapolated(jmesh, jnp.asarray(tau), ja[0].dims,
                                  "tauDm")
        jdiv = np.asarray(jfvc.div_tensor(jmesh, jtau).data)
    ttau = m.tau_dm(tmesh, ta0, torch.as_tensor(rho), ta[0].dims)
    assert rel(ttau.data.numpy(), tau) <= TOL
    calls = []
    plain = gdia_mac.shift_mac_cols_plain

    def counted(x, coeffs, offsets):
        calls.append(coeffs.shape[:2])
        return plain(x, coeffs, offsets)
    gdia_mac.shift_mac_cols_plain = counted
    try:
        tdiv = tfvc.div_tensor(tmesh, ttau)
    finally:
        gdia_mac.shift_mac_cols_plain = plain
    assert rel(tdiv.data.numpy(), jdiv) <= TOL
    assert calls == ([(5, 1)] * 9 if layout == "gdia" else [])


def test_barotropic_closure_matches_jax():
    """alphav_psi (cavitatingfoam.py:91-94) and the thermodynamic closure
    (:183-197) on densities across the liquid, the mixture and rhoMin, and
    pressures across the expansion, to 1e-12 (the JAX closures composed of
    jnp)."""
    bt = tcav.Barotropic.__new__(tcav.Barotropic)
    bt.psil, bt.rhol_sat, bt.psiv, bt.p_sat, bt.rho_min = (
        4.54e-7, 830.0, 2.5e-6, 8000.0, 0.001)
    bt.rhov_sat = bt.psiv * bt.p_sat
    bt.rhol0 = bt.rhol_sat - bt.p_sat * bt.psil
    rng = np.random.default_rng(3)
    rho = np.concatenate([rng.uniform(0.0, 840.0, 200), [0.0, 0.001, 830.0,
                                                         bt.rhov_sat]])
    p = rng.uniform(-1e3, 3e5, rho.size)

    def j_alphav_psi(r):
        av = jnp.clip((r - bt.rhol_sat) / (bt.rhov_sat - bt.rhol_sat),
                      0.0, 1.0)
        return av, av * bt.psiv + (1.0 - av) * bt.psil
    jav, jpsi = j_alphav_psi(jnp.asarray(rho))
    tav, tpsi = bt.alphav_psi(torch.as_tensor(rho))
    assert rel(tav.numpy(), jav) <= TOL and rel(tpsi.numpy(), jpsi) <= TOL
    jr = jnp.maximum(jpsi * p + (1.0 - jav) * bt.rhol0 + (
        (jav * bt.psiv + (1.0 - jav) * bt.psil) - jpsi) * bt.p_sat,
        bt.rho_min)
    jav2, jpsi2 = j_alphav_psi(jr)
    jp = (jr - (1.0 - jav2) * bt.rhol0 - (
        (jav2 * bt.psiv + (1.0 - jav2) * bt.psil) - jpsi2) * bt.p_sat) \
        / jpsi2
    tr, tav2, tpsi2, tp = bt.closure(torch.as_tensor(p), tav, tpsi)
    for x, y in ((tr, jr), (tav2, jav2), (tpsi2, jpsi2), (tp, jp)):
        assert rel(x.numpy(), np.asarray(y)) <= TOL
    assert float(tr.min()) >= bt.rho_min


def test_wave_surface_pressure_update_matches_jax(tmp_path):
    """One zeta update of waveSurfacePressure (potentialfreesurfacefoam.py:
    78-98) on the sloshing tank's free surface with a random flux, on
    gdia: zeta and the patch's p_gh = -g & zeta to 1e-12; the patch reads
    as waveSurfacePressure through the registry."""
    d = str(tmp_path / "slosh")
    with captured():
        sloshing_tank_case(d, nx=8, ny=4)
    case = port_case(d, "gdia")
    bcs = case.read_field("p_gh").bcs
    assert [type(bc) for bc in bcs].count(tpfs.WaveSurfacePressure) == 1
    with jax_quiet():
        jc = JCase(d, lattice=detect_lattice(read_polymesh(d),
                                             full_box=True))
    jmesh = jc.mesh
    mesh = interop.mesh_arrays(jmesh, device=CPU, dtype=F64)
    bcdata = tuple({"value": torch.zeros(p.size, dtype=F64)}
                   if p.name == "freeSurface" else {} for p in mesh.patches)
    p_gh = VolField(torch.zeros(mesh.n_cells, dtype=F64),
                    torch.zeros(mesh.n_boundary, dtype=F64), bcs,
                    DimensionSet.of(0, 2, -2), "p_gh", bcdata)
    rng = np.random.default_rng(11)
    phi = rng.standard_normal(jmesh.n_faces) * np.asarray(jmesh.mag_sf)
    g = np.array([0.0, -9.81, 0.0])
    dt = 3e-3
    zeta = np.zeros((jmesh.n_boundary, 3))
    patch = next(p for p in jmesh.patches if p.name == "freeSurface")
    sl = slice(patch.start, patch.start + patch.size)
    bsl = slice(patch.bstart, patch.bstart + patch.size)
    with jax_quiet():
        n = np.asarray(jmesh.patch_normals(patch))
        mag = np.asarray(jmesh.patch_mag_sf(patch))
    zeta[bsl] += (dt * phi[sl] / mag)[:, None] * n
    tp, tz = tpfs.update_zeta(
        mesh, p_gh, SurfaceField(torch.as_tensor(phi), p_gh.dims, "phi"),
        torch.zeros((mesh.n_boundary, 3), dtype=F64), dt,
        torch.as_tensor(g))
    assert rel(tz.numpy(), zeta) <= TOL
    assert rel(tp.bvalues.numpy()[bsl], -(zeta[bsl] * g).sum(-1)) <= TOL


# -- the dispatcher and the dynamic-mesh forms -------------------------------------

NEW_SOLVERS = ("multiphaseInterFoam", "driftFluxFoam",
               "potentialFreeSurfaceFoam", "cavitatingFoam")


def test_dispatcher_runs_the_multiphase_solvers(tmp_path):
    """The four new entries of `python -m rapidcfd_tpu_torch` (32 in
    all with the porous, basic and non-Newtonian mains), fp32 by default, no DyM name among them; potentialFreeSurfaceFoam
    and driftFluxFoam run through it with -gdiaBox -device cpu to their
    endTime."""
    from rapidcfd_tpu_torch import __main__ as cli
    from rapidcfd_tpu_torch import solver_dtype
    assert len(cli.SOLVERS) == 34
    for name in NEW_SOLVERS:
        assert name in cli.SOLVERS
        assert solver_dtype(name) == torch.float32
    assert not any("DyM" in name for name in cli.SOLVERS)
    a, b = str(tmp_path / "slosh"), str(tmp_path / "column")
    with captured():
        sloshing_tank_case(a, nx=8, ny=4, end_time=0.006)
        settling_column_case(b, nx=4, ny=8, end_time=0.1)
    for name, d, steps in (("potentialFreeSurfaceFoam", a, 3),
                           ("driftFluxFoam", b, 2)):
        with captured() as log:
            cli.main([name, "-case", d, "-gdiaBox", "-device", "cpu",
                      "-noWrite"])
        out = log.getvalue()
        assert "gdia: lattice" in out and out.rstrip().endswith("End")
        assert out.count("\nTime = ") == steps


@pytest.mark.parametrize("module", [tmp, tpfs, tcav],
                         ids=["multiphaseInterDyMFoam",
                              "potentialFreeSurfaceDyMFoam",
                              "cavitatingDyMFoam"])
def test_dym_forms_raise(tmp_path, module):
    """The dynamic-mesh forms of these solvers are not ported: run(dym=True)
    raises and names the dynamic mesh, before any case is read."""
    with pytest.raises(NotImplementedError, match="dynamic mesh"):
        module.run(str(tmp_path), device=CPU, dtype=F64, dym=True)
