"""The port's polyhedral channel slice against the JAX package: simpleFoam
with kOmegaSST, wall functions and the corrected laplacian on the
perturbed merged-cell channel of bench_unstructured.py (perturb 0.12,
merge fraction 0.04, seed 3), in both of its layouts:

- "channel": 16x10x10 on the merged-cell 3-D gdia lattice (ghost slots,
  K = 7 Gauss planes; the JAX package takes its XLA path on the CPU);
- "duct": 16x8x8 bent by 1.2 rad and graded 4:1, which detect_lattice
  rejects, on the renumbered padded ELL (K = 10, two faces between some
  cell pairs).

Inputs come from numpy seeds and go through both packages (fp64):

- the generator gives integer-identical PolyMesh arrays and lattice
  embeddings for two seeds, with curve/grade and without;
- the mesh builds agree to 1e-12 relative (corr_vecs and the
  non-orthogonal delta coefficients in the gdia face layout included);
- wall_distance, fvm.laplacian(..., "corrected") of a scalar and a
  vector (diag, upper, source, and the boundary coefficients at the
  scale of their patch's internal ones), the p system of simple_step
  and one GAMG V-cycle (the structured one on the 3-D ghost-slot
  lattice, pair agglomeration on the duct) on that p system and on the
  shifted laplacian, to 1e-12 relative;
- one KOmegaSST.correct from a common state: k, omega and nut to 1e-10
  relative, equal iteration counts; its wall fix to 1e-12, the cells with
  two or more wall faces (the channel's edges, merged cells) checked on
  their own;
- 3 SIMPLE iterations: U, p, phi, k, omega and nut to 1e-8 relative to
  their largest magnitude (SURVEY §4), iteration counts within one per
  solve.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapidcfd_tpu.linalg import gamg as jgamg
from rapidcfd_tpu.linalg import solvers as jsolvers
from rapidcfd_tpu.models import turbulence as jturbulence
from rapidcfd_tpu.models.transport import \
    SinglePhaseTransportModel as JTransport
from rapidcfd_tpu.ops import fvc as jfvc
from rapidcfd_tpu.ops import fvm as jfvm
from rapidcfd_tpu.solvers import simplefoam as jsimple
from rapidcfd_tpu.solvers.case import Case as JCase
from rapidcfd_tpu.solvers.controls import SimpleControl as JSimpleControl
from rapidcfd_tpu.utils import unstructured as junstr
from rapidcfd_tpu_torch import interop
from rapidcfd_tpu_torch.fields.field import Dimensioned as TDimensioned
from rapidcfd_tpu_torch.linalg import gamg as tgamg
from rapidcfd_tpu_torch.linalg import solvers as tsolvers
from rapidcfd_tpu_torch.linalg import structured_mg as tsmg
from rapidcfd_tpu_torch.models import turbulence as tturbulence
from rapidcfd_tpu_torch.models.transport import SinglePhaseTransportModel
from rapidcfd_tpu_torch.ops import fvc, fvm
from rapidcfd_tpu_torch.solvers import simplefoam as tsimple
from rapidcfd_tpu_torch.solvers.case import Case
from rapidcfd_tpu_torch.solvers.controls import SimpleControl
from rapidcfd_tpu_torch.utils import unstructured as tunstr
from rapidcfd_tpu_torch.utils.dimensions import DimensionSet
from rapidcfd_tpu_torch.utils.logging import captured

CPU = torch.device("cpu")
F64 = torch.float64
FIELD_TOL = 1e-8
OP_TOL = 1e-12
_FIELDS = ["U", "p", "phi", "k", "omega", "nut"]
_BENCH = dict(perturb=0.12, merge_fraction=0.04, seed=3, write_mesh=False)
_LAYOUTS = {"channel": dict(nx=16, ny=10, nz=10),
            "duct": dict(nx=16, ny=8, nz=8, curve=1.2, grade=4.0)}


def _close(port, ref, name="", tol=OP_TOL, scale=None):
    """max|port - ref| <= tol * scale; scale defaults to max|ref|."""
    a = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port)
    b = np.asarray(ref)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    if scale is None:
        scale = max(np.abs(b).max(), 1e-300) if b.size else 1.0
    assert np.abs(a - b).max() <= tol * scale, (name, np.abs(a - b).max(),
                                                scale)


@pytest.mark.parametrize("variant", [{}, dict(curve=1.2, grade=4.0)],
                         ids=["lattice", "curved"])
@pytest.mark.parametrize("seed", [0, 7])
def test_generator_matches_jax(seed, variant):
    """unstructured_box with the channel's patches: points, faces,
    owner, neighbour, patches and the lattice embedding."""
    kw = dict(nx=8, ny=6, nz=5, size=(4.0, 1.0, 1.0), perturb=0.12,
              merge_fraction=0.04, seed=seed, **variant,
              patch_spec={"xmin": ("inlet", "patch"),
                          "xmax": ("outlet", "patch"),
                          "ymin": ("walls", "wall"),
                          "ymax": ("walls", "wall"),
                          "zmin": ("walls", "wall"),
                          "zmax": ("walls", "wall")})
    jl, tl = {}, {}
    jm = junstr.unstructured_box(lattice_out=jl, **kw)
    tm = tunstr.unstructured_box(lattice_out=tl, **kw)
    for a in ("points", "face_points", "face_offsets", "owner",
              "neighbour"):
        x, y = getattr(jm, a), getattr(tm, a)
        assert x.dtype == y.dtype and np.array_equal(x, y), a
    assert [(p.name, p.type, p.start_face, p.n_faces) for p in jm.patches] \
        == [(p.name, p.type, p.start_face, p.n_faces) for p in tm.patches]
    assert tm.n_cells < 8 * 6 * 5          # cells were merged
    assert sorted(jl) == sorted(tl)
    for k in jl:
        assert np.array_equal(np.asarray(jl[k]), np.asarray(tl[k])), k
    assert (tunstr.detect_lattice(tm) is None) \
        == (junstr.detect_lattice(jm) is None)


@pytest.fixture(scope="module", params=list(_LAYOUTS))
def runs(request):
    """The case in both packages, and 3 SIMPLE iterations of each,
    keeping the states after iterations 1 and 3."""
    layout = request.param
    d = tempfile.mkdtemp(prefix=f"rcfd_{layout}_")
    gdia = layout == "channel"
    jlat, tlat = ({}, {}) if gdia else (None, None)
    kw = dict(_LAYOUTS[layout], **_BENCH)
    jpm = junstr.unstructured_channel_case(d, lattice_out=jlat, **kw)
    tpm = tunstr.unstructured_channel_case(d, lattice_out=tlat, **kw)
    jcase = JCase(d, pmesh=jpm, lattice=jlat)
    U, p = jcase.read_field("U"), jcase.read_field("p")
    phi = jfvc.flux(jcase.mesh, U)
    jtransport = JTransport(jcase.transport_properties())
    jturb = jturbulence.make_ras_model(jcase, U)
    ts = jturb.init_state(U)
    step = jsimple.make_step(jcase, jtransport, jturb, JSimpleControl(jcase))
    jout, jits = [], []
    for _ in range(3):
        U, p, phi, ts, stats = step(U, p, phi, ts)
        jout.append(dict(U=U, p=p, phi=phi, **ts))
        jits += tsimple.iteration_counts(stats)

    with captured():
        case = Case(d, device=CPU, dtype=F64, pmesh=tpm, lattice=tlat)
        tU, tp = case.read_field("U"), case.read_field("p")
        tphi = fvc.flux(case.mesh, tU)
        turb = tturbulence.make_ras_model(case, tU)
        tts = turb.init_state(tU)
        tstep = tsimple.make_step(
            case, SinglePhaseTransportModel(case.transport_properties()),
            turb, SimpleControl(case))
        tout, tits = [], []
        for _ in range(3):
            tU, tp, tphi, tts, stats = tstep(tU, tp, tphi, tts)
            tout.append(dict(U=tU, p=tp, phi=tphi, **tts))
            tits += tsimple.iteration_counts(stats)
    return dict(layout=layout, dir=d, jcase=jcase, jturb=jturb,
                jnu=jtransport.nu(jcase.mesh, None), jout=jout, jits=jits,
                case=case, turb=turb, tout=tout, tits=tits)


def test_layout_and_model(runs):
    case = runs["case"]
    assert isinstance(runs["turb"], tturbulence.KOmegaSST)
    assert case.laplacian_scheme() == "corrected"
    assert SimpleControl(case).n_non_orth == 1
    if runs["layout"] == "channel":
        assert case.mesh.gdia is not None and len(case.mesh.gauss.offsets) \
            == 7
    else:
        assert case.mesh.gdia is None and case.mesh.K > 6
    for key in ("wall_distance", "gdia" if runs["layout"] == "channel"
                else "rcm"):
        assert key in case.setup_seconds


def test_mesh_build_matches_jax(runs):
    """The port's own build of the mesh against the JAX package's: the
    geometry, the non-orthogonal correction vectors and delta
    coefficients in the same face layout, the ELL tables or the gdia
    ghost and dead masks and the Gauss planes."""
    tm, jm = runs["case"].mesh, runs["jcase"].mesh
    assert (tm.n_cells, tm.n_faces, tm.n_internal) \
        == (jm.n_cells, jm.n_faces, jm.n_internal)
    for name in ("owner", "neighbour", "Sf", "mag_sf", "Cf", "C", "V",
                 "weights", "delta_coeffs", "nonorth_delta_coeffs",
                 "corr_vecs", "b_delta_coeffs", "b_nonorth_delta_coeffs"):
        _close(getattr(tm, name), getattr(jm, name), name)
    assert np.abs(np.asarray(jm.corr_vecs)).max() > 1e-3     # non-orthogonal
    if jm.gdia is None:
        for name in ("cell_faces", "cell_sign", "cell_nbr", "ell_coeff_idx"):
            _close(getattr(tm, name), getattr(jm, name), name)
        # duplicate cell-pair adjacencies stay two faces
        own = tm.owner[:tm.n_internal].numpy()
        pairs = own * tm.n_cells + tm.neighbour.numpy()
        assert np.unique(pairs).size < pairs.size
        return
    tg, jg = tm.gdia, jm.gdia
    assert tuple(tg.shape) == tuple(jg.shape) and tg.shape[0] > 1
    _close(tg.primary, jg.primary, "primary")
    _close(tg.dead, jg.dead, "dead")
    _close(tg.plane_mask, jg.plane_mask, "plane_mask")
    assert all(m is not None for m in tg.ghost_prev)
    for a, b in zip(tg.ghost_prev, jg.ghost_prev):
        _close(a, b, "ghost_prev")
    assert tuple(tm.gauss.offsets) == tuple(jm.gauss.offsets)
    _close(tm.gauss.coeffs, jm.gauss.coeffs, "gauss planes")
    _close(tm.V_asm, jm.V_assemble, "V_assemble")


def test_wall_distance_matches_jax(runs):
    y = tturbulence.wall_distance(runs["case"])
    _close(y, jturbulence.wall_distance(runs["jcase"]), "y")
    _close(runs["turb"].y, runs["jturb"].y, "model y")
    assert float(y.min()) > 0.0


@jax.jit
def _jax_laplacian(mesh, gamma, vf):
    return jfvm.laplacian(mesh, gamma, vf, "corrected")


@pytest.fixture(scope="module")
def lap(runs):
    """fvm.laplacian(gamma, psi, "corrected") in both packages on the JAX
    mesh, for a scalar (p) and a vector (U) with random cell values
    (file order, so ghost slots mirror their primary) and a random
    positive gamma."""
    jcase = runs["jcase"]
    jmesh, maps = jcase.mesh, jcase.maps
    tmesh = interop.mesh_arrays(jmesh, device=CPU, dtype=F64)
    rng = np.random.default_rng(55)
    nf = jcase.pmesh.n_cells
    out = {}
    for name, shape in (("p", ()), ("U", (3,))):
        jf = jcase.read_field(name)
        data = maps.cells_to_device(rng.standard_normal((nf,) + shape))
        jf = jf.replace(data=jnp.asarray(data)).correct_boundary_conditions(
            jmesh)
        gamma = maps.cells_to_device(rng.uniform(0.5, 2.0, nf))
        jg = jcase.read_field("p")
        jg = jg.replace(data=jnp.asarray(gamma)).correct_boundary_conditions(
            jmesh)
        jm = _jax_laplacian(jmesh, jg, jf)
        tm = fvm.laplacian(tmesh, interop.vol_field(jg, device=CPU,
                                                    dtype=F64),
                           interop.vol_field(jf, device=CPU, dtype=F64),
                           "corrected")
        out[name] = (jm, tm)
    return dict(jmesh=jmesh, tmesh=tmesh, **out)


@pytest.mark.parametrize("name", ["p", "U"], ids=["scalar", "vector"])
def test_corrected_laplacian_matches_jax(lap, name):
    jm, tm = lap[name]
    for part in ("diag", "upper", "lower", "source"):
        _close(getattr(tm, part), getattr(jm, part), part)
    # a patch's boundary coefficients against the scale of its internal
    # ones (gamma_f |Sf| deltaCoeffs): on the walls, where U is fixed at
    # zero, they are zero up to the JAX program's rounding
    for ai, bi, ab, bb in zip(tm.internal_coeffs, jm.internal_coeffs,
                              tm.boundary_coeffs, jm.boundary_coeffs):
        _close(ai, bi, "internal_coeffs")
        _close(ab, bb, "boundary_coeffs", scale=max(
            np.abs(np.asarray(bi)).max(initial=0.0),
            np.abs(np.asarray(bb)).max(initial=0.0), 1e-300))
    # the correction is really there: the source of an orthogonal
    # laplacian is zero
    assert np.abs(np.asarray(jm.source)).max() > 0.0
    for cmpt in ([None] if name == "p" else range(3)):
        jd, js = jm.component_system(lap["jmesh"], cmpt)
        td, ts = tm.component_system(lap["tmesh"], cmpt)
        _close(td, jd, f"folded diag {cmpt}")
        _close(ts, js, f"folded source {cmpt}")


_VCYCLE = dict(solver="GAMG", smoother="GaussSeidel", n_coarsest_cells=50,
               n_pre_sweeps=1, n_post_sweeps=1, n_finest_sweeps=1)


@pytest.fixture(scope="module")
def vcycle(runs):
    """(port matrix, JAX matrix, b) -> the output of one linear GAMG
    V-cycle from zero (V(1,1), coarse correction scaled by 2, levels down
    to 50 cells) in both packages on the case's mesh: on the channel the
    structured V-cycle of the 3-D merged-cell lattice (16x10x10 -> 8x5x5
    -> 4x3x3, dense), on the duct pair agglomeration. The JAX V-cycle is
    compiled once for every matrix of the layout."""
    jmesh = runs["jcase"].mesh
    tmesh = interop.mesh_arrays(jmesh, device=CPU, dtype=F64)

    @jax.jit
    def jvc(m, b):
        d, _ = m.component_system(jmesh, None)
        return jgamg.make_vcycle(
            jmesh, m, jsolvers._amul_fn(jmesh, m, d), d,
            jsolvers.SolverControls(**_VCYCLE), False, 2.0)(
                jnp.zeros_like(b), b)

    def run(tm, jm, b):
        td, _ = tm.component_system(tmesh, None)
        tvc = tgamg.make_vcycle(tmesh, tm, tsolvers._amul_fn(tmesh, tm, td),
                                td, tsolvers.SolverControls(**_VCYCLE),
                                False, 2.0)
        b = torch.from_numpy(b)
        # the matrix's units are static in the JAX pytree: one unit keeps
        # one compiled V-cycle for every matrix
        return tvc(torch.zeros_like(b), b), jvc(jm.replace(dims=jm.psi.dims),
                                                jnp.asarray(b.numpy()))
    if runs["layout"] == "channel":
        assert tsmg.structured_info(tmesh) == (10, 10, 16)
    else:
        assert len(tgamg.build_hierarchy(tmesh, 50)) > 1
    return run


def test_gamg_vcycle_matches_jax(lap, runs, vcycle):
    """One V-cycle on the corrected laplacian with its diagonal shifted
    by -1, to 1e-12 relative, its output on primary slots only. The shift
    is needed because this laplacian is singular: its gamma is a copy of
    the p field, so on the outlet it carries p's fixed value 0, the
    outlet's coefficients vanish and no row pins the level (every row
    sums to zero). Unshifted, both packages' V-cycles return values ~1e14
    that agree to no digit. The p system the solver builds is regular and
    is compared unshifted in test_gamg_vcycle_on_p_system_matches_jax."""
    jm, tm = lap["p"]
    jm, tm = jm.replace(diag=jm.diag - 1.0), tm.replace(diag=tm.diag - 1.0)
    jmesh = lap["jmesh"]
    b = np.random.default_rng(31).standard_normal(jmesh.n_cells)
    tx, jx = vcycle(tm, jm, b)
    _close(tx, jx, "vcycle")
    if runs["layout"] == "channel":
        ghost = ~np.asarray(jmesh.gdia.primary, bool)
        assert ghost.any() and (tx.numpy()[ghost] == 0).all()


@pytest.fixture(scope="module")
def carried(runs):
    """The JAX state after one iteration, in both packages, with the
    port's kOmegaSST of the port's case (its wall distance carried from
    the JAX model)."""
    j = runs["jout"][0]
    jnu = runs["jnu"]
    turb = runs["turb"]
    jmesh = runs["jcase"].mesh
    jstate = {k: j[k] for k in ("k", "omega", "nut")}
    tmesh = interop.mesh_arrays(jmesh, device=CPU, dtype=F64)
    turb.y = interop.wall_distance(runs["jturb"], device=CPU, dtype=F64)
    return dict(
        jmesh=jmesh, jstate=jstate, jU=j["U"], jphi=j["phi"], jnu=jnu,
        tmesh=tmesh, tstate=interop.turb_state(jstate, device=CPU,
                                               dtype=F64),
        tU=interop.vol_field(j["U"], device=CPU, dtype=F64),
        tphi=interop.surface_field(j["phi"], device=CPU, dtype=F64),
        tnu=TDimensioned("nu", DimensionSet(*jnu.dims.as_tuple()),
                         float(jnu.value)))


@pytest.fixture(scope="module")
def p_system(runs, carried):
    """The p system of the second SIMPLE iteration (from the JAX state
    after the first) as simple_step builds it, in both packages on the
    JAX mesh: rAU = 1/A of the relaxed momentum matrix (its boundary
    values extrapolated from the cells), laplacian(rAU, p, corrected)
    with p's own boundary conditions and set_reference."""
    c = carried
    jcase, jturb, turb = runs["jcase"], runs["jturb"], runs["turb"]
    kw = jsimple.step_kwargs_from_case(
        jcase, JSimpleControl(jcase),
        JTransport(jcase.transport_properties()), jturb)

    @jax.jit
    def jsys(mesh, U, p, phi, st):
        UEqn = jfvm.div(mesh, phi, U, kw["div_u"]) + jsimple.div_dev_reff(
            mesh, jturb.nu_eff(mesh, st, c["jnu"]), U, kw["lap_corr"])
        rAU = 1.0 / UEqn.relax(mesh, kw["u_relax"]).A(mesh)
        return jfvm.laplacian(mesh, rAU, p, kw["lap_corr"]).set_reference(
            kw["p_ref_cell"], kw["p_ref_value"])

    jp = runs["jout"][0]["p"]
    jm = jsys(c["jmesh"], c["jU"], jp, c["jphi"], c["jstate"])
    tmesh, tU = c["tmesh"], c["tU"]
    UEqn = fvm.div(tmesh, c["tphi"], tU, kw["div_u"]) + tsimple.div_dev_reff(
        tmesh, turb.nu_eff(tmesh, c["tstate"], c["tnu"]), tU, kw["lap_corr"])
    rAU = 1.0 / UEqn.relax(tmesh, kw["u_relax"]).A(tmesh)
    tm = fvm.laplacian(tmesh, rAU, interop.vol_field(jp, device=CPU,
                                                     dtype=F64),
                       kw["lap_corr"]).set_reference(kw["p_ref_cell"],
                                                     kw["p_ref_value"])
    return jm, tm


def test_gamg_vcycle_on_p_system_matches_jax(runs, carried, p_system,
                                            vcycle):
    """The solver's own p system, unshifted: its coefficients and its
    folded diagonal, and one V-cycle on it (levels down to 50 cells, where
    the shifted case's laplacian is singular), to 1e-12 relative. rAU's
    boundary values and the outlet's fixed value keep every level regular:
    the V-cycle's output stays at the scale of b/diag."""
    jm, tm = p_system
    jmesh, tmesh = carried["jmesh"], carried["tmesh"]
    for part in ("diag", "upper", "lower"):
        _close(getattr(tm, part), getattr(jm, part), part)
    jd, _ = jm.component_system(jmesh, None)
    td, _ = tm.component_system(tmesh, None)
    _close(td, jd, "folded diag")
    live = np.ones(tmesh.n_cells, bool) if jmesh.gdia is None \
        else np.asarray(jmesh.gdia.primary, bool)
    b = np.random.default_rng(32).standard_normal(tmesh.n_cells) * live
    tx, jx = vcycle(tm, jm, b)
    _close(tx, jx, "vcycle")
    scale = np.abs(b).max() / np.abs(np.asarray(jd)[live]).min()
    assert 0.0 < np.abs(np.asarray(jx)).max() < 1e3 * scale


def test_komegasst_correct_matches_jax(runs, carried):
    c = carried
    jst, jperf = jax.jit(lambda mesh, st, U, phi: runs["jturb"].correct(
        mesh, st, U, phi, c["jnu"]))(c["jmesh"], c["jstate"], c["jU"],
                                     c["jphi"])
    with captured():
        tst, tperf = runs["turb"].correct(c["tmesh"], c["tstate"], c["tU"],
                                          c["tphi"], c["tnu"])
    for k in ("k", "omega", "nut"):
        for part in ("data", "bvalues"):
            _close(getattr(tst[k], part), getattr(jst[k], part), (k, part),
                   tol=1e-10)
    for k in ("k", "omega"):
        assert int(tperf[k][2]) == int(jperf[k][2]) > 0


def test_wall_fix_matches_jax(runs, carried):
    """G, the fix mask and the wall omega; the cells with two or more
    faces on the walls patch (the channel's four x-edges, merged cells)
    take the values of their last face, as the JAX package's CPU
    scatter writes them."""
    c = carried
    tmesh = c["tmesh"]
    walls = [p for p in tmesh.patches if p.name == "walls"][0]
    cells = tmesh.patch_face_cells(walls).numpy()
    uniq, count = np.unique(cells, return_counts=True)
    multi = uniq[count >= 2]
    assert multi.size >= 4 * (_LAYOUTS[runs["layout"]]["nx"] - 2)
    G = np.random.default_rng(7).uniform(0.0, 1.0, tmesh.n_cells)
    jout = runs["jturb"]._wall_fix(c["jmesh"], c["jstate"], c["jU"],
                                   c["jnu"], jnp.asarray(G))
    tout = runs["turb"]._wall_fix(tmesh, c["tstate"], c["tU"], c["tnu"],
                                  torch.from_numpy(G))
    for a, b, name in zip(tout, jout, ("G", "fix", "omega")):
        _close(a, b, name)
        _close(a[torch.from_numpy(multi)], np.asarray(b)[multi],
               f"{name} at cells with several wall faces")
    assert (tout[1].numpy()[multi] == 1.0).all()
    # the last face of each such cell is the one that wrote
    last = {int(cl): pos for pos, cl in enumerate(cells)}
    y = 1.0 / tmesh.patch_delta_coeffs(walls)
    k_c = torch.clamp(c["tstate"]["k"].data[torch.from_numpy(cells)], min=0)
    om_vis = 6.0 * c["tnu"].value / (tturbulence.KOmegaSST.beta1 * y * y)
    om_log = torch.sqrt(k_c) / (0.09 ** 0.25 * 0.41 * y)
    om_w = torch.sqrt(om_vis ** 2 + om_log ** 2).numpy()
    for cl in multi:
        assert tout[2][cl].item() == om_w[last[int(cl)]]


def _rel_err(runs, n, name):
    case, jcase = runs["case"], runs["jcase"]
    a = runs["tout"][n - 1][name].data.numpy()
    b = np.asarray(runs["jout"][n - 1][name].data)
    if name == "phi":
        # both in device orientation (the port's file orientation is
        # checked against it in test_phi_file_orientation)
        nf = case.maps.n_file_faces
        a, b = case.maps.faces_to_file(a), jcase.maps.faces_to_file(b)[:nf]
    else:
        a, b = case.maps.cells_to_file(a), jcase.maps.cells_to_file(b)
    assert np.isfinite(a).all()
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("name", _FIELDS)
def test_three_iterations_match_jax(runs, name):
    assert _rel_err(runs, 1, name) <= FIELD_TOL
    assert _rel_err(runs, 3, name) <= FIELD_TOL


def test_three_iteration_counts_match_jax(runs):
    tits, jits = runs["tits"], runs["jits"]
    assert [f for f, _ in tits] == [f for f, _ in jits]
    assert [f for f, _ in tits[:7]] \
        == ["Ux", "Uy", "Uz", "p", "p", "k", "omega"]   # 2 p: 1 corrector
    assert all(abs(t - j) <= 1 for (_, t), (_, j) in zip(tits, jits))


def test_phi_file_orientation(runs):
    """faces_to_file(flux=True) gives phi in the orientation the mesh was
    written in: the device orientation times the face sign."""
    maps = runs["case"].maps
    phi = runs["tout"][2]["phi"].data.numpy()
    a = maps.faces_to_file(phi, flux=True)
    b = maps.faces_to_file(phi) * maps.faces_to_file(maps.face_sign)
    _close(a, b, "phi", tol=0.0)
