"""The port's structured geometric multigrid (linalg/structured_mg.py)
against the JAX package's: the grid operators on random planes (2-D and
3-D, odd and even sizes, so zero-padding is exercised), and one V-cycle
applied to the pressure system of the first SIMPLE iteration of
pitzDaily x1 (gdia lattice, fp64), in its preconditioner form (V(1,1),
coarse correction scaled by 2) and with the line-search scaling, to
1e-12 relative to the largest magnitude. Also GAMG on that system: the
Krylov-wrapped solve (PCG with the structured V-cycle) with the same
iteration count and the same solution to 1e-10. Inputs are made with
numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapidcfd_tpu.linalg import solvers as jsolvers
from rapidcfd_tpu.linalg import structured_mg as jsmg
from rapidcfd_tpu.models.transport import SinglePhaseTransportModel
from rapidcfd_tpu.models.turbulence import make_ras_model
from rapidcfd_tpu.ops import fvc as jfvc
from rapidcfd_tpu.ops import fvm as jfvm
from rapidcfd_tpu.solvers import simplefoam as jsimple
from rapidcfd_tpu.solvers.case import Case as JCase
from rapidcfd_tpu_torch import interop
from rapidcfd_tpu_torch.linalg import gamg as tgamg
from rapidcfd_tpu_torch.linalg import solvers as tsolvers
from rapidcfd_tpu_torch.linalg import structured_mg as tsmg
from rapidcfd_tpu_torch.utils.casegen import pitz_daily_case

CPU = torch.device("cpu")
F64 = torch.float64
TOL = 1e-12
# the p controls of pitz_daily_case, in the form PCG's GAMG
# preconditioner forces (V(1,1))
_CTL = dict(solver="GAMG", smoother="GaussSeidel", n_coarsest_cells=32,
            n_pre_sweeps=1, n_post_sweeps=1, n_finest_sweeps=1)


def _close(port, ref, name="", tol=TOL):
    a = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port)
    b = np.asarray(ref)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    scale = max(np.abs(b).max(), 1e-300)
    assert np.abs(a - b).max() <= tol * scale, (name, np.abs(a - b).max(),
                                                scale)


def _levels(shape, seed, rank=0):
    """The same random GridLevel in both packages: diag and the planes
    of every direction of extent > 1."""
    rng = np.random.default_rng(seed)
    nz, ny, nx = shape
    diag = rng.uniform(1.0, 2.0, shape + (3,) * rank)
    planes = {}
    for key, ext in ((1, nx), (nx, ny), (nx * ny, nz)):
        if ext > 1:
            planes[key] = -rng.uniform(0.0, 0.25, shape)
            planes[-key] = -rng.uniform(0.0, 0.25, shape)
    jl = jsmg.GridLevel(shape, jnp.asarray(diag),
                        {k: jnp.asarray(v) for k, v in planes.items()})
    tl = tsmg.GridLevel(shape, torch.from_numpy(diag),
                        {k: torch.from_numpy(v) for k, v in planes.items()})
    return jl, tl


_SHAPES = [(1, 6, 8), (1, 7, 9), (3, 5, 4), (5, 3, 7)]


@jax.jit
def _jax_level_ops(diag, planes, x, b, xc):
    """The JAX package's grid operators of one level, in one program."""
    lv = jsmg.GridLevel(x.shape, diag, planes)
    cdims = [ax for ax in range(3) if x.shape[ax] > 1]
    c = jsmg.coarsen(lv)
    return dict(amul=lv.amul(x), cdiag=c.diag, cplanes=c.planes,
                restrict=jsmg.restrict(lv, b, cdims),
                prolong=jsmg.prolong(lv, xc, cdims),
                chebyshev=jsmg._chebyshev_grid(lv, b, x, 3))


@pytest.mark.parametrize("shape", _SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_grid_operators_match(shape):
    """amul, coarsen (Galerkin planes and diagonal), restrict, prolong and
    the Chebyshev smoother of one level."""
    jl, tl = _levels(shape, 11)
    rng = np.random.default_rng(12)
    x = rng.standard_normal(shape)
    b = rng.standard_normal(shape)
    cdims = [ax for ax in range(3) if shape[ax] > 1]
    cshape = tuple((s + 1) // 2 if ax in cdims else s
                   for ax, s in enumerate(shape))
    xc = rng.standard_normal(cshape)
    j = _jax_level_ops(jl.diag, jl.planes, jnp.asarray(x), jnp.asarray(b),
                       jnp.asarray(xc))
    _close(tl.amul(torch.from_numpy(x)), j["amul"], "amul")
    tc = tsmg.coarsen(tl)
    assert tc.shape == cshape
    _close(tc.diag, j["cdiag"], "coarse diag")
    assert sorted(tc.planes) == sorted(j["cplanes"])
    for k in j["cplanes"]:
        _close(tc.planes[k], j["cplanes"][k], f"coarse plane {k}")
    _close(tsmg.restrict(tl, torch.from_numpy(b), cdims), j["restrict"],
           "restrict")
    _close(tsmg.prolong(tl, torch.from_numpy(xc), cdims), j["prolong"],
           "prolong")
    _close(tsmg._chebyshev_grid(tl, torch.from_numpy(b),
                                torch.from_numpy(x), 3), j["chebyshev"],
           "chebyshev")


def test_vector_level_operators_match():
    """A column-batched level (diag with a trailing component axis)."""
    jl, tl = _levels((1, 7, 6), 21, rank=1)
    x = np.random.default_rng(22).standard_normal((1, 7, 6, 3))
    _close(tl.amul(torch.from_numpy(x)), jl.amul(jnp.asarray(x)), "amul")
    jc, tc = jsmg.coarsen(jl), tsmg.coarsen(tl)
    _close(tc.diag, jc.diag, "coarse diag")


@pytest.mark.parametrize("shape", [(1, 5, 7), (2, 3, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_dense_indices_match(shape):
    jn, jpairs = jsmg._dense_indices(shape)
    tn, tpairs = tsmg._dense_indices(shape)
    assert tn == jn and sorted(tpairs) == sorted(jpairs)
    for key, (rows, cols) in jpairs.items():
        _, trows, tcols = tpairs[key]
        np.testing.assert_array_equal(trows, rows)
        np.testing.assert_array_equal(tcols, cols)


@pytest.fixture(scope="module")
def psys(tmp_path_factory):
    """The p system of the first SIMPLE iteration of pitzDaily x1, in the
    JAX package and carried into the port."""
    d = str(tmp_path_factory.mktemp("pitz1smg"))
    pitz_daily_case(d, scale=1, tight_tol=True)
    case = JCase(d)
    mesh = case.mesh
    U, p = case.read_field("U"), case.read_field("p")
    turb = make_ras_model(case, U)
    nu = SinglePhaseTransportModel(case.transport_properties()).nu(mesh, U)
    div_u = case.div_scheme("div(phi,U)")

    @jax.jit
    def p_system(mesh, U, p, state):
        phi = jfvc.flux(mesh, U)
        UEqn = jfvm.div(mesh, phi, U, div_u) \
            + jsimple.div_dev_reff(mesh, turb.nu_eff(mesh, state, nu), U,
                                   "orthogonal")
        UEqn = UEqn.relax(mesh, 0.7)
        rAU = 1.0 / UEqn.A(mesh)
        hbya = jfvc.constrain_hbya(mesh, rAU * UEqn.H(mesh), U)
        phi_h = jfvc.adjust_phi(mesh, jfvc.flux(mesh, hbya), U)
        return jfvm.laplacian(mesh, rAU, p, "orthogonal") \
            == jfvc.div(mesh, phi_h)
    jm = p_system(mesh, U, p, turb.init_state(U))
    tmesh = interop.mesh_arrays(mesh, device=CPU, dtype=F64)
    tm = interop.fv_matrix(jm, device=CPU, dtype=F64)
    jd, js = jm.component_system(mesh, None)
    td, ts = tm.component_system(tmesh, None)
    _close(td, jd, "diag")
    _close(ts, js, "source")
    return dict(jmesh=mesh, tmesh=tmesh, jm=jm, tm=tm, jd=jd, td=td)


def test_structured_info(psys):
    assert tsmg.structured_info(psys["tmesh"]) == (1, 40, 112) \
        == tuple(jsmg.structured_info(psys["jmesh"]))


@pytest.mark.parametrize("line_search", [False, True],
                         ids=["fixed_scale_2", "line_search"])
def test_vcycle_matches(psys, line_search):
    """One V-cycle on a random rhs (and a random start for the
    line-search form): levels 112x40 -> 56x20 -> 28x10 -> 14x5 -> 7x3
    (21 cells, the dense coarsest), output on primary slots only."""
    jm, tm, jd, td = psys["jm"], psys["tm"], psys["jd"], psys["td"]
    rng = np.random.default_rng(31)
    n = psys["tmesh"].n_cells
    b = rng.standard_normal(n)
    x0 = rng.standard_normal(n) if line_search else np.zeros(n)
    jamul = jsolvers._amul_fn(psys["jmesh"], jm, jd)
    tamul = tsolvers._amul_fn(psys["tmesh"], tm, td)
    scale = 1.0 if line_search else 2.0
    jvc = jsmg.make_structured_vcycle(
        psys["jmesh"], jm, jamul, jd, jsolvers.SolverControls(**_CTL),
        line_search, scale)
    tvc = tgamg.make_vcycle(psys["tmesh"], tm, tamul, td,
                            tsolvers.SolverControls(**_CTL), line_search,
                            scale)
    jx = jax.jit(jvc)(jnp.asarray(x0), jnp.asarray(b))
    tx = tvc(torch.from_numpy(x0), torch.from_numpy(b))
    _close(tx, jx, "vcycle")
    dead = ~np.asarray(psys["jmesh"].gdia.primary, bool)
    assert dead.any() and (tx.numpy()[dead] == 0).all()


@pytest.mark.parametrize("ctl", [dict(solver="GAMG"),
                                 dict(solver="PCG", preconditioner="GAMG")],
                         ids=["GAMG", "PCG_GAMG"])
def test_gamg_solve_matches(psys, ctl):
    """solver GAMG on a gdia mesh is PCG preconditioned by the structured
    V-cycle (the same iterations as PCG with preconditioner GAMG)."""
    c = dict(_CTL, tolerance=1e-10, rel_tol=0.0, **ctl)
    jx, jperf = jsolvers.solve(psys["jmesh"], psys["jm"],
                               jsolvers.SolverControls(**c))
    tx, tperf = tsolvers.solve(psys["tmesh"], psys["tm"],
                               tsolvers.SolverControls(**c))
    _close(tx.data, jx.data, "p", tol=1e-10)
    (j0, _, jit), = jperf
    (t0, _, tit), = tperf
    assert int(tit) == int(jit) > 1
    _close(t0, j0, "initial residual", tol=1e-10)
