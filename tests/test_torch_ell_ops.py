"""The port's padded-ELL operators and solvers against the JAX package on
random fields over the 20x20 cavity (renumbered; the JAX mesh is built
with RCFD_FORCE_RCM=1 and carried into the port through interop): fvc,
fvm, FvMatrix.A/H/flux, one GAMG V-cycle, and a smoothSolver and a
GAMG-preconditioned PCG solve. Inputs are made with numpy from a seed.
Tolerance: 1e-12 relative to the largest magnitude (fp64; the two
packages sum in different orders); iteration counts must be equal."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rapidcfd_tpu.fields  # noqa: F401  (populates the BC registry)
from rapidcfd_tpu.fields import io as jio
from rapidcfd_tpu.fields.field import Dimensioned as JDimensioned
from rapidcfd_tpu.linalg import gamg as jgamg
from rapidcfd_tpu.linalg import solvers as jsolvers
from rapidcfd_tpu.mesh import mesharrays as jma
from rapidcfd_tpu.mesh import polymesh as jpm
from rapidcfd_tpu.ops import fvc as jfvc
from rapidcfd_tpu.ops import fvm as jfvm
from rapidcfd_tpu.utils import switches
from rapidcfd_tpu.utils.dimensions import DimensionSet as JDims
from rapidcfd_tpu_torch import interop
from rapidcfd_tpu_torch.fields.field import Dimensioned as TDimensioned
from rapidcfd_tpu_torch.linalg import gamg as tgamg
from rapidcfd_tpu_torch.linalg import solvers as tsolvers
from rapidcfd_tpu_torch.ops import fvc as tfvc
from rapidcfd_tpu_torch.ops import fvm as tfvm
from rapidcfd_tpu_torch.utils.casegen import cavity_case
from rapidcfd_tpu_torch.utils.dimensions import DimensionSet as TDims

CPU = torch.device("cpu")
F64 = torch.float64
TOL = 1e-12
_NU = (0, 2, -1)
_TIME = (0, 0, 1)


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


def _close(port, ref, name="", tol=TOL):
    a = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port)
    b = np.asarray(ref)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    scale = max(np.abs(b).max(), 1e-300) if b.size else 1.0
    err = np.abs(a - b).max() if b.size else 0.0
    assert err <= tol * scale, (name, err, scale)


def _close_field(port, ref, name=""):
    _close(port.data, ref.data, name + ".data")
    _close(port.bvalues, ref.bvalues, name + ".bvalues")


def _close_matrix(port, ref, name=""):
    for k in ("diag", "lower", "upper", "source"):
        _close(getattr(port, k), getattr(ref, k), f"{name}.{k}")
    for k in ("internal_coeffs", "boundary_coeffs"):
        for i, (a, b) in enumerate(zip(getattr(port, k), getattr(ref, k))):
            _close(a, b, f"{name}.{k}[{i}]")


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cavity20ops"))
    cavity_case(d, n=20)
    with jax_switches(FORCE_RCM="1"):
        jmesh, _, jmaps = jma.build_mesh_arrays(jpm.read_polymesh(d),
                                                dtype=jnp.float64)
    rng = np.random.default_rng(2025)
    n = jmesh.n_cells
    jp = jio.read_vol_field(d, "0", "p", jmesh, jmaps, dtype=jnp.float64)
    jU = jio.read_vol_field(d, "0", "U", jmesh, jmaps, dtype=jnp.float64)
    jp = jp.replace(data=jnp.asarray(rng.standard_normal(n))) \
        .correct_boundary_conditions(jmesh)
    U0 = rng.standard_normal((n, 3))
    U0[:, 2] = 0.0
    jU = jU.replace(data=jnp.asarray(U0)).correct_boundary_conditions(jmesh)
    jU = jU.store_old().replace(
        data=jnp.asarray(U0 + 0.1 * rng.standard_normal((n, 3))))
    jU = jU.correct_boundary_conditions(jmesh)
    jphi = jfvc.flux(jmesh, jU)
    return dict(jmesh=jmesh,
                tmesh=interop.mesh_arrays(jmesh, device=CPU, dtype=F64),
                jp=jp, jU=jU, jphi=jphi,
                tp=interop.vol_field(jp, device=CPU, dtype=F64),
                tU=interop.vol_field(jU, device=CPU, dtype=F64),
                tphi=interop.surface_field(jphi, device=CPU, dtype=F64),
                jnu=JDimensioned("nu", JDims.of(*_NU), 1e-2),
                tnu=TDimensioned("nu", TDims.of(*_NU), 1e-2))


def _mod(k, jmod, tmod):
    return jmod if k == "j" else tmod


_FVC = {
    "grad_scalar": lambda m, e, k: _mod(k, jfvc, tfvc).grad(m, e[k + "p"]),
    "grad_vector": lambda m, e, k: _mod(k, jfvc, tfvc).grad(m, e[k + "U"]),
    "div_phi": lambda m, e, k: _mod(k, jfvc, tfvc).div(m, e[k + "phi"]),
    "div_phi_U": lambda m, e, k: _mod(k, jfvc, tfvc).div(
        m, e[k + "phi"], e[k + "U"], "linear"),
    "surface_integrate": lambda m, e, k: _mod(
        k, jfvc, tfvc).surface_integrate(m, e[k + "phi"]),
}


@pytest.mark.parametrize("op", sorted(_FVC))
def test_ell_fvc_field_ops_match(env, op):
    j = _FVC[op](env["jmesh"], env, "j")
    t = _FVC[op](env["tmesh"], env, "t")
    _close_field(t, j, op)


def test_ell_fvc_flux_and_sn_grad_match(env):
    _close(tfvc.flux(env["tmesh"], env["tU"]).data, env["jphi"].data,
           "flux")
    _close(tfvc.sn_grad(env["tmesh"], env["tp"]).data,
           jfvc.sn_grad(env["jmesh"], env["jp"]).data, "snGrad")


def test_ell_fvc_surface_sum_unsigned_matches(env):
    t = tfvc.surface_sum_faces(env["tmesh"], env["tphi"].data.abs(),
                               signed=False)
    j = jfvc.surface_sum_faces(env["jmesh"], jnp.abs(env["jphi"].data),
                               signed=False)
    _close(t, j, "surfaceSum")


def _assemble(env, k, which):
    fvm = _mod(k, jfvm, tfvm)
    mesh = env[k + "mesh"]
    if which == "ddt":
        return fvm.ddt(mesh, env[k + "U"], 1e-3)
    if which == "div_linear":
        return fvm.div(mesh, env[k + "phi"], env[k + "U"], "linear")
    if which == "div_upwind":
        return fvm.div(mesh, env[k + "phi"], env[k + "U"], "upwind")
    if which == "laplacian_nu":
        return fvm.laplacian(mesh, env[k + "nu"], env[k + "U"],
                             "orthogonal")
    if which == "laplacian_field":
        p = env[k + "p"]        # gamma: random, positive, an rAU (time)
        gamma = p.replace(data=p.data ** 2 + 1.0,
                          bvalues=p.bvalues ** 2 + 1.0,
                          dims=_mod(k, JDims, TDims).of(*_TIME))
        return fvm.laplacian(mesh, gamma, env[k + "p"], "orthogonal")
    if which == "ddt_steady":
        return fvm.ddt(mesh, env[k + "U"], 1.0, "steadyState")
    if which == "div_bounded":
        return fvm.div(mesh, env[k + "phi"], env[k + "U"],
                       ("bounded", "upwind"))
    if which in ("Sp", "SuSp"):           # coefficient of mixed sign
        return getattr(fvm, which)(mesh, env[k + "p"], env[k + "U"])
    if which == "Su":                     # a source of U's rank
        return fvm.Su(mesh, env[k + "U"], env[k + "U"])
    raise KeyError(which)


@pytest.mark.parametrize("which", ["ddt", "ddt_steady", "div_linear",
                                   "div_upwind", "div_bounded",
                                   "laplacian_nu", "laplacian_field", "Sp",
                                   "Su", "SuSp"])
def test_ell_fvm_coefficients_match(env, which):
    _close_matrix(_assemble(env, "t", which), _assemble(env, "j", which),
                  which)


def _ueqn(env, k):
    return (_assemble(env, k, "ddt") + _assemble(env, k, "div_linear")
            - _assemble(env, k, "laplacian_nu"))


@pytest.mark.parametrize("query", ["A", "H"])
def test_ell_fvmatrix_queries_match(env, query):
    jm = _ueqn(env, "j")
    t = getattr(_ueqn(env, "t"), query)(env["tmesh"])
    _close_field(t, getattr(jm, query)(env["jmesh"]), query)


def test_ell_fvmatrix_flux_matches(env):
    j = _assemble(env, "j", "laplacian_field")
    t = interop.fv_matrix(j, device=CPU, dtype=F64)
    _close(t.flux(env["tmesh"]).data, j.flux(env["jmesh"]).data, "flux")


def _relaxable(env, k, rank):
    """div(phi, psi) - laplacian(nu, psi), upwind, psi = U or p."""
    fvm = _mod(k, jfvm, tfvm)
    vf = env[k + ("U" if rank else "p")]
    return fvm.div(env[k + "mesh"], env[k + "phi"], vf, "upwind") \
        - fvm.laplacian(env[k + "mesh"], env[k + "nu"], vf, "orthogonal")


@pytest.mark.parametrize("rank", [0, 1], ids=["scalar", "vector"])
def test_ell_relax_matches(env, rank):
    t = _relaxable(env, "t", rank).relax(env["tmesh"], 0.7)
    j = _relaxable(env, "j", rank).relax(env["jmesh"], 0.7)
    _close_matrix(t, j, "relaxed")


def test_ell_set_values_matches(env):
    rng = np.random.default_rng(78)
    n = env["tmesh"].n_cells
    mask = (rng.uniform(size=n) < 0.05).astype(float)
    vals = rng.standard_normal(n)
    t = _relaxable(env, "t", 0).set_values(
        env["tmesh"], torch.from_numpy(mask), torch.from_numpy(vals))
    j = _relaxable(env, "j", 0).set_values(
        env["jmesh"], jnp.asarray(mask), jnp.asarray(vals))
    _close_matrix(t, j, "setValues")


def test_ell_adjust_phi_matches(env):
    """Every cavity patch fixes U: nothing is adjustable, phi stays."""
    t = tfvc.adjust_phi(env["tmesh"], env["tphi"], env["tU"])
    _close(t.data, jfvc.adjust_phi(env["jmesh"], env["jphi"],
                                   env["jU"]).data, "adjustPhi")
    assert t is env["tphi"]


def test_ell_div_dev_t_grad_chain_matches(env):
    """The generic chain of divDevReff's explicit part on ELL meshes:
    div_tensor(dev_transpose_grad(U) * nuEff)."""
    def chain(k):
        fvc = _mod(k, jfvc, tfvc)
        mesh, p = env[k + "mesh"], env[k + "p"]
        nu = p.replace(data=p.data ** 2 + 1e-3,
                       bvalues=p.bvalues ** 2 + 1e-3,
                       dims=_mod(k, JDims, TDims).of(*_NU))
        devt = fvc.dev_transpose_grad(mesh, env[k + "U"])
        return devt, fvc.div_tensor(mesh, devt * nu)
    (tdev, tdiv), (jdev, jdiv) = chain("t"), chain("j")
    _close_field(tdev, jdev, "devT")
    _close_field(tdiv, jdiv, "div_tensor")


def _p_system(env):
    """The pinned pressure-like system (pure Neumann: p is zeroGradient
    everywhere) in both packages."""
    jm = (_assemble(env, "j", "laplacian_field")
          == jfvc.div(env["jmesh"], env["jphi"])).set_reference(0, 0.0)
    return jm, interop.fv_matrix(jm, device=CPU, dtype=F64)


_GAMG = dict(smoother="Chebyshev", n_coarsest_cells=32, merge_levels=1,
             n_pre_sweeps=1, n_post_sweeps=1, n_finest_sweeps=1)


def test_ell_gamg_vcycle_matches(env):
    """One linear V-cycle (Chebyshev, 4 levels down to 25 cells, dense
    coarsest inverse, coarse correction scaled by 2) on a random rhs."""
    jm, tm = _p_system(env)
    jd, _ = jm.component_system(env["jmesh"], None)
    td, _ = tm.component_system(env["tmesh"], None)
    b = np.random.default_rng(5).standard_normal(env["tmesh"].n_cells)
    jamul = jsolvers._amul_fn(env["jmesh"], jm, jd)
    tamul = tsolvers._amul_fn(env["tmesh"], tm, td)
    jvc = jgamg.make_vcycle(env["jmesh"], jm, jamul, jd,
                            jsolvers.SolverControls(**_GAMG), False, 2.0)
    tvc = tgamg.make_vcycle(env["tmesh"], tm, tamul, td,
                            tsolvers.SolverControls(**_GAMG), False, 2.0)
    assert len(tgamg.build_hierarchy(env["tmesh"], 32, merge_levels=1)) == 4
    jx = jax.jit(jvc)(jnp.zeros(b.size), jnp.asarray(b))
    tx = tvc(torch.zeros(b.size, dtype=F64), torch.from_numpy(b))
    _close(tx, jx, "vcycle")


_TO = dict(tolerance=1e-10, rel_tol=0.0)
# name -> (system, fvSolution controls, solution tolerance)
_SOLVES = {
    "U_smoothSolver": ("U", dict(solver="smoothSolver",
                                 smoother="symGaussSeidel", **_TO), 1e-10),
    "U_diagonal": ("U", dict(solver="diagonal"), TOL),
    "U_GAMG": ("U", dict(solver="GAMG", **_TO, **_GAMG), 1e-10),
    "U_PBiCGStab_none": ("U", dict(solver="PBiCGStab",
                                   preconditioner="none", **_TO), 1e-10),
    "U_PBiCGStab_diagonal": ("U", dict(solver="PBiCGStab",
                                       preconditioner="diagonal", **_TO),
                             1e-10),
    "p_diagonal": ("p", dict(solver="diagonal"), TOL),
    "p_PCG_GAMG": ("p", dict(solver="PCG", preconditioner="GAMG", **_TO,
                             **_GAMG), 1e-9),
    "p_GAMG": ("p", dict(solver="GAMG", **_TO, **_GAMG), 1e-9),
}


@pytest.mark.parametrize("what", sorted(_SOLVES))
def test_ell_solve_matches(env, what):
    """Every ported solver and preconditioner on the same system in both
    packages: smoothSolver (damped Jacobi), diagonal, PBiCGStab with the
    none and diagonal preconditioners, PCG with the GAMG preconditioner,
    and the GAMG solver (V-cycles with
    the line-search correction on the symmetric p, per component on the
    asymmetric U). Equal iteration counts, initial residuals to 1e-10,
    solutions to 1e-10 relative (U) and 1e-9 (p: this random-coefficient
    pure-Neumann system fixes its solution only to ~4e-10 relative at
    that residual; the JAX package's own DIC and GAMG solves of it differ
    by as much)."""
    system, ctl, tol = _SOLVES[what]
    if system == "U":
        jm = _ueqn(env, "j") == (-jfvc.grad(env["jmesh"], env["jp"]))
        tm = interop.fv_matrix(jm, device=CPU, dtype=F64)
    else:
        jm, tm = _p_system(env)
    jx, jperf = jsolvers.solve(env["jmesh"], jm,
                               jsolvers.SolverControls(**ctl))
    tx, tperf = tsolvers.solve(env["tmesh"], tm,
                               tsolvers.SolverControls(**ctl))
    _close(tx.data, jx.data, what, tol=tol)
    assert len(tperf) == len(jperf)
    for (j0, _, jit), (t0, _, tit) in zip(jperf, tperf):
        assert int(jit) == int(tit)
        assert (int(tit) == 0) == (ctl["solver"] == "diagonal")
        _close(t0, j0, "initial residual", tol=1e-10)
