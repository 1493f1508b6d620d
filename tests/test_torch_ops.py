"""The port's field IO, fvc/fvm operators, FvMatrix queries and Krylov
solves against the JAX package, on random fields over the pitzDaily x1
gdia mesh. Inputs are made with numpy from a seed and carried into the
port through rapidcfd_tpu_torch.interop. Tolerance: 1e-12 relative to
the largest magnitude (fp64; the two packages sum in different orders,
so results differ in the last bits)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rapidcfd_tpu.fields  # noqa: F401  (populates the BC registry)
from rapidcfd_tpu.fields import io as jio
from rapidcfd_tpu.fields.field import Dimensioned as JDimensioned
from rapidcfd_tpu.linalg import solvers as jsolvers
from rapidcfd_tpu.mesh import mesharrays as jma
from rapidcfd_tpu.mesh import polymesh as jpm
from rapidcfd_tpu.ops import fvc as jfvc
from rapidcfd_tpu.ops import fvm as jfvm
from rapidcfd_tpu.utils import unstructured as jun
from rapidcfd_tpu.utils.dimensions import DimensionSet
from rapidcfd_tpu_torch import interop
from rapidcfd_tpu_torch.fields import io as tio
from rapidcfd_tpu_torch.fields.field import Dimensioned as TDimensioned
from rapidcfd_tpu_torch.linalg import solvers as tsolvers
from rapidcfd_tpu_torch.mesh.mesharrays import build_gdia_mesh_arrays
from rapidcfd_tpu_torch.mesh.polymesh import read_polymesh
from rapidcfd_tpu_torch.ops import fvc as tfvc
from rapidcfd_tpu_torch.ops import fvm as tfvm
from rapidcfd_tpu_torch.utils.casegen import pitz_daily_ico_case
from rapidcfd_tpu_torch.utils.dimensions import DimensionSet as TDims
from rapidcfd_tpu_torch.utils.unstructured import detect_lattice

CPU = torch.device("cpu")
F64 = torch.float64
TOL = 1e-12
_NU_DIMS = DimensionSet.of(0, 2, -1)


def _port_build(case_dir):
    pm = read_polymesh(case_dir)
    return build_gdia_mesh_arrays(pm, detect_lattice(pm), device=CPU,
                                  dtype=F64)


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
    d = str(tmp_path_factory.mktemp("pitz1ops"))
    pitz_daily_ico_case(d, scale=1)
    pm = jpm.read_polymesh(d)
    jmesh, _, jmaps = jma.build_gdia_mesh_arrays(
        pm, jun.detect_lattice(pm), dtype=jnp.float64)
    rng = np.random.default_rng(2024)
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
    tmesh = interop.mesh_arrays(jmesh, device=CPU, dtype=F64)
    return dict(dir=d, jmesh=jmesh, jmaps=jmaps, tmesh=tmesh,
                tmaps=_port_build(d)[2], jp=jp, jU=jU, jphi=jphi,
                tp=interop.vol_field(jp, device=CPU, dtype=F64),
                tU=interop.vol_field(jU, device=CPU, dtype=F64),
                tphi=interop.surface_field(jphi, device=CPU, dtype=F64),
                jnu=JDimensioned("nu", _NU_DIMS, 1e-3),
                tnu=TDimensioned("nu", _NU_DIMS, 1e-3))


# ---------------------------------------------------------------------------
# field IO
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["p", "U"])
def test_read_vol_field_matches(env, name):
    tmesh, _, tmaps = _port_build(env["dir"])
    t = tio.read_vol_field(env["dir"], "0", name, tmesh, tmaps)
    j = jio.read_vol_field(env["dir"], "0", name, env["jmesh"],
                           env["jmaps"], dtype=jnp.float64)
    _close_field(t, j, name)
    assert [type(b).__name__ for b in t.bcs] == \
        [type(b).__name__ for b in j.bcs]
    for tb, jb in zip(t.bcdata, j.bcdata):
        assert set(tb) <= set(jb)
        for k in tb:
            _close(tb[k], jb[k], k)


@pytest.mark.parametrize("name", ["p", "U"])
def test_write_vol_field_matches_jax_file(env, tmp_path, name):
    a, b = tmp_path / "jax", tmp_path / "port"
    jio.write_vol_field(env["j" + name], str(a), "1", env["jmesh"],
                        env["jmaps"])
    tio.write_vol_field(env["t" + name], str(b), "1", env["tmesh"],
                        env["tmaps"])
    assert (a / "1" / name).read_text() == (b / "1" / name).read_text()


def test_surface_field_write_read_round_trip(env, tmp_path):
    tio.write_surface_field(env["tphi"], str(tmp_path), "1", env["tmesh"],
                            env["tmaps"], prec=17)
    back = tio.read_surface_field(str(tmp_path), "1", "phi", env["tmesh"],
                                  env["tmaps"])
    real = torch.as_tensor(env["tmaps"].face_perm < env["tmaps"].n_file_faces)
    _close(back.data[real], env["tphi"].data[real], "phi", tol=1e-15)
    assert (back.data[~real] == 0).all()
    assert os.path.isfile(tmp_path / "1" / "phi")


# ---------------------------------------------------------------------------
# fvc
# ---------------------------------------------------------------------------

_FVC = {
    "grad_scalar": (lambda m, e, k: (jfvc if k == "j" else tfvc).grad(
        m, e[k + "p"])),
    "grad_vector": (lambda m, e, k: (jfvc if k == "j" else tfvc).grad(
        m, e[k + "U"])),
    "div_phi": (lambda m, e, k: (jfvc if k == "j" else tfvc).div(
        m, e[k + "phi"])),
    "div_phi_U": (lambda m, e, k: (jfvc if k == "j" else tfvc).div(
        m, e[k + "phi"], e[k + "U"], "linear")),
    "surface_integrate": (lambda m, e, k: (
        jfvc if k == "j" else tfvc).surface_integrate(m, e[k + "phi"])),
}


@pytest.mark.parametrize("op", sorted(_FVC))
def test_fvc_field_ops_match(env, op):
    j = _FVC[op](env["jmesh"], env, "j")
    t = _FVC[op](env["tmesh"], env, "t")
    _close_field(t, j, op)


def test_fvc_flux_matches(env):
    t = tfvc.flux(env["tmesh"], env["tU"])
    _close(t.data, env["jphi"].data, "flux")


def test_fvc_sn_grad_matches(env):
    t = tfvc.sn_grad(env["tmesh"], env["tp"])
    j = jfvc.sn_grad(env["jmesh"], env["jp"])
    _close(t.data, j.data, "snGrad")


def test_fvc_surface_sum_unsigned_matches(env):
    t = tfvc.surface_sum_faces(env["tmesh"], env["tphi"].data.abs(),
                               signed=False)
    j = jfvc.surface_sum_faces(env["jmesh"], jnp.abs(env["jphi"].data),
                               signed=False)
    _close(t, j, "surfaceSum")


# ---------------------------------------------------------------------------
# fvm and FvMatrix
# ---------------------------------------------------------------------------

def _assemble(env, k, which):
    fvm = jfvm if k == "j" else tfvm
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
                          dims=DimensionSet.of(0, 0, 1))
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


_WHICH = ["ddt", "ddt_steady", "div_linear", "div_upwind", "div_bounded",
          "laplacian_nu", "laplacian_field", "Sp", "Su", "SuSp"]


@pytest.mark.parametrize("which", _WHICH)
def test_fvm_coefficients_match(env, which):
    _close_matrix(_assemble(env, "t", which), _assemble(env, "j", which),
                  which)


def _ueqn(env, k):
    return (_assemble(env, k, "ddt") + _assemble(env, k, "div_linear")
            - _assemble(env, k, "laplacian_nu"))


@pytest.mark.parametrize("query", ["A", "H"])
def test_fvmatrix_queries_match(env, query):
    j = getattr(_ueqn(env, "j"), query)(env["jmesh"])
    # the port's matrix comes through interop from the JAX assembly
    tm = interop.fv_matrix(_ueqn(env, "j"), device=CPU, dtype=F64)
    t = getattr(tm, query)(env["tmesh"])
    _close_field(t, j, query)


def test_fvmatrix_flux_matches(env):
    j = _assemble(env, "j", "laplacian_field")
    t = interop.fv_matrix(j, device=CPU, dtype=F64)
    _close(t.flux(env["tmesh"]).data, j.flux(env["jmesh"]).data, "flux")


@pytest.mark.parametrize("what", ["U", "p"])
def test_solve_matches(env, what):
    """PBiCGStab/DILU (column-batched U) and PCG/DIC (p) on the same
    system: solutions to 1e-10 relative and iteration counts within one
    (the frameworks sum reductions in different orders)."""
    if what == "U":
        jm = _ueqn(env, "j") == (-jfvc.grad(env["jmesh"], env["jp"]))
        ctl = dict(solver="PBiCGStab", preconditioner="DILU",
                   tolerance=1e-12, rel_tol=0.0)
    else:
        jm = _assemble(env, "j", "laplacian_field") \
            == jfvc.div(env["jmesh"], env["jphi"])
        ctl = dict(solver="PCG", preconditioner="DIC", tolerance=1e-10,
                   rel_tol=0.0)
    tm = interop.fv_matrix(jm, device=CPU, dtype=F64)
    jx, jperf = jsolvers.solve(env["jmesh"], jm,
                               jsolvers.SolverControls(**ctl))
    tx, tperf = tsolvers.solve(env["tmesh"], tm,
                               tsolvers.SolverControls(**ctl))
    _close_field(tx, jx, what)
    for (j0, j1, jit), (t0, t1, tit) in zip(jperf, tperf):
        assert abs(int(jit) - int(tit)) <= 1
        _close(t0, j0, "initial residual", tol=1e-10)


@pytest.mark.parametrize("ctl", [dict(solver="GAMG"),
                                 dict(solver="PCG", preconditioner="GAMG")],
                         ids=["GAMG", "PCG_GAMG"])
def test_gamg_on_gdia_runs(env, ctl):
    """GAMG on a gdia mesh cycles on the structured multigrid, wrapped in
    PCG (linalg/gamg.gamg_solve), and reaches the solution PCG/DIC
    reaches (tests/test_torch_structured_mg.py holds it against the JAX
    package's V-cycle and solve)."""
    jm = _assemble(env, "j", "laplacian_field") \
        == jfvc.div(env["jmesh"], env["jphi"])
    tm = interop.fv_matrix(jm, device=CPU, dtype=F64)
    c = dict(tolerance=1e-11, rel_tol=0.0, n_coarsest_cells=32)
    tx, tperf = tsolvers.solve(env["tmesh"], tm,
                               tsolvers.SolverControls(**c, **ctl))
    ref, rperf = tsolvers.solve(
        env["tmesh"], tm, tsolvers.SolverControls(**c, solver="PCG",
                                                  preconditioner="DIC"))
    _close(tx.data, ref.data, "p", tol=1e-8)
    assert 1 < int(tperf[0][2]) < int(rperf[0][2])


# ---------------------------------------------------------------------------
# the SIMPLE-slice operators: relax, setValues, adjustPhi, the explicit
# part of divDevReff
# ---------------------------------------------------------------------------

def _relaxable(env, rank):
    """div(phi, psi) - laplacian(nu, psi), upwind, psi = U or p."""
    vf = env["j" + ("U" if rank else "p")]
    return jfvm.div(env["jmesh"], env["jphi"], vf, "upwind") \
        - jfvm.laplacian(env["jmesh"], env["jnu"], vf, "orthogonal")


@pytest.mark.parametrize("rank", [0, 1], ids=["scalar", "vector"])
def test_relax_matches(env, rank):
    """fvMatrix::relax: dominance on the folded row, the change on the
    primary slot, the source compensated with psi."""
    j = _relaxable(env, rank)
    tm = interop.fv_matrix(j, device=CPU, dtype=F64)
    _close_matrix(tm.relax(env["tmesh"], 0.7), j.relax(env["jmesh"], 0.7),
                  "relaxed")
    assert tm.relax(env["tmesh"], 1.0) is tm


def test_set_values_matches(env):
    rng = np.random.default_rng(77)
    n = env["tmesh"].n_cells
    prim = np.asarray(env["jmesh"].gdia.primary)
    mask = (rng.uniform(size=n) < 0.05) * prim
    vals = rng.standard_normal(n)
    j = _relaxable(env, 0)
    t = interop.fv_matrix(j, device=CPU, dtype=F64).set_values(
        env["tmesh"], torch.from_numpy(mask), torch.from_numpy(vals))
    j = j.set_values(env["jmesh"], jnp.asarray(mask), jnp.asarray(vals))
    _close_matrix(t, j, "setValues")
    assert not t.symmetric


def test_adjust_phi_matches(env):
    """The outlet (zeroGradient U) takes the imbalance of a random flux."""
    t = tfvc.adjust_phi(env["tmesh"], env["tphi"], env["tU"])
    j = jfvc.adjust_phi(env["jmesh"], env["jphi"], env["jU"])
    _close(t.data, j.data, "adjustPhi")
    assert not torch.equal(t.data, env["tphi"].data)


def _nu_eff(env, k):
    """A positive random viscosity field (nuEff)."""
    p = env[k + "p"]
    dims = (DimensionSet if k == "j" else TDims).of(0, 2, -1)
    return p.replace(data=p.data ** 2 + 1e-3, bvalues=p.bvalues ** 2 + 1e-3,
                     dims=dims)


def test_dev_transpose_grad_matches(env):
    t = tfvc.dev_transpose_grad(env["tmesh"], env["tU"])
    _close_field(t, jfvc.dev_transpose_grad(env["jmesh"], env["jU"]), "devT")


@pytest.mark.parametrize("path", ["fused", "div_tensor"])
def test_div_dev_t_grad_matches(env, path):
    """div(nuEff*dev(T(grad U))): the fused gdia pipeline (3 shift-MAC
    calls with C = 3, 9 with C = 1) against the JAX package's, and
    against the chain div_tensor(dev_transpose_grad(U)*nuEff) of both."""
    j = jfvc.div_dev_t_grad(env["jmesh"], env["jU"], _nu_eff(env, "j"))
    tm, tU, tnu = env["tmesh"], env["tU"], _nu_eff(env, "t")
    if path == "fused":
        t = tfvc.div_dev_t_grad(tm, tU, tnu)
    else:
        t = tfvc.div_tensor(tm, tfvc.dev_transpose_grad(tm, tU) * tnu)
        jt = jfvc.div_tensor(env["jmesh"], jfvc.dev_transpose_grad(
            env["jmesh"], env["jU"]) * _nu_eff(env, "j"))
        _close_field(t, jt, "div_tensor")
    _close_field(t, j, path)
    assert t.dims.as_tuple() == j.dims.as_tuple()


def test_div_dev_t_grad_constant_nu_matches_chain(env):
    """A constant nuEff (the laminar model's nu): the fused pipeline
    against the port's own div_tensor chain (the JAX package's fused
    function takes fields only)."""
    tm, tU, nu = env["tmesh"], env["tU"], env["tnu"]
    nu = TDimensioned("nu", TDims.of(0, 2, -1), nu.value)
    _close_field(tfvc.div_dev_t_grad(tm, tU, nu),
                 tfvc.div_tensor(tm, tfvc.dev_transpose_grad(tm, tU) * nu),
                 "constant nu")


def test_set_reference_matches(env):
    """setReference (forced: p's outlet already fixes the level), the
    compatibility projection of the folded source, and the re-pin after
    the solve, against JAX."""
    jm = _assemble(env, "j", "laplacian_field") \
        == jfvc.div(env["jmesh"], env["jphi"])
    cell = int(np.nonzero(np.asarray(env["jmesh"].gdia.primary))[0][7])
    tm = interop.fv_matrix(jm, device=CPU, dtype=F64).set_reference(
        cell, 0.25, force=True)
    jm = jm.set_reference(cell, 0.25, force=True)
    _close_matrix(tm, jm, "pinned")
    jd, js = jm.component_system(env["jmesh"], None)
    td, ts = tm.component_system(env["tmesh"], None)
    _close(td, jd, "diag")
    _close(ts, js, "source")
    ctl = dict(solver="PCG", preconditioner="DIC", tolerance=1e-10,
               rel_tol=0.0)
    jx, _ = jsolvers.solve(env["jmesh"], jm, jsolvers.SolverControls(**ctl))
    tx, _ = tsolvers.solve(env["tmesh"], tm, tsolvers.SolverControls(**ctl))
    _close_field(tx, jx, "pinned solve")
    assert abs(float(tx.data[cell]) - 0.25) < 1e-12
