"""The port's padded-ELL mesh build and GAMG hierarchy against the JAX
package: build_mesh_arrays (reverse Cuthill-McKee, geometry, ELL,
boundary fold, MeshMaps) on the 20x20 cavity, a 3-D 8x8x2 cavity and
pitzDaily x1 taken off the lattice path, and the 64x64 cavity's
agglomeration levels. The JAX package builds these with RCFD_FORCE_RCM=1
(its default sends a structured box to the structured layout, which the
port does not have) and RCFD_GDIA_AUTO=0. Both run the same numpy
algorithms: integers must match exactly, floats to 1e-14 relative."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapidcfd_tpu.linalg import gamg as jgamg
from rapidcfd_tpu.mesh import mesharrays as jma
from rapidcfd_tpu.mesh import polymesh as jpm
from rapidcfd_tpu.solvers.case import Case as JCase
from rapidcfd_tpu.utils import logging as jlog
from rapidcfd_tpu.utils import switches
from rapidcfd_tpu_torch.linalg import gamg as tgamg
from rapidcfd_tpu_torch.mesh import mesharrays as tma
from rapidcfd_tpu_torch.mesh import polymesh as tpm
from rapidcfd_tpu_torch.solvers.case import Case as TCase
from rapidcfd_tpu_torch.utils import casegen as tcg
from rapidcfd_tpu_torch.utils import logging as tlog

CPU = torch.device("cpu")
F64 = torch.float64
_ELL_FIELDS = ("owner", "neighbour", "Sf", "mag_sf", "Cf", "C", "V",
               "weights", "delta_coeffs", "nonorth_delta_coeffs",
               "corr_vecs", "b_delta_coeffs", "b_nonorth_delta_coeffs",
               "cell_faces", "cell_sign", "cell_nbr", "ell_coeff_idx",
               "internal_mask", "bnd_cells", "bnd_sel")


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
def quiet():
    """Silence both packages' solver logs."""
    old = jlog.Info.enabled, tlog.Info.enabled
    jlog.Info.enabled = tlog.Info.enabled = False
    try:
        yield
    finally:
        jlog.Info.enabled, tlog.Info.enabled = old


def _same(a, b, name=""):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    if np.issubdtype(b.dtype, np.integer) or b.dtype == bool:
        np.testing.assert_array_equal(a, b, err_msg=name)
    else:
        scale = max(np.abs(b).max(), 1e-300) if b.size else 1.0
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-14 * scale,
                                   err_msg=name)


def _built_pair(tmp_path_factory, name):
    """(JAX (mesh, maps), port (mesh, maps)) for one test mesh."""
    d = str(tmp_path_factory.mktemp(name))
    if name == "pitz1":
        tcg.pitz_daily_ico_case(d, scale=1)
        with quiet(), jax_switches(GDIA_AUTO="0", FORCE_RCM="1"):
            jc = JCase(d, dtype=jnp.float64)
            tc = TCase(d, device=CPU, dtype=F64, gdia_auto=False)
        return (jc.mesh, jc.maps), (tc.mesh, tc.maps)
    if name == "cavity20":
        tcg.cavity_case(d, n=20)
    else:
        tcg.cavity_case(d, n=8, nz=2)
    with jax_switches(FORCE_RCM="1"):
        jout = jma.build_mesh_arrays(jpm.read_polymesh(d),
                                     dtype=jnp.float64)
    tout = tma.build_mesh_arrays(tpm.read_polymesh(d), device=CPU,
                                 dtype=F64)
    return (jout[0], jout[2]), (tout[0], tout[2])


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    return {name: _built_pair(tmp_path_factory, name)
            for name in ("cavity20", "cavity3d", "pitz1")}


_MESHES = ("cavity20", "cavity3d", "pitz1")


@pytest.mark.parametrize("name", _ELL_FIELDS)
@pytest.mark.parametrize("mesh", _MESHES)
def test_ell_mesh_arrays_match(built, mesh, name):
    (jmesh, _), (tmesh, _) = built[mesh]
    assert tmesh.gdia is None and jmesh.structured is None
    _same(getattr(tmesh, name), getattr(jmesh, name), name)


@pytest.mark.parametrize("mesh", _MESHES)
def test_ell_mesh_metadata_and_maps_match(built, mesh):
    (jmesh, jmaps), (tmesh, tmaps) = built[mesh]
    assert (tmesh.n_cells, tmesh.n_faces, tmesh.n_internal, tmesh.K) == \
        (jmesh.n_cells, jmesh.n_faces, jmesh.n_internal, jmesh.K)
    assert [(p.name, p.type, p.start, p.size, p.bstart)
            for p in tmesh.patches] == \
        [(p.name, p.type, p.start, p.size, p.bstart) for p in jmesh.patches]
    _same(tmaps.cell_perm, jmaps.cell_perm, "cell_perm")
    _same(tmaps.face_perm, jmaps.face_perm, "face_perm")
    # the renumbering really moved cells, and flipped some faces
    assert (tmaps.cell_perm != np.arange(tmesh.n_cells)).any()
    assert (tmaps.face_sign < 0).any()


@pytest.mark.parametrize("mesh", _MESHES)
def test_boundary_fold_matches_scatter(built, mesh):
    """add_at_boundary_cells (per-cell sums, one add per cell) against a
    plain numpy scatter-add over every non-empty patch face."""
    _, (tmesh, _) = built[mesh]
    rng = np.random.default_rng(11)
    data = rng.standard_normal((tmesh.n_cells, 3))
    bvals = rng.standard_normal((tmesh.n_boundary, 3))
    ref = data.copy()
    own = tmesh.owner.numpy()
    for p in tmesh.patches:
        if not p.is_empty:
            np.add.at(ref, own[p.start:p.start + p.size],
                      bvals[p.bstart:p.bstart + p.size])
    out = tmesh.add_at_boundary_cells(torch.from_numpy(data),
                                      torch.from_numpy(bvals))
    _same(out, ref, "fold")


# ---------------------------------------------------------------------------
# GAMG hierarchy: the 64x64 cavity, mergeLevels 1, 32 coarsest cells
# ---------------------------------------------------------------------------

_LEVEL_FIELDS = ("restrict_addr", "face_coarse", "face_flip", "face_cell",
                 "cell_nbr", "ell_idx", "coarse_owner", "coarse_neighbour",
                 "children", "face_children", "face_child_flip",
                 "int_faces")


@pytest.fixture(scope="module")
def hierarchies(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cavity64"))
    tcg.cavity_case(d, n=64)
    with jax_switches(FORCE_RCM="1"):
        jmesh = jma.build_mesh_arrays(jpm.read_polymesh(d),
                                      dtype=jnp.float64)[0]
    tmesh = tma.build_mesh_arrays(tpm.read_polymesh(d), device=CPU,
                                  dtype=F64)[0]
    jl = jgamg.build_hierarchy(jmesh, n_coarsest=32, merge_levels=1)
    tl = tgamg.build_hierarchy(tmesh, n_coarsest=32, merge_levels=1)
    return jl, tl


def test_gamg_hierarchy_sizes_match(hierarchies):
    jl, tl = hierarchies
    assert len(tl) == len(jl) >= 5
    for j, t in zip(jl, tl):
        assert (t.n_coarse, t.n_coarse_faces, t.n_fine, t.n_fine_faces) \
            == (j.n_coarse, j.n_coarse_faces, j.n_fine, j.n_fine_faces)
    assert tl[-1].n_coarse <= 32


@pytest.mark.parametrize("name", _LEVEL_FIELDS)
def test_gamg_level_arrays_match(hierarchies, name):
    jl, tl = hierarchies
    for i, (j, t) in enumerate(zip(jl, tl)):
        _same(getattr(t, name), getattr(j, name), f"level {i} {name}")
