"""The port's host mesh pipeline against the JAX package on pitzDaily x1:
case files, polyMesh read, detect_lattice, build_gdia_mesh_arrays (with
GdiaInfo, GaussPlanes and MeshMaps). Integers must match exactly; floats
to 1e-14 relative (both run the same numpy algorithms)."""

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapidcfd_tpu.mesh import mesharrays as jma
from rapidcfd_tpu.mesh import polymesh as jpm
from rapidcfd_tpu.utils import casegen as jcg
from rapidcfd_tpu.utils import unstructured as jun
from rapidcfd_tpu_torch.mesh import mesharrays as tma
from rapidcfd_tpu_torch.mesh import polymesh as tpm
from rapidcfd_tpu_torch.utils import casegen as tcg
from rapidcfd_tpu_torch.utils import unstructured as tun

_MESH_FIELDS = ("owner", "neighbour", "Sf", "mag_sf", "Cf", "C", "V",
                "weights", "delta_coeffs", "nonorth_delta_coeffs",
                "corr_vecs", "b_delta_coeffs", "b_nonorth_delta_coeffs",
                "V_assemble", "bnd_cells", "bnd_sel")


def _same(a, b, name=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    if np.issubdtype(a.dtype, np.integer) or a.dtype == bool:
        np.testing.assert_array_equal(a, b, err_msg=name)
    else:
        scale = max(np.abs(b).max(), 1e-300) if b.size else 1.0
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-14 * scale,
                                   err_msg=name)


@pytest.fixture(scope="module")
def case_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pitz1"))
    tcg.pitz_daily_ico_case(d, scale=1)
    return d


@pytest.fixture(scope="module")
def built(case_dir):
    jm = jpm.read_polymesh(case_dir)
    tm = tpm.read_polymesh(case_dir)
    jl = jun.detect_lattice(jm)
    tl = tun.detect_lattice(tm)
    jout = jma.build_gdia_mesh_arrays(jm, jl, dtype=jnp.float64)
    tout = tma.build_gdia_mesh_arrays(tm, tl, device=torch.device("cpu"),
                                      dtype=torch.float64)
    return dict(jm=jm, tm=tm, jl=jl, tl=tl, jout=jout, tout=tout)


def test_pitz_daily_case_files_match(tmp_path):
    """The port's casegen writes byte-identical pitzDaily case files."""
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    jcg.pitz_daily_case(a, scale=1, tight_tol=True)
    tcg.pitz_daily_case(b, scale=1, tight_tol=True)
    files = sorted(os.path.relpath(os.path.join(r, f), a)
                   for r, _, fs in os.walk(a) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(r, f), b)
                           for r, _, fs in os.walk(b) for f in fs)
    _, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
    assert not mismatch and not errors


def test_polymesh_read_matches(built):
    jm, tm = built["jm"], built["tm"]
    for name in ("points", "face_points", "face_offsets", "owner",
                 "neighbour"):
        _same(getattr(tm, name), getattr(jm, name), name)
    assert [(p.name, p.type, p.start_face, p.n_faces) for p in tm.patches] \
        == [(p.name, p.type, p.start_face, p.n_faces) for p in jm.patches]


def test_polymesh_write_round_trip(built, tmp_path):
    tpm.write_polymesh(built["tm"], str(tmp_path))
    back = jpm.read_polymesh(str(tmp_path))
    for name in ("points", "face_points", "face_offsets", "owner",
                 "neighbour"):
        _same(getattr(back, name), getattr(built["jm"], name), name)


def test_detect_lattice_matches(built):
    jl, tl = built["jl"], built["tl"]
    assert jl is not None and tl is not None
    assert set(jl) == set(tl)
    assert tl["shape"] == jl["shape"] == (1, 40, 112)
    for k in jl:
        if k != "shape":
            _same(tl[k], jl[k], k)
    assert int(tl["dead"].sum()) == 12 * 20


@pytest.mark.parametrize("name", _MESH_FIELDS)
def test_gdia_mesh_arrays_match(built, name):
    jmesh, tmesh = built["jout"][0], built["tout"][0]
    _same(getattr(tmesh, name), getattr(jmesh, name), name)


def test_gdia_mesh_metadata_match(built):
    jmesh, tmesh = built["jout"][0], built["tout"][0]
    assert (tmesh.n_cells, tmesh.n_faces, tmesh.n_internal) == \
        (jmesh.n_cells, jmesh.n_faces, jmesh.n_internal)
    assert [(p.name, p.type, p.start, p.size, p.bstart)
            for p in tmesh.patches] == \
        [(p.name, p.type, p.start, p.size, p.bstart) for p in jmesh.patches]


def test_gdia_info_matches(built):
    jg, tg = built["jout"][0].gdia, built["tout"][0].gdia
    assert tg.shape == jg.shape and tg.axes == jg.axes
    assert tg.sync_iters == jg.sync_iters and tg.steps == jg.steps
    for jm_, tm_ in zip(jg.ghost_prev, tg.ghost_prev):
        # the port stores an all-zero ghost mask as None
        _same(np.zeros(tg.n_lat) if tm_ is None else tm_, jm_, "ghost")
    for name in ("dead", "primary", "plane_mask"):
        _same(getattr(tg, name), getattr(jg, name), name)


def test_gauss_planes_match(built):
    jp, tp = built["jout"][0].gauss, built["tout"][0].gauss
    assert tp.offsets == jp.offsets == (-112, -1, 0, 1, 112)
    _same(tp.coeffs, jp.coeffs, "coeffs")
    for i in range(3):
        _same(tp.coeffs_i[i], jp.coeffs_i[i], f"coeffs_i[{i}]")


def test_mesh_maps_match(built):
    jmaps, tmaps = built["jout"][2], built["tout"][2]
    _same(tmaps.cell_perm, jmaps.cell_perm, "cell_perm")
    _same(tmaps.face_perm, jmaps.face_perm, "face_perm")
    _same(tmaps.cell_primary, jmaps.cell_primary, "cell_primary")
    rng = np.random.default_rng(3)
    dev = rng.standard_normal((tmaps.cell_perm.size, 3))
    _same(tmaps.cells_to_file(dev), jmaps.cells_to_file(dev), "to_file")
    assert tmaps.n_file_cells == built["tm"].n_cells


# ---------------------------------------------------------------------------
# a 3-D lattice with merged cells (ghost slots): the JAX package's own gdia
# test mesh (tests/test_gdia.py); K = 7 shift-MAC offsets
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ghosted(tmp_path_factory):
    from rapidcfd_tpu.utils.unstructured import unstructured_box
    lat = {}
    m = unstructured_box(10, 6, 5, size=(1.0, 0.6, 0.5), perturb=0.1,
                         merge_fraction=0.08, seed=2, lattice_out=lat,
                         patch_spec={
                             "xmin": ("inlet", "patch"),
                             "xmax": ("outlet", "patch"),
                             "ymin": ("walls", "wall"),
                             "ymax": ("walls", "wall"),
                             "zmin": ("walls", "wall"),
                             "zmax": ("walls", "wall")})
    d = str(tmp_path_factory.mktemp("ghosted"))
    jpm.write_polymesh(m, d)     # both packages build from the same file
    jmesh = jma.build_gdia_mesh_arrays(jpm.read_polymesh(d), lat,
                                       dtype=jnp.float64)[0]
    tmesh = tma.build_gdia_mesh_arrays(tpm.read_polymesh(d), lat,
                                       device=torch.device("cpu"),
                                       dtype=torch.float64)[0]
    assert any(g is not None for g in tmesh.gdia.ghost_prev)
    return jmesh, tmesh


def test_ghosted_lattice_build_matches(ghosted):
    jmesh, tmesh = ghosted
    for name in _MESH_FIELDS:
        _same(getattr(tmesh, name), getattr(jmesh, name), name)
    jg, tg = jmesh.gdia, tmesh.gdia
    assert tg.shape == jg.shape and tg.steps == jg.steps
    for jm_, tm_ in zip(jg.ghost_prev, tg.ghost_prev):
        _same(np.zeros(tg.n_lat) if tm_ is None else tm_, jm_, "ghost")
    assert tmesh.gauss.offsets == jmesh.gauss.offsets
    assert len(tmesh.gauss.offsets) == 7
    _same(tmesh.gauss.coeffs, jmesh.gauss.coeffs, "coeffs")


def _gdia_op(op, gd, mesh, a):
    g = mesh.gdia
    if op == "sync":
        return gd.sync(g, a["x3"])
    if op == "fold":
        return gd.fold(g, a["x3"])
    if op == "face_own_nei":
        return gd.face_own_nei(g, a["x"])[1]
    if op == "surface_sum_signed":
        return gd.surface_sum_internal(g, a["f"], True)
    if op == "surface_sum_unsigned":
        return gd.surface_sum_internal(g, a["f"], False)
    if op == "neg_sum_diag":
        return gd.neg_sum_diag(g, a["lower"], a["upper"])
    if op == "offdiag_mv":
        return gd.offdiag_mv(g, a["lower"], a["upper"])(a["x3"])
    if op == "internal_flux":
        return gd.internal_flux(g, a["x"], a["lower"], a["upper"])
    if op == "sync_last":
        return gd.sync_last(g, a["x3"].T)
    if op == "fold_last":
        return gd.fold_last(g, a["x3"].T)
    if op == "gauss_mac3":
        return gd.gauss_mac3(g, mesh.gauss, gd.sync(g, a["x"]))
    if op.startswith("gauss_mac1_"):
        return gd.gauss_mac1(g, mesh.gauss, int(op[-1]), gd.sync(g, a["x"]))
    if op == "flux_mac":
        return gd.flux_mac(g, mesh.Sf, mesh.weights, gd.sync(g, a["x3"]))
    if op == "fold_diag":
        return gd.fold_diag(g, a["x"])
    raise KeyError(op)


@pytest.mark.parametrize("op", [
    "sync", "fold", "face_own_nei", "surface_sum_signed",
    "surface_sum_unsigned", "neg_sum_diag", "offdiag_mv", "internal_flux",
    "sync_last", "fold_last", "gauss_mac3", "gauss_mac1_0", "gauss_mac1_1",
    "gauss_mac1_2", "flux_mac", "fold_diag"])
def test_ghosted_gdia_ops_match(ghosted, op):
    """Every mesh/gdia.py operator, on random inputs over the ghosted
    lattice, against JAX at 1e-14 relative (fp64)."""
    from rapidcfd_tpu.mesh import gdia as jgd
    from rapidcfd_tpu_torch.mesh import gdia as tgd
    jmesh, tmesh = ghosted
    n = tmesh.gdia.n_lat
    nf = len(tmesh.gdia.steps) * n
    rng = np.random.default_rng(7)
    arrs = dict(x=rng.standard_normal(n), x3=rng.standard_normal((n, 3)),
                f=rng.standard_normal(nf), lower=rng.standard_normal(nf),
                upper=rng.standard_normal(nf))
    j = _gdia_op(op, jgd, jmesh, {k: jnp.asarray(v) for k, v in arrs.items()})
    t = _gdia_op(op, tgd, tmesh, {k: torch.from_numpy(v)
                                  for k, v in arrs.items()})
    _same(t, j, op)
