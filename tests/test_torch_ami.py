"""The port's cyclicAMI and cyclicACMI coupling (mesh/ami.py,
mesh/mesharrays.py's AMI tables and ami_ghost, fields/bcs.py's
CyclicAMI/CyclicACMI, FvMatrix.coupled_mv and the coupled terms) against
the JAX package in fp64 on the CPU.

- The AMI tables of the 8:12 non-conforming channel, the ACMI channel
  (shift 0.5 and 0.25) and the kept jump pair: partner cells equal,
  weights, masks, delta coefficients and face weights to 1e-12, the ACMI
  area scale in the cell geometry (volumes, centres) to 1e-12.
- rotation_about_axis and the ghost values of a rotated table (a vector
  field from a numpy seed), and the ACMI ghost with its uncovered
  remainder, to 1e-12.
- The laplacian and upwind convection matrices on the AMI and ACMI
  channels: coefficients, A, H, H1, the flux and the matrix product with
  the coupled interface, to 1e-12.
- 5 steps against the JAX package's run(): laplacianFoam on the AMI and
  ACMI channels and scalarTransportFoam through the conformal cyclicAMI
  pair, fields to 1e-8, counts within one; the conformal AMI's run
  within 1e-8 of the merged cyclic's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapidcfd_tpu.linalg import solvers as jsolvers
from rapidcfd_tpu.mesh.ami import rotation_about_axis as jrot
from rapidcfd_tpu.ops import fvc as jfvc
from rapidcfd_tpu.ops import fvm as jfvm
from rapidcfd_tpu.solvers.case import Case as JCase
from rapidcfd_tpu_torch import interop
from rapidcfd_tpu_torch.linalg import solvers as tsolvers
from rapidcfd_tpu_torch.mesh.ami import rotation_about_axis
from rapidcfd_tpu_torch.ops import fvc as tfvc
from rapidcfd_tpu_torch.ops import fvm as tfvm
from rapidcfd_tpu_torch.utils import casegen
from rapidcfd_tpu_torch.utils.logging import captured
from torch_heat_reference import (CPU, F64, basic_pair, counts_close,
                                  jax_quiet, jax_switches, port_case, rel)

RUN_TOL = 1e-8
TOL = 1e-12
CASES = {
    "ami": lambda d: casegen.ami_channel_case(d),
    "acmi": lambda d: casegen.acmi_channel_case(d, shift_frac=0.5),
    "acmi_quarter": lambda d: casegen.acmi_channel_case(d, shift_frac=0.25),
    "jump": lambda d: casegen.jump_channel_case(d, "fixedJump"),
}


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """name -> (case dir, JAX Case, port Case) on the padded ELL."""
    out = {}
    for name, writer in CASES.items():
        d = str(tmp_path_factory.mktemp(name))
        with captured():
            writer(d)
        with jax_switches(GDIA_AUTO="0", FORCE_RCM="1"), jax_quiet(False):
            jcase = JCase(d)
        out[name] = (d, jcase, port_case(d, "ell"))
    return out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("name", list(CASES))
def test_ami_tables_match_jax(meshes, name):
    """Every AMI table and the mesh geometry the ACMI area scale feeds,
    against the JAX package's (rows of a cyclicAMI table sum to 1, those
    of a cyclicACMI table to the mask)."""
    _, jcase, tcase = meshes[name]
    jm, tm = jcase.mesh, tcase.mesh
    assert [p.name for p in tm.patches] == [p.name for p in jm.patches]
    assert len(tm.ami) == len(jm.ami)
    n_tabs = 0
    for j, t in zip(jm.ami, tm.ami):
        assert (j is None) == (t is None)
        if t is None:
            continue
        n_tabs += 1
        assert np.array_equal(_np(t.nbr_cells), np.asarray(j.nbr_cells))
        for k in ("w", "dc", "w_face", "mask", "rot"):
            a, b = getattr(t, k), getattr(j, k)
            assert (a is None) == (b is None), k
            if a is not None:
                assert np.abs(_np(a) - np.asarray(b)).max() <= TOL, k
        assert (t.owner, t.partner, t.non_overlap) \
            == (j.owner, j.partner, j.non_overlap)
        rows = _np(t.w).sum(1)
        want = _np(t.mask) if t.mask is not None else 1.0
        assert np.abs(rows - want).max() < 1e-5
    assert n_tabs == 2
    for k in ("Sf", "C", "V", "b_delta_coeffs", "owner", "cell_nbr"):
        assert np.abs(_np(getattr(tm, k)).astype(float)
                      - np.asarray(getattr(jm, k)).astype(float)
                      ).max() <= TOL, k


@pytest.mark.parametrize("axis,deg", [((0, 0, 1), 90.0), ((1, 2, 3), 37.5)])
def test_rotated_and_acmi_ghosts_match_jax(meshes, axis, deg):
    """rotation_about_axis as the JAX package builds it; the ghost values
    of a vector field through a table carrying that rotation, and the ACMI
    ghost with the uncovered remainder, as ami_ghost computes them."""
    R = rotation_about_axis(axis, np.deg2rad(deg))
    assert np.abs(R - jrot(axis, np.deg2rad(deg))).max() <= TOL
    assert np.abs(R @ R.T - np.eye(3)).max() <= TOL
    rng = np.random.default_rng(11)
    for name in ("ami", "acmi"):
        _, jcase, _ = meshes[name]
        jm = jcase.mesh
        jm = dataclasses.replace(jm, ami=tuple(
            None if t is None else dataclasses.replace(
                t, rot=jnp.asarray(R)) for t in jm.ami))
        tm = interop.mesh_arrays(jm, device=CPU, dtype=F64)
        u = rng.standard_normal((jm.n_cells, 3))
        s = rng.standard_normal(jm.n_cells)
        for p, t in zip(jm.patches, jm.ami):
            if t is None:
                continue
            tp = tm.patches[jm.patches.index(p)]
            for x in (u, s):
                a = tm.ami_ghost(tp, torch.tensor(x))
                b = jm.ami_ghost(p, jnp.asarray(x))
                assert np.abs(a.numpy() - np.asarray(b)).max() <= TOL
            if t.mask is not None:
                dflt = rng.standard_normal(p.size)
                a = tm.ami_ghost(tp, torch.tensor(s), torch.tensor(dflt))
                b = jm.ami_ghost(p, jnp.asarray(s), jnp.asarray(dflt))
                assert np.abs(a.numpy() - np.asarray(b)).max() <= TOL


@pytest.mark.parametrize("name", ["ami", "acmi", "jump"])
def test_coupled_matrix_terms_match_jax(meshes, name):
    """On the JAX mesh carried over by interop, T from a numpy seed: the
    laplacian (with the jump folded in) plus an upwind convection by a
    seeded flux, its coefficients, A, H, H1, the flux of the laplacian
    and the matrix product with the coupled interface, to 1e-12."""
    d, jcase, _ = meshes[name]
    jm = jcase.mesh
    tm = interop.mesh_arrays(jm, device=CPU, dtype=F64)
    rng = np.random.default_rng(5)
    jT = jcase.read_field("T", "0")
    jT = jT.replace(data=jnp.asarray(300.0 + rng.standard_normal(
        jm.n_cells))).correct_boundary_conditions(jm)
    tT = interop.vol_field(jT, device=CPU, dtype=F64)
    from rapidcfd_tpu.fields.field import SurfaceField as JSurface
    from rapidcfd_tpu.utils.dimensions import DimensionSet as JD
    phi = rng.uniform(-1e-3, 1e-3, jm.n_faces)
    jphi = JSurface(jnp.asarray(phi), JD.of(0, 3, -1), "phi")
    tphi = interop.surface_field(jphi, device=CPU, dtype=F64)
    from rapidcfd_tpu.fields.field import Dimensioned as JDimensioned
    from rapidcfd_tpu_torch.fields.field import Dimensioned
    from rapidcfd_tpu_torch.utils.dimensions import DimensionSet
    jl = jfvm.laplacian(jm, JDimensioned("DT", JD.of(0, 2, -1), 0.05), jT)
    tl = tfvm.laplacian(tm, Dimensioned("DT", DimensionSet.of(0, 2, -1),
                                        0.05), tT)
    jd = jfvm.div(jm, jphi, jT, "upwind")
    td = tfvm.div(tm, tphi, tT, "upwind")

    def close(a, b, what):
        assert np.abs(_np(a) - np.asarray(b)).max() \
            <= TOL * max(np.abs(np.asarray(b)).max(), 1.0), what
    for jmat, tmat, tag in ((jl, tl, "laplacian"), (jd, td, "div"),
                            (jl + jd, tl + td, "sum")):
        for k in ("diag", "lower", "upper", "source"):
            close(getattr(tmat, k), getattr(jmat, k), f"{tag} {k}")
        for a, b in zip(tmat.boundary_coeffs + tmat.internal_coeffs,
                        jmat.boundary_coeffs + jmat.internal_coeffs):
            close(a, b, f"{tag} patch coefficients")
        close(tmat.A(tm).data, jmat.A(jm).data, f"{tag} A")
        close(tmat.H(tm).data, jmat.H(jm).data, f"{tag} H")
        close(tmat.H1(tm).data, jmat.H1(jm).data, f"{tag} H1")
        jdiag, jsrc = jmat.component_system(jm, None)
        tdiag, tsrc = tmat.component_system(tm, None)
        close(tdiag, jdiag, f"{tag} folded diag")
        close(tsrc, jsrc, f"{tag} folded source")
        x = rng.standard_normal(jm.n_cells)
        close(tsolvers._amul_fn(tm, tmat, tdiag)(torch.tensor(x)),
              jsolvers._amul_fn(jm, jmat, jdiag)(jnp.asarray(x)),
              f"{tag} A x")
    close(tl.flux(tm).data, jl.flux(jm).data, "flux")
    close(tfvc.grad(tm, tT).data, jfvc.grad(jm, jT).data, "grad")


@pytest.mark.parametrize("name,fn", [
    ("ami", "run_laplacian_foam"), ("acmi", "run_laplacian_foam"),
    ("acmi_quarter", "run_laplacian_foam")])
def test_ami_channels_match_jax(meshes, name, fn):
    """5 laplacianFoam steps across the non-conforming interface: T
    within 1e-8, counts within one, T between the two wall temperatures
    to 1e-3 K (the partial ACMI overlap undershoots by ~2e-4 K after 5
    steps, in both packages)."""
    d = meshes[name][0]
    (jcase, jT), jits, (tcase, tT), tits = basic_pair(fn, d)
    a = tcase.maps.cells_to_file(tT.data.numpy())
    assert rel(a, jcase.maps.cells_to_file(np.asarray(jT.data))) <= RUN_TOL
    assert counts_close(tits, jits)
    assert 300.0 - 1e-3 <= float(tT.data.min()) \
        and float(tT.data.max()) <= 400.0 + 1e-3


@pytest.fixture(scope="module")
def periodic_pair(tmp_path_factory):
    out = {}
    for kind in ("cyclic", "ami"):
        d = str(tmp_path_factory.mktemp("periodic_" + kind))
        with captured():
            casegen.periodic_transport_case(d, kind)
        out[kind] = basic_pair("run_scalar_transport_foam", d)
    return out


def test_conforming_ami_matches_jax_and_merged_cyclic(periodic_pair):
    """5 upwind steps of the periodic blob through the conformal
    cyclicAMI pair: T within 1e-8 of the JAX package's, counts within
    one, and within 1e-8 of the merged cyclic's run (the same operator)."""
    files = {}
    for kind, ((jcase, jT), jits, (tcase, tT), tits) in \
            periodic_pair.items():
        a = tcase.maps.cells_to_file(tT.data.numpy())
        assert rel(a, jcase.maps.cells_to_file(np.asarray(jT.data))) \
            <= RUN_TOL, kind
        assert counts_close(tits, jits), kind
        files[kind] = a
    assert rel(files["ami"], files["cyclic"]) <= RUN_TOL
