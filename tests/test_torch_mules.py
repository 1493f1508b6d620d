"""The port's MULES (ops/mules.py), fvc.smooth on gdia and LTSInterFoam's
rDeltaT against the JAX package in fp64 on the CPU.

Three meshes: the 12x12 dam break box on the gdia lattice (the port's
plane-shift sums) and on the padded ELL, and the small polyhedral channel
of the unstructured generator (ELL, inlet and outlet patches). The JAX
package builds each mesh; interop carries it, and the inputs, into the
port, so both run on one layout. Random fields and fluxes come from a
numpy seed (zero on the lattice's dummy plane faces and on empty
patches). limiter, bounded_flux, explicit_solve (plain, with
div_phi_comp, with Sp and Su) and implicit_solve match to 1e-12 relative
to the largest magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapidcfd_tpu.fields.field import SurfaceField as JSurface
from rapidcfd_tpu.linalg.solvers import SolverControls as JControls
from rapidcfd_tpu.ops import fvc as jfvc
from rapidcfd_tpu.ops import mules as jm
from rapidcfd_tpu.solvers import lts as jlts
from rapidcfd_tpu.solvers.case import Case as JCase
from rapidcfd_tpu.utils.dimensions import DimensionSet as JDims
from rapidcfd_tpu_torch import interop
from rapidcfd_tpu_torch.linalg.solvers import SolverControls
from rapidcfd_tpu_torch.mesh.polymesh import read_polymesh
from rapidcfd_tpu_torch.ops import fvc as tfvc
from rapidcfd_tpu_torch.ops import mules as tm
from rapidcfd_tpu_torch.solvers import lts as tlts
from rapidcfd_tpu_torch.utils.casegen import dam_break_case
from rapidcfd_tpu_torch.utils.logging import captured
from rapidcfd_tpu_torch.utils.unstructured import (detect_lattice,
                                                   unstructured_channel_case)
from torch_heat_reference import CPU, F64, jax_quiet, jax_switches, rel

TOL = 1e-12


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """name -> (JAX case, port MeshArrays, the scalar field carrying psi)."""
    box = str(tmp_path_factory.mktemp("box12"))
    ch = str(tmp_path_factory.mktemp("channel"))
    with captured():
        dam_break_case(box, n=12)
        unstructured_channel_case(ch, nx=8, ny=6, nz=6, perturb=0.12,
                                  seed=3, end_time=3)
    out = {}
    with jax_quiet():
        out["box-gdia"] = (JCase(box, lattice=detect_lattice(
            read_polymesh(box), full_box=True)), "alpha1")
        with jax_switches(GDIA_AUTO="0", FORCE_RCM="1"):
            out["box-ell"] = (JCase(box), "alpha1")
            out["channel-ell"] = (JCase(ch), "p")
    return {k: (jc, interop.mesh_arrays(jc.mesh, device=CPU, dtype=F64),
                name) for k, (jc, name) in out.items()}


def _inputs(jcase, name, seed):
    """(JAX psi, JAX phi, port psi, port phi, dt): psi random in [0, 1]
    with a third of the cells exactly 0 or 1, phi a random flux that is
    zero on dummy and empty faces, and dt for a largest Courant number of
    0.8."""
    jmesh = jcase.mesh
    rng = np.random.default_rng(seed)
    with jax_quiet():
        jpsi = jcase.read_field(name)
    x = rng.uniform(0.0, 1.0, jmesh.n_cells)
    pick = rng.uniform(size=jmesh.n_cells)
    x[pick < 0.15], x[pick > 0.85] = 0.0, 1.0
    jpsi = jpsi.replace(data=jnp.asarray(x)).correct_boundary_conditions(
        jmesh)
    mag_sf = np.asarray(jmesh.mag_sf)
    live = mag_sf > 0
    for p in jmesh.patches:
        if p.is_empty:
            live[p.start:p.start + p.size] = False
    phi = np.where(live, rng.standard_normal(jmesh.n_faces) * mag_sf, 0.0)
    jphi = JSurface(jnp.asarray(phi), JDims.of(0, 3, -1), "phi")
    co = 0.5 * np.asarray(jfvc.surface_sum_faces(
        jmesh, jnp.abs(jphi.data), signed=False)) / np.asarray(jmesh.V)
    dt = 0.8 / co.max()
    return (jpsi, jphi, interop.vol_field(jpsi, device=CPU, dtype=F64),
            interop.surface_field(jphi, device=CPU, dtype=F64), dt)


def _candidate(jmesh, tmesh, jpsi, jphi, tpsi, tphi):
    """The high-order candidate flux: linear face values times phi."""
    jc = JSurface(jphi.data * jfvc.face_values(jmesh, jpsi), jphi.dims,
                  "phiPsi")
    tc = type(tphi)(tphi.data * tfvc.face_values(tmesh, tpsi), tphi.dims,
                    "phiPsi")
    return jc, tc


def _close(a, b):
    return rel(np.asarray(a), np.asarray(b)) <= TOL


MESHES = ["box-gdia", "box-ell", "channel-ell"]


@pytest.mark.parametrize("which", MESHES)
def test_bounded_flux_and_limiter_match_jax(meshes, which):
    """bounded_flux's (phiBD, correction) and the Zalesak lambda (3
    sweeps) against the JAX package's; lambda is 1 on boundary faces and
    within [0, 1] everywhere."""
    jcase, tmesh, name = meshes[which]
    jmesh = jcase.mesh
    jpsi, jphi, tpsi, tphi, dt = _inputs(jcase, name, 1)
    jc, tc = _candidate(jmesh, tmesh, jpsi, jphi, tpsi, tphi)
    jbd, jcorr = jm.bounded_flux(jmesh, jpsi, jphi, jc)
    tbd, tcorr = tm.bounded_flux(tmesh, tpsi, tphi, tc)
    assert _close(tbd, jbd) and _close(tcorr, jcorr)
    td = tpsi.data - dt / tmesh.V * tfvc.surface_sum_faces(tmesh, tbd)
    jtd = jpsi.data - dt / jmesh.V * jfvc.surface_sum_faces(jmesh, jbd)
    lam_t = tm.limiter(tmesh, td, tcorr, dt)
    lam_j = jm.limiter(jmesh, jtd, jcorr, dt)
    # the dummy plane faces carry no correction: compare where one flows
    real = np.asarray(jcorr) != 0.0
    assert real.any()
    assert _close(lam_t.numpy()[real], np.asarray(lam_j)[real])
    n_int = tmesh.n_internal
    assert bool((lam_t[n_int:] == 1.0).all())
    assert float(lam_t.min()) >= 0.0 and float(lam_t.max()) <= 1.0
    assert float(lam_t[:n_int][torch.as_tensor(real[:n_int])].min()) < 1.0


@pytest.mark.parametrize("form", ["plain", "div_phi_comp", "sp_su"])
@pytest.mark.parametrize("which", MESHES)
def test_explicit_solve_matches_jax(meshes, which, form):
    """explicit_solve's psi and limited flux against the JAX package's:
    plain, with div(phi) compensation (and its conservation restore) and
    with a physical Sp < 0 and Su >= 0."""
    jcase, tmesh, name = meshes[which]
    jmesh = jcase.mesh
    jpsi, jphi, tpsi, tphi, dt = _inputs(jcase, name, 2)
    jc, tc = _candidate(jmesh, tmesh, jpsi, jphi, tpsi, tphi)
    jkw, tkw = {}, {}
    if form == "div_phi_comp":
        jkw["div_phi_comp"] = jfvc.surface_sum_faces(jmesh, jphi.data) \
            / jmesh.V
        tkw["div_phi_comp"] = tfvc.surface_sum_faces(tmesh, tphi.data) \
            / tmesh.V
    elif form == "sp_su":
        rng = np.random.default_rng(3)
        sp = -rng.uniform(0.0, 1.0 / dt, jmesh.n_cells)
        su = rng.uniform(0.0, 0.1 / dt, jmesh.n_cells)
        jkw.update(sp=jnp.asarray(sp), su=jnp.asarray(su))
        tkw.update(sp=torch.tensor(sp), su=torch.tensor(su))
    ja, jf = jm.explicit_solve(jmesh, jpsi, jphi, jc, dt, **jkw)
    ta, tf = tm.explicit_solve(tmesh, tpsi, tphi, tc, dt, **tkw)
    assert _close(ta.data, ja.data) and _close(ta.bvalues, ja.bvalues)
    assert _close(tf.data, jf.data)


@pytest.mark.parametrize("which", MESHES)
def test_implicit_solve_matches_jax(meshes, which):
    """implicit_solve (MULESCorr) at a largest Courant number of 4, its
    bounded upwind system solved by PBiCGStab/DILU to 1e-14: psi and the
    limited flux against the JAX package's."""
    jcase, tmesh, name = meshes[which]
    jmesh = jcase.mesh
    jpsi, jphi, tpsi, tphi, dt = _inputs(jcase, name, 4)
    dt = 5.0 * dt
    jc, tc = _candidate(jmesh, tmesh, jpsi, jphi, tpsi, tphi)
    kw = dict(solver="PBiCGStab", preconditioner="DILU", tolerance=1e-14,
              rel_tol=0.0, max_iter=500)
    with jax_quiet(unoptimized=False):
        ja, jf = jm.implicit_solve(jmesh, jpsi.store_old(), jphi, jc, dt,
                                   JControls(**kw))
    ta, tf = tm.implicit_solve(tmesh, tpsi.store_old(), tphi, tc, dt,
                               SolverControls(**kw))
    assert _close(ta.data, ja.data) and _close(ta.bvalues, ja.bvalues)
    assert _close(tf.data, jf.data)


def test_smooth_on_gdia_matches_jax(meshes):
    """fvc.smooth on the gdia lattice (the port's plane shifts; it raised
    there before) against the JAX package's cell_nbr sweeps on the same
    lattice, and against the port's own ELL form on the ELL box."""
    rng = np.random.default_rng(7)
    for which in ("box-gdia", "box-ell"):
        jcase, tmesh, _ = meshes[which]
        x = np.exp(rng.standard_normal(tmesh.n_cells) * 3.0)
        a = tfvc.smooth(tmesh, torch.tensor(x), 1.0 / 1.02, sweeps=12)
        b = jfvc.smooth(jcase.mesh, jnp.asarray(x), 1.0 / 1.02, sweeps=12)
        assert rel(a.numpy(), np.asarray(b)) <= TOL
        assert bool((a >= torch.tensor(x)).all())


@pytest.mark.parametrize("which", ["box-gdia", "box-ell"])
def test_rdelta_t_interface_matches_jax(meshes, which):
    """LTSInterFoam's rDeltaT (maxCo, the interface band's maxAlphaCo,
    12 smoothing sweeps and the damping against the previous value)
    against the JAX package's."""
    jcase, tmesh, name = meshes[which]
    jpsi, jphi, tpsi, tphi, _ = _inputs(jcase, name, 5)
    c = dict(max_co=0.9, smoothing_coeff=0.05, damping_coeff=0.5,
             max_delta_t=1.0)
    jf = jlts.make_rdelta_t_interface(jcase.mesh, jlts.LTSControls(**c), 0.3)
    tf = tlts.make_rdelta_t_interface(tmesh, tlts.LTSControls(**c), 0.3)
    prev = np.random.default_rng(6).uniform(1.0, 50.0, tmesh.n_cells)
    a = tf(tphi.data, tpsi.data, torch.tensor(prev))
    b = jf(jphi.data, jpsi.data, jnp.asarray(prev))
    assert rel(a.numpy(), np.asarray(b)) <= TOL
    a0 = tf(tphi.data, tpsi.data, None)
    b0 = jf(jphi.data, jpsi.data, None)
    assert rel(a0.numpy(), np.asarray(b0)) <= TOL
