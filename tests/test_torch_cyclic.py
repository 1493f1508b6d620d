"""The port's merged cyclics and the jump family (mesh/cyclic.py,
mesh/mesharrays.py, fields/bcs_coupled.py, fields/io.py) against the JAX
package in fp64 on the CPU.

- The 40-cell ring and the small periodic LES channel (both directions
  cyclic): the merged mesh's ELL addressing integer-equal to the JAX
  package's, weights, delta coefficients, centres and volumes to 1e-12.
- cyclicSlip and nonuniformTransformCyclic read as cyclic and written
  back under their own spelling (ascii, binary, gzip); build_mesh_arrays'
  keep_cyclic leaves its input mesh as it was; a coupled mesh never takes
  the gdia layout (detection gives None, -gdiaBox raises by name).
- 5 steps against the JAX package's run(): the ring's scalarTransportFoam
  (vanLeer), the fixedJump, uniformJump (constant and ramped) and fan
  channels (laplacianFoam), T carried through a fan at its face flux
  (scalarTransportFoam), a fan on p in a periodic duct and a fanPressure
  inlet (laminar pimpleFoam), a uniformJump table of time on U in
  icoFoam, and the periodic LES channel (pimpleFoam, oneEqEddy,
  pressureGradientExplicitSource, Euler as the JAX package runs
  backward): fields to 1e-8 of their largest magnitude, every count
  within one; the fan's jump and fanPressure's p0 to 1e-12.
- A pair kept coupled by a jump on one field while another says
  `cyclic` there: held to the merged case and to the zero vector jump.
- Fields on a merged mesh: the cyclic entries written back, a face flux
  written with both sides of each pair (the B side negated) and read
  back; the coupled cases run without importing jax.
"""

import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapidcfd_tpu.fields.bcs_coupled import FanPressure as JFanPressure
from rapidcfd_tpu.mesh import build_mesh_arrays as jbuild
from rapidcfd_tpu.mesh.polymesh import read_polymesh as jread
from rapidcfd_tpu.solvers import pimplefoam as jpimple
from rapidcfd_tpu_torch import interop
from rapidcfd_tpu_torch.fields import io as tio
from rapidcfd_tpu_torch.fields.bcs_coupled import FanPressure
from rapidcfd_tpu_torch.mesh.mesharrays import build_mesh_arrays
from rapidcfd_tpu_torch.mesh.polymesh import read_polymesh, write_polymesh
from rapidcfd_tpu_torch.ops import fvc
from rapidcfd_tpu_torch.solvers import basic as tbasic
from rapidcfd_tpu_torch.solvers import pimplefoam as tpimple
from rapidcfd_tpu_torch.solvers.case import Case, scan_jump_patches
from rapidcfd_tpu_torch.utils import casegen
from rapidcfd_tpu_torch.utils.logging import captured
from rapidcfd_tpu_torch.utils.unstructured import detect_lattice
from torch_heat_reference import (CPU, F64, basic_pair, counts_close,
                                  jax_quiet, jax_switches, port_case, rel)

RUN_TOL = 1e-8
COUPLED_TOL = 1e-10
TOL = 1e-12
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ELL_INT = ("owner", "neighbour", "cell_faces", "cell_nbr",
            "ell_coeff_idx")
_ELL_FLOAT = ("cell_sign", "internal_mask", "weights", "delta_coeffs",
              "nonorth_delta_coeffs", "corr_vecs", "C", "V", "Sf", "Cf",
              "b_delta_coeffs")


def _channel(d, **kw):
    return casegen.periodic_channel_case(
        d, 8, 8, 6, n_steps=5, ddt="Euler", fmt="ascii", compress=False,
        u_seed=3, k_seed=4, **kw)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    out = {}
    with captured():
        for name, writer in (("ring", casegen.cyclic_ring_case),
                             ("channel", _channel)):
            d = str(tmp_path_factory.mktemp(name))
            writer(d)
            out[name] = d
    return out


@pytest.mark.parametrize("name", ["ring", "channel"])
def test_merged_mesh_matches_jax(cases, name):
    """The merged mesh of both packages: the periodic faces are internal
    (the ring has 40 internal faces and its two empty patches), its ELL
    arrays integer-equal, its geometry and coefficients to 1e-12, the
    cell and face maps equal (the JAX maps carried by interop map cells
    and pRefCell as the port's)."""
    d = cases[name]
    with captured():
        ta, _, tmaps = build_mesh_arrays(read_polymesh(d), device=CPU,
                                         dtype=F64)
    ja, _, jmaps = jbuild(jread(d), dtype=jnp.float64)
    for k in _ELL_INT:
        assert np.array_equal(getattr(ta, k).numpy(),
                              np.asarray(getattr(ja, k))), k
    for k in _ELL_FLOAT:
        assert np.abs(getattr(ta, k).numpy()
                      - np.asarray(getattr(ja, k))).max() <= TOL, k
    assert np.array_equal(tmaps.cell_perm, jmaps.cell_perm)
    assert np.array_equal(tmaps.face_perm, jmaps.face_perm)
    carried = interop.mesh_maps(jmaps, tmaps.n_file_faces)
    cells = np.random.default_rng(2).standard_normal(ta.n_cells)
    assert np.array_equal(carried.cells_to_file(cells),
                          tmaps.cells_to_file(cells))
    assert carried.device_cell(0) == tmaps.device_cell(0)
    assert [p.name for p in ta.patches] == [p.name for p in ja.patches]
    if name == "ring":
        assert ta.n_internal == 40 and \
            [p.name for p in ta.patches] == ["sides", "fb"]
        assert np.allclose(ta.delta_coeffs.numpy(), 40.0, rtol=1e-12)
    else:
        assert [p.name for p in ta.patches] == ["bottomWall", "topWall"]
    file_names = [p[0] for p in tmaps.file_patches]
    assert file_names == [p.name for p in read_polymesh(d).patches]


@pytest.mark.parametrize("fmt,compress", [("ascii", False),
                                          ("binary", False),
                                          ("binary", True)])
@pytest.mark.parametrize("typ", ["cyclicSlip", "nonuniformTransformCyclic"])
def test_cyclic_wrapper_types_round_trip(tmp_path, typ, fmt, compress):
    """A cyclicSlip or nonuniformTransformCyclic pair reads as cyclic,
    merges as the JAX package merges it, and is written back under its
    own spelling with its neighbourPatch."""
    mesh = casegen.box_mesh(40, 1, 1, size=(1.0, 0.05, 0.05), patch_spec={
        "xmin": ("left", typ, "right"), "xmax": ("right", typ, "left"),
        "ymin": ("sides", "empty"), "ymax": ("sides", "empty"),
        "zmin": ("fb", "empty"), "zmax": ("fb", "empty")})
    d = str(tmp_path / "in")
    write_polymesh(mesh, d, fmt=fmt, compress=compress)
    with captured():
        m = read_polymesh(d)
    assert [p.type for p in m.patches[:2]] == ["cyclic", "cyclic"]
    ta, _, _ = build_mesh_arrays(m, device=CPU, dtype=F64)
    assert ta.n_internal == 40
    d2 = str(tmp_path / "out")
    write_polymesh(m, d2, fmt=fmt, compress=compress)
    text = open(os.path.join(d2, "constant", "polyMesh", "boundary")).read()
    assert text.count(typ) == 2 and "_originalType" not in text
    assert "neighbourPatch  right" in text
    with captured():
        back = read_polymesh(d2)
    assert np.array_equal(back.owner, m.owner)
    assert [(p.name, p.type, p.start_face, p.n_faces) for p in back.patches] \
        == [(p.name, p.type, p.start_face, p.n_faces) for p in m.patches]


def test_keep_cyclic_leaves_its_input(tmp_path):
    """keep_cyclic turns the named pair into a conformal cyclicAMI with
    the inferred translation, on a copy: the caller's mesh keeps its
    types and its patch dictionaries (the JAX package writes transform and
    separationVector into them)."""
    d = str(tmp_path)
    with captured():
        casegen.jump_channel_case(d, "fixedJump")
        pm = read_polymesh(d)
    before = [(p.type, dict(p.extra)) for p in pm.patches]
    ta, _, _ = build_mesh_arrays(pm, device=CPU, dtype=F64,
                                 keep_cyclic=("inlet",))
    assert [(p.type, dict(p.extra)) for p in pm.patches] == before
    types = {p.name: p.type for p in ta.patches}
    assert types["inlet"] == types["outlet"] == "cyclicAMI"
    tabs = [t for t in ta.ami if t is not None]
    assert len(tabs) == 2 and all(
        float((t.w.sum(1) - 1).abs().max()) < 1e-12 for t in tabs)


def test_coupled_mesh_never_takes_gdia(cases):
    """A periodic box is a lattice by its cells, yet detection gives None;
    gdia_box and a given lattice raise, naming the coupled patches; the
    case runs on ELL."""
    d = cases["channel"]
    with captured():
        pm = read_polymesh(d)
        assert detect_lattice(pm, full_box=True) is None
        for kw in (dict(gdia_box=True), dict(lattice={"shape": (6, 8, 8)})):
            with pytest.raises(ValueError, match="inout1.*inout2.*sides1"):
                Case(d, device=CPU, dtype=F64, **kw)
        case = Case(d, device=CPU, dtype=F64)
    assert case.mesh.gdia is None and case.mesh.cell_nbr is not None


def test_scan_jump_patches_reads_boundary_types(tmp_path):
    """The jump scan reads each start-time file's boundaryField: from a
    seeded ascii T, a binary gzipped copy, and a file whose jump entry
    reads a macro defined above it; a file that does not parse is logged
    by name; the scan is a set-up stage of its own."""
    d = str(tmp_path)
    with captured():
        pm = casegen.jump_channel_case(d, "fixedJump", t_seed=1)
    t0 = os.path.join(d, "0")
    text = open(os.path.join(t0, "T")).read()
    os.remove(os.path.join(t0, "T"))
    with open(os.path.join(t0, "M"), "w") as f:
        f.write(text.replace("internalField", "jumpType fixedJump;\n"
                             "internalField", 1)
                .replace("type            fixedJump;",
                         "type            $jumpType;"))
    with open(os.path.join(t0, "bad"), "w") as f:
        f.write("FoamFile { class volScalarField; }\nboundaryField {")
    with captured() as buf:
        got = scan_jump_patches(read_polymesh(d), d, "0")
    assert got == ("inlet", "outlet")
    assert "bad was not read" in buf.getvalue()
    os.remove(os.path.join(t0, "bad"))
    os.remove(os.path.join(t0, "M"))
    casegen.write_field(
        d, "0", "T", "volScalarField", "[0 0 0 1 0 0 0]",
        tio._body_value(np.random.default_rng(1).standard_normal(
            pm.n_cells), binary=True),
        {"walls": casegen._ZG, "fb": casegen._EMPTY,
         '"(inlet|outlet)"': casegen.JUMP_BCS["fan"]},
        fmt="binary", compress=True)
    assert os.listdir(t0) == ["T.gz"]
    with captured():
        assert scan_jump_patches(read_polymesh(d), d, "0") == \
            ("inlet", "outlet")
        case = Case(d, device=CPU, dtype=F64)
    assert "scan" in case.setup_seconds


@pytest.fixture(scope="module")
def ring_runs(cases):
    return basic_pair("run_scalar_transport_foam", cases["ring"])


def test_ring_transport_matches_jax(ring_runs):
    """5 vanLeer steps around the ring: T within 1e-8, counts within one;
    T conserved through the merged face to 1e-9 (the solves stop at a
    residual of 1e-10) and bounded."""
    (jcase, jT), jits, (tcase, tT), tits = ring_runs
    a = tcase.maps.cells_to_file(tT.data.numpy())
    assert rel(a, jcase.maps.cells_to_file(np.asarray(jT.data))) <= RUN_TOL
    assert counts_close(tits, jits)
    t0 = tcase.read_field("T", "0").data
    V = tcase.mesh.V
    assert abs(float((tT.data * V).sum() - (t0 * V).sum())) \
        < 1e-9 * float((t0 * V).sum())
    assert float(tT.data.min()) > -1e-12 and float(tT.data.max()) < 1.0


@pytest.mark.parametrize("bc", ["fixedJump", "uniformJump", "fan",
                                "uniformJumpRamp"])
def test_jump_bcs_match_jax(tmp_path, bc):
    """5 laplacianFoam steps of the jump channel from a seeded T: T
    within 1e-8, counts within one; fixedJump and uniformJump (a constant
    jumpTable) give the same T, fan's curve vanishes at t = 0. The ramped
    jumpTable (10 at t = 0 to 60 at t = 1) is evaluated at t = 0 at every
    step in both packages, as no solver hands the time to the jump
    (ROADMAP Queue 3): its T equals fixedJump's (jump 10) to 1e-12."""
    d = str(tmp_path / bc)
    with captured():
        casegen.jump_channel_case(d, bc, t_seed=1)
    (jcase, jT), jits, (tcase, tT), tits = basic_pair("run_laplacian_foam",
                                                      d)
    a = tcase.maps.cells_to_file(tT.data.numpy())
    assert rel(a, jcase.maps.cells_to_file(np.asarray(jT.data))) <= RUN_TOL
    assert counts_close(tits, jits)
    types = {p.name: p.type for p in tcase.mesh.patches}
    assert types["inlet"] == "cyclicAMI"
    word = "uniformJump" if bc == "uniformJumpRamp" else bc
    assert type(tT.bcs[[p.name for p in tcase.mesh.patches].index(
        "inlet")]).word == word
    if bc == "uniformJumpRamp":
        d10 = str(tmp_path / "fixed")
        with captured():
            casegen.jump_channel_case(d10, "fixedJump", t_seed=1)
            fcase, fT = tbasic.run_laplacian_foam(
                d10, device=CPU, dtype=F64, write=False, max_steps=5)[:2]
        assert rel(a, fcase.maps.cells_to_file(fT.data.numpy())) <= TOL


def _inout(case):
    names = [p.name for p in case.mesh.patches]
    return [(case.mesh.patches[names.index(n)], names.index(n))
            for n in ("inlet", "outlet")]


def test_fan_flux_jump_matches_jax(tmp_path):
    """The fan curve at the face flux: 5 scalarTransportFoam steps of the
    jump channel with T carried through the fan by U = (1 0 0) (U says
    `cyclic` on the kept pair). T within 1e-8 of the JAX package's,
    counts within one. The convection term's jump is max(curve(Un), 0) on
    each side from its own flux in both packages, to 1e-12: 100 - 50 = 50
    on the outlet (Un = 1), 0 on the inlet (Un clamped from -1 to 0). Both
    packages upwind the coupled face whatever the scheme, so the outlet
    takes its own cell and the inlet the ghost with its zero jump: T
    equals the zero-jump run's to 1e-12 (ROADMAP Queue 3)."""
    from rapidcfd_tpu.ops import fvc as jfvc
    d = str(tmp_path / "fan")
    with captured():
        casegen.jump_channel_case(d, "fan", t_seed=1, u_flow=1.0)
    (jcase, jT), jits, (tcase, tT), tits = basic_pair(
        "run_scalar_transport_foam", d)
    a = tcase.maps.cells_to_file(tT.data.numpy())
    assert rel(a, jcase.maps.cells_to_file(np.asarray(jT.data))) <= RUN_TOL
    assert counts_close(tits, jits)
    with captured():
        tphi = fvc.flux(tcase.mesh, tcase.read_field("U", "0"))
    jphi = jfvc.flux(jcase.mesh, jcase.read_field("U", "0"))
    got = {}
    for (patch, i), (jpatch, _) in zip(_inout(tcase), _inout(jcase)):
        bc, bd = tT.bcs[i], tT.bcdata[i]
        assert type(bc).word == "fan"
        tj = bc.jump_magnitude(tcase.mesh, patch, tT, bd, {"phi": tphi})
        jj = jT.bcs[i].jump_magnitude(jcase.mesh, jpatch, jT, jT.bcdata[i],
                                      {"phi": jphi})
        assert np.abs(tj.numpy() - np.asarray(jj)).max() <= TOL * 50.0
        got[patch.name] = tj.numpy()
    assert np.allclose(got["outlet"], 50.0, rtol=1e-12, atol=0)
    assert np.array_equal(got["inlet"], np.zeros_like(got["inlet"]))
    dz = str(tmp_path / "zero")
    with captured():
        casegen.jump_channel_case(dz, "zeroJump", t_seed=1, u_flow=1.0)
        zcase, zT = tbasic.run_scalar_transport_foam(
            dz, device=CPU, dtype=F64, write=False, max_steps=5)[:2]
    assert rel(a, zcase.maps.cells_to_file(zT.data.numpy())) <= TOL


def _port_pimple(d, steps=5):
    with captured():
        case, U, p, _, ts = tpimple.run(d, device=CPU, dtype=F64,
                                        write=False, max_steps=steps)
    return case, dict(U=U, p=p, **ts)


def _file_rel(a, b, name):
    (ca, fa), (cb, fb) = a, b
    return rel(ca.maps.cells_to_file(fa[name].data.numpy()),
               cb.maps.cells_to_file(fb[name].data.numpy()))


def test_kept_pair_cyclic_fields_match_merged(tmp_path):
    """A pair kept coupled by a zero jump on T, U saying `cyclic` there
    (coupled as the conformal AMI), runs as the same case merged: 5
    scalarTransportFoam steps of the flowing jump channel, T within 1e-10
    of the merged run's largest magnitude."""
    runs = {}
    for bc in ("zeroJump", "cyclic"):
        d = str(tmp_path / bc)
        with captured():
            casegen.jump_channel_case(d, bc, t_seed=1, u_flow=1.0)
            case, T = tbasic.run_scalar_transport_foam(
                d, device=CPU, dtype=F64, write=False, max_steps=5)[:2]
        runs[bc] = case, dict(T=T)
    kcase, mcase = runs["zeroJump"][0], runs["cyclic"][0]
    names = [p.name for p in kcase.mesh.patches]
    assert kcase.mesh.patches[names.index("inlet")].type == "cyclicAMI"
    assert "inlet" not in [p.name for p in mcase.mesh.patches]
    with captured():
        U = kcase.read_field("U", "0")
    assert type(U.bcs[names.index("inlet")]).__name__ == "CyclicAMI"
    assert _file_rel(runs["zeroJump"], runs["cyclic"], "T") <= COUPLED_TOL


def test_kept_pair_cyclic_u_in_pimple(tmp_path):
    """In pimpleFoam, U saying `cyclic` on a pair that p keeps coupled (a
    zero jump) runs as U's zero vector jump, the type the JAX package
    couples there: 5 steps of the periodic duct from a seeded U, U and p
    within 1e-12. The same case merged parts from both by more than 1%:
    HbyA and rAU keep their own side's values at a kept pair, where a
    merged face interpolates across it (ROADMAP Queue 3; the JAX package
    parts the same way)."""
    runs = {}
    for p_bc, u_bc in (("zeroJump", "cyclic"), ("zeroJump", "zeroJump"),
                       ("cyclic", "cyclic")):
        d = str(tmp_path / f"{p_bc}_{u_bc}")
        with captured():
            casegen.fan_channel_case(d, p_bc=p_bc, u_bc=u_bc, u_seed=5)
        runs[u_bc if p_bc == "zeroJump" else "merged"] = _port_pimple(d)
    names = [p.name for p in runs["cyclic"][0].mesh.patches]
    assert type(runs["cyclic"][1]["U"].bcs[names.index("inlet")]) \
        .__name__ == "CyclicAMI"
    for name in ("U", "p"):
        assert _file_rel(runs["cyclic"], runs["zeroJump"], name) <= TOL
        assert _file_rel(runs["cyclic"], runs["merged"], name) > 1e-2


def _pimple_counts_close(jsteps, tsteps) -> bool:
    """Per step: the non-p counts within one; the JAX package logs the
    last corrector's p solves only, held against the port's last."""
    if len(jsteps) != len(tsteps):
        return False
    for j, t in zip(jsteps, tsteps):
        jo, to = ([x for x in s if x[0] != "p"] for s in (j, t))
        if [f for f, _ in jo] != [f for f, _ in to] or any(
                abs(a - b) > 1 for (_, a), (_, b) in zip(jo, to)):
            return False
        jp = [n for f, n in j if f == "p"]
        tp = [n for f, n in t if f == "p"][-len(jp):]
        if any(abs(a - b) > 1 for a, b in zip(jp, tp)):
            return False
    return True


@pytest.mark.parametrize("kind", ["fan", "fanPressure"])
def test_fan_channels_match_jax(tmp_path, kind):
    """5 laminar pimpleFoam steps against the JAX package: U and p within
    1e-8, counts within one. fan: a fan in the periodic duct (p fan on
    the kept pair, U a zero vector jump) from a seeded U. fanPressure: a
    fan drawing from the ambient through the inlet. Neither package hands phi to p's
    boundary conditions in the pressure solve (ROADMAP Queue 3), so the
    fan's jump is its curve at zero flow, 30, though the flux through
    it is not zero, and the fanPressure inlet holds p0 = 10 although
    the curve at the inflow is not zero."""
    d = str(tmp_path)
    with captured():
        if kind == "fan":
            casegen.fan_channel_case(d, u_seed=5)
        else:
            casegen.fan_pressure_channel_case(d)
    jcase, jf, jsteps = _jax_pimple(d, 5)
    tcase, tf = _port_pimple(d)
    for name in ("U", "p"):
        assert rel(tcase.maps.cells_to_file(tf[name].data.numpy()),
                   jcase.maps.cells_to_file(np.asarray(jf[name].data))) \
            <= RUN_TOL, name
    assert _pimple_counts_close(
        jsteps, [t["iterations"] for t in tcase.step_log])
    p = tf["p"]
    with captured():
        phi = fvc.flux(tcase.mesh, tf["U"])
    for patch, i in _inout(tcase)[:1 if kind == "fanPressure" else 2]:
        flux = phi.data[patch.start:patch.start + patch.size]
        assert float(flux.abs().min()) > 1e-3 * float(
            tcase.mesh.patch_mag_sf(patch).min())
        bc, bd = p.bcs[i], p.bcdata[i]
        assert type(bc).word == kind
        if kind == "fan":
            assert float(bc.jump_magnitude(tcase.mesh, patch, p, bd)) \
                == 30.0
        else:
            assert float(bc._p0(tcase.mesh, patch, p, bd,
                                {"phi": phi}).min()) > 10.0
            assert np.array_equal(
                p.bvalues[patch.bstart:patch.bstart + patch.size].numpy(),
                np.full(patch.size, 10.0))


def test_fan_pressure_p0_matches_jax(tmp_path):
    """fanPressure's p0 offset by the fan curve at the patch's flow rate,
    both directions, as the JAX package computes it."""
    d = str(tmp_path)
    with captured():
        casegen.cavity_case(d, n=4)
        case = Case(d, device=CPU, dtype=F64)
    mesh = case.mesh
    patch = mesh.patches[0]
    p = case.read_field("p", "0")
    from rapidcfd_tpu.utils.dimensions import DimensionSet as JD
    from rapidcfd_tpu_torch.fields.field import SurfaceField
    from rapidcfd_tpu_torch.utils.dimensions import DimensionSet
    flux = np.zeros(mesh.n_faces)
    flux[patch.start:patch.start + patch.size] = np.random.default_rng(
        7).uniform(-1e-3, 2e-3, patch.size)
    times, values = [0.0, 1e-3, 4e-3], [0.0, 30.0, 100.0]

    class _JPhi:
        data = jnp.asarray(flux)
        dims = JD.of(0, 3, -1)
    for direction in (1, -1):
        tbd = dict(p0=torch.tensor(5.0, dtype=F64),
                   jump_times=torch.tensor(times, dtype=F64),
                   jump_values=torch.tensor(values, dtype=F64))
        jbd = dict(p0=jnp.asarray(5.0), jump_times=jnp.asarray(times),
                   jump_values=jnp.asarray(values))
        tv = FanPressure(0, direction)._p0(
            mesh, patch, p, tbd, env={"phi": SurfaceField(
                torch.tensor(flux), DimensionSet.of(0, 3, -1))})
        jv = JFanPressure(0, direction)._p0(None, patch, None, jbd,
                                             env={"phi": _JPhi()})
        assert abs(float(tv) - float(jv)) <= TOL * 5.0


def _jax_pimple(d, steps):
    """pimpleFoam of the JAX package with its iteration counts recorded
    and old levels pre-stored (so its step compiles once); pRefCell as the
    device row of file cell 0, the port's mapping."""
    record = []
    orig = jpimple.make_step

    def make_step(case, transport, turb, ctrl, piso_mode):
        perm = np.asarray(case.maps.cell_perm)
        ctrl.p_ref_cell = int(np.nonzero(perm == ctrl.p_ref_cell)[0][0])
        step = orig(case, transport, turb, ctrl, piso_mode)

        def recorded(U, p, phi, ts, dt):
            if U.old is None:
                U = U.store_old()
                ts = {k: v.store_old() for k, v in ts.items()}
            out = step(U, p, phi, ts, dt)
            st = out[4]
            record.append(
                [(f"U{c}", int(pf[2])) for c, pf in zip("xyz",
                                                        st["u_perf"])]
                + [("p", int(pf[2])) for pf in st["p_perf"]]
                + [(k, int(pf[2])) for k, pf in sorted(st["turb"].items())])
            return out
        return recorded
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpimple, "make_step", make_step)
        with jax_switches(GDIA_AUTO="0", FORCE_RCM="1"), jax_quiet():
            case, U, p, phi, ts = jpimple.run(d, write=False,
                                              max_steps=steps)
    return case, dict(U=U, p=p, **ts), record


def _p_less_mean(case, p):
    x = case.maps.cells_to_file(np.asarray(p.data))
    return x - x.mean()


def test_uniform_jump_follows_time_in_icofoam(tmp_path):
    """icoFoam hands the end-of-step time to its U equation, as the JAX
    package's does: 5 steps of the periodic duct whose U carries a
    uniformJump table of time ((0 0 0) at t = 0, (2 0 0) at t = 1; p a
    zero jump) against the JAX package, U within 1e-8 and p within 1e-8
    up to its level (the two packages pin pRefCell in different orders),
    counts within one; U leaves the zero-jump run's, the jump's value at
    t = 0."""
    from rapidcfd_tpu.solvers import icofoam as jico
    from rapidcfd_tpu.utils.logging import Info as JInfo
    from rapidcfd_tpu_torch.solvers import icofoam as tico
    its_re = re.compile(r"Solving for (\w+),.*No Iterations (\d+)")
    out = {}
    for u_bc in ("uniformJumpRamp", "zeroJump"):
        d = str(tmp_path / u_bc)
        with captured():
            casegen.fan_channel_case(d, p_bc="zeroJump", u_bc=u_bc)
        with captured() as buf:
            old, JInfo.stream = JInfo.stream, buf
            try:
                jout = jico.run(d, write=False, max_steps=5) \
                    if u_bc != "zeroJump" else None
            finally:
                JInfo.stream = old
            jlog = buf.getvalue()
        with captured() as buf:
            tout = tico.run(d, device=CPU, dtype=F64, write=False,
                            max_steps=5)
        out[u_bc] = jout, jlog, tout, buf.getvalue()
    jout, jlog, tout, tlog = out["uniformJumpRamp"]
    (jcase, jU, jp), (tcase, tU, tp) = jout[:3], tout[:3]
    a = tcase.maps.cells_to_file(tU.data.numpy())
    assert rel(a, jcase.maps.cells_to_file(np.asarray(jU.data))) <= RUN_TOL
    assert rel(_p_less_mean(tcase, tp), _p_less_mean(jcase, jp)) <= RUN_TOL
    jits = [(f, int(n)) for f, n in its_re.findall(jlog)]
    tits = [(f, int(n)) for f, n in its_re.findall(tlog)]
    assert [f for f, _ in jits] == [f for f, _ in tits] and all(
        abs(x - y) <= 1 for (_, x), (_, y) in zip(jits, tits))
    zcase, zU = out["zeroJump"][2][:2]
    assert rel(a, zcase.maps.cells_to_file(zU.data.numpy())) > 1e-3


@pytest.fixture(scope="module")
def channel_runs(cases):
    d = cases["channel"]
    jcase, jf, jsteps = _jax_pimple(d, 5)
    tcase = port_case(d, "ell")
    with captured() as buf:
        _, U, p, phi, ts = tpimple.run(d, device=CPU, dtype=F64,
                                       write=False, max_steps=5, case=tcase)
    return jcase, jf, jsteps, tcase, dict(U=U, p=p, **ts), buf.getvalue()


def test_periodic_les_channel_matches_jax(channel_runs):
    """5 Euler steps of the periodic LES channel: U, p, k and nut within
    1e-8; the JAX package logs the last corrector's p solve, held against
    the port's last; every other count within one; the driving gradient
    logged at every step with the bulk velocity near Ubar."""
    jcase, jf, jsteps, tcase, tf, log = channel_runs
    assert sorted(jf) == sorted(tf) == ["U", "k", "nut", "p"]
    for name in jf:
        a = tcase.maps.cells_to_file(tf[name].data.numpy())
        b = jcase.maps.cells_to_file(np.asarray(jf[name].data))
        assert rel(a, b) <= RUN_TOL, name
    assert len(jsteps) == 5
    assert _pimple_counts_close(jsteps,
                                [t["iterations"] for t in tcase.step_log])
    lines = [ln for ln in log.splitlines() if "uncorrected Ubar" in ln]
    assert len(lines) == 5
    ubar = [float(ln.split("=")[1].split(",")[0]) for ln in lines]
    assert all(abs(u / casegen.CHANNEL395_UBAR - 1.0) < 0.05 for u in ubar)


def test_merged_fields_write_back(tmp_path, channel_runs):
    """On the merged channel: a written field holds the cyclic entries in
    the file's patch order and reads back; phi is written with both sides
    of every pair, the B side the negative of its matched A face, and
    reads back to the device flux."""
    _, _, _, tcase, tf, _ = channel_runs
    mesh, maps = tcase.mesh, tcase.maps
    d = str(tmp_path)
    tio.write_vol_field(tf["U"], d, "1", mesh, maps, prec=17)
    text = open(os.path.join(d, "1", "U")).read()
    names = [p[0] for p in maps.file_patches]
    order = [text.index(f"    {n}\n") for n in names]
    assert order == sorted(order)
    for n in ("inout1", "inout2", "sides1", "sides2"):
        assert f"    {n}\n    {{\n        type            cyclic;\n    }}" \
            in text
    back = tio.read_vol_field(d, "1", "U", mesh, maps)
    assert rel(back.data.numpy(), tf["U"].data.numpy()) <= 1e-15
    phi = fvc.flux(mesh, tf["U"])
    for fmt in ("ascii", "binary"):
        tio.write_surface_field(phi, d, fmt, mesh, maps, prec=17, fmt=fmt)
        from rapidcfd_tpu_torch.utils.dictionary import parse_file
        f = parse_file(os.path.join(d, fmt, "phi"))
        bf = f.subdict("boundaryField")
        stash = getattr(f, "binstash", None)
        vals = {n: tio._parse_value(bf.subdict(n).lookup("value"), s,
                                    np.float64, stash)
                for n, _, _, s in maps.file_patches}
        assert bf.subdict("inout1").word("type") == "cyclic"
        file_all = maps.faces_to_file(phi.data.numpy(), flux=True)
        b = maps.partner_face >= 0
        a_file = maps.face_perm[b]
        assert np.array_equal(file_all[maps.partner_face[b]],
                              -file_all[a_file])
        starts = {n: st for n, _, st, _ in maps.file_patches}
        for n in ("inout2", "sides2"):
            assert np.array_equal(vals[n], file_all[starts[n]:starts[n]
                                                    + vals[n].size])
        back = tio.read_surface_field(d, fmt, "phi", mesh, maps)
        assert rel(back.data.numpy(), phi.data.numpy()) <= 1e-15


def test_coupled_cases_run_without_jax(tmp_path):
    """The ring, the jump channel and the periodic LES channel (written
    binary and compressed, through the dispatcher) run on the CPU
    without importing jax or the JAX package."""
    script = f"""
import sys
before = {{m for m in sys.modules if m in ("jax", "rapidcfd_tpu")
          or m.startswith(("jax.", "rapidcfd_tpu."))}}
import torch
from rapidcfd_tpu_torch.__main__ import main
from rapidcfd_tpu_torch.utils import casegen
casegen.cyclic_ring_case("ring", end_time=0.01)
casegen.jump_channel_case("jump", "fan", end_time=0.1)
casegen.periodic_channel_case("chan", 8, 8, 6, n_steps=2)
for solver, d in (("scalarTransportFoam", "ring"), ("laplacianFoam", "jump"),
                  ("pimpleFoam", "chan")):
    main([solver, "-case", d, "-device", "cpu"])
after = {{m for m in sys.modules if m in ("jax", "rapidcfd_tpu")
         or m.startswith(("jax.", "rapidcfd_tpu."))}}
print("NEW_FOREIGN_MODULES", sorted(after - before))
"""
    env = dict(os.environ, PYTHONPATH=_REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NEW_FOREIGN_MODULES []" in res.stdout
    assert os.path.isfile(tmp_path / "chan" / "2" / "U.gz")
