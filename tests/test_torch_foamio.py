"""The port's binary and gzip IO against the JAX package's, on the CPU in
fp64: the polyMesh (pitzDaily x1 and the 20x20 cavity) and field files.

- Each package reads what the other writes, in binary and in ascii,
  compressed or not: points, faces, owner and neighbour come back
  bit-identical to the mesh written (binary) or to the other package's
  read of the same file (ascii).
- The native parser (csrc/foamio.cpp) matches the numpy parse on every
  list of the ascii files.
- A binary file's `arch` entry sets its label and scalar widths: 64-bit
  labels and 32-bit scalars are read, a big-endian file is refused by
  name.
- Random (seeded) volScalarField and volVectorField values written by
  one package in binary and gzip are read back bit-identical by the
  other, in file order, on the gdia lattice and the ELL.
- An icoFoam run of the cavity written in binary and compressed writes
  the fields an ascii run at 17 digits writes, to 1e-15.
"""

import gzip
import os

import numpy as np
import pytest
import torch

from rapidcfd_tpu.fields import io as jio
from rapidcfd_tpu.mesh import polymesh as jpoly
from rapidcfd_tpu.solvers.case import Case as JCase
from rapidcfd_tpu.utils import switches
from rapidcfd_tpu_torch.fields import io as tio
from rapidcfd_tpu_torch.mesh import polymesh as tpoly
from rapidcfd_tpu_torch.solvers import icofoam
from rapidcfd_tpu_torch.solvers.case import Case
from rapidcfd_tpu_torch.utils import foambin, foamio_native
from rapidcfd_tpu_torch.utils.casegen import (cavity_case,
                                              pitz_daily_ico_case)
from rapidcfd_tpu_torch.utils.logging import captured

CPU = torch.device("cpu")
F64 = torch.float64
_KEYS = ("face_points", "face_offsets", "owner", "neighbour")
_WRITERS = {"pitzDaily": lambda d: pitz_daily_ico_case(d, scale=1),
            "cavity20": lambda d: cavity_case(d, n=20)}


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """{name: (case dir, the PolyMesh written)} of both ascii cases."""
    out = {}
    for name, writer in _WRITERS.items():
        d = str(tmp_path_factory.mktemp(name))
        with captured():
            writer(d)
        out[name] = (d, tpoly.read_polymesh(d))
    return out


def _same_mesh(a, b, exact_points=True):
    for k in _KEYS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    if exact_points:
        np.testing.assert_array_equal(a.points, b.points)
    assert [(p.name, p.type, p.start_face, p.n_faces) for p in a.patches] \
        == [(p.name, p.type, p.start_face, p.n_faces) for p in b.patches]


@pytest.mark.parametrize("name", sorted(_WRITERS))
@pytest.mark.parametrize("fmt,compress", [("binary", False),
                                          ("binary", True),
                                          ("ascii", True)])
def test_polymesh_both_ways(cases, tmp_path, name, fmt, compress):
    _, mesh = cases[name]
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    tpoly.write_polymesh(mesh, port_dir, fmt=fmt, compress=compress)
    jpoly.write_polymesh(jpoly.PolyMesh(
        mesh.points, mesh.face_points, mesh.face_offsets, mesh.owner,
        mesh.neighbour, [jpoly.BoundaryPatch(p.name, p.type, p.start_face,
                                             p.n_faces)
                         for p in mesh.patches]),
        jax_dir, fmt=fmt, compress=compress)
    suffix = ".gz" if compress else ""
    assert os.path.isfile(os.path.join(port_dir, "constant", "polyMesh",
                                       "faces" + suffix))
    with captured():
        jax_of_port = jpoly.read_polymesh(port_dir)
        port_of_jax = tpoly.read_polymesh(jax_dir)
        port_of_port = tpoly.read_polymesh(port_dir)
    binary = fmt == "binary"
    _same_mesh(port_of_jax, mesh, exact_points=binary)
    _same_mesh(jax_of_port, mesh, exact_points=binary)
    # ascii points go through 12 digits: each package parses the other's
    # file to the same doubles
    np.testing.assert_array_equal(port_of_port.points, jax_of_port.points)
    np.testing.assert_array_equal(port_of_jax.points,
                                  jpoly.read_polymesh(jax_dir).points)


@pytest.mark.parametrize("name", sorted(_WRITERS))
def test_native_parser_matches_numpy(cases, name):
    d, _ = cases[name]
    assert foamio_native.parser_status() == "native"
    pm = os.path.join(d, "constant", "polyMesh")
    for fname, parse in (("points", lambda b, nat: tpoly._parse_scalar_list(
                              b, 3, nat)),
                         ("owner", tpoly._parse_label_list),
                         ("neighbour", tpoly._parse_label_list),
                         ("faces", tpoly._parse_face_list)):
        with open(os.path.join(pm, fname), encoding="latin-1") as f:
            body = tpoly._strip_header(f.read())[1]
        native, plain = parse(body, True), parse(body, False)
        for a, b in zip(native if isinstance(native, tuple) else (native,),
                        plain if isinstance(plain, tuple) else (plain,)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    # a malformed body is left to the numpy parse, by name in the log,
    # which raises
    assert foamio_native.parse_labels("3 ( 1 x 2 )", 3) is None
    with captured() as log, pytest.raises(ValueError):
        tpoly._parse_label_list("3 ( 1 x 2 )", name="owner")
    assert ("polyMesh owner: the native parser did not read 3 labels"
            in log.getvalue())


def _binary_labels(path, values, width, arch):
    hdr = (f'FoamFile\n{{\n    version 2.0;\n    format binary;\n'
           f'    arch "{arch}";\n    class labelList;\n'
           f'    object owner;\n}}\n').encode()
    a = np.asarray(values, dtype=f"<i{width}")
    with open(path, "wb") as f:
        f.write(hdr + b"\n%d\n(" % a.size + a.tobytes() + b")\n")


@pytest.mark.parametrize("label,scalar", [(64, 64), (32, 32), (64, 32)])
def test_arch_widths(tmp_path, label, scalar):
    """A binary file is read at its arch's label and scalar widths."""
    arch = f"LSB;label={label};scalar={scalar}"
    lab = np.array([0, 7, 2 ** 20, 3], np.int64)
    _binary_labels(str(tmp_path / "owner"), lab, label // 8, arch)
    np.testing.assert_array_equal(tpoly._read_labels(str(tmp_path / "owner")),
                                  lab)
    pts = np.arange(12, dtype=np.float64).reshape(4, 3) / 8.0
    hdr = (f'FoamFile\n{{\n    format binary;\n    arch "{arch}";\n'
           f'    class vectorField;\n    object points;\n}}\n').encode()
    raw = pts.astype(f"<f{scalar // 8}").tobytes()
    with open(tmp_path / "points", "wb") as f:
        f.write(hdr + b"\n4\n(" + raw + b")\n")
    np.testing.assert_array_equal(tpoly._read_points(str(tmp_path /
                                                         "points")), pts)
    # a field file's nonuniform list at the same widths
    field = (f'FoamFile\n{{\n    format binary;\n    arch "{arch}";\n'
             f'    class volScalarField;\n    object p;\n}}\n'
             f'internalField nonuniform List<scalar> 4 (').encode() \
        + pts[:, 0].astype(f"<f{scalar // 8}").tobytes() + b");\n"
    text, stash = foambin.decode_binary_dict(field)
    np.testing.assert_array_equal(np.asarray(stash["__bin0__"], float),
                                  pts[:, 0])


def test_arch_big_endian_refused(tmp_path):
    _binary_labels(str(tmp_path / "owner"), [1, 2], 4,
                   "MSB;label=32;scalar=64")
    with pytest.raises(NotImplementedError, match="MSB"):
        tpoly._read_labels(str(tmp_path / "owner"))
    _binary_labels(str(tmp_path / "owner"), [1, 2], 4,
                   "LSB;label=16;scalar=64")
    with pytest.raises(NotImplementedError, match="label=16"):
        tpoly._read_labels(str(tmp_path / "owner"))


@pytest.fixture
def jax_ell():
    """The JAX package on its ELL layout (RCFD_GDIA_AUTO=0)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RCFD_GDIA_AUTO", "0")
        switches._CACHE.pop("GDIA_AUTO", None)
        try:
            yield
        finally:
            switches._CACHE.pop("GDIA_AUTO", None)


@pytest.mark.parametrize("name", sorted(_WRITERS))
@pytest.mark.parametrize("gdia", [True, False], ids=["gdia", "ell"])
@pytest.mark.parametrize("compress", [False, True])
def test_fields_both_ways(cases, tmp_path, jax_ell, name, gdia, compress):
    src, _ = cases[name]
    with captured():
        case = Case(src, device=CPU, dtype=F64, gdia_auto=gdia)
        jcase = JCase(src)
    assert (case.mesh.gdia is not None) == (gdia and name == "pitzDaily")
    rng = np.random.default_rng(hash((name, gdia, compress)) % 2 ** 32)
    out = str(tmp_path)
    for fname in ("p", "U"):
        with captured():
            tf = case.read_field(fname)
            jf = jcase.read_field(fname)
        n = case.maps.n_file_cells
        vals = rng.standard_normal((n,) + tuple(tf.data.shape[1:]))
        tf = tf.replace(data=torch.as_tensor(case.maps.cells_to_device(vals)))
        jf = jf.replace(data=jf.data.at[:].set(
            jcase.maps.cells_to_device(vals)))
        tio.write_vol_field(tf, out, "port", case.mesh, case.maps,
                            fmt="binary", compress=compress)
        jio.write_vol_field(jf, out, "jax", jcase.mesh, jcase.maps,
                            fmt="binary", compress=compress)
        gz = ".gz" if compress else ""
        assert os.path.isfile(os.path.join(out, "port", fname + gz))
        if compress:
            with gzip.open(os.path.join(out, "port", fname + gz)) as f:
                assert foambin.is_binary(f.read(2048))
        with captured():
            back = tio.read_vol_field(out, "jax", fname, case.mesh,
                                      case.maps)
            jback = jio.read_vol_field(out, "port", fname, jcase.mesh,
                                       jcase.maps)
        np.testing.assert_array_equal(
            case.maps.cells_to_file(back.data.numpy()), vals)
        np.testing.assert_array_equal(
            jcase.maps.cells_to_file(np.asarray(jback.data)), vals)
        # the boundary values come back as each package evaluates them
        np.testing.assert_array_equal(back.bvalues.numpy(),
                                      tf.correct_boundary_conditions(
                                          case.mesh).bvalues.numpy())


def test_binary_run_writes_the_ascii_run(tmp_path):
    """icoFoam on the 20x20 cavity, 3 steps written every step, once with
    writeFormat ascii at writePrecision 17 and once binary compressed:
    U, p and phi read back the same to 1e-15."""
    runs = {}
    for fmt in ("ascii", "binary"):
        d = str(tmp_path / fmt)
        with captured():
            cavity_case(d, n=20)
        cd = os.path.join(d, "system", "controlDict")
        with open(cd) as f:
            text = f.read()
        text = text.replace("writeFormat     ascii;", "")
        extra = ("\nwriteFormat ascii;\nwritePrecision 17;\n"
                 if fmt == "ascii" else
                 "\nwriteFormat binary;\nwriteCompression compressed;\n")
        import re
        text = re.sub(r"writePrecision\s+\d+;", "", text)
        text = re.sub(r"writeInterval\s+[^;]+;", "writeInterval 1;", text)
        text = re.sub(r"writeControl\s+[^;]+;", "writeControl timeStep;",
                      text)
        with open(cd, "w") as f:
            f.write(text + extra)
        with captured():
            case, U, p, phi = icofoam.run(d, device=CPU, dtype=F64,
                                          max_steps=3)
        t = case.time.name
        if fmt == "binary":
            assert os.path.isfile(os.path.join(d, t, "U.gz"))
            assert os.path.isfile(os.path.join(d, t, "phi.gz"))
        with captured():
            runs[fmt] = (case.read_field("U", t).data,
                         case.read_field("p", t).data,
                         tio.read_surface_field(d, t, "phi", case.mesh,
                                                case.maps).data)
    for a, b in zip(runs["ascii"], runs["binary"]):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-15 * max(scale, 1.0)
