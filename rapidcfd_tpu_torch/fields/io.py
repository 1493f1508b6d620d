"""Field file IO: read/write `<time>/<field>` in OpenFOAM format (port of
rapidcfd_tpu/fields/io.py). Files hold file-order cells and faces; MeshMaps
translates to and from the device layout. Reads ascii and binary files,
gzip-compressed or not (binary payloads through utils/foambin's
decode_binary_dict); writes either format, compressed or not: a binary file
holds every nonuniform list as raw doubles, whatever the run's precision,
as the JAX package writes them."""

from __future__ import annotations

import gzip
import os

import numpy as np
import torch

from ..utils import foambin
from ..utils.dictionary import foamfile_header, parse_file
from ..utils.dimensions import DimensionSet

from ..mesh.mesharrays import MeshArrays, MeshMaps
from ..mesh.polymesh import BINARY_ARCH, GZIP_LEVEL
from .bcs import Calculated, make_bc
from .field import SurfaceField, VolField

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}

#: per-face boundary-condition entries, broadcast to the patch size (the
#: JAX package's _BC_DATA_KEYS, rapidcfd_tpu/fields/io.py:25, and
#: turbulentInlet's referenceField, a field in the reference, which the JAX
#: package does not capture and takes `value` for)
_BC_DATA_KEYS = ("value", "gradient", "refValue", "refGradient",
                 "valueFraction", "inletValue", "outletValue", "p0",
                 "volumetricFlowRate", "uniformValue", "freestreamValue",
                 "emissivity", "jump", "referenceField")

#: yes/no words kept as 0/1 scalars (the JAX package's _BC_SWITCH_KEYS,
#: rapidcfd_tpu/fields/io.py:31): SRFVelocity's `relative`
_BC_SWITCH_KEYS = ("relative", "setAverage")

#: entries that are configuration words, not data
_BC_WORD_KEYS = ("type", "mode", "patchType", "neighbourPatch",
                 "fieldName", "sampleMode", "samplePatch", "sampleRegion",
                 "offsetMode", "interpolationScheme", "direction")

#: the jump family's curve entries, read by _capture_jump_table
_JUMP_KEYS = ("jumpTable", "fileName")
_JUMP_TABLE_TYPES = ("fan", "fanPressure", "uniformJump", "uniformJumpAMI")


def _read_foam_table(path: str):
    """(x, y) of an OpenFOAM table file `((x y) ...)`, comments allowed
    (rapidcfd_tpu/utils/function1.py:74-89)."""
    import re
    with open(path) as fh:
        text = re.sub(r"//[^\n]*|/\*.*?\*/", " ", fh.read(), flags=re.S)
    vals = np.array([float(x) for x in re.findall(r"[-+0-9.eE]+", text)])
    rows = text.count("(") - 1
    if rows <= 0 or vals.size % rows:
        raise ValueError(f"{path}: malformed table")
    arr = vals.reshape(rows, vals.size // rows)
    return arr[:, 0], (arr[:, 1] if arr.shape[1] == 2 else arr[:, 1:])


def _capture_jump_table(pd, bd: dict, npdt, case_dir: str):
    """A fan or uniformJump jumpTable (constant, table or polynomial) or
    a fanPressure fileName table as bd's jump_const, jump_times/
    jump_values or jump_poly (rapidcfd_tpu/fields/io.py:69-99)."""
    e = pd.lookup("jumpTable")
    if isinstance(e, tuple) and len(e) >= 2:
        kind = e[0]
        if kind == "constant":
            bd["jump_const"] = np.asarray(float(e[1]), npdt)
        elif kind == "table":
            bd["jump_times"] = np.asarray([r[0] for r in e[1]], npdt)
            bd["jump_values"] = np.asarray([r[1] for r in e[1]], npdt)
        elif kind == "polynomial":
            bd["jump_poly"] = np.asarray(e[1], npdt)
        else:
            raise NotImplementedError(
                f"jumpTable DataEntry type '{kind}' is not supported "
                "(constant, table or polynomial)")
    elif isinstance(e, (int, float)):
        bd["jump_const"] = np.asarray(float(e), npdt)
    fn = pd.lookup("fileName")
    if fn is not None and "jump_times" not in bd:
        path = str(fn).strip('"').replace("$FOAM_CASE", case_dir)
        if not os.path.isabs(path):
            path = os.path.join(case_dir, "constant", path)
        x, y = _read_foam_table(path)
        bd["jump_times"] = np.ascontiguousarray(x, npdt)
        bd["jump_values"] = np.ascontiguousarray(y, npdt)


def _boundary_data(pd, size: int, npdt, stash=None) -> dict:
    """A patch dictionary's numeric entries as numpy arrays: the
    per-face keys at the patch size, every other number or vector as it
    stands (intensity, mixingLength, ...). A tabulated entry (a
    uniformTotalPressure's p0 table, say) raises: the JAX package
    evaluates none (it keeps a table as raw data only,
    rapidcfd_tpu/fields/io.py:58-65)."""
    bd = {}
    for key in pd:
        entry = pd.lookup(key)
        if key in _BC_WORD_KEYS or key in _JUMP_KEYS:
            continue
        if key in _BC_SWITCH_KEYS:
            bd[key] = np.asarray(1.0 if pd.word(key) in ("yes", "true", "on",
                                                       "1") else 0.0, npdt)
            continue
        if isinstance(entry, tuple) and entry and entry[0] == "table":
            raise NotImplementedError(
                f"tabulated boundary entry '{key}' ({pd.word('type')}): "
                "a table is evaluated by neither package")
        if key == "value":
            bd[key] = _parse_value(entry, size, npdt, stash)
        elif key in _BC_DATA_KEYS:
            try:
                bd[key] = _parse_value(entry, size, npdt, stash)
            except (ValueError, TypeError):
                continue
        elif isinstance(entry, (int, float)) and not isinstance(entry, bool):
            bd[key] = np.asarray(float(entry), npdt)
        elif isinstance(entry, list):
            try:
                bd[key] = np.asarray(entry, npdt)
            except (TypeError, ValueError):
                continue
    return bd


def _parse_value(entry, n: int, npdt, stash=None):
    """Parse `uniform v`, `uniform (x y z)`, `nonuniform List<T> N (...)`
    into a numpy array of n entries. A binary file holds a `__binK__`
    placeholder word where its payload was; stash (the parsed file's
    binstash) resolves it."""
    if isinstance(entry, (int, float)):
        return np.full((n,), float(entry), npdt)
    if isinstance(entry, tuple):
        items = list(entry)
        if items[0] == "uniform":
            v = items[1]
            if isinstance(v, list):
                return np.broadcast_to(np.asarray(v, npdt),
                                       (n, len(v))).copy()
            return np.full((n,), float(v), npdt)
        if items[0] == "nonuniform":
            payload = items[-1]
            if isinstance(payload, str):
                if stash is None or payload not in stash:
                    raise ValueError(f"nonuniform payload {payload!r} "
                                     "without its binary block")
                payload = stash[payload]
            if isinstance(payload, int):    # `nonuniform List<scalar> 0 ()`
                payload = []
            arr = np.asarray(payload, dtype=float)
            if arr.ndim == 0:
                arr = arr.reshape(0)
            if arr.shape[0] != n:
                raise ValueError(f"nonuniform field has {arr.shape[0]} "
                                 f"entries, expected {n}")
            return arr.astype(npdt)
    if isinstance(entry, list):
        return np.broadcast_to(np.asarray(entry, npdt),
                               (n, len(entry))).copy()
    raise ValueError(f"cannot parse field value: {entry!r}")


def read_vol_field(case_dir: str, time: str, name: str, mesh: MeshArrays,
                   maps: MeshMaps) -> VolField:
    """Read a volScalarField/volVectorField onto the mesh's device and
    dtype, then evaluate its boundary conditions."""
    npdt = _NP_DTYPE[mesh.dtype]
    d = parse_file(os.path.join(case_dir, time, name))
    stash = getattr(d, "binstash", None)
    dims = d.lookup("dimensions", required=True)
    if not isinstance(dims, DimensionSet):
        raise ValueError(f"{name}: dimensions entry is not a dimension set")
    data = _parse_value(d.lookup("internalField", required=True),
                        maps.n_file_cells, npdt, stash)
    data = maps.cells_to_device(data)

    bfield = d.subdict("boundaryField")
    bcs, bcdata = [], []
    bvalues = np.zeros((mesh.n_boundary,) + data.shape[1:], npdt)
    for i, patch in enumerate(mesh.patches):
        pd = bfield.lookup(patch.name)
        if pd is None:
            raise KeyError(f"field {name}: no boundaryField entry for "
                           f"patch '{patch.name}'")
        bcs.append(make_bc(pd.word("type"), i, pd))
        bd = _boundary_data(pd, patch.size, npdt, stash)
        if pd.word("type") in _JUMP_TABLE_TYPES:
            _capture_jump_table(pd, bd, npdt, case_dir)
        if "value" in bd:
            bvalues[patch.bstart:patch.bstart + patch.size] = \
                np.broadcast_to(bd["value"], (patch.size,) + data.shape[1:])
        bcdata.append({k: torch.as_tensor(v, device=mesh.device)
                       for k, v in bd.items()})

    f = VolField(torch.as_tensor(data, device=mesh.device),
                 torch.as_tensor(bvalues, device=mesh.device), tuple(bcs),
                 dims, name, tuple(bcdata))
    return f.correct_boundary_conditions(mesh)


#: the List<T> word and the field class of each component count
_COMP = {3: "vector", 6: "symmTensor", 9: "tensor"}
_VOL_CLASS = {1: "volScalarField", 3: "volVectorField",
              6: "volSymmTensorField", 9: "volTensorField"}


def _fmt_scalar(v: float, prec: int = 8) -> str:
    return f"{v:.{prec}g}"


def _body_value(arr: np.ndarray, prec: int = 8, binary: bool = False):
    """The value of an entry: `uniform ...`, or a nonuniform list (ascii
    text, or under binary an ascii prefix and a raw-double block, even
    where the values are uniform, as the JAX package writes them)."""
    if binary and arr.size:
        comp = "scalar" if arr.ndim == 1 else _COMP[arr.shape[1]]
        return (f"nonuniform List<{comp}>".encode("latin-1")
                + foambin.fmt_list(arr))
    if arr.ndim == 1:
        if arr.size and np.all(arr == arr[0]):
            return f"uniform {_fmt_scalar(float(arr[0]), prec)}"
        body = "\n".join(_fmt_scalar(float(v), prec) for v in arr)
        return f"nonuniform List<scalar>\n{arr.shape[0]}\n(\n{body}\n)"
    comp = _COMP[arr.shape[1]]
    if arr.size and np.all(arr == arr[0]):
        return ("uniform ("
                + " ".join(_fmt_scalar(float(v), prec) for v in arr[0]) + ")")
    rows = "\n".join(
        "(" + " ".join(_fmt_scalar(float(v), prec) for v in row) + ")"
        for row in arr)
    return f"nonuniform List<{comp}>\n{arr.shape[0]}\n(\n{rows}\n)"


def _dims_str(dims: DimensionSet) -> str:
    return "[" + " ".join(str(int(e)) if e.denominator == 1 else str(float(e))
                          for e in dims.as_tuple()) + "]"


def _header(cls: str, name: str, time: str, fmt: str) -> str:
    if fmt not in ("ascii", "binary"):
        raise ValueError(f"writeFormat '{fmt}' (ascii or binary)")
    return foamfile_header(cls, name, time, fmt=fmt,
                           arch=BINARY_ARCH if fmt == "binary" else "")


def _emit(path: str, parts, compress: bool = False):
    """Join the str/bytes parts and write them, gzipped to <path>.gz under
    compress (`writeCompression compressed`); the other form of the file
    is removed."""
    payload = b"".join(p if isinstance(p, bytes) else p.encode("latin-1")
                       for p in parts)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if compress:
        with gzip.open(path + ".gz", "wb",
                       compresslevel=GZIP_LEVEL) as f:
            f.write(payload)
        stale = path
    else:
        with open(path, "wb") as f:
            f.write(payload)
        stale = path + ".gz"
    if os.path.isfile(stale):
        os.remove(stale)


def write_vol_field(field: VolField, case_dir: str, time: str,
                    mesh: MeshArrays, maps: MeshMaps, prec: int = 8,
                    fmt: str = "ascii", compress: bool = False):
    """Write a VolField in file cell order; fmt='binary' writes every
    nonuniform list as a raw-double block, compress gzips the file."""
    binary = fmt == "binary"
    cls = _VOL_CLASS[1 if field.data.dim() == 1 else field.data.shape[1]]
    data = maps.cells_to_file(field.data.detach().cpu().numpy())
    lines = [_header(cls, field.name, time, fmt),
             f"\ndimensions      {_dims_str(field.dims)};\n\n",
             "internalField   ", _body_value(data, prec, binary),
             ";\n\n", "boundaryField\n{\n"]
    bvals = field.bvalues.detach().cpu().numpy()
    by_name = {mesh.patches[bc.patch].name: (bc, bd)
               for bc, bd in zip(field.bcs, field.bcdata)}
    for name, ptype, _, _ in maps.file_layout(mesh.n_boundary,
                                               mesh.patches)[1]:
        if name not in by_name:
            # a merged cyclic patch: the reference's cyclic patch field
            # holds its type alone
            lines.append(f"    {name}\n    {{\n"
                         f"        type            {ptype};\n    }}\n")
            continue
        bc, bd = by_name[name]
        patch = mesh.patches[bc.patch]
        lines.append(f"    {patch.name}\n    {{\n"
                     f"        type            {bc.word};\n")
        if isinstance(bc, Calculated) or "value" in bd:
            pb = bvals[patch.bstart:patch.bstart + patch.size]
            lines += ["        value           ",
                      _body_value(pb, prec, binary), ";\n"]
        for key, v in bd.items():
            if key == "value" or key.startswith("jump_"):
                continue
            arr = v.detach().cpu().numpy()
            if arr.ndim == 0:
                body = _fmt_scalar(float(arr), prec)
            elif arr.ndim == 1 and arr.shape[0] == 3 and patch.size != 3:
                body = "(" + " ".join(_fmt_scalar(float(x), prec)
                                      for x in arr) + ")"
            else:
                body = _body_value(arr, prec, binary)
            lines += [f"        {key}           ", body, ";\n"]
        lines.append("    }\n")
    lines.append("}\n")
    _emit(os.path.join(case_dir, time, field.name), lines, compress)


def write_surface_field(sf: SurfaceField, case_dir: str, time: str,
                        mesh: MeshArrays, maps: MeshMaps, prec: int = 8,
                        fmt: str = "ascii", compress: bool = False):
    """Write a face flux (e.g. phi) as a surfaceScalarField file in file
    face order and orientation (padded dummy faces are dropped). Both
    sides of a merged cyclic pair are written, the B side's flux the
    negative of the A side's, under `type cyclic` as the reference writes
    them (the JAX package's write fails on a merged mesh: its face map
    indexes the file's faces into the merged mesh's)."""
    binary = fmt == "binary"
    data = maps.faces_to_file(sf.data.detach().cpu().numpy(), flux=True)
    n_int, layout = maps.file_layout(mesh.n_boundary, mesh.patches)
    merged = {p.name for p in mesh.patches}
    lines = [_header("surfaceScalarField", sf.name or "phi", time, fmt),
             f"\ndimensions      {_dims_str(sf.dims)};\n\n",
             "internalField   ", _body_value(data[:n_int], prec, binary),
             ";\n\n", "boundaryField\n{\n"]
    for name, ptype, start, size in layout:
        pb = data[start:start + size]
        word = "calculated" if name in merged else ptype
        lines += [f"    {name}\n    {{\n"
                  f"        type            {word};\n"
                  "        value           ", _body_value(pb, prec, binary),
                  ";\n    }\n"]
    lines.append("}\n")
    _emit(os.path.join(case_dir, time, sf.name or "phi"), lines, compress)


def read_surface_field(case_dir: str, time: str, name: str,
                       mesh: MeshArrays, maps: MeshMaps) -> SurfaceField:
    """Read a face flux written by write_surface_field (or the
    reference): internal values + per-patch boundary values, turned to
    the device orientation."""
    npdt = _NP_DTYPE[mesh.dtype]
    d = parse_file(os.path.join(case_dir, time, name))
    stash = getattr(d, "binstash", None)
    dims = d.lookup("dimensions", required=True)
    n_int, layout = maps.file_layout(mesh.n_boundary, mesh.patches)
    data = np.zeros(maps.n_file_faces, npdt)
    data[:n_int] = _parse_value(d.lookup("internalField", required=True),
                                n_int, npdt, stash)
    bfield = d.subdict("boundaryField")
    for name, _, start, size in layout:
        pd = bfield.lookup(name)
        if pd is None or pd.lookup("value") is None:
            continue
        data[start:start + size] = _parse_value(pd.lookup("value"), size,
                                                npdt, stash)
    return SurfaceField(torch.as_tensor(maps.faces_to_device(data, flux=True),
                                        device=mesh.device), dims, name)
