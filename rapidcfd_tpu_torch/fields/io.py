"""Field file IO: read/write `<time>/<field>` in OpenFOAM ascii format
(port of rapidcfd_tpu/fields/io.py). Files hold file-order cells and
faces; MeshMaps translates to and from the device layout. Binary and
compressed field files are not ported yet."""

from __future__ import annotations

import os

import numpy as np
import torch

from rapidcfd_tpu.utils.dictionary import foamfile_header, parse_file
from rapidcfd_tpu.utils.dimensions import DimensionSet

from ..mesh.mesharrays import MeshArrays, MeshMaps
from .bcs import Calculated, make_bc
from .field import SurfaceField, VolField

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def _parse_value(entry, n: int, npdt):
    """Parse `uniform v`, `uniform (x y z)`, `nonuniform List<T> N (...)`
    into a numpy array of n entries."""
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
                raise NotImplementedError("binary field files are not "
                                          "supported by the port yet")
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
    dims = d.lookup("dimensions", required=True)
    if not isinstance(dims, DimensionSet):
        raise ValueError(f"{name}: dimensions entry is not a dimension set")
    data = _parse_value(d.lookup("internalField", required=True),
                        maps.n_file_cells, npdt)
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
        bd = {}
        if pd.lookup("value") is not None:
            v = _parse_value(pd.lookup("value"), patch.size, npdt)
            bd["value"] = torch.as_tensor(v, device=mesh.device)
            bvalues[patch.bstart:patch.bstart + patch.size] = v
        bcdata.append(bd)

    f = VolField(torch.as_tensor(data, device=mesh.device),
                 torch.as_tensor(bvalues, device=mesh.device), tuple(bcs),
                 dims, name, tuple(bcdata))
    return f.correct_boundary_conditions(mesh)


def _fmt_scalar(v: float, prec: int = 8) -> str:
    return f"{v:.{prec}g}"


def _body_value(arr: np.ndarray, prec: int = 8) -> str:
    if arr.ndim == 1:
        if arr.size and np.all(arr == arr[0]):
            return f"uniform {_fmt_scalar(float(arr[0]), prec)}"
        body = "\n".join(_fmt_scalar(float(v), prec) for v in arr)
        return f"nonuniform List<scalar>\n{arr.shape[0]}\n(\n{body}\n)"
    comp = "vector" if arr.shape[1] == 3 else f"Type{arr.shape[1]}"
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


def _emit(path: str, parts):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="latin-1") as f:
        f.write("".join(parts))


def write_vol_field(field: VolField, case_dir: str, time: str,
                    mesh: MeshArrays, maps: MeshMaps, prec: int = 8):
    """Write a VolField in file cell order (ascii)."""
    cls = "volScalarField" if field.data.dim() == 1 else "volVectorField"
    data = maps.cells_to_file(field.data.detach().cpu().numpy())
    lines = [foamfile_header(cls, field.name, time),
             f"\ndimensions      {_dims_str(field.dims)};\n\n",
             "internalField   ", _body_value(data, prec),
             ";\n\n", "boundaryField\n{\n"]
    bvals = field.bvalues.detach().cpu().numpy()
    for bc, bd in zip(field.bcs, field.bcdata):
        patch = mesh.patches[bc.patch]
        lines.append(f"    {patch.name}\n    {{\n"
                     f"        type            {bc.word};\n")
        if isinstance(bc, Calculated) or "value" in bd:
            pb = bvals[patch.bstart:patch.bstart + patch.size]
            lines += ["        value           ", _body_value(pb, prec),
                      ";\n"]
        lines.append("    }\n")
    lines.append("}\n")
    _emit(os.path.join(case_dir, time, field.name), lines)


def write_surface_field(sf: SurfaceField, case_dir: str, time: str,
                        mesh: MeshArrays, maps: MeshMaps, prec: int = 8):
    """Write a SurfaceField (e.g. phi) as a surfaceScalarField file in
    file face order (padded dummy faces are dropped)."""
    data = maps.faces_to_file(sf.data.detach().cpu().numpy())
    n_int = maps.n_file_faces - mesh.n_boundary
    lines = [foamfile_header("surfaceScalarField", sf.name or "phi", time),
             f"\ndimensions      {_dims_str(sf.dims)};\n\n",
             "internalField   ", _body_value(data[:n_int], prec),
             ";\n\n", "boundaryField\n{\n"]
    for patch in mesh.patches:
        start = n_int + patch.bstart
        pb = data[start:start + patch.size]
        lines += [f"    {patch.name}\n    {{\n"
                  "        type            calculated;\n"
                  "        value           ", _body_value(pb, prec),
                  ";\n    }\n"]
    lines.append("}\n")
    _emit(os.path.join(case_dir, time, sf.name or "phi"), lines)


def read_surface_field(case_dir: str, time: str, name: str,
                       mesh: MeshArrays, maps: MeshMaps) -> SurfaceField:
    """Read a surfaceScalarField written by write_surface_field (or the
    reference): internal values + per-patch boundary values."""
    npdt = _NP_DTYPE[mesh.dtype]
    d = parse_file(os.path.join(case_dir, time, name))
    dims = d.lookup("dimensions", required=True)
    n_int = maps.n_file_faces - mesh.n_boundary
    data = np.zeros(maps.n_file_faces, npdt)
    data[:n_int] = _parse_value(d.lookup("internalField", required=True),
                                n_int, npdt)
    bfield = d.subdict("boundaryField")
    for patch in mesh.patches:
        pd = bfield.lookup(patch.name)
        if pd is None or pd.lookup("value") is None:
            continue
        start = n_int + patch.bstart
        data[start:start + patch.size] = _parse_value(
            pd.lookup("value"), patch.size, npdt)
    return SurfaceField(torch.as_tensor(maps.faces_to_device(data),
                                        device=mesh.device), dims, name)
