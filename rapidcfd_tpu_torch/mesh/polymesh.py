"""polyMesh reader/writer: constant/polyMesh/{points,faces,owner,neighbour,
boundary}, and the faceZones reader — a numpy copy of
rapidcfd_tpu/mesh/polymesh.py. Reads ascii, binary and gzip-compressed
files (binary payloads by utils/foambin, at the widths of the `arch`
header entry); writes ascii or binary, compressed or not. Ascii lists are
parsed by the native parser (utils/foamio_native, csrc/foamio.cpp) when it
builds, else by numpy; read_polymesh logs which."""

from __future__ import annotations

import gzip
import os
import re
from dataclasses import dataclass, field

import numpy as np

from ..utils import foambin, foamio_native
from ..utils.dictionary import (Dictionary, foamfile_header,
                                           parse_dictionary)
from ..utils.logging import info


def _read_text(path: str) -> str:
    """An ascii dictionary file (boundary, faceZones), gzip or not."""
    return foambin.read_raw(path).decode("latin-1")


def _strip_header(text: str) -> tuple[Dictionary, str]:
    """Split off the FoamFile header dict, return (header, body_text)."""
    m = re.search(r"FoamFile\s*\{", text)
    if not m:
        return Dictionary(), text
    depth = 1
    i = m.end()
    while depth and i < len(text):
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
        i += 1
    header = parse_dictionary(text[m.start():i].replace("FoamFile", "", 1)
                              .strip().strip("{}").join(["{", "}"]))
    return header, text[i:]


_COMMENT_RE = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)


def _strip_comments(text: str) -> str:
    return _COMMENT_RE.sub(" ", text)


def _list_body(body: str) -> tuple[int, str]:
    body = _strip_comments(body)
    m = re.search(r"(\d+)\s*\(", body)
    if not m:
        raise ValueError("cannot find list count")
    return int(m.group(1)), body[m.end():body.rfind(")")]


def _native_missed(name: str, what: str) -> None:
    """Say by name that a list the native parser could not read goes to
    the numpy parse (silent only when the library is unavailable, which
    read_polymesh logs once)."""
    if foamio_native.get_lib() is not None:
        info(f"polyMesh {name}: the native parser did not read {what}; "
             "numpy parse")


def _parse_scalar_list(body: str, ncols: int, native: bool = True,
                       name: str = "list") -> np.ndarray:
    """`N ( (x y z) ... )` or `N ( v ... )` -> (N, ncols) / (N,) array;
    native=False takes the numpy parse."""
    n, data = _list_body(body)
    arr = foamio_native.parse_scalars(data, n * ncols) if native else None
    if arr is None:
        if native:
            _native_missed(name, f"{n * ncols} scalars")
        arr = np.array(data.replace("(", " ").replace(")", " ").split(),
                       dtype=np.float64)
    if arr.size != n * ncols:
        raise ValueError(f"expected {n * ncols} values, got {arr.size}")
    return arr.reshape(n, ncols) if ncols > 1 else arr


def _parse_label_list(body: str, native: bool = True,
                      name: str = "list") -> np.ndarray:
    n, data = _list_body(body)
    arr = foamio_native.parse_labels(data, n) if native else None
    if arr is None:
        if native:
            _native_missed(name, f"{n} labels")
        arr = np.array(data.split(), dtype=np.int64)
    if arr.shape[0] != n:
        raise ValueError(f"expected {n} labels, got {arr.shape[0]}")
    return arr


_FACE_RE = re.compile(r"(\d+)\s*\(([^)]*)\)")


def _parse_face_list(body: str, native: bool = True, name: str = "faces"
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Parse faces `N ( 4(a b c d) ... )` -> (flat_points, offsets)."""
    n, chunk = _list_body(body)
    got = foamio_native.parse_faces(chunk, n) if native else None
    if got is not None:
        return got
    if native:
        _native_missed(name, f"{n} faces")
    sizes = np.empty(n, dtype=np.int64)
    flats = []
    for i, fm in enumerate(_FACE_RE.finditer(chunk)):
        if i >= n:
            raise ValueError(f"more than {n} faces")
        sizes[i] = int(fm.group(1))
        flats.append(fm.group(2))
    if len(flats) != n:
        raise ValueError(f"expected {n} faces, parsed {len(flats)}")
    flat = np.array(" ".join(flats).split(), dtype=np.int64)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(sizes, out=offsets[1:])
    if flat.shape[0] != offsets[-1]:
        raise ValueError("face point count mismatch")
    return flat, offsets


@dataclass
class BoundaryPatch:
    name: str
    type: str
    start_face: int
    n_faces: int
    extra: Dictionary = field(default_factory=Dictionary)


@dataclass
class PolyMesh:
    """Raw mesh topology as read from disk (host, numpy)."""
    points: np.ndarray          # (nPoints, 3) float64
    face_points: np.ndarray     # flat point labels
    face_offsets: np.ndarray    # (nFaces+1,)
    owner: np.ndarray           # (nFaces,)
    neighbour: np.ndarray       # (nInternalFaces,)
    patches: list[BoundaryPatch]

    @property
    def n_points(self):
        return self.points.shape[0]

    @property
    def n_faces(self):
        return self.face_offsets.shape[0] - 1

    @property
    def n_internal_faces(self):
        return self.neighbour.shape[0]

    @property
    def n_cells(self):
        return int(self.owner.max()) + 1 if self.owner.size else 0

    def face(self, i: int) -> np.ndarray:
        return self.face_points[self.face_offsets[i]:self.face_offsets[i + 1]]


def _bin_header_end(raw: bytes) -> int:
    i = raw.find(b"FoamFile")
    return raw.find(b"}", i) + 1


def _bin_class(raw: bytes) -> str:
    m = re.search(rb"class\s+(\w+)\s*;", raw[:2048])
    return m.group(1).decode() if m else ""


def _ascii_body(raw: bytes) -> str:
    return _strip_header(raw.decode("latin-1"))[1]


def _read_points(path: str) -> np.ndarray:
    raw = foambin.read_raw(path)
    if foambin.is_binary(raw):
        _, scalar_w = foambin.arch_widths(raw)
        pts, _ = foambin.scan_list(raw, _bin_header_end(raw), 3, "f",
                                   scalar_w)
        return np.asarray(pts, np.float64)
    return _parse_scalar_list(_ascii_body(raw), 3,
                              name=os.path.basename(path))


def _read_faces(path: str) -> tuple[np.ndarray, np.ndarray]:
    raw = foambin.read_raw(path)
    if foambin.is_binary(raw):
        # binary faces are a CompactIOList: the offsets labelList, then
        # the flattened labelList (reference: CompactIOList.C:operator<<)
        cls = _bin_class(raw)
        if "Compact" not in cls:
            raise NotImplementedError(
                f"binary faces class '{cls}': only faceCompactIOList "
                "(the reference's binary write format) is read")
        label_w, _ = foambin.arch_widths(raw)
        offsets, pos = foambin.scan_list(raw, _bin_header_end(raw), 1, "i",
                                         label_w)
        flat, _ = foambin.scan_list(raw, pos, 1, "i", label_w)
        return np.asarray(flat, np.int64), np.asarray(offsets, np.int64)
    return _parse_face_list(_ascii_body(raw))


def _read_labels(path: str) -> np.ndarray:
    raw = foambin.read_raw(path)
    if foambin.is_binary(raw):
        label_w, _ = foambin.arch_widths(raw)
        arr, _ = foambin.scan_list(raw, _bin_header_end(raw), 1, "i",
                                   label_w)
        return np.asarray(arr, np.int64)
    return _parse_label_list(_ascii_body(raw),
                             name=os.path.basename(path))


def read_polymesh(case_dir: str) -> PolyMesh:
    """Read constant/polyMesh. Logs the files' format and, for ascii, the
    parser that runs (and, by name, any list the native parser leaves to
    the numpy parse)."""
    d = os.path.join(case_dir, "constant", "polyMesh")
    raw = foambin.read_raw(os.path.join(d, "faces"))
    fmt = "binary" if foambin.is_binary(raw) else "ascii"
    if fmt == "ascii":
        fmt += ", " + foamio_native.parser_status()
    info(f"polyMesh: {fmt}\n")
    points = _read_points(os.path.join(d, "points"))
    face_points, face_offsets = _read_faces(os.path.join(d, "faces"))
    owner = _read_labels(os.path.join(d, "owner"))
    neighbour = _read_labels(os.path.join(d, "neighbour"))
    patches = _parse_boundary(_strip_header(_read_text(
        os.path.join(d, "boundary")))[1])
    return PolyMesh(points, face_points, face_offsets, owner, neighbour,
                    patches)


def _parse_boundary(body: str) -> list[BoundaryPatch]:
    n, inner = _list_body(body)
    d = parse_dictionary(inner)
    patches = []
    for name, sub in d.items():
        if not isinstance(sub, Dictionary):
            continue
        typ = sub.word("type")
        if typ in CYCLIC_ALIASES:
            # cyclicSlip (reference: cyclicSlipFvPatchField.H:31-33, its
            # slip part acts on point motion only) and
            # nonuniformTransformCyclic (per-face transforms, resolved
            # geometrically by the merge) are cyclics; the spelling is
            # kept for the write-back
            sub["_originalType"] = typ
            typ = "cyclic"
        patches.append(BoundaryPatch(
            name=str(name),
            type=typ,
            start_face=int(sub.scalar("startFace")),
            n_faces=int(sub.scalar("nFaces")),
            extra=sub,
        ))
    if len(patches) != n:
        raise ValueError(f"boundary: expected {n} patches, got {len(patches)}")
    return patches


#: boundary types read as `cyclic` and written back under their own name
CYCLIC_ALIASES = ("cyclicSlip", "nonuniformTransformCyclic")


def _num(x) -> str:
    """A number of a boundary entry, exactly (integers without a point)."""
    x = float(x)
    return str(int(x)) if x.is_integer() else repr(x)


#: the binary files' `arch` entry: the widths foambin.fmt_list writes
BINARY_ARCH = "LSB;label=32;scalar=64"
#: zlib's default level, that of the reference's gzstream (gzip.open's own
#: default, 9, takes several times as long on a million-cell mesh)
GZIP_LEVEL = 6


def write_polymesh(mesh: PolyMesh, case_dir: str, fmt: str = "ascii",
                   compress: bool = False):
    """Write the mesh (the reference's polyMesh contract). fmt='binary'
    writes points/owner/neighbour as binary lists and faces as a
    faceCompactIOList (rapidcfd_tpu/mesh/polymesh.py:261-300); compress
    gzips the data files. The boundary file stays ascii."""
    d = os.path.join(case_dir, "constant", "polyMesh")
    os.makedirs(d, exist_ok=True)
    loc = "constant/polyMesh"

    def wr(name, cls, body, binary=False):
        hdr = foamfile_header(cls, name, loc,
                              fmt="binary" if binary else "ascii",
                              arch=BINARY_ARCH if binary else "")
        payload = hdr.encode("latin-1") + (
            body if isinstance(body, bytes) else body.encode("latin-1"))
        path = os.path.join(d, name)
        if compress and name != "boundary":
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

    if fmt == "binary":
        wr("points", "vectorField", foambin.fmt_list(mesh.points) + b"\n",
           binary=True)
        wr("faces", "faceCompactIOList",
           foambin.fmt_list(mesh.face_offsets)
           + foambin.fmt_list(mesh.face_points) + b"\n", binary=True)
        wr("owner", "labelList", foambin.fmt_list(mesh.owner) + b"\n",
           binary=True)
        wr("neighbour", "labelList",
           foambin.fmt_list(mesh.neighbour) + b"\n", binary=True)
    elif fmt == "ascii":
        pts = "\n".join(f"({p[0]:.12g} {p[1]:.12g} {p[2]:.12g})"
                        for p in mesh.points)
        wr("points", "vectorField", f"\n{mesh.n_points}\n(\n{pts}\n)\n")
        lines = []
        for i in range(mesh.n_faces):
            fp = mesh.face(i)
            lines.append(f"{len(fp)}({' '.join(map(str, fp))})")
        wr("faces", "faceList", f"\n{mesh.n_faces}\n(\n"
           + "\n".join(lines) + "\n)\n")
        wr("owner", "labelList", f"\n{mesh.n_faces}\n(\n"
           + "\n".join(map(str, mesh.owner)) + "\n)\n")
        wr("neighbour", "labelList", f"\n{mesh.n_internal_faces}\n(\n"
           + "\n".join(map(str, mesh.neighbour)) + "\n)\n")
    else:
        raise ValueError(f"write_polymesh: format '{fmt}' (ascii or "
                         "binary)")

    pb = [f"\n{len(mesh.patches)}\n("]
    for p in mesh.patches:
        extra = ""
        ptype = p.extra.word("_originalType", p.type) if p.extra else p.type
        for k, v in (p.extra or {}).items():
            if k in ("type", "nFaces", "startFace", "_originalType"):
                continue
            if isinstance(v, (tuple, list)) and all(
                    isinstance(x, (int, float)) for x in v):
                vs = "(" + " ".join(_num(x) for x in v) + ")"
            else:
                vs = str(v)
            extra += f"        {k}  {vs};\n"
        pb.append(f"    {p.name}\n    {{\n        type            {ptype};\n"
                  f"{extra}"
                  f"        nFaces          {p.n_faces};\n"
                  f"        startFace       {p.start_face};\n    }}")
    pb.append(")\n")
    wr("boundary", "polyBoundaryMesh", "\n".join(pb))


def read_face_zones(case_dir: str, region: str = "") -> dict:
    """constant/polyMesh/faceZones -> {name: (faceLabels, None)} in FILE
    numbering (reference: meshes/polyMesh/zones/faceZone; the flip map is
    not read). No file gives {}."""
    path = os.path.join(case_dir, "constant", region, "polyMesh",
                        "faceZones")
    if not os.path.isfile(path):
        return {}
    _, body = _strip_header(_read_text(path))
    body = _strip_comments(body)
    # compact lists like "3(1 2 3)" spaced out for the tokenizer
    body = body.replace("(", " ( ").replace(")", " ) ")
    m = re.search(r"(\d+)\s*\(", body)
    d = parse_dictionary(body[m.end():body.rfind(")")])
    zones = {}
    for name, sub in d.items():
        if not isinstance(sub, Dictionary):
            continue
        fl = sub.lookup("faceLabels")
        # entry forms: [..., N, [labels]] or plain [labels]
        labels = None
        if isinstance(fl, (list, tuple)):
            for item in (list(fl)[::-1] if isinstance(fl, tuple) else [fl]):
                if isinstance(item, list):
                    labels = item
                    break
        if labels is None and isinstance(fl, list):
            labels = fl
        zones[str(name)] = (np.asarray(labels, dtype=np.int64), None)
    return zones
