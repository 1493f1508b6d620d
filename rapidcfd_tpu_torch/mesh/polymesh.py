"""polyMesh reader/writer: constant/polyMesh/{points,faces,owner,neighbour,
boundary}, and the faceZones reader — a numpy copy of
rapidcfd_tpu/mesh/polymesh.py (ascii, with
gzip-compressed files read transparently). Binary polyMesh files are not
ported yet and raise."""

from __future__ import annotations

import gzip
import os
import re
from dataclasses import dataclass, field

import numpy as np

from ..utils.dictionary import (Dictionary, foamfile_header,
                                           parse_dictionary)


def _read_text(path: str) -> str:
    if os.path.isfile(path + ".gz"):
        with gzip.open(path + ".gz", "rt", encoding="latin-1") as f:
            text = f.read()
    else:
        with open(path, encoding="latin-1") as f:
            text = f.read()
    if re.search(r"format\s+binary\s*;", text[:2048]):
        raise NotImplementedError(f"{path}: binary polyMesh files are not "
                                  "supported by the port yet (ascii only)")
    return text


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


def _parse_scalar_list(body: str, ncols: int) -> np.ndarray:
    """`N ( (x y z) ... )` or `N ( v ... )` -> (N, ncols) / (N,) array."""
    n, data = _list_body(body)
    arr = np.array(data.replace("(", " ").replace(")", " ").split(),
                   dtype=np.float64)
    if arr.size != n * ncols:
        raise ValueError(f"expected {n * ncols} values, got {arr.size}")
    return arr.reshape(n, ncols) if ncols > 1 else arr


def _parse_label_list(body: str) -> np.ndarray:
    n, data = _list_body(body)
    arr = np.array(data.split(), dtype=np.int64)
    if arr.shape[0] != n:
        raise ValueError(f"expected {n} labels, got {arr.shape[0]}")
    return arr


_FACE_RE = re.compile(r"(\d+)\s*\(([^)]*)\)")


def _parse_face_list(body: str) -> tuple[np.ndarray, np.ndarray]:
    """Parse faces `N ( 4(a b c d) ... )` -> (flat_points, offsets)."""
    n, chunk = _list_body(body)
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


def read_polymesh(case_dir: str) -> PolyMesh:
    d = os.path.join(case_dir, "constant", "polyMesh")

    def body(name):
        return _strip_header(_read_text(os.path.join(d, name)))[1]

    points = _parse_scalar_list(body("points"), 3)
    face_points, face_offsets = _parse_face_list(body("faces"))
    owner = _parse_label_list(body("owner"))
    neighbour = _parse_label_list(body("neighbour"))
    patches = _parse_boundary(body("boundary"))
    return PolyMesh(points, face_points, face_offsets, owner, neighbour,
                    patches)


def _parse_boundary(body: str) -> list[BoundaryPatch]:
    n, inner = _list_body(body)
    d = parse_dictionary(inner)
    patches = []
    for name, sub in d.items():
        if not isinstance(sub, Dictionary):
            continue
        patches.append(BoundaryPatch(
            name=str(name),
            type=sub.word("type"),
            start_face=int(sub.scalar("startFace")),
            n_faces=int(sub.scalar("nFaces")),
            extra=sub,
        ))
    if len(patches) != n:
        raise ValueError(f"boundary: expected {n} patches, got {len(patches)}")
    return patches


def write_polymesh(mesh: PolyMesh, case_dir: str):
    """Write the mesh in ascii (the reference's polyMesh contract)."""
    d = os.path.join(case_dir, "constant", "polyMesh")
    os.makedirs(d, exist_ok=True)
    loc = "constant/polyMesh"

    def wr(name, cls, body):
        with open(os.path.join(d, name), "w", encoding="latin-1") as f:
            f.write(foamfile_header(cls, name, loc) + body)

    pts = "\n".join(f"({p[0]:.12g} {p[1]:.12g} {p[2]:.12g})"
                    for p in mesh.points)
    wr("points", "vectorField", f"\n{mesh.n_points}\n(\n{pts}\n)\n")
    lines = []
    for i in range(mesh.n_faces):
        fp = mesh.face(i)
        lines.append(f"{len(fp)}({' '.join(map(str, fp))})")
    wr("faces", "faceList", f"\n{mesh.n_faces}\n(\n" + "\n".join(lines)
       + "\n)\n")
    wr("owner", "labelList", f"\n{mesh.n_faces}\n(\n"
       + "\n".join(map(str, mesh.owner)) + "\n)\n")
    wr("neighbour", "labelList", f"\n{mesh.n_internal_faces}\n(\n"
       + "\n".join(map(str, mesh.neighbour)) + "\n)\n")

    pb = [f"\n{len(mesh.patches)}\n("]
    for p in mesh.patches:
        extra = ""
        for k, v in (p.extra or {}).items():
            if k in ("type", "nFaces", "startFace"):
                continue
            if isinstance(v, tuple):
                vs = "(" + " ".join(f"{float(x):g}" for x in v) + ")"
            else:
                vs = str(v)
            extra += f"        {k}  {vs};\n"
        pb.append(f"    {p.name}\n    {{\n        type            {p.type};\n"
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
