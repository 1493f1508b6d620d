"""Cell set and cell zone readers (a numpy copy of the readers of
rapidcfd_tpu/mesh/toposet.py:197-230; reference: src/meshTools/sets and
meshes/polyMesh/zones).

Sets live under constant/polyMesh/sets and zones in
constant/polyMesh/cellZones; every label is in FILE (on-disk polyMesh)
numbering, and consumers translate to the device ordering through
MeshMaps. The topoSet utility that builds sets is not ported.
"""

from __future__ import annotations

import os
import re

import numpy as np

from .polymesh import _parse_label_list, _read_text, _strip_header


def read_set(case_dir: str, name: str) -> np.ndarray:
    """constant/polyMesh/sets/<name> -> label array (FILE numbering)."""
    path = os.path.join(case_dir, "constant", "polyMesh", "sets", name)
    _, body = _strip_header(_read_text(path))
    return _parse_label_list(body, name=f"sets/{name}")


def read_cell_zones(case_dir: str, region: str = "") -> dict:
    """constant/polyMesh/cellZones -> {name: labels} (FILE numbering); no
    file gives {}."""
    path = os.path.join(case_dir, "constant", region, "polyMesh",
                        "cellZones")
    if not os.path.isfile(path) and not os.path.isfile(path + ".gz"):
        return {}
    _, body = _strip_header(_read_text(path))
    return parse_file_zones_body(body)


def parse_file_zones_body(body: str) -> dict:
    """Parse the `N ( name { type cellZone; cellLabels List<label> M
    ( ... ); } ... )` zone-file layout."""
    out = {}
    for m in re.finditer(
            r"(\w+)\s*\{[^{}]*?cellLabels[^(]*\(\s*([^)]*)\)", body, re.S):
        txt = m.group(2).split()
        out[m.group(1)] = (np.asarray([int(x) for x in txt], np.int64)
                           if txt else np.zeros(0, np.int64))
    return out
