"""attach_solver_layouts — derive the solvers' mesh-only data once (port of
the GAMG half of rapidcfd_tpu/linalg/precompute.py; the JAX package's
banded layout is a TPU layout and is not ported).

The GAMG agglomeration hierarchy depends on the mesh alone, so, as the
reference builds its GAMGAgglomeration once per mesh (GAMGAgglomeration.H:
61), it is built here at make_step time and attached to the MeshArrays.
"""

from __future__ import annotations

import time


def _wants_gamg(c) -> bool:
    return c.solver == "GAMG" or c.preconditioner == "GAMG"


def attach_solver_layouts(mesh, controls=(), timings: dict | None = None):
    """mesh with .gamg built for the first of `controls` (SolverControls)
    that selects GAMG as solver or preconditioner, with its
    nCellsInCoarsestLevel/mergeLevels; mesh itself when none does, the
    hierarchy is already attached or the mesh is a gdia lattice. timings, when given, receives the host
    seconds of the build ("agglomeration", the copy of the levels to the
    device included)."""
    cand = [c for c in controls if _wants_gamg(c)]
    # gdia lattices cycle on the structured multigrid, whose levels are
    # built per solve from the matrix: nothing to attach
    if mesh.gamg is not None or not cand or mesh.gdia is not None:
        return mesh
    from .gamg import build_hierarchy, gamg_shape
    t0 = time.perf_counter()
    n_coarsest, merge_levels = gamg_shape(cand[0])
    levels = build_hierarchy(mesh, n_coarsest=n_coarsest,
                             merge_levels=merge_levels)
    if timings is not None:
        timings["agglomeration"] = time.perf_counter() - t0
    return mesh.replace(gamg=levels)
