"""lduMatrix preconditioners (port of rapidcfd_tpu/linalg/
preconditioners.py): none, diagonal and AINV. As in the reference, the
sequential triangular preconditioners DIC/DILU alias to the
pointwise-parallel AINV (DICPreconditioner.C:41-57,
DILUPreconditioner.C:48-56). GAMG (one V-cycle) is built in
linalg/solvers.py."""

from __future__ import annotations

import torch


def _safe_recip(diag):
    """1/diag with zero-diagonal rows (ghost/dead slots) mapped to 0."""
    return torch.where(diag != 0.0,
                       1.0 / torch.where(diag == 0.0,
                                         torch.ones_like(diag), diag),
                       torch.zeros_like(diag))


def none_precond(mesh, m, diag):
    return lambda r: r


def diagonal_precond(mesh, m, diag):
    rd = _safe_recip(diag)
    return lambda r: rd * r


def ainv_precond(mesh, m, diag):
    """Sparse approximate inverse: w = D^-1 r - D^-1 O D^-1 r (one
    off-diagonal product; reference: AINVPreconditioner.C:49-110)."""
    rd = _safe_recip(diag)
    off_mv = m.offdiag_mv(mesh)

    def apply(r):
        rdr = rd * r
        return rdr - rd * off_mv(rdr)
    return apply


PRECONDITIONERS = {"none": none_precond, "diagonal": diagonal_precond,
                   **{name: ainv_precond
                      for name in ("AINV", "DIC", "DILU", "FDIC")}}


def make_preconditioner(name: str, mesh, m, diag):
    fn = PRECONDITIONERS.get(name)
    if fn is None:
        raise NotImplementedError(
            f"preconditioner '{name}' is not ported yet (ported: "
            f"{', '.join(sorted(PRECONDITIONERS))})")
    return fn(mesh, m, diag)
