"""Linear solvers (port of rapidcfd_tpu/linalg/solvers.py: PCG, PBiCGStab,
smoothSolver, diagonal and GAMG, with the reference's residual
normalisation, so log lines and iteration counts are comparable).

The JAX package runs each solve as one `lax.while_loop` on the device.
Here the loop is a Python loop whose convergence test is read back to the
host once per iteration (one device sync per iteration).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..mesh import gdia as gd
from ..mesh.mesharrays import MeshArrays
from ..ops.fvmatrix import FvMatrix
from .preconditioners import _safe_recip, make_preconditioner

_SMALL = 1e-20

# Krylov true-residual replacement period: every _RESTART iterations the
# recursive residual is replaced by the explicitly recomputed b - A*psi
# (fp32 recurrences drift and report convergence the solution lacks)
_RESTART = 32


def gsum(x):
    """Global sum over the CELL axis (axis 0): column-batched solves get
    per-column reductions; scalar fields give scalars."""
    return torch.sum(x, dim=0)


def gmax(x):
    return torch.max(x)


@dataclass(frozen=True)
class SolverControls:
    solver: str = "PCG"
    preconditioner: str = "DIC"
    smoother: str = "Jacobi"
    tolerance: float = 1e-6
    rel_tol: float = 0.0
    max_iter: int = 1000
    min_iter: int = 0
    n_sweeps: int = 1
    # GAMG entries (reference: GAMGSolver dictionary). None = not set in
    # fvSolution: linalg.gamg.gamg_shape then picks its defaults
    n_pre_sweeps: int = 0
    n_post_sweeps: int = 2
    n_finest_sweeps: int = 2
    n_coarsest_cells: int | None = None
    merge_levels: int | None = None
    # coarse-correction over-relaxation of the GAMG preconditioner;
    # None = 2.0
    vcycle_scale: float | None = None

    @staticmethod
    def from_dict(d) -> "SolverControls":
        if d is None:
            return SolverControls()

        def opt(key, cast):
            return None if d.lookup(key) is None else cast(d.scalar(key))
        return SolverControls(
            solver=d.word("solver", "PCG"),
            preconditioner=d.word("preconditioner", "DIC"),
            smoother=d.word("smoother", "Jacobi"),
            tolerance=d.scalar("tolerance", 1e-6),
            rel_tol=d.scalar("relTol", 0.0),
            max_iter=int(d.scalar("maxIter", 1000)),
            min_iter=int(d.scalar("minIter", 0)),
            n_sweeps=int(d.scalar("nSweeps", 1)),
            n_pre_sweeps=int(d.scalar("nPreSweeps", 0)),
            n_post_sweeps=int(d.scalar("nPostSweeps", 2)),
            n_finest_sweeps=int(d.scalar("nFinestSweeps", 2)),
            n_coarsest_cells=opt("nCellsInCoarsestLevel", int),
            merge_levels=opt("mergeLevels", int),
            vcycle_scale=opt("vCycleScale", float),
        )


def _amul_fn(mesh: MeshArrays, m: FvMatrix, diag):
    """x -> diag*x + offdiag(x) + the implicit interfaces' part
    (FvMatrix.coupled_mv); diag and x may be (n,) or (n, m)
    (column-batched vector solves)."""
    off_mv = m.offdiag_mv(mesh)
    cmv = m.coupled_mv(mesh)

    def amul(x):
        out = diag * x + off_mv(x)
        return out if cmv is None else cmv(x, out)
    return amul


def _norm_factor(amul, psi, source, apsi, v_ones):
    """Reference normFactor (lduMatrix::solver::normFactor): with
    xRef = average(psi): gSum(|Apsi - A xRef| + |source - A xRef|) + SMALL."""
    x_ref = gsum(psi) / gsum(v_ones)
    a_xref = amul(torch.full_like(psi, 1.0) * x_ref)
    return (gsum(torch.abs(apsi - a_xref))
            + gsum(torch.abs(source - a_xref)) + _SMALL)


def _gdia_sync(mesh, x):
    """Restore the ghost-synced field invariant after a solve on a gdia
    mesh (solver iterations leave ghost slots at stale values); the
    identity on ELL meshes."""
    if mesh.gdia is None:
        return x
    return gd.sync(mesh.gdia, x)


def _nonzero(x):
    return x.masked_fill(x == 0.0, _SMALL)


class _Stop:
    """The loop test of the reference's solvers: converged (absolute or
    relative tolerance, after minIter), maxIter reached, or stalled (no
    residual below `improve` times the best one in `stall` iterations —
    the floor guard; in fp64 it waits maxIter unless stall_fp64 is given).
    `step` is the iteration count of one update (nSweeps for the
    smoother)."""

    def __init__(self, c: SolverControls, res0, dtype, stall_fp32: int,
                 stall_fp64: int | None = None, improve: float = 0.999,
                 step: int = 1):
        self.c = c
        self.res0 = res0
        self.stall = stall_fp32 if dtype == torch.float32 else (
            c.max_iter if stall_fp64 is None else stall_fp64)
        self.improve = improve
        self.step = step
        self.best = res0
        self.since_best = torch.zeros((), dtype=torch.int64,
                                      device=res0.device)

    def update(self, res):
        improved = torch.any(res < self.improve * self.best)
        self.best = torch.minimum(self.best, res)
        self.since_best = torch.where(improved,
                                      torch.zeros_like(self.since_best),
                                      self.since_best + self.step)

    def done(self, res, it: int) -> bool:
        c = self.c
        ok = res <= c.tolerance
        if c.rel_tol > 0:
            ok = ok | (res <= c.rel_tol * self.res0)
        converged = torch.all(ok) & (it >= c.min_iter)
        return bool(converged | (self.since_best >= self.stall)) \
            or it >= c.max_iter


def solve_component(mesh: MeshArrays, m: FvMatrix, cmpt: int | None,
                    controls: SolverControls):
    """Solve one scalar component of the system; returns (psi, perf)."""
    diag, source = m.component_system(mesh, cmpt)
    psi0 = m.psi.data if cmpt is None else m.psi.data[:, cmpt]
    return _krylov(mesh, _amul_fn(mesh, m, diag), m, diag, source, psi0,
                   controls)


def _krylov(mesh, amul, m, diag, source, psi0, c: SolverControls):
    """Dispatch on fvSolution's `solver` word; psi0 may be (n,) or (n, m)
    (column-batched vector solve), except for GAMG."""
    if c.solver in ("PCG", "ICCG"):
        return _pcg(mesh, amul, m, diag, source, psi0, c)
    if c.solver in ("PBiCGStab", "PBiCG", "BICCG"):
        return _pbicgstab(mesh, amul, m, diag, source, psi0, c)
    if c.solver == "smoothSolver":
        return _smooth_solver(mesh, amul, m, diag, source, psi0, c)
    if c.solver == "diagonal":
        z = torch.zeros(psi0.shape[1:], dtype=psi0.dtype,
                        device=psi0.device)
        return source * _safe_recip(diag), (z, z, 0)
    if c.solver == "GAMG":
        from .gamg import gamg_solve
        return gamg_solve(mesh, m, amul, diag, source, psi0, c)
    raise NotImplementedError(
        f"linear solver '{c.solver}' is not ported yet (PCG, PBiCGStab, "
        "smoothSolver, diagonal, GAMG)")


def _gamg_precond(mesh, m, amul, diag, c: SolverControls):
    """One linear multigrid V-cycle as a Krylov preconditioner. PCG needs
    a symmetric preconditioner, so the sweeps are the symmetric V(1,1)
    whatever nPre/nPostSweeps say; the coarse correction is over-relaxed
    by vCycleScale (default 2.0, near-optimal for piecewise-constant
    pairwise aggregation)."""
    from .gamg import make_vcycle
    scale = 2.0 if c.vcycle_scale is None else c.vcycle_scale
    cp = dataclasses.replace(c, n_pre_sweeps=1, n_post_sweeps=1,
                             n_finest_sweeps=1)
    vc = make_vcycle(mesh, m, amul, diag, cp, scale_correction=False,
                     fixed_scale=scale)
    return lambda r: vc(torch.zeros_like(r), r)


def _preconditioner(mesh, m, amul, diag, c: SolverControls):
    if c.preconditioner == "GAMG":
        return _gamg_precond(mesh, m, amul, diag, c)
    return make_preconditioner(c.preconditioner, mesh, m, diag)


def _pcg(mesh, amul, m, diag, source, psi0, c: SolverControls):
    """Preconditioned conjugate gradient (reference PCG.C:67-205), in
    delta form: iterate on A*delta = r0 from delta = 0 and add psi0 once
    at the end (residuals identical to the direct form)."""
    precond = _preconditioner(mesh, m, amul, diag, c)
    apsi = amul(psi0)
    nf = _norm_factor(amul, psi0, source, apsi, torch.ones_like(psi0))
    r0 = source - apsi
    res0 = gsum(torch.abs(r0)) / nf
    b = r0
    stop = _Stop(c, res0, psi0.dtype, 100)
    psi = torch.zeros_like(psi0)
    r, p = r0, torch.zeros_like(psi0)
    wr_old = None
    res, it = res0, 0
    while not stop.done(res, it):
        w = precond(r)
        wr = gsum(w * r)
        beta = torch.zeros_like(wr) if it == 0 else wr / _nonzero(wr_old)
        p = w + beta * p
        wa = amul(p)
        alpha = wr / _nonzero(gsum(wa * p))
        psi = psi + alpha * p
        r = b - amul(psi) if (it + 1) % _RESTART == 0 else r - alpha * wa
        res = gsum(torch.abs(r)) / nf
        stop.update(res)
        wr_old = wr
        it += 1
    return psi0 + psi, (res0, res, it)


def _pbicgstab(mesh, amul, m, diag, source, psi0, c: SolverControls):
    """Preconditioned BiCGStab (reference PBiCGStab.H:50), delta form, for
    asymmetric (convection) systems."""
    precond = _preconditioner(mesh, m, amul, diag, c)
    apsi = amul(psi0)
    nf = _norm_factor(amul, psi0, source, apsi, torch.ones_like(psi0))
    r0 = source - apsi
    b = r0
    rr0 = r0   # shadow residual
    res0 = gsum(torch.abs(r0)) / nf
    stop = _Stop(c, res0, psi0.dtype, 100)
    psi = torch.zeros_like(psi0)
    r = r0
    p = torch.zeros_like(psi0)
    v = torch.zeros_like(psi0)
    rho_o = alpha_o = omega_o = torch.ones_like(res0)
    res, it = res0, 0
    while not stop.done(res, it):
        rho = gsum(rr0 * r)
        beta = (rho / _nonzero(rho_o)) * (alpha_o / _nonzero(omega_o))
        p = r if it == 0 else r + beta * (p - omega_o * v)
        ph = precond(p)
        v = amul(ph)
        alpha = rho / _nonzero(gsum(rr0 * v))
        s = r - alpha * v
        sh = precond(s)
        t = amul(sh)
        omega = gsum(t * s) / _nonzero(gsum(t * t))
        psi = psi + alpha * ph + omega * sh
        r = b - amul(psi) if (it + 1) % _RESTART == 0 else s - omega * t
        res = gsum(torch.abs(r)) / nf
        stop.update(res)
        rho_o, alpha_o, omega_o = rho, alpha, omega
        it += 1
    return psi0 + psi, (res0, res, it)


def jacobi_sweeps(amul, diag, source, psi, n: int, omega: float = 0.9):
    """n damped-Jacobi sweeps (reference: JacobiSmoother.C:34-120,
    omega 0.9; GaussSeidel and symGaussSeidel alias here, as in the
    reference's data-parallel smoothers)."""
    rd = omega * _safe_recip(diag)
    for _ in range(n):
        psi = psi + rd * (source - amul(psi))
    return psi


def _smooth_solver(mesh, amul, m, diag, source, psi0, c: SolverControls):
    """smoothSolver: sweep in groups of nSweeps until converged
    (reference: smoothSolver.H:54), delta form."""
    apsi = amul(psi0)
    nf = _norm_factor(amul, psi0, source, apsi, torch.ones_like(psi0))
    b = source - apsi
    res0 = gsum(b.abs()) / nf
    n_sweeps = max(1, c.n_sweeps)
    # fp32 floors can sit above an absolute tolerance: stop when sweeps
    # make no measurable progress
    stop = _Stop(c, res0, psi0.dtype, 12 * n_sweeps, improve=1.0 - 1e-6,
                 step=n_sweeps)
    psi = torch.zeros_like(psi0)
    res, it = res0, 0
    while not stop.done(res, it):
        psi = jacobi_sweeps(amul, diag, b, psi, n_sweeps)
        res = gsum((b - amul(psi)).abs()) / nf
        stop.update(res)
        it += n_sweeps
    return psi0 + psi, (res0, res, it)


def _repin_reference(m: FvMatrix, x):
    """Re-pin the solution level at the reference cell after solving a
    setReference'd system (the constant near-null mode drifts freely
    during the solve)."""
    if m.ref_cell is None:
        return x
    return x + m.ref_weight * (m.ref_value - x[m.ref_cell])


def solve(mesh: MeshArrays, m: FvMatrix, controls: SolverControls,
          env=None):
    """fvMatrix::solve: segregated solve + boundary update (reference:
    fvMatrixSolve.C:104-227). Vector systems are solved column-batched:
    one Krylov iteration advances all components together, with one
    shared iteration count.

    Returns (new psi VolField, tuple of per-component (initial residual,
    final residual, iterations))."""
    psi = m.psi
    if psi.data.dim() == 1:
        x, perf = solve_component(mesh, m, None, controls)
        x = _gdia_sync(mesh, _repin_reference(m, x))
        new = psi.replace(data=x).correct_boundary_conditions(mesh, env)
        return new, (perf,)
    if controls.solver == "GAMG":   # scalar-only: one solve per component
        comps, perfs = zip(*(solve_component(mesh, m, c, controls)
                             for c in range(psi.data.shape[1])))
        x = _gdia_sync(mesh, torch.stack(comps, dim=1))
        new = psi.replace(data=x).correct_boundary_conditions(mesh, env)
        return new, perfs
    diag, source = m.component_system_all(mesh)
    x, (res0, res, it) = _krylov(mesh, _amul_fn(mesh, m, diag), m, diag,
                                 source, psi.data, controls)
    x = _gdia_sync(mesh, x)
    new = psi.replace(data=x).correct_boundary_conditions(mesh, env)
    return new, tuple((res0[c], res[c], it) for c in range(psi.data.shape[1]))
