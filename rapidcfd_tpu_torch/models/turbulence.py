"""The turbulence models (port of rapidcfd_tpu/models/turbulence.py;
reference: src/turbulenceModels/incompressible/RAS and LES, OpenFOAM 2.3).

RAS: laminar, kEpsilon, RNGkEpsilon, realizableKE, LaunderSharmaKE and
qZeta (kEpsilon's hooks), kOmega, kOmegaSST, SpalartAllmaras and v2f.
LES: Smagorinsky, oneEqEddy/kEqn, dynOneEqEddy/homogeneousDynOneEqEddy
with the simple test filter, SpalartAllmarasDES and DDES, laminar; the
LES deltas cubeRootVol, maxDeltaxyz, smooth and Prandtl (vanDriest takes
Prandtl's form, as in the JAX package). models/turbulence_extra.py holds
the rest of the JAX package's registrations (kkLOmega, LienCubicKE and
the other LES models).

A model's correct() is a plain function over a state dict of VolFields:
steady (simpleFoam) without a time step, transient with one (pimpleFoam
and pisoFoam): each solved field keeps the old levels the case's ddt
scheme reads (two under backward and CrankNicolson, fvm.store_old).
The wall functions are BC descriptors (fields/bcs.py, re-exported here)
and a pass that fixes epsilon or omega and the production in the wall
cells (fvMatrix::setValues). The wall distance is a host k-d tree query
over the wall-face centres, once per case. CompressibleTurbulence wraps
a model for the compressible solvers (mut = rho*nut).
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from ..fields.bcs import (_CMU25, _CMU75, _KAPPA, EpsilonWallFunction,
                          KqRWallFunction, NutkWallFunction,
                          OmegaWallFunction)
from ..fields.field import Dimensioned, SurfaceField, VolField
from ..linalg.solvers import solve
from ..ops import fvc, fvm
from ..utils.dictionary import Dictionary, parse_file
from ..utils.dimensions import DimensionSet, dim_length, dim_viscosity

__all__ = ["CompressibleTurbulence", "DynOneEqEddy", "EpsilonWallFunction",
           "KEpsilon", "KOmega", "KOmegaSST", "KqRWallFunction", "Laminar",
           "LaunderSharmaKE", "LES_MODELS", "NutkWallFunction",
           "OmegaWallFunction", "OneEqEddy", "QZeta", "RAS_MODELS",
           "RNGkEpsilon", "RealizableKE", "Smagorinsky", "SpalartAllmaras",
           "SpalartAllmarasDDES", "SpalartAllmarasDES", "V2F", "bound",
           "les_delta", "magsqr_skew_grad", "magsqr_symm_grad",
           "make_ras_model", "max_delta_xyz", "ras_model_name",
           "simple_filter", "wall_distance"]

_RTIME = DimensionSet.of(0, 0, -1)


def bound(f: VolField, min_value: float) -> VolField:
    """Clip a field from below (reference: cfdTools/general bound)."""
    return f.replace(data=torch.clamp(f.data, min=min_value),
                     bvalues=torch.clamp(f.bvalues, min=min_value))


def _ddt(scheme, dt):
    """(ddt scheme, time step) of a turbulence equation: steadyState
    without a time step."""
    return ("steadyState", 1.0) if dt is None else (scheme, dt)


def magsqr_symm_grad(mesh, U: VolField):
    """2*|symm(grad U)|^2 per cell (the S2 of G = nut*S2)."""
    g = fvc.grad(mesh, U).data
    sym = 0.5 * (g + g.transpose(1, 2))
    return 2.0 * (sym * sym).sum((-2, -1))


class Laminar:
    needs = ()

    def __init__(self, case, coeffs: Dictionary):
        self.case = case

    def init_state(self, U):
        return {}

    def nut(self, state):
        return None

    def nu_eff(self, mesh, state, nu):
        return nu

    def correct(self, mesh, state, U, phi, nu, dt=None):
        return state, {}


class KEpsilon:
    """Standard k-epsilon (reference: incompressible/RAS/kEpsilon). The
    production, the k sink, the epsilon source and destruction and the
    nut closure are hooks, so RNGkEpsilon, realizableKE, LaunderSharmaKE,
    qZeta and LienCubicKE share its assembly, solves and wall functions
    (as in the JAX package)."""
    needs = ("k", "epsilon", "nut")
    Cmu_default, C1_default, C2_default = 0.09, 1.44, 1.92
    sigmak_default, sigmaEps_default = 1.0, 1.3

    def __init__(self, case, coeffs: Dictionary):
        self.case = case
        c = coeffs or Dictionary()
        self.Cmu = c.scalar("Cmu", self.Cmu_default)
        self.C1 = c.scalar("C1", self.C1_default)
        self.C2 = c.scalar("C2", self.C2_default)
        self.sigma_k = c.scalar("sigmak", self.sigmak_default)
        self.sigma_eps = c.scalar("sigmaEps", self.sigmaEps_default)
        self.k_min = 1e-15
        self.eps_min = 1e-15
        self.k_controls = case.solver_controls("k")
        self.eps_controls = case.solver_controls("epsilon")
        self.k_relax = case.relaxation_factor("k", default=0.7)
        self.eps_relax = case.relaxation_factor("epsilon", default=0.7)
        self.div_k = case.div_scheme("div(phi,k)")
        try:
            self.div_eps = case.div_scheme("div(phi,epsilon)")
        except KeyError:
            self.div_eps = self.div_k
        self.lap_corr = case.laplacian_scheme()
        self.ddt_scheme = case.ddt_scheme()
        # (id(mesh.owner), patch index) -> (mesh.owner, face positions,
        # cells): the wall cells of each wall-function patch
        self._wall_rows: dict = {}

    def init_state(self, U):
        return {name: self.case.read_field(name) for name in self.needs}

    def nut(self, state):
        return state["nut"]

    def nu_eff(self, mesh, state, nu):
        nut = state["nut"]
        if isinstance(nu, Dimensioned):
            data, bval = nut.data + nu.value, nut.bvalues + nu.value
        else:
            data, bval = nut.data + nu.data, nut.bvalues + nu.bvalues
        return nut.with_calculated_bcs(data, bval, dim_viscosity, "nuEff")

    # -- wall-function manipulation -----------------------------------------
    def _wall_cells(self, mesh, i, patch):
        """(face positions, cells) of a wall patch with one face per cell:
        a cell with two faces on the patch (the step's corner) keeps its
        LAST face, which is the write that wins in the JAX package's
        scatter on the CPU. Zero-area padding faces are skipped. Computed
        once per mesh on the host, so the writes are unique indices and
        the result is the same on every device."""
        key = (id(mesh.owner), i)
        hit = self._wall_rows.get(key)
        if hit is not None and hit[0] is mesh.owner:
            return hit[1], hit[2]
        cells = mesh.patch_face_cells(patch).cpu().numpy()
        active = (mesh.patch_active(patch) > 0).cpu().numpy()
        last = {}
        for pos in range(patch.size):
            if active[pos]:
                last[int(cells[pos])] = pos
        pos = torch.tensor(sorted(last.values()), dtype=torch.int64,
                           device=mesh.device)
        rows = mesh.patch_face_cells(patch)[pos]
        self._wall_rows[key] = (mesh.owner, pos, rows)
        return pos, rows

    def _wall_fix(self, mesh, state, U, nu, G):
        """Wall-cell overrides (reference: epsilonWallFunction
        updateCoeffs): returns (G', epsilon fix mask, epsilon values)."""
        k = state["k"]
        nut = state["nut"]
        fix = torch.zeros_like(G)
        eps_vals = torch.zeros_like(G)
        G = G.clone()
        for i, (bc, patch) in enumerate(zip(state["epsilon"].bcs,
                                            mesh.patches)):
            if not isinstance(bc, EpsilonWallFunction) or patch.size == 0:
                continue
            cells = mesh.patch_face_cells(patch)
            y = 1.0 / mesh.patch_delta_coeffs(patch)
            k_c = torch.clamp(k.data[cells], min=0.0)
            nu_w = nu.value if isinstance(nu, Dimensioned) else nu.data[cells]
            sl = slice(patch.bstart, patch.bstart + patch.size)
            nut_w = nut.bvalues[sl]
            # wall-normal velocity gradient magnitude
            mag_grad_uw = torch.linalg.norm(U.data[cells] - U.bvalues[sl],
                                            dim=-1) / y
            g_w = (nut_w + nu_w) * mag_grad_uw * _CMU25 * torch.sqrt(k_c) \
                / (_KAPPA * y)
            eps_w = _CMU75 * k_c ** 1.5 / (_KAPPA * y)
            pos, rows = self._wall_cells(mesh, i, patch)
            G[rows] = g_w[pos]
            fix[rows] = 1.0
            eps_vals[rows] = eps_w[pos]
        return G, fix, eps_vals

    def _store(self, mesh, f: VolField, dt) -> VolField:
        """The old levels of a solved field at the start of a transient
        correct(): two under backward and CrankNicolson (with the ddt0
        state advanced), one under Euler; none when steady."""
        return f if dt is None else fvm.store_old(mesh, f, dt,
                                                   self.ddt_scheme)

    def correct(self, mesh, state, U, phi, nu, dt=None):
        """One turbulence correction (reference kEpsilon.C:229-280):
        steadyState ddt when dt is None, else the case's ddt scheme over
        dt (a float or a 0-d tensor)."""
        k, eps, nut = state["k"], state["epsilon"], state["nut"]
        k, eps = self._store(mesh, k, dt), self._store(mesh, eps, dt)
        ddt_scheme, ddt_dt = _ddt(self.ddt_scheme, dt)
        s2 = magsqr_symm_grad(mesh, U)
        G = self._production(mesh, state, U, s2)       # [m2/s3]
        G, eps_fix, eps_vals = self._wall_fix(mesh, state, U, nu, G)

        nu_eff_eps = self._dcoeff(state, nu, self.sigma_eps)
        nu_eff_k = self._dcoeff(state, nu, self.sigma_k)
        k_floor = torch.clamp(k.data, min=self.k_min)

        # epsilon equation
        rhs_eps = eps.with_calculated_bcs(
            self._eps_prod(mesh, U, G, k, eps, s2),
            torch.zeros_like(eps.bvalues),
            eps.dims / DimensionSet.of(0, 0, 1))
        eps_eqn = (fvm.ddt(mesh, eps, ddt_dt, ddt_scheme)
                   + fvm.div(mesh, phi, eps, self.div_eps)
                   - fvm.laplacian(mesh, nu_eff_eps, eps, self.lap_corr)
                   + fvm.Sp(mesh, Dimensioned(
                       "epsDest", _RTIME,
                       self._eps_dest(mesh, U, k, eps, nu)), eps))
        eps_eqn = eps_eqn.equals(rhs_eps).relax(mesh, self.eps_relax)
        eps_eqn = eps_eqn.set_values(mesh, eps_fix, eps_vals)
        eps_new, eps_perf = solve(mesh, eps_eqn, self.eps_controls,
                                  env={"phi": phi})
        eps_new = bound(eps_new, self.eps_min)

        # k equation (with LaunderSharma's low-Re wall sink)
        rhs_k = k.with_calculated_bcs(
            G - self._k_sink(mesh, U, k, nu), torch.zeros_like(k.bvalues),
            k.dims / DimensionSet.of(0, 0, 1))
        k_eqn = (fvm.ddt(mesh, k, ddt_dt, ddt_scheme)
                 + fvm.div(mesh, phi, k, self.div_k)
                 - fvm.laplacian(mesh, nu_eff_k, k, self.lap_corr)
                 + fvm.Sp(mesh, Dimensioned(
                     "eps/k", _RTIME, eps_new.data / k_floor), k))
        k_eqn = k_eqn.equals(rhs_k).relax(mesh, self.k_relax)
        k_new, k_perf = solve(mesh, k_eqn, self.k_controls, env={"phi": phi})
        k_new = bound(k_new, self.k_min)

        # nut and its wall function
        nut_new = nut.replace(data=self._nut_from(mesh, U, k_new, eps_new)) \
            .correct_boundary_conditions(mesh, env={"k": k_new, "nu": nu})
        return (dict(k=k_new, epsilon=eps_new, nut=nut_new),
                {"k": k_perf[0], "epsilon": eps_perf[0]})

    # -- variant hooks -------------------------------------------------------
    def _production(self, mesh, state, U, s2):
        return state["nut"].data * s2

    def _k_sink(self, mesh, U, k, nu):
        return 0.0

    def _eps_prod(self, mesh, U, G, k, eps, s2):
        return self.C1 * G * eps.data / torch.clamp(k.data, min=self.k_min)

    def _eps_dest(self, mesh, U, k, eps, nu):
        return self.C2 * eps.data / torch.clamp(k.data, min=self.k_min)

    def _nut_from(self, mesh, U, k, eps):
        return self.Cmu * k.data ** 2 / torch.clamp(eps.data,
                                                    min=self.eps_min)

    def _dcoeff(self, state, nu, sigma):
        """DkEff/DepsilonEff = nut/sigma + nu, face-interpolatable."""
        nut = state["nut"]
        if isinstance(nu, Dimensioned):
            data, bval = nut.data / sigma + nu.value, \
                nut.bvalues / sigma + nu.value
        else:
            data, bval = nut.data / sigma + nu.data, \
                nut.bvalues / sigma + nu.bvalues
        return nut.with_calculated_bcs(data, bval, dim_viscosity, "Deff")


def _nu_c(nu):
    """nu per cell (a VolField's data) or the constant."""
    return nu.value if isinstance(nu, Dimensioned) else nu.data


def _nu_b(nu):
    """nu per boundary face or the constant."""
    return nu.value if isinstance(nu, Dimensioned) else nu.bvalues


def _sym(t):
    return 0.5 * (t + t.transpose(-1, -2))


def _skew(t):
    return 0.5 * (t - t.transpose(-1, -2))


def _dev(t):
    tr = t.diagonal(dim1=-2, dim2=-1).sum(-1)
    return t - (tr / 3.0)[..., None, None] * torch.eye(
        3, dtype=t.dtype, device=t.device)


class RNGkEpsilon(KEpsilon):
    """RNG k-epsilon (port of rapidcfd_tpu/models/turbulence.py:329-350;
    reference: incompressible/RAS/RNGkEpsilon/RNGkEpsilon.C:272-298): the
    epsilon production coefficient C1 - eta(1 - eta/eta0)/(1 + beta
    eta^3), eta = |S| k/epsilon."""
    Cmu_default, C1_default, C2_default = 0.0845, 1.42, 1.68
    sigmak_default, sigmaEps_default = 0.71942, 0.71942

    def __init__(self, case, coeffs: Dictionary):
        super().__init__(case, coeffs)
        c = coeffs or Dictionary()
        self.eta0 = c.scalar("eta0", 4.38)
        self.beta = c.scalar("beta", 0.012)

    def _eps_prod(self, mesh, U, G, k, eps, s2):
        eps_pos = torch.clamp(eps.data, min=self.eps_min)
        eta = torch.sqrt(torch.clamp(s2, min=0.0)) * k.data / eps_pos
        R = eta * (1.0 - eta / self.eta0) / (1.0 + self.beta * eta ** 3)
        return (self.C1 - R) * G * eps.data \
            / torch.clamp(k.data, min=self.k_min)


class RealizableKE(KEpsilon):
    """Realizable k-epsilon (port of rapidcfd_tpu/models/turbulence.py:
    351-401; reference: incompressible/RAS/realizableKE/realizableKE.C:
    47-86, 288-346): Cmu from the realizability bound, the eta-based C1
    and the destruction C2 eps/(k + sqrt(nu eps))."""
    Cmu_default, C1_default, C2_default = 0.09, 1.44, 1.9
    sigmak_default, sigmaEps_default = 1.0, 1.2

    def __init__(self, case, coeffs: Dictionary):
        super().__init__(case, coeffs)
        c = coeffs or Dictionary()
        self.A0 = c.scalar("A0", 4.0)

    @staticmethod
    def _dev_symm_s2(mesh, U):
        g = fvc.grad(mesh, U).data
        dev = _dev(_sym(g))
        skw = _skew(g)
        return dev, 2.0 * (dev * dev).sum((-2, -1)), \
            (skw * skw).sum((-2, -1))

    def _eps_prod(self, mesh, U, G, k, eps, s2):
        _, s2d, _ = self._dev_symm_s2(mesh, U)
        mag_s = torch.sqrt(torch.clamp(s2d, min=0.0))
        eta = mag_s * k.data / torch.clamp(eps.data, min=self.eps_min)
        c1 = torch.clamp(eta / (5.0 + eta), min=0.43)
        return c1 * mag_s * eps.data

    def _eps_dest(self, mesh, U, k, eps, nu):
        eps_pos = torch.clamp(eps.data, min=0.0)
        return self.C2 * eps.data / (
            torch.clamp(k.data, min=self.k_min)
            + torch.sqrt(_nu_c(nu) * eps_pos))

    def _nut_from(self, mesh, U, k, eps):
        dev, s2d, sk2 = self._dev_symm_s2(mesh, U)
        mag_s = torch.sqrt(torch.clamp(s2d, min=0.0))
        eps_pos = torch.clamp(eps.data, min=self.eps_min)
        # W = 2 sqrt(2) (S.S):S / (|S| S2), As = sqrt(6) cos(phi/3)
        sss = torch.einsum("nij,njk,nki->n", dev, dev, dev)
        W = 2.0 * math.sqrt(2.0) * sss / (mag_s * s2d + 1e-30)
        phi_s = torch.arccos(torch.clamp(math.sqrt(6.0) * W, -1.0,
                                         1.0)) / 3.0
        As = math.sqrt(6.0) * torch.cos(phi_s)
        Us = torch.sqrt(s2d / 2.0 + sk2)
        r_cmu = 1.0 / (self.A0 + As * Us * k.data / eps_pos)
        return r_cmu * k.data ** 2 / eps_pos


class LaunderSharmaKE(KEpsilon):
    """Launder-Sharma low-Re k-epsilon (port of rapidcfd_tpu/models/
    turbulence.py:973-1023; reference: incompressible/RAS/LaunderSharmaKE):
    fMu = exp(-3.4/(1 + Rt/50)^2) on nut, f2 = 1 - 0.3 exp(-Rt^2) on the
    destruction, the wall sink D = 2 nu |grad sqrt(k)|^2 in k and the
    source E = 2 nu nut |grad grad U|^2 in epsilon."""

    def _rt(self, k, eps, nu_c):
        return torch.clamp(k, min=0.0) ** 2 / (
            nu_c * torch.clamp(eps, min=1e-20))

    def _k_sink(self, mesh, U, k, nu):
        sqrt_k = k.replace(data=torch.sqrt(torch.clamp(k.data, min=0.0)),
                           bvalues=torch.sqrt(torch.clamp(k.bvalues,
                                                          min=0.0)))
        g = fvc.grad(mesh, sqrt_k).data
        return 2.0 * _nu_c(nu) * (g * g).sum(-1)

    def _eps_prod(self, mesh, U, G, k, eps, s2):
        base = self.C1 * G * eps.data / torch.clamp(k.data, min=self.k_min)
        # E = 2 nu nut |grad grad U|^2 through the (n, 9) flattened grad U
        gu = fvc.grad(mesh, U)
        gu_flat = gu.replace(data=gu.data.reshape(gu.data.shape[0], 9),
                             bvalues=gu.bvalues.reshape(
                                 gu.bvalues.shape[0], 9))
        gg = fvc.grad(mesh, gu_flat).data
        return base + 2.0 * self._nu * self._nut_prev \
            * (gg * gg).sum((-2, -1))

    def _eps_dest(self, mesh, U, k, eps, nu):
        rt = self._rt(k.data, eps.data, _nu_c(nu))
        f2 = 1.0 - 0.3 * torch.exp(-torch.clamp(rt * rt, max=50.0))
        return self.C2 * f2 * eps.data / torch.clamp(k.data, min=self.k_min)

    def _nut_from(self, mesh, U, k, eps):
        fmu = torch.exp(-3.4 / (1.0 + self._rt(k.data, eps.data, self._nu)
                                / 50.0) ** 2)
        return self.Cmu * fmu * torch.clamp(k.data, min=0.0) ** 2 \
            / torch.clamp(eps.data, min=self.eps_min)

    def correct(self, mesh, state, U, phi, nu, dt=None):
        self._nu = _nu_c(nu)
        self._nut_prev = state["nut"].data
        return super().correct(mesh, state, U, phi, nu, dt=dt)


class QZeta(KEpsilon):
    """q-zeta low-Re model (port of rapidcfd_tpu/models/turbulence.py:
    1024-1046; reference: incompressible/RAS/qZeta), solved in the (k,
    epsilon) variables as the JAX package does, with the damping
    fMu = exp(-2.5/(1 + Rt/50))."""

    def _nut_from(self, mesh, U, k, eps):
        rt = torch.clamp(k.data, min=0.0) ** 2 / (
            self._nu * torch.clamp(eps.data, min=1e-20))
        fmu = torch.exp(-2.5 / (1.0 + rt / 50.0))
        return self.Cmu * fmu * torch.clamp(k.data, min=0.0) ** 2 \
            / torch.clamp(eps.data, min=self.eps_min)

    def correct(self, mesh, state, U, phi, nu, dt=None):
        self._nu = _nu_c(nu)
        return super().correct(mesh, state, U, phi, nu, dt=dt)


def wall_distance(case) -> torch.Tensor:
    """Distance from every cell slot's centre to the nearest wall-face
    centre of the case's mesh (the JAX package's replacement of the
    reference's patchWave wallDist, src/finiteVolume/fvMesh/wallDist: a
    k-d tree query on the host, once per case; 1e10 without a wall
    patch)."""
    from scipy.spatial import cKDTree
    mesh = case.mesh
    walls = [mesh.Cf[p.start:p.start + p.size] for p in mesh.patches
             if p.type == "wall"]
    if not walls:
        return torch.full((mesh.n_cells,), 1e10, dtype=mesh.dtype,
                          device=mesh.device)
    tree = cKDTree(torch.cat(walls).cpu().numpy())
    d, _ = tree.query(mesh.C.cpu().numpy(), workers=-1)
    return torch.as_tensor(np.asarray(d), dtype=mesh.dtype,
                           device=mesh.device)


class KOmegaSST:
    """Menter k-omega SST (reference: incompressible/RAS/kOmegaSST/
    kOmegaSST.H:115, the 2.3 formulation with F1-blended coefficients),
    steady or transient as kEpsilon."""
    needs = ("k", "omega", "nut")

    alphaK1, alphaK2 = 0.85, 1.0
    alphaOmega1, alphaOmega2 = 0.5, 0.856
    gamma1, gamma2 = 5.0 / 9.0, 0.44
    beta1, beta2 = 0.075, 0.0828
    betaStar = 0.09
    a1, b1, c1 = 0.31, 1.0, 10.0

    def __init__(self, case, coeffs: Dictionary):
        self.case = case
        self.k_min = 1e-15
        self.omega_min = 1e-10
        self.k_controls = case.solver_controls("k")
        self.omega_controls = case.solver_controls("omega")
        self.k_relax = case.relaxation_factor("k", default=0.7)
        self.omega_relax = case.relaxation_factor("omega", default=0.7)
        self.div_k = case.div_scheme("div(phi,k)")
        try:
            self.div_omega = case.div_scheme("div(phi,omega)")
        except KeyError:
            self.div_omega = self.div_k
        self.lap_corr = case.laplacian_scheme()
        self.ddt_scheme = case.ddt_scheme()
        t0 = time.perf_counter()
        #: wall distance per cell slot (the case's mesh)
        self.y = wall_distance(case)
        case.setup_seconds["wall_distance"] = time.perf_counter() - t0
        self._wall_rows: dict = {}

    def init_state(self, U):
        return {name: self.case.read_field(name) for name in self.needs}

    def nut(self, state):
        return state["nut"]

    nu_eff = KEpsilon.nu_eff
    _wall_cells = KEpsilon._wall_cells
    _store = KEpsilon._store

    @staticmethod
    def _blend(F1, c1v, c2v):
        return F1 * c1v + (1.0 - F1) * c2v

    def _omega_extra(self, mesh, U, k_pos, om_pos, gk, gom, s2):
        """An explicit omega source (kOmegaSSTSAS's QSAS)."""
        return 0.0

    def _wall_fix(self, mesh, state, U, nu, G):
        """omegaWallFunction's wall cells: omega fixed to sqrt(omega_vis^2
        + omega_log^2) and G overridden. Returns (G', omega fix mask,
        omega values). A cell with several faces on a wall patch keeps
        its last face (_wall_cells)."""
        k = state["k"]
        nut = state["nut"]
        fix = torch.zeros_like(G)
        om_vals = torch.zeros_like(G)
        G = G.clone()
        for i, (bc, patch) in enumerate(zip(state["omega"].bcs,
                                            mesh.patches)):
            if not isinstance(bc, OmegaWallFunction) or patch.size == 0:
                continue
            cells = mesh.patch_face_cells(patch)
            y = 1.0 / mesh.patch_delta_coeffs(patch)
            k_c = torch.clamp(k.data[cells], min=0.0)
            nu_w = nu.value if isinstance(nu, Dimensioned) else nu.data[cells]
            sl = slice(patch.bstart, patch.bstart + patch.size)
            nut_w = nut.bvalues[sl]
            mag_grad_uw = torch.linalg.norm(U.data[cells] - U.bvalues[sl],
                                            dim=-1) / y
            om_vis = 6.0 * nu_w / (self.beta1 * y * y)
            om_log = torch.sqrt(k_c) / (_CMU25 * _KAPPA * y)
            om_w = torch.sqrt(om_vis ** 2 + om_log ** 2)
            g_w = (nut_w + nu_w) * mag_grad_uw * _CMU25 * torch.sqrt(k_c) \
                / (_KAPPA * y)
            pos, rows = self._wall_cells(mesh, i, patch)
            G[rows] = g_w[pos]
            fix[rows] = 1.0
            om_vals[rows] = om_w[pos]
        return G, fix, om_vals

    def correct(self, mesh, state, U, phi, nu, dt=None):
        """One turbulence correction: the F1/F2 blending, the omega
        equation with its wall fix, the k equation, nut with F2
        (steadyState ddt when dt is None)."""
        k, omega, nut = state["k"], state["omega"], state["nut"]
        k, omega = self._store(mesh, k, dt), self._store(mesh, omega, dt)
        ddt_scheme, ddt_dt = _ddt(self.ddt_scheme, dt)
        y = self.y
        nu_c = nu.value if isinstance(nu, Dimensioned) else nu.data
        nu_b = nu.value if isinstance(nu, Dimensioned) else nu.bvalues

        s2 = magsqr_symm_grad(mesh, U)
        sqrt_s2 = torch.sqrt(torch.clamp(s2, min=0.0))
        G = nut.data * s2

        gk = fvc.grad(mesh, k)
        gom = fvc.grad(mesh, omega)
        om_pos = torch.clamp(omega.data, min=self.omega_min)
        cd_kom = torch.clamp(
            2.0 * self.alphaOmega2 * (gk.data * gom.data).sum(-1) / om_pos,
            min=1e-10)
        k_pos = torch.clamp(k.data, min=0.0)
        visc = 500.0 * nu_c / (y * y * om_pos)
        arg1 = torch.clamp(torch.minimum(torch.maximum(
            torch.sqrt(k_pos) / (self.betaStar * om_pos * y), visc),
            4.0 * self.alphaOmega2 * k_pos / (cd_kom * y * y)), max=10.0)
        F1 = torch.tanh(arg1 ** 4)
        arg2 = torch.clamp(torch.maximum(
            2.0 * torch.sqrt(k_pos) / (self.betaStar * om_pos * y), visc),
            max=100.0)
        F2 = torch.tanh(arg2 ** 2)

        gamma = self._blend(F1, self.gamma1, self.gamma2)
        beta = self._blend(F1, self.beta1, self.beta2)
        alpha_k = self._blend(F1, self.alphaK1, self.alphaK2)
        alpha_om = self._blend(F1, self.alphaOmega1, self.alphaOmega2)

        G, om_fix, om_vals = self._wall_fix(mesh, state, U, nu, G)

        d_om = nut.with_calculated_bcs(
            alpha_om * nut.data + nu_c, self.alphaOmega1 * nut.bvalues + nu_b,
            dim_viscosity, "DomegaEff")
        d_k = nut.with_calculated_bcs(
            alpha_k * nut.data + nu_c, self.alphaK1 * nut.bvalues + nu_b,
            dim_viscosity, "DkEff")

        # omega equation
        gamma_s2 = gamma * torch.minimum(
            s2, (self.c1 / self.a1) * self.betaStar * om_pos
            * torch.maximum(self.a1 * om_pos, self.b1 * F2 * sqrt_s2))
        extra = self._omega_extra(mesh, U, k_pos, om_pos, gk, gom, s2)
        rhs_om = omega.with_calculated_bcs(
            gamma_s2 + (1.0 - F1) * cd_kom + extra,
            torch.zeros_like(omega.bvalues),
            omega.dims / DimensionSet.of(0, 0, 1))
        om_eqn = (fvm.ddt(mesh, omega, ddt_dt, ddt_scheme)
                  + fvm.div(mesh, phi, omega, self.div_omega)
                  - fvm.laplacian(mesh, d_om, omega, self.lap_corr)
                  + fvm.Sp(mesh, Dimensioned("beta*omega", _RTIME,
                                             beta * om_pos), omega))
        om_eqn = om_eqn.equals(rhs_om).relax(mesh, self.omega_relax)
        om_eqn = om_eqn.set_values(mesh, om_fix, om_vals)
        omega_new, om_perf = solve(mesh, om_eqn, self.omega_controls,
                                   env={"phi": phi})
        omega_new = bound(omega_new, self.omega_min)

        # k equation
        rhs_k = k.with_calculated_bcs(
            torch.minimum(G, self.c1 * self.betaStar * k_pos * om_pos),
            torch.zeros_like(k.bvalues), k.dims / DimensionSet.of(0, 0, 1))
        k_eqn = (fvm.ddt(mesh, k, ddt_dt, ddt_scheme)
                 + fvm.div(mesh, phi, k, self.div_k)
                 - fvm.laplacian(mesh, d_k, k, self.lap_corr)
                 + fvm.Sp(mesh, Dimensioned(
                     "betaStar*omega", _RTIME,
                     self.betaStar * omega_new.data), k))
        k_eqn = k_eqn.equals(rhs_k).relax(mesh, self.k_relax)
        k_new, k_perf = solve(mesh, k_eqn, self.k_controls, env={"phi": phi})
        k_new = bound(k_new, self.k_min)

        nut_data = self.a1 * k_new.data / torch.maximum(
            self.a1 * torch.clamp(omega_new.data, min=self.omega_min),
            self.b1 * F2 * sqrt_s2)
        nut_new = nut.replace(data=nut_data).correct_boundary_conditions(
            mesh, env={"k": k_new, "nu": nu})
        return (dict(k=k_new, omega=omega_new, nut=nut_new),
                {"omega": om_perf[0], "k": k_perf[0]})


class KOmega:
    """Wilcox k-omega (port of rapidcfd_tpu/models/turbulence.py:402-497;
    reference: incompressible/RAS/kOmega/kOmega.C:253-281): omega
    production alpha G omega/k, destruction beta omega^2, nut = k/omega,
    and kOmegaSST's omega wall function with beta as its beta1."""
    needs = ("k", "omega", "nut")

    def __init__(self, case, coeffs: Dictionary):
        self.case = case
        c = coeffs or Dictionary()
        self.Cmu = c.scalar("Cmu", 0.09)
        self.beta = c.scalar("beta", 0.072)
        self.alpha = c.scalar("alpha", 0.52)
        self.alpha_k = c.scalar("alphaK", 0.5)
        self.alpha_omega = c.scalar("alphaOmega", 0.5)
        self.k_min = 1e-15
        self.omega_min = 1e-10
        self.k_controls = case.solver_controls("k")
        self.omega_controls = case.solver_controls("omega")
        self.k_relax = case.relaxation_factor("k", default=0.7)
        self.omega_relax = case.relaxation_factor("omega", default=0.7)
        self.div_k = case.div_scheme("div(phi,k)")
        try:
            self.div_omega = case.div_scheme("div(phi,omega)")
        except KeyError:
            self.div_omega = self.div_k
        self.lap_corr = case.laplacian_scheme()
        self.ddt_scheme = case.ddt_scheme()
        self.beta1 = self.beta      # the viscous-sublayer omega of the fix
        self._wall_rows: dict = {}

    def init_state(self, U):
        return {name: self.case.read_field(name) for name in self.needs}

    def nut(self, state):
        return state["nut"]

    nu_eff = KEpsilon.nu_eff
    _dcoeff = KEpsilon._dcoeff
    _wall_cells = KEpsilon._wall_cells
    _store = KEpsilon._store

    def _wall_fix(self, mesh, state, U, nu, G):
        return KOmegaSST._wall_fix(self, mesh, state, U, nu, G)

    def correct(self, mesh, state, U, phi, nu, dt=None):
        k, omega, nut = state["k"], state["omega"], state["nut"]
        k, omega = self._store(mesh, k, dt), self._store(mesh, omega, dt)
        ddt_scheme, ddt_dt = _ddt(self.ddt_scheme, dt)
        s2 = magsqr_symm_grad(mesh, U)
        G, om_fix, om_vals = self._wall_fix(
            mesh, dict(state, k=k, omega=omega), U, nu, nut.data * s2)
        d_om = self._dcoeff(state, nu, 1.0 / self.alpha_omega)
        d_k = self._dcoeff(state, nu, 1.0 / self.alpha_k)
        k_pos = torch.clamp(k.data, min=self.k_min)
        om_pos = torch.clamp(omega.data, min=self.omega_min)

        rhs_om = omega.with_calculated_bcs(
            self.alpha * G * omega.data / k_pos,
            torch.zeros_like(omega.bvalues),
            omega.dims / DimensionSet.of(0, 0, 1))
        om_eqn = (fvm.ddt(mesh, omega, ddt_dt, ddt_scheme)
                  + fvm.div(mesh, phi, omega, self.div_omega)
                  - fvm.laplacian(mesh, d_om, omega, self.lap_corr)
                  + fvm.Sp(mesh, Dimensioned("beta*omega", _RTIME,
                                             self.beta * om_pos), omega))
        om_eqn = om_eqn.equals(rhs_om).relax(mesh, self.omega_relax)
        om_eqn = om_eqn.set_values(mesh, om_fix, om_vals)
        omega_new, om_perf = solve(mesh, om_eqn, self.omega_controls,
                                   env={"phi": phi})
        omega_new = bound(omega_new, self.omega_min)

        rhs_k = k.with_calculated_bcs(G, torch.zeros_like(k.bvalues),
                                      k.dims / DimensionSet.of(0, 0, 1))
        k_eqn = (fvm.ddt(mesh, k, ddt_dt, ddt_scheme)
                 + fvm.div(mesh, phi, k, self.div_k)
                 - fvm.laplacian(mesh, d_k, k, self.lap_corr)
                 + fvm.Sp(mesh, Dimensioned(
                     "Cmu*omega", _RTIME, self.Cmu * omega_new.data), k))
        k_eqn = k_eqn.equals(rhs_k).relax(mesh, self.k_relax)
        k_new, k_perf = solve(mesh, k_eqn, self.k_controls, env={"phi": phi})
        k_new = bound(k_new, self.k_min)

        nut_data = k_new.data / torch.clamp(omega_new.data,
                                            min=self.omega_min)
        nut_new = nut.replace(data=nut_data).correct_boundary_conditions(
            mesh, env={"k": k_new, "nu": nu})
        return (dict(k=k_new, omega=omega_new, nut=nut_new),
                {"omega": om_perf[0], "k": k_perf[0]})


def magsqr_skew_grad(mesh, U: VolField):
    """2*|skew(grad U)|^2 per cell (its root is sqrt(2)|skew(grad U)|,
    the vorticity magnitude of the SA production)."""
    sk = _skew(fvc.grad(mesh, U).data)
    return 2.0 * (sk * sk).sum((-2, -1))


def _cbrt(x):
    return torch.pow(x, 1.0 / 3.0)


class SpalartAllmaras:
    """Spalart-Allmaras (port of rapidcfd_tpu/models/turbulence.py:
    832-926; reference: incompressible/RAS/SpalartAllmaras/
    SpalartAllmaras.C:45-136, 437-463): nut = nuTilda fv1, Stilda =
    sqrt(2)|skew(grad U)| + fv2 nuTilda/(kappa d)^2, production Cb1
    Stilda nuTilda, destruction Cw1 fw (nuTilda/d)^2 implicit. The DES
    forms override the length scale _d_tilde."""
    needs = ("nuTilda", "nut")

    def __init__(self, case, coeffs: Dictionary):
        self.case = case
        c = coeffs or Dictionary()
        self.sigma_nut = c.scalar("sigmaNut", 0.66666)
        self.kappa = c.scalar("kappa", 0.41)
        self.cb1 = c.scalar("Cb1", 0.1355)
        self.cb2 = c.scalar("Cb2", 0.622)
        self.cw1 = self.cb1 / self.kappa ** 2 \
            + (1.0 + self.cb2) / self.sigma_nut
        self.cw2 = c.scalar("Cw2", 0.3)
        self.cw3 = c.scalar("Cw3", 2.0)
        self.cv1 = c.scalar("Cv1", 7.1)
        self.controls = case.solver_controls("nuTilda")
        self.relax = case.relaxation_factor("nuTilda", default=0.7)
        self.div_nt = case.div_scheme("div(phi,nuTilda)")
        self.lap_corr = case.laplacian_scheme()
        self.ddt_scheme = case.ddt_scheme()
        t0 = time.perf_counter()
        self.y = torch.clamp(wall_distance(case), min=1e-10)
        case.setup_seconds["wall_distance"] = time.perf_counter() - t0

    def init_state(self, U):
        return {name: self.case.read_field(name) for name in self.needs}

    def nut(self, state):
        return state["nut"]

    nu_eff = KEpsilon.nu_eff
    _store = KEpsilon._store

    def _d_tilde(self, mesh, state, U, nu):
        """The length scale: the wall distance (DES: its blend with the
        grid scale)."""
        return self.y

    def correct(self, mesh, state, U, phi, nu, dt=None):
        nu_tilda, nut = state["nuTilda"], state["nut"]
        nu_tilda = self._store(mesh, nu_tilda, dt)
        ddt_scheme, ddt_dt = _ddt(self.ddt_scheme, dt)
        nu_c = _nu_c(nu)
        d = self._d_tilde(mesh, state, U, nu)

        nt_pos = torch.clamp(nu_tilda.data, min=0.0)
        chi = nt_pos / nu_c
        chi3 = chi ** 3
        fv1 = chi3 / (chi3 + self.cv1 ** 3)
        fv2 = 1.0 - chi / (1.0 + chi * fv1)
        omega_mag = torch.sqrt(torch.clamp(magsqr_skew_grad(mesh, U),
                                           min=0.0))
        stilda = torch.clamp(
            omega_mag + fv2 * nt_pos / (self.kappa * d) ** 2, min=1e-20)
        r = torch.clamp(nt_pos / (stilda * (self.kappa * d) ** 2), max=10.0)
        g = r + self.cw2 * (r ** 6 - r)
        fw = g * ((1.0 + self.cw3 ** 6)
                  / (g ** 6 + self.cw3 ** 6)) ** (1.0 / 6.0)

        d_nt = nu_tilda.with_calculated_bcs(
            (nt_pos + nu_c) / self.sigma_nut,
            (torch.clamp(nu_tilda.bvalues, min=0.0) + _nu_b(nu))
            / self.sigma_nut, dim_viscosity, "DnuTildaEff")
        g_nt = fvc.grad(mesh, nu_tilda).data
        rhs = nu_tilda.with_calculated_bcs(
            self.cb1 * stilda * nt_pos
            + (self.cb2 / self.sigma_nut) * (g_nt * g_nt).sum(-1),
            torch.zeros_like(nu_tilda.bvalues),
            nu_tilda.dims / DimensionSet.of(0, 0, 1))
        eqn = (fvm.ddt(mesh, nu_tilda, ddt_dt, ddt_scheme)
               + fvm.div(mesh, phi, nu_tilda, self.div_nt)
               - fvm.laplacian(mesh, d_nt, nu_tilda, self.lap_corr)
               + fvm.Sp(mesh, Dimensioned(
                   "Cw1*fw*nuTilda/d^2", _RTIME,
                   self.cw1 * fw * nt_pos / (d * d)), nu_tilda))
        eqn = eqn.equals(rhs).relax(mesh, self.relax)
        nt_new, perf = solve(mesh, eqn, self.controls, env={"phi": phi})
        nt_new = bound(nt_new, 0.0)

        chi_n = nt_new.data / nu_c
        fv1_n = chi_n ** 3 / (chi_n ** 3 + self.cv1 ** 3)
        nut_new = nut.replace(data=fv1_n * nt_new.data) \
            .correct_boundary_conditions(mesh, env={"k": nt_new, "nu": nu})
        return dict(nuTilda=nt_new, nut=nut_new), {"nuTilda": perf[0]}


class SpalartAllmarasDES(SpalartAllmaras):
    """DES-97 (port of rapidcfd_tpu/models/turbulence.py:929-942;
    reference: incompressible/LES/SpalartAllmaras): the SA equation with
    d_tilde = min(d, CDES delta), delta = deltaCoeff cbrt(V)."""

    def __init__(self, case, coeffs: Dictionary):
        super().__init__(case, coeffs)
        c = coeffs or Dictionary()
        self.cdes = c.scalar("CDES", 0.65)
        self.delta = c.scalar("deltaCoeff", 1.0) * _cbrt(case.mesh.V)

    def _d_tilde(self, mesh, state, U, nu):
        return torch.minimum(self.y, self.cdes * self.delta)


class SpalartAllmarasDDES(SpalartAllmarasDES):
    """Delayed DES (port of rapidcfd_tpu/models/turbulence.py:945-970;
    reference: incompressible/LES/SpalartAllmarasDDES): d_tilde = d -
    fd max(0, d - CDES delta), fd = 1 - tanh((8 rd)^3)."""

    def _d_tilde(self, mesh, state, U, nu):
        g = fvc.grad(mesh, U).data
        mag_grad = torch.sqrt(torch.clamp((g * g).sum((-2, -1)), min=1e-30))
        rd = torch.clamp(torch.clamp(state["nuTilda"].data, min=0.0)
                         / (mag_grad * (self.kappa * self.y) ** 2), max=10.0)
        fd = 1.0 - torch.tanh((8.0 * rd) ** 3)
        return self.y - fd * torch.clamp(self.y - self.cdes * self.delta,
                                         min=0.0)


class V2F:
    """Lien-Kalitzin v2-f with the Davidson limiter (port of
    rapidcfd_tpu/models/turbulence.py:1061-1223; reference: incompressible/
    RAS/v2f/v2f.C:360-450, Ts and Ls :78-87): epsilon, k, the elliptic f
    and v2; nut = min(Cmu v2 Ts, CmuKEps k^2/epsilon), epsilon's wall
    cells fixed as kEpsilon's."""
    needs = ("k", "epsilon", "v2", "f", "nut")
    N = 6.0

    def __init__(self, case, coeffs: Dictionary):
        self.case = case
        c = coeffs or Dictionary()
        self.cmu = c.scalar("Cmu", 0.22)
        self.cmu_keps = c.scalar("CmuKEps", 0.09)
        self.c1 = c.scalar("C1", 1.4)
        self.c2 = c.scalar("C2", 0.3)
        self.cl = c.scalar("CL", 0.23)
        self.ceta = c.scalar("Ceta", 70.0)
        self.ceps2 = c.scalar("Ceps2", 1.9)
        self.sigma_k = c.scalar("sigmaK", 1.0)
        self.sigma_eps = c.scalar("sigmaEps", 1.3)
        self.k_min = self.eps_min = self.v2_min = 1e-15
        self.f_min = 0.0
        names = ("k", "epsilon", "v2", "f")
        self.controls = {n: case.solver_controls(n) for n in names}
        self.relax = {n: case.relaxation_factor(n, default=0.7)
                      for n in names}
        self.div_of = {}
        for n in ("k", "epsilon", "v2"):
            try:
                self.div_of[n] = case.div_scheme(f"div(phi,{n})")
            except KeyError:
                self.div_of[n] = case.div_scheme("div(phi,k)")
        self.lap_corr = case.laplacian_scheme()
        self.ddt_scheme = case.ddt_scheme()
        self._wall_rows: dict = {}

    def init_state(self, U):
        return {name: self.case.read_field(name) for name in self.needs}

    def nut(self, state):
        return state["nut"]

    nu_eff = KEpsilon.nu_eff
    _dcoeff = KEpsilon._dcoeff
    _wall_cells = KEpsilon._wall_cells
    _wall_fix = KEpsilon._wall_fix
    _store = KEpsilon._store

    def correct(self, mesh, state, U, phi, nu, dt=None):
        k, eps = state["k"], state["epsilon"]
        v2, f, nut = state["v2"], state["f"], state["nut"]
        k, eps, v2 = (self._store(mesh, x, dt) for x in (k, eps, v2))
        ddt_scheme, dt_v = _ddt(self.ddt_scheme, dt)
        nu_c = _nu_c(nu)

        dev = _dev(_sym(fvc.grad(mesh, U).data))
        s2 = 2.0 * (dev * dev).sum((-2, -1))
        G, eps_fix, eps_vals = self._wall_fix(mesh, state, U, nu,
                                              nut.data * s2)
        k_pos = torch.clamp(k.data, min=self.k_min)
        eps_pos = torch.clamp(eps.data, min=self.eps_min)
        v2_pos = torch.clamp(v2.data, min=self.v2_min)
        T = torch.maximum(k_pos / eps_pos, 6.0 * torch.sqrt(nu_c / eps_pos))
        L2 = (self.cl * torch.maximum(
            k_pos ** 1.5 / eps_pos,
            self.ceta * (nu_c ** 3 / eps_pos) ** 0.25)) ** 2
        alpha = ((self.c1 - self.N) * v2_pos
                 - (2.0 / 3.0) * k_pos * (self.c1 - 1.0)) / T
        ceps1 = 1.4 * (1.0 + 0.05 * torch.clamp(torch.sqrt(k_pos / v2_pos),
                                                max=100.0))
        one = Dimensioned("1", DimensionSet(), 1.0)
        rdims = _RTIME

        # epsilon
        rhs = eps.with_calculated_bcs(ceps1 * G / T,
                                      torch.zeros_like(eps.bvalues),
                                      eps.dims * rdims)
        eqn = (fvm.ddt(mesh, eps, dt_v, ddt_scheme)
               + fvm.div(mesh, phi, eps, self.div_of["epsilon"])
               - fvm.laplacian(mesh, self._dcoeff(state, nu, self.sigma_eps),
                               eps, self.lap_corr)
               + fvm.Sp(mesh, Dimensioned("Ceps2/T", rdims, self.ceps2 / T),
                        eps))
        eqn = eqn.equals(rhs).relax(mesh, self.relax["epsilon"])
        eqn = eqn.set_values(mesh, eps_fix, eps_vals)
        eps_new, eps_perf = solve(mesh, eqn, self.controls["epsilon"],
                                  env={"phi": phi})
        eps_new = bound(eps_new, self.eps_min)

        # k
        rhs = k.with_calculated_bcs(G, torch.zeros_like(k.bvalues),
                                    k.dims * rdims)
        eqn = (fvm.ddt(mesh, k, dt_v, ddt_scheme)
               + fvm.div(mesh, phi, k, self.div_of["k"])
               - fvm.laplacian(mesh, self._dcoeff(state, nu, self.sigma_k),
                               k, self.lap_corr)
               + fvm.Sp(mesh, Dimensioned("eps/k", rdims,
                                          eps_new.data / k_pos), k))
        eqn = eqn.equals(rhs).relax(mesh, self.relax["k"])
        k_new, k_perf = solve(mesh, eqn, self.controls["k"],
                              env={"phi": phi})
        k_new = bound(k_new, self.k_min)

        # f: -laplacian(f) + Sp(1/L2, f) == -(alpha - C2 G)/(L2 k)
        rhs = f.with_calculated_bcs(-(alpha - self.c2 * G) / (L2 * k_pos),
                                    torch.zeros_like(f.bvalues),
                                    f.dims / (dim_length ** 2))
        eqn = (-fvm.laplacian(mesh, one, f, self.lap_corr)
               + fvm.Sp(mesh, Dimensioned("1/L2", DimensionSet.of(0, -2, 0),
                                          1.0 / L2), f))
        eqn = eqn.equals(rhs).relax(mesh, self.relax["f"])
        f_new, f_perf = solve(mesh, eqn, self.controls["f"],
                              env={"phi": phi})
        f_new = bound(f_new, self.f_min)

        # v2
        rhs = v2.with_calculated_bcs(
            torch.minimum(k_new.data * f_new.data, -alpha + self.c2 * G),
            torch.zeros_like(v2.bvalues), v2.dims * rdims)
        eqn = (fvm.ddt(mesh, v2, dt_v, ddt_scheme)
               + fvm.div(mesh, phi, v2, self.div_of["v2"])
               - fvm.laplacian(mesh, self._dcoeff(state, nu, self.sigma_k),
                               v2, self.lap_corr)
               + fvm.Sp(mesh, Dimensioned(
                   "N*eps/k", rdims, self.N * eps_new.data
                   / torch.clamp(k_new.data, min=self.k_min)), v2))
        eqn = eqn.equals(rhs).relax(mesh, self.relax["v2"])
        v2_new, v2_perf = solve(mesh, eqn, self.controls["v2"],
                                env={"phi": phi})
        v2_new = bound(v2_new, self.v2_min)

        # nut with the Davidson limiter
        eps_n = torch.clamp(eps_new.data, min=self.eps_min)
        T_new = torch.maximum(torch.clamp(k_new.data, min=self.k_min) / eps_n,
                              6.0 * torch.sqrt(nu_c / eps_n))
        nut_data = torch.minimum(self.cmu * v2_new.data * T_new,
                                 self.cmu_keps * k_new.data ** 2 / eps_n)
        nut_new = nut.replace(data=nut_data).correct_boundary_conditions(
            mesh, env={"k": k_new, "nu": nu})
        return (dict(k=k_new, epsilon=eps_new, v2=v2_new, f=f_new,
                     nut=nut_new),
                {"epsilon": eps_perf[0], "k": k_perf[0], "f": f_perf[0],
                 "v2": v2_perf[0]})


# ---------------------------------------------------------------------------
# LES: the test filter, the deltas and the core models
# ---------------------------------------------------------------------------

def simple_filter(mesh, cell_data: torch.Tensor) -> torch.Tensor:
    """LES test filter (port of rapidcfd_tpu/models/turbulence.py:1226-1238;
    reference: LESfilters/simpleFilter/simpleFilter.C:69-76):
    surfaceSum(magSf interpolate(x)) / surfaceSum(magSf), the boundary
    faces taking their owner's value. The face values and the unsigned
    sums are fvc.face_own_nei and fvc.surface_sum_faces, on the ELL and
    on gdia. A slot with no face (a dead lattice slot) divides by one."""
    n_int = mesh.n_internal
    own, nei = fvc.face_own_nei(mesh, cell_data)
    w = fvc._ext(mesh.weights[:n_int], own)
    face = torch.cat([w * own + (1.0 - w) * nei,
                      fvc.boundary_owner_values(mesh, cell_data)])
    num = fvc.surface_sum_faces(mesh, face * fvc._ext(mesh.mag_sf, face),
                                signed=False)
    den = fvc.surface_sum_faces(mesh, mesh.mag_sf, signed=False)
    den = torch.where(den > 0, den, torch.ones_like(den))
    return num / fvc._ext(den, num)


def max_delta_xyz(mesh) -> torch.Tensor:
    """maxDeltaxyz (reference: LESdeltas/maxDeltaxyz): twice the largest
    component of |Cf - C| over each cell's faces (empty-patch and
    zero-area faces left out, as the padded ELL leaves them)."""
    if mesh.gdia is None:
        d = (mesh.Cf[mesh.cell_faces] - mesh.C[:, None, :]).abs()
        return 2.0 * (d * mesh.cell_sign.abs()[:, :, None]).amax((1, 2))
    from ..mesh import gdia as gd
    g, n_int = mesh.gdia, mesh.n_internal
    own, nei = gd.face_own_nei(g, mesh.C)
    real = (mesh.mag_sf[:n_int] > 0)[:, None]
    zero = torch.zeros((), dtype=mesh.C.dtype, device=mesh.C.device)
    d_own = torch.where(real, (mesh.Cf[:n_int] - own).abs(), zero)
    d_nei = torch.where(real, (mesh.Cf[:n_int] - nei).abs(), zero)
    out = torch.zeros_like(mesh.C)
    for (pi, step), fo, fn in zip(gd.plane_steps(g),
                                  gd.face_planes(g, d_own),
                                  gd.face_planes(g, d_nei)):
        out = torch.maximum(out, torch.maximum(
            fo, gd._shift_flat(fn, step, g.n_lat)))
    for p in mesh.patches:
        if p.is_empty or p.size == 0:
            continue
        cells = mesh.patch_face_cells(p)
        d = torch.where((mesh.patch_mag_sf(p) > 0)[:, None],
                        (mesh.Cf[p.start:p.start + p.size]
                         - mesh.C[cells]).abs(), zero)
        out = out.scatter_reduce(0, cells[:, None].expand(-1, 3), d, "amax")
    return 2.0 * gd.sync(g, out).amax(1)


def les_delta(case, coeffs) -> torch.Tensor:
    """LESdelta (port of rapidcfd_tpu/models/turbulence.py:1241-1268;
    reference: LESdeltas/): cubeRootVol (the default), maxDeltaxyz,
    smooth (cubeRootVol bounded between neighbours, 8 sweeps of
    fvc.smooth) and Prandtl, min(cubeRootVol, kappa y/Cdelta); vanDriest
    takes Prandtl's form, as in the JAX package (its y+ damping needs the
    wall shear every step). Any other word takes cubeRootVol."""
    c = coeffs or Dictionary()
    mesh = case.mesh
    name = c.word("delta", "cubeRootVol")
    base = c.scalar("deltaCoeff", 1.0) * _cbrt(mesh.V)
    if name == "maxDeltaxyz":
        return max_delta_xyz(mesh)
    if name == "smooth":
        sub = c.subdict("smoothCoeffs", required=False) or Dictionary()
        return fvc.smooth(mesh, base, 1.0 / sub.scalar("maxDeltaRatio", 1.1),
                          sweeps=8)
    if name in ("Prandtl", "vanDriest"):
        sub = c.subdict(name + "Coeffs", required=False) or Dictionary()
        kappa = sub.scalar("kappa", 0.41)
        cdelta = sub.scalar("Cdelta", 0.158)
        return torch.minimum(base, kappa * wall_distance(case) / cdelta)
    return base


class Smagorinsky:
    """Smagorinsky (port of rapidcfd_tpu/models/turbulence.py:696-727;
    reference: incompressible/LES/Smagorinsky): the JAX package's Cs form
    nut = (Cs delta)^2 sqrt(2 S:S), not OpenFOAM 2.3's ck/ce form."""
    needs = ("nut",)

    def __init__(self, case, coeffs: Dictionary):
        self.case = case
        c = coeffs or Dictionary()
        self.cs = c.scalar("Cs", 0.17)
        self.delta = les_delta(case, c)

    def init_state(self, U):
        return {"nut": self.case.read_field("nut")}

    def nut(self, state):
        return state["nut"]

    nu_eff = KEpsilon.nu_eff

    def correct(self, mesh, state, U, phi, nu, dt=None):
        s2 = magsqr_symm_grad(mesh, U)
        nut_data = (self.cs * self.delta) ** 2 * torch.sqrt(
            torch.clamp(s2, min=0.0))
        nut = state["nut"].replace(data=nut_data)
        return {"nut": nut.correct_boundary_conditions(
            mesh, env={"k": nut, "nu": nu})}, {}


class OneEqEddy:
    """The one-equation SGS model oneEqEddy / kEqn (port of rapidcfd_tpu/
    models/turbulence.py:729-781; reference: incompressible/LES/oneEqEddy/
    oneEqEddy.C): the k-SGS transport with the sink ce sqrt(k)/delta,
    nut = ck sqrt(k) delta."""
    needs = ("k", "nut")

    def __init__(self, case, coeffs: Dictionary):
        self.case = case
        c = coeffs or Dictionary()
        self.ck = c.scalar("ck", 0.094)
        self.ce = c.scalar("ce", 1.048)
        self.delta = les_delta(case, c)
        self.k_min = 1e-15
        self.k_controls = case.solver_controls("k")
        self.div_k = case.div_scheme("div(phi,k)")
        self.lap_corr = case.laplacian_scheme()
        self.ddt_scheme = case.ddt_scheme()

    def init_state(self, U):
        return {name: self.case.read_field(name) for name in self.needs}

    def nut(self, state):
        return state["nut"]

    nu_eff = KEpsilon.nu_eff
    _dcoeff = KEpsilon._dcoeff
    _store = KEpsilon._store

    def _coeffs(self, mesh, U, k, nut, nu):
        """(ck, ce): the model's constants (dynOneEqEddy: per cell)."""
        return self.ck, self.ce

    def correct(self, mesh, state, U, phi, nu, dt=None):
        k, nut = state["k"], state["nut"]
        k = self._store(mesh, k, dt)
        ddt_scheme, ddt_dt = _ddt(self.ddt_scheme, dt)
        ck, ce = self._coeffs(mesh, U, k, nut, nu)
        G = nut.data * magsqr_symm_grad(mesh, U)
        k_pos = torch.clamp(k.data, min=self.k_min)
        rhs_k = k.with_calculated_bcs(G, torch.zeros_like(k.bvalues),
                                      k.dims / DimensionSet.of(0, 0, 1))
        k_eqn = (fvm.ddt(mesh, k, ddt_dt, ddt_scheme)
                 + fvm.div(mesh, phi, k, self.div_k)
                 - fvm.laplacian(mesh, self._dcoeff(state, nu, 1.0), k,
                                 self.lap_corr)
                 + fvm.Sp(mesh, Dimensioned(
                     "ce*sqrt(k)/delta", _RTIME,
                     ce * torch.sqrt(k_pos) / self.delta), k))
        k_new, k_perf = solve(mesh, k_eqn.equals(rhs_k), self.k_controls,
                              env={"phi": phi})
        k_new = bound(k_new, self.k_min)
        nut_new = nut.replace(data=ck * torch.sqrt(k_new.data) * self.delta) \
            .correct_boundary_conditions(mesh, env={"k": k_new, "nu": nu})
        return dict(k=k_new, nut=nut_new), {"k": k_perf[0]}


class DynOneEqEddy(OneEqEddy):
    """dynOneEqEddy and homogeneousDynOneEqEddy (port of rapidcfd_tpu/
    models/turbulence.py:1271-1345; reference: incompressible/LES/
    dynOneEqEddy/dynOneEqEddy.C:46-172): ck and ce per cell from the
    Germano identity with the simple test filter (11 filter passes a
    step), then oneEqEddy's k equation and nut."""

    def _coeffs(self, mesh, U, k, nut, nu):
        d = self.delta
        u = U.data
        filt_u = simple_filter(mesh, u)
        filt_uu = simple_filter(mesh, u[:, :, None] * u[:, None, :])
        kk = torch.clamp(0.5 * (filt_uu.diagonal(dim1=1, dim2=2).sum(-1)
                                - (filt_u * filt_u).sum(-1)), min=1e-20)
        D = _sym(fvc.grad(mesh, U).data)
        filt_d = simple_filter(mesh, D)
        ll_raw = filt_uu - filt_u[:, :, None] * filt_u[:, None, :]
        LL = simple_filter(mesh, _dev(ll_raw))
        MM = simple_filter(mesh, -2.0 * d[:, None, None]
                           * torch.sqrt(kk)[:, None, None] * filt_d)
        ck = simple_filter(mesh, 0.5 * (LL * MM).sum((-2, -1))) \
            / (simple_filter(mesh, (MM * MM).sum((-2, -1))) + 1e-30)
        ck = torch.clamp(ck, min=0.0)
        nu_eff = nut.data + _nu_c(nu)
        ce = simple_filter(mesh, nu_eff * (
            simple_filter(mesh, (D * D).sum((-2, -1)))
            - (filt_d * filt_d).sum((-2, -1)))) \
            / (simple_filter(mesh, kk ** 1.5 / (2.0 * d)) + 1e-30)
        return ck, torch.clamp(ce, min=0.0)



#: RASModel names -> model classes: every name the JAX package registers
#: under RASModel (rapidcfd_tpu/models/turbulence.py and
#: turbulence_extra.py; models/turbulence_extra.py adds kkLOmega and
#: LienCubicKE)
RAS_MODELS = {"laminar": Laminar, "kEpsilon": KEpsilon,
              "RNGkEpsilon": RNGkEpsilon, "realizableKE": RealizableKE,
              "kOmega": KOmega, "kOmegaSST": KOmegaSST,
              "SpalartAllmaras": SpalartAllmaras,
              "LaunderSharmaKE": LaunderSharmaKE, "qZeta": QZeta,
              "v2f": V2F}
#: LESModel names -> model classes, aliases included (turbulence_extra
#: adds the rest of the JAX package's LESModel registrations)
LES_MODELS = {"laminar": Laminar, "Smagorinsky": Smagorinsky,
              "oneEqEddy": OneEqEddy, "kEqn": OneEqEddy,
              "dynOneEqEddy": DynOneEqEddy,
              "homogeneousDynOneEqEddy": DynOneEqEddy,
              "SpalartAllmarasDES": SpalartAllmarasDES,
              "SpalartAllmaras": SpalartAllmarasDES,
              "SpalartAllmarasDDES": SpalartAllmarasDDES}


def _ras_selection(case):
    """(kind, model name, its coefficients dictionary) from constant/
    RASProperties or turbulenceProperties (an LES model and its
    <name>Coeffs, with the delta, in the latter): kind is "RAS"
    or "LES"; ('RAS', 'laminar', None) when there is none or the model is
    switched off."""
    props = None
    for fname in ("RASProperties", "turbulenceProperties"):
        path = os.path.join(case.dir, "constant", fname)
        if os.path.isfile(path):
            props = parse_file(path)
            break
    if props is None:
        return "RAS", "laminar", None
    sim_type = props.word("simulationType", "RAS") \
        if props.lookup("simulationType") is not None else None
    if sim_type in ("LES", "LESModel") or props.lookup("LES") is not None \
            or props.lookup("LESModel") is not None:
        sub = props.subdict("LES", required=False) or props
        name = sub.word("LESModel", "Smagorinsky")
        if not sub.boolean("turbulence", True):
            return "RAS", "laminar", None
        return "LES", name, sub.subdict(name + "Coeffs", required=False)
    if sim_type == "laminar":
        return "RAS", "laminar", None
    if props.lookup("RAS") is not None:     # the modern format nests RAS {}
        sub = props.subdict("RAS")
        name = sub.word("RASModel", "laminar")
        coeffs = sub.subdict(name + "Coeffs", required=False)
        on = sub.boolean("turbulence", True)
    else:
        name = props.word("RASModel", "laminar")
        coeffs = props.subdict(name + "Coeffs", required=False)
        on = props.boolean("turbulence", True)
    return ("RAS", name, coeffs) if on else ("RAS", "laminar", None)


def ras_model_name(case) -> str:
    """The turbulence model a case asks for ('laminar' without one)."""
    return _ras_selection(case)[1]


def make_ras_model(case, U):
    """incompressible::RASModel::New and LESModel::New (port of
    rapidcfd_tpu/models/turbulence.py:784-822): reads constant/
    RASProperties or turbulenceProperties; laminar when
    there is none. A name the JAX package does not register raises."""
    kind, name, coeffs = _ras_selection(case)
    if name == "laminar":
        return Laminar(case, Dictionary())
    table = RAS_MODELS if kind == "RAS" else LES_MODELS
    cls = table.get(name)
    if cls is None:
        raise NotImplementedError(
            f"{kind}Model '{name}' is not ported (ported: "
            f"{', '.join(sorted(table))})")
    return cls(case, coeffs)


class CompressibleTurbulence:
    """Compressible adapter over the RAS models above (port of
    rapidcfd_tpu/models/turbulence.py:1348-1390; reference: src/
    turbulenceModels/compressible/RAS, the rho-weighted forms of the same
    models): muEff = mu + mut and alphaEff = alpha + mut/Prt with
    mut = rho*nut.

    As in the JAX package, the turbulence equations are solved in
    kinematic form with the volumetric flux phi/rho_f and nu = mu/rho
    (exact where the density is solenoidal; the drho/dt transport terms
    of the rho-weighted forms are dropped). The momentum and energy
    equations take the full mut."""

    def __init__(self, case, U, prt: float = 1.0):
        self.inner = make_ras_model(case, U)
        self.prt = prt

    @property
    def laminar(self) -> bool:
        return isinstance(self.inner, Laminar)

    def init_state(self, U):
        return self.inner.init_state(U)

    def correct(self, mesh, state, U, phi_mass, rho, nu: VolField,
                dt=None):
        if self.laminar:
            return state, {}
        rho_f = fvc.face_values(mesh, rho)
        phi_vol = SurfaceField(phi_mass.data / torch.clamp(rho_f, min=1e-10),
                               phi_mass.dims / rho.dims, "phiByRho")
        return self.inner.correct(mesh, state, U, phi_vol, nu, dt=dt)

    def mut_faces(self, mesh, state, rho_f):
        """Face eddy viscosity rho_f * nut_f, or None (laminar)."""
        if self.laminar:
            return None
        nut = self.inner.nut(state)
        if nut is None:
            return None
        return rho_f * torch.clamp(fvc.face_values(mesh, nut), min=0.0)


# turbulence_extra adds the rest of the JAX package's registrations to both
# tables; it imports this module, so it comes last
from . import turbulence_extra  # noqa: E402,F401
