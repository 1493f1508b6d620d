"""RAS turbulence: laminar, kEpsilon and kOmegaSST with wall functions
(port of rapidcfd_tpu/models/turbulence.py:52-326, :498-694 and
:784-822; reference: src/turbulenceModels/incompressible/RAS/kEpsilon/
kEpsilon.C:229-280 and kOmegaSST/kOmegaSST.H:115).

A model's correct() is a plain function over a state dict of VolFields:
steady (simpleFoam) without a time step, transient with one (pimpleFoam
and pisoFoam: the old time level of each solved field is stored and the
case's ddt scheme is used).
The wall functions are BC descriptors (fields/bcs.py, re-exported here)
and a pass that fixes epsilon or omega and the production in the wall
cells (fvMatrix::setValues). kOmegaSST's wall distance is a host k-d tree
query over the wall-face centres, once per case. Other RAS models and LES
are not ported: make_ras_model raises on them. CompressibleTurbulence
wraps a model for the compressible solvers (mut = rho*nut).
"""

from __future__ import annotations

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
from ..utils.dimensions import DimensionSet, dim_viscosity

__all__ = ["CompressibleTurbulence", "EpsilonWallFunction", "KEpsilon",
           "KOmegaSST", "KqRWallFunction", "Laminar", "NutkWallFunction",
           "OmegaWallFunction", "bound",
           "magsqr_symm_grad", "make_ras_model", "ras_model_name",
           "wall_distance"]

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
    """Standard k-epsilon (reference: incompressible/RAS/kEpsilon)."""
    needs = ("k", "epsilon", "nut")

    def __init__(self, case, coeffs: Dictionary):
        self.case = case
        c = coeffs or Dictionary()
        self.Cmu = c.scalar("Cmu", 0.09)
        self.C1 = c.scalar("C1", 1.44)
        self.C2 = c.scalar("C2", 1.92)
        self.sigma_k = c.scalar("sigmak", 1.0)
        self.sigma_eps = c.scalar("sigmaEps", 1.3)
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
        # cells): the wall cells of each epsilonWallFunction patch
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

    def correct(self, mesh, state, U, phi, nu, dt=None):
        """One turbulence correction (reference kEpsilon.C:229-280):
        steadyState ddt when dt is None, else the case's ddt scheme over
        dt (a float or a 0-d tensor)."""
        k, eps, nut = state["k"], state["epsilon"], state["nut"]
        if dt is not None:
            k, eps = k.store_old(), eps.store_old()
        ddt_scheme, ddt_dt = _ddt(self.ddt_scheme, dt)
        s2 = magsqr_symm_grad(mesh, U)
        G = nut.data * s2                              # [m2/s3]
        G, eps_fix, eps_vals = self._wall_fix(mesh, state, U, nu, G)

        nu_eff_eps = self._dcoeff(state, nu, self.sigma_eps)
        nu_eff_k = self._dcoeff(state, nu, self.sigma_k)
        k_floor = torch.clamp(k.data, min=self.k_min)

        # epsilon equation
        rhs_eps = eps.with_calculated_bcs(
            self.C1 * G * eps.data / k_floor, torch.zeros_like(eps.bvalues),
            eps.dims / DimensionSet.of(0, 0, 1))
        eps_eqn = (fvm.ddt(mesh, eps, ddt_dt, ddt_scheme)
                   + fvm.div(mesh, phi, eps, self.div_eps)
                   - fvm.laplacian(mesh, nu_eff_eps, eps, self.lap_corr)
                   + fvm.Sp(mesh, Dimensioned(
                       "epsDest", _RTIME, self.C2 * eps.data / k_floor),
                       eps))
        eps_eqn = eps_eqn.equals(rhs_eps).relax(mesh, self.eps_relax)
        eps_eqn = eps_eqn.set_values(mesh, eps_fix, eps_vals)
        eps_new, eps_perf = solve(mesh, eps_eqn, self.eps_controls,
                                  env={"phi": phi})
        eps_new = bound(eps_new, self.eps_min)

        # k equation
        rhs_k = k.with_calculated_bcs(G, torch.zeros_like(k.bvalues),
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
        nut_data = self.Cmu * k_new.data ** 2 \
            / torch.clamp(eps_new.data, min=self.eps_min)
        nut_new = nut.replace(data=nut_data).correct_boundary_conditions(
            mesh, env={"k": k_new, "nu": nu})
        return (dict(k=k_new, epsilon=eps_new, nut=nut_new),
                {"k": k_perf[0], "epsilon": eps_perf[0]})

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

    @staticmethod
    def _blend(F1, c1v, c2v):
        return F1 * c1v + (1.0 - F1) * c2v

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
        if dt is not None:
            k, omega = k.store_old(), omega.store_old()
        ddt_scheme, ddt_dt = _ddt(self.ddt_scheme, dt)
        y = self.y
        nu_c = nu.value if isinstance(nu, Dimensioned) else nu.data
        nu_b = nu.value if isinstance(nu, Dimensioned) else nu.bvalues

        s2 = magsqr_symm_grad(mesh, U)
        sqrt_s2 = torch.sqrt(torch.clamp(s2, min=0.0))
        G = nut.data * s2

        gk = fvc.grad(mesh, k).data
        gom = fvc.grad(mesh, omega).data
        om_pos = torch.clamp(omega.data, min=self.omega_min)
        cd_kom = torch.clamp(
            2.0 * self.alphaOmega2 * (gk * gom).sum(-1) / om_pos, min=1e-10)
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
        rhs_om = omega.with_calculated_bcs(
            gamma_s2 + (1.0 - F1) * cd_kom, torch.zeros_like(omega.bvalues),
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


RAS_MODELS = {"laminar": Laminar, "kEpsilon": KEpsilon,
              "kOmegaSST": KOmegaSST}


def _ras_selection(case):
    """(model name, its coefficients dictionary) from constant/
    RASProperties or constant/turbulenceProperties; ('laminar', None)
    when there is neither or the model is switched off."""
    props = None
    for fname in ("RASProperties", "turbulenceProperties"):
        path = os.path.join(case.dir, "constant", fname)
        if os.path.isfile(path):
            props = parse_file(path)
            break
    if props is None:
        return "laminar", None
    sim_type = props.word("simulationType", "RAS") \
        if props.lookup("simulationType") is not None else None
    if sim_type in ("LES", "LESModel") or props.lookup("LES") is not None \
            or props.lookup("LESModel") is not None:
        raise NotImplementedError("LES models are not ported yet")
    if sim_type == "laminar":
        return "laminar", None
    if props.lookup("RAS") is not None:     # the modern format nests RAS {}
        sub = props.subdict("RAS")
        name = sub.word("RASModel", "laminar")
        coeffs = sub.subdict(name + "Coeffs", required=False)
        on = sub.boolean("turbulence", True)
    else:
        name = props.word("RASModel", "laminar")
        coeffs = props.subdict(name + "Coeffs", required=False)
        on = props.boolean("turbulence", True)
    return (name, coeffs) if on else ("laminar", None)


def ras_model_name(case) -> str:
    """The RAS model a case asks for ('laminar' without one)."""
    return _ras_selection(case)[0]


def make_ras_model(case, U):
    """incompressible::RASModel::New: reads constant/RASProperties or
    constant/turbulenceProperties; laminar when there is neither."""
    name, coeffs = _ras_selection(case)
    if name == "laminar":
        return Laminar(case, Dictionary())
    cls = RAS_MODELS.get(name)
    if cls is None:
        raise NotImplementedError(
            f"RASModel '{name}' is not ported yet (ported: "
            f"{', '.join(sorted(RAS_MODELS))})")
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
