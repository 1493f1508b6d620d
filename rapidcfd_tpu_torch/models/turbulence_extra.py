"""The rest of the JAX package's turbulence models (port of
rapidcfd_tpu/models/turbulence_extra.py:46-790; reference: src/
turbulenceModels/incompressible/RAS and LES, OpenFOAM 2.3).

RAS: kkLOmega (Walters-Cokljat transition, kkLOmega.C:630-790) and
LienCubicKE (cubic nonlinear k-epsilon, LienCubicKE.C:330-400).
LES: kOmegaSSTSAS (on KOmegaSST's omega-source hook), Smagorinsky2,
mixedSmagorinsky, scaleSimilarity, homogeneousDynSmagorinsky,
dynLagrangian, spectEddyVisc and SpalartAllmarasIDDES (`laminar` as an
LESModel is in turbulence.LES_MODELS).

A model whose Reynolds stress is not a pure eddy-viscosity closure has
nonlinear_stress(mesh, state, U): the explicit part of divDevReff, whose
divergence the solvers take from the momentum source
(solvers/simplefoam.py turb_nl_stress). Importing this module adds the
models to turbulence.RAS_MODELS and LES_MODELS.
"""

from __future__ import annotations

import torch

from ..fields.field import Dimensioned, VolField
from ..linalg.solvers import solve
from ..ops import fvc, fvm
from ..utils.dictionary import Dictionary
from ..utils.dimensions import DimensionSet, dim_viscosity
from . import turbulence as tm
from .turbulence import (_RTIME, KEpsilon, KOmegaSST, Smagorinsky,
                         SpalartAllmarasDES, _dev, _nu_b, _nu_c, _skew, _sym,
                         bound, les_delta, max_delta_xyz, simple_filter)

_STRESS = DimensionSet.of(0, 2, -2)       # [m2/s2]
_SQRTK = DimensionSet.of(0, 1, -1)        # [m/s]
_F4 = DimensionSet.of(0, 4, -4)           # flm, fmm [m4/s4]

__all__ = ["DynLagrangian", "HomogeneousDynSmagorinsky", "KOmegaSSTSAS",
           "KkLOmega", "LienCubicKE", "MixedSmagorinsky", "ScaleSimilarity",
           "Smagorinsky2", "SpalartAllmarasIDDES", "SpectEddyVisc"]


def _uniform_like(template: VolField, value: float, dims, name: str):
    """A uniform field on another field's footprint, with calculated
    (zero-order) boundaries."""
    return template.with_calculated_bcs(
        torch.full_like(template.data, value),
        torch.full_like(template.bvalues, value), dims, name)


def _vol_avg(mesh, x):
    """The volume average over the cells (dead and ghost slots weigh
    nothing)."""
    return (mesh.V_asm * x).sum() / mesh.V_asm.sum()


def _mm(a, b):
    return torch.einsum("nij,njk->nik", a, b)


class KkLOmega:
    """The 3-equation transition model (turbulent kt, laminar kl, omega;
    port of rapidcfd_tpu/models/turbulence_extra.py:89-310): the bypass
    and natural transition sources move energy from kl to kt."""
    needs = ("kt", "kl", "omega", "nut")

    def __init__(self, case, coeffs: Dictionary):
        self.case = case
        g = (coeffs or Dictionary()).scalar
        self.A0, self.As, self.Av = g("A0", 4.04), g("As", 2.12), \
            g("Av", 6.75)
        self.Abp, self.Anat, self.Ats = g("Abp", 0.6), g("Anat", 200.0), \
            g("Ats", 200.0)
        self.CbpCrit, self.Cnc = g("CbpCrit", 1.2), g("Cnc", 0.1)
        self.CnatCrit, self.Cint = g("CnatCrit", 1250.0), g("Cint", 0.75)
        self.CtsCrit, self.CrNat = g("CtsCrit", 1000.0), g("CrNat", 0.02)
        self.C11, self.C12 = g("C11", 3.4e-6), g("C12", 1.0e-10)
        self.CR, self.CalphaTheta = g("CR", 0.12), g("CalphaTheta", 0.035)
        self.Css, self.CtauL = g("Css", 1.5), g("CtauL", 4360.0)
        self.Cw1, self.Cw2, self.Cw3 = g("Cw1", 0.44), g("Cw2", 0.92), \
            g("Cw3", 0.3)
        self.CwR, self.Clambda = g("CwR", 1.5), g("Clambda", 2.495)
        self.CmuStd, self.Prtheta = g("CmuStd", 0.09), g("Prtheta", 0.85)
        self.sigma_k, self.sigma_w = g("Sigmak", 1.0), g("Sigmaw", 1.17)
        self.k_min, self.omega_min = 1e-15, 1e-10
        self.kt_controls = case.solver_controls("kt")
        self.kl_controls = case.solver_controls("kl")
        self.omega_controls = case.solver_controls("omega")
        self.kt_relax = case.relaxation_factor("kt", default=0.7)
        self.kl_relax = case.relaxation_factor("kl", default=0.7)
        self.omega_relax = case.relaxation_factor("omega", default=0.7)
        try:
            self.div_kt = case.div_scheme("div(phi,kt)")
        except KeyError:
            self.div_kt = case.div_scheme("div(phi,k)")
        try:
            self.div_kl = case.div_scheme("div(phi,kl)")
        except KeyError:
            self.div_kl = self.div_kt
        try:
            self.div_omega = case.div_scheme("div(phi,omega)")
        except KeyError:
            self.div_omega = self.div_kt
        self.lap_corr = case.laplacian_scheme()
        self.ddt_scheme = case.ddt_scheme()
        self.y = torch.clamp(tm.wall_distance(case), min=1e-10)

    def init_state(self, U):
        """kt and kl from their files, or from k's (kl at 1e-8)."""
        case, s = self.case, {}
        for name in self.needs:
            if case.field_exists(name):
                s[name] = case.read_field(name)
            elif name in ("kt", "kl") and case.field_exists("k"):
                k = case.read_field("k")
                val = k if name == "kt" else k.replace(
                    data=torch.full_like(k.data, 1e-8),
                    bvalues=torch.full_like(k.bvalues, 1e-8))
                s[name] = val.replace(name=name)
            else:
                raise FileNotFoundError(f"kkLOmega requires field '{name}'")
        return s

    def nut(self, state):
        return state["nut"]

    nu_eff = KEpsilon.nu_eff
    _store = KEpsilon._store

    @staticmethod
    def _diff(nut, data, bval):
        return nut.with_calculated_bcs(data, bval, dim_viscosity, "Deff")

    def correct(self, mesh, state, U, phi, nu, dt=None):
        kt, kl, omega, nut = (state["kt"], state["kl"], state["omega"],
                              state["nut"])
        kt, kl, omega = (self._store(mesh, f, dt) for f in (kt, kl, omega))
        ddt_scheme, dtv = tm._ddt(self.ddt_scheme, dt)
        nu_c = _nu_c(nu)
        y = self.y

        kt_pos = torch.clamp(kt.data, min=self.k_min)
        kl_pos = torch.clamp(kl.data, min=self.k_min)
        om_pos = torch.clamp(omega.data, min=self.omega_min)
        lambda_t = torch.sqrt(kt_pos + kl_pos) / om_pos
        lambda_eff = torch.minimum(self.Clambda * y, lambda_t)
        fw = lambda_eff / torch.clamp(lambda_t, min=1e-30)

        g = fvc.grad(mesh, U).data
        skew = _skew(g)
        om_vort = torch.sqrt(2.0 * torch.clamp((skew * skew).sum((-2, -1)),
                                               min=0.0))
        s2 = 2.0 * torch.clamp((_sym(g) * _sym(g)).sum((-2, -1)), min=0.0)
        sqrt_s2 = torch.sqrt(torch.clamp(s2, min=1e-30))

        fss = torch.exp(-(self.Css * nu_c * om_vort / kt_pos) ** 2)
        kts = fss * fw * kt_pos
        fv = 1.0 - torch.exp(-torch.sqrt(torch.clamp(
            fw ** 2 * kt_pos / nu_c / om_pos, min=0.0)) / self.Av)
        fint = torch.clamp(kl_pos / (self.Cint * (kl_pos + kt_pos)), max=1.0)
        cmu_s = 1.0 / (self.A0 + self.As * (sqrt_s2 / om_pos))
        nuts = fv * fint * cmu_s * torch.sqrt(torch.clamp(kts, min=0.0)) \
            * lambda_eff
        p_kt = nuts * s2

        ktl = kt_pos - kts
        re_omega = y ** 2 * om_vort / nu_c
        f_taul = 1.0 - torch.exp(-self.CtauL * ktl / torch.clamp(
            (lambda_eff * om_pos) ** 2, min=1e-30))
        beta_ts = 1.0 - torch.exp(
            -torch.clamp(re_omega - self.CtsCrit, min=0.0) ** 2 / self.Ats)
        nutl = torch.minimum(
            self.C11 * f_taul * om_vort * lambda_eff ** 2
            * torch.sqrt(torch.clamp(ktl, min=0.0)) * lambda_eff / nu_c
            + self.C12 * beta_ts * re_omega * y ** 2 * om_vort,
            0.5 * (kl_pos + ktl) / sqrt_s2)
        p_kl = nutl * s2
        alpha_t_eff = fv * self.CmuStd * torch.sqrt(
            torch.clamp(kts, min=0.0)) * lambda_eff

        fw_eps = fw + 1e-30
        gamma_bp = torch.clamp(
            kt_pos / nu_c / torch.clamp(om_vort, min=1e-30) - self.CbpCrit,
            0.0, 50.0)
        r_bp = self.CR * (1.0 - torch.exp(-gamma_bp / self.Abp)) \
            * om_pos / fw_eps
        f_nat_crit = 1.0 - torch.exp(
            -self.Cnc * torch.sqrt(kl_pos) * y / nu_c)
        gamma_nat = torch.clamp(
            re_omega - self.CnatCrit / (f_nat_crit + 1e-30), min=0.0)
        r_nat = self.CrNat * (1.0 - torch.exp(-gamma_nat / self.Anat)) \
            * om_vort

        def d_of(f, pos):
            root = f.with_calculated_bcs(
                torch.sqrt(pos), torch.sqrt(torch.clamp(f.bvalues, min=0.0)),
                _SQRTK, f"sqrt({f.name})")
            gr = fvc.grad(mesh, root).data
            return nu_c * (gr * gr).sum(-1)
        d_t, d_l = d_of(kt, kt_pos), d_of(kl, kl_pos)

        nu_b = _nu_b(nu)
        nut_b = torch.clamp(nut.bvalues, min=0.0)
        dk_eff = self._diff(nut, alpha_t_eff / self.sigma_k + nu_c,
                            nut_b / self.sigma_k + nu_b)
        dw_eff = self._diff(nut, alpha_t_eff / self.sigma_w + nu_c,
                            nut_b / self.sigma_w + nu_b)
        dl_eff = self._diff(nut, torch.zeros_like(nut.data) + nu_c,
                            torch.zeros_like(nut.bvalues) + nu_b)
        rdims = DimensionSet.of(0, 0, 1)

        def transport(f, div, d_eff, sp, src, controls, relax, floor):
            rhs = f.with_calculated_bcs(src, torch.zeros_like(f.bvalues),
                                        f.dims / rdims)
            eqn = (fvm.ddt(mesh, f, dtv, ddt_scheme)
                   + fvm.div(mesh, phi, f, div)
                   - fvm.laplacian(mesh, d_eff, f, self.lap_corr) + sp)
            out, perf = solve(mesh, eqn.equals(rhs).relax(mesh, relax),
                              controls, env={"phi": phi})
            return bound(out, floor), perf

        kt_new, kt_perf = transport(
            kt, self.div_kt, dk_eff,
            fvm.Sp(mesh, Dimensioned("omega", _RTIME, om_pos), kt),
            p_kt + (r_bp + r_nat) * kl_pos - d_t, self.kt_controls,
            self.kt_relax, self.k_min)
        kl_new, kl_perf = transport(
            kl, self.div_kl, dl_eff,
            fvm.Sp(mesh, Dimensioned("Rbp+Rnat", _RTIME, r_bp + r_nat), kl),
            p_kl - d_l, self.kl_controls, self.kl_relax, self.k_min)
        susp = (self.CwR / fw_eps - 1.0) * kl_pos * (r_bp + r_nat) / kt_pos
        f_omega = 1.0 - torch.exp(
            -0.41 * (lambda_eff / torch.clamp(lambda_t, min=1e-30)) ** 4)
        om_new, om_perf = transport(
            omega, self.div_omega, dw_eff,
            fvm.Sp(mesh, Dimensioned("Cw2*omega", _RTIME,
                                     self.Cw2 * om_pos), omega)
            + fvm.SuSp(mesh, Dimensioned("-(CwR..)", _RTIME, -susp), omega),
            self.Cw1 * p_kt * om_pos / kt_pos
            + self.Cw3 * f_omega * alpha_t_eff * fw ** 2
            * torch.sqrt(kt_pos) / y ** 3,
            self.omega_controls, self.omega_relax, self.omega_min)

        nut_new = nut.replace(data=nuts + nutl).correct_boundary_conditions(
            mesh, env={"k": kt_new, "nu": nu})
        return (dict(kt=kt_new, kl=kl_new, omega=om_new, nut=nut_new),
                {"kt": kt_perf[0], "kl": kl_perf[0], "omega": om_perf[0]})


class LienCubicKE(KEpsilon):
    """Cubic nonlinear k-epsilon (port of rapidcfd_tpu/models/
    turbulence_extra.py:317-391; reference: LienCubicKE.C:330-400): Cmu a
    strain and rotation functional, the C5 cubic correction of nut, and
    the quadratic and cubic nonlinear stress into momentum through
    nonlinear_stress()."""

    def __init__(self, case, coeffs: Dictionary):
        super().__init__(case, coeffs)
        c = coeffs or Dictionary()
        self.A1 = c.scalar("A1", 1.25)
        self.A2 = c.scalar("A2", 1000.0)
        self.Ctau1 = c.scalar("Ctau1", -4.0)
        self.Ctau2 = c.scalar("Ctau2", 13.0)
        self.Ctau3 = c.scalar("Ctau3", -2.0)
        self.alphaKsi = c.scalar("alphaKsi", 0.9)

    def _cubic(self, mesh, U, k_data, eps_data):
        """(Cmu, nut with C5, the nonlinear stress tensor) per cell."""
        k_pos = torch.clamp(k_data, min=self.k_min)
        eps_pos = torch.clamp(eps_data, min=self.eps_min)
        g = fvc.grad(mesh, U).data
        sym, skw = _sym(g), _skew(g)
        eta = k_pos / eps_pos * torch.sqrt(
            2.0 * torch.clamp((sym * sym).sum((-2, -1)), min=0.0))
        ksi = k_pos / eps_pos * torch.sqrt(
            2.0 * torch.clamp((skw * skw).sum((-2, -1)), min=0.0))
        cmu = 2.0 / (3.0 * (self.A1 + eta + self.alphaKsi * ksi))
        f_eta = self.A2 + eta ** 3
        gT = g.transpose(-1, -2)
        gg, ggT, gTg = _mm(g, g), _mm(g, gT), _mm(gT, g)
        k3e2 = k_pos ** 3 / eps_pos ** 2
        quad = k3e2[:, None, None] / f_eta[:, None, None] * (
            self.Ctau1 * (gg + gg.transpose(-1, -2))
            + self.Ctau2 * ggT + self.Ctau3 * gTg)
        cubic = -20.0 * (k_pos ** 4 / eps_pos ** 3 * cmu ** 3)[:, None, None] \
            * (_mm(gg, gT) + _mm(ggT, gT) - _mm(gTg, g) - _mm(_mm(gT, gT), g))
        nl = _sym(quad + cubic)
        c5 = -2.0 * cmu ** 3 * k_pos ** 4 / eps_pos ** 3 * (
            torch.clamp(((g + gT) ** 2).sum((-2, -1)), min=0.0)
            - torch.clamp(((g - gT) ** 2).sum((-2, -1)), min=0.0))
        return cmu, cmu * k_pos ** 2 / eps_pos + c5, nl

    def nonlinear_stress(self, mesh, state, U):
        _, _, nl = self._cubic(mesh, U, state["k"].data,
                               state["epsilon"].data)
        return fvc._extrapolated(mesh, nl, _STRESS, "nonlinearStress")

    def _production(self, mesh, state, U, s2):
        """G = Cmu k^2/eps (symm(grad U) && grad U) - NL && grad U
        (reference LienCubicKE.C:361-366; s2 = 2|symm|^2)."""
        k, eps = state["k"], state["epsilon"]
        cmu, _, nl = self._cubic(mesh, U, k.data, eps.data)
        g = fvc.grad(mesh, U).data
        k_pos = torch.clamp(k.data, min=self.k_min)
        eps_pos = torch.clamp(eps.data, min=self.eps_min)
        return cmu * k_pos ** 2 / eps_pos * (0.5 * s2) \
            - (nl * g).sum((-2, -1))

    def _nut_from(self, mesh, U, k, eps):
        return torch.clamp(self._cubic(mesh, U, k.data, eps.data)[1],
                           min=0.0)


class KOmegaSSTSAS(KOmegaSST):
    """SST-SAS (port of rapidcfd_tpu/models/turbulence_extra.py:398-433;
    reference: kOmegaSSTSAS.C:339-410): kOmegaSST with the von Karman
    length-scale source QSAS in omega."""
    alphaK1, alphaK2 = 0.85034, 1.0
    alphaOmega1, alphaOmega2 = 0.5, 0.85616
    gamma1, gamma2 = 0.5532, 0.4403

    def __init__(self, case, coeffs: Dictionary):
        super().__init__(case, coeffs)
        c = coeffs or Dictionary()
        self.Cs_sas = c.scalar("Cs", 0.262)
        self.alphaPhi = c.scalar("alphaPhi", 0.666667)
        self.zetaTilda2 = c.scalar("zetaTilda2", 1.755)
        self.FSAS = c.scalar("FSAS", 1.25)
        self.Cmu_sas = c.scalar("Cmu", 0.09)
        self.kappa = c.scalar("kappa", 0.41)
        self.delta = les_delta(case, c)

    def _omega_extra(self, mesh, U, k_pos, om_pos, gk, gom, s2):
        L = torch.sqrt(k_pos) / (self.Cmu_sas ** 0.25 * om_pos)
        lap_u = fvc.laplacian(mesh, 1.0, U).data
        mag_lap = torch.sqrt(torch.clamp((lap_u * lap_u).sum(-1),
                                         min=1e-60))
        lvk2 = torch.maximum(
            self.kappa * torch.sqrt(torch.clamp(s2, min=0.0)) / mag_lap,
            self.Cs_sas * self.delta)
        grad_ok = torch.maximum(
            (gom.data * gom.data).sum(-1) / om_pos ** 2,
            (gk.data * gk.data).sum(-1)
            / torch.clamp(k_pos, min=self.k_min) ** 2)
        qsas = self.zetaTilda2 * self.kappa * s2 * (L / lvk2) ** 2 \
            - 2.0 / self.alphaPhi * k_pos * grad_ok
        return self.FSAS * torch.clamp(qsas, min=0.0)


class DynLagrangian:
    """Meneveau-Lund-Cabot dynamic model (port of rapidcfd_tpu/models/
    turbulence_extra.py:443-529; reference: dynLagrangian.C:110-165): the
    Germano numerator and denominator are relaxed along pathlines by
    transporting flm and fmm with T = theta delta (flm fmm)^(-1/8);
    nut = (flm/fmm) delta^2 |dev S|."""
    needs = ("flm", "fmm", "nut")

    def __init__(self, case, coeffs: Dictionary):
        self.case = case
        c = coeffs or Dictionary()
        self.theta = c.scalar("theta", 1.5)
        self.delta = les_delta(case, c)
        self.flm_controls = case.solver_controls("flm")
        self.fmm_controls = case.solver_controls("fmm")
        try:
            self.div_f = case.div_scheme("div(phi,flm)")
        except KeyError:
            self.div_f = case.div_scheme("div(phi,k)")
        self.ddt_scheme = case.ddt_scheme()
        self.fmm0 = 1e-30

    def init_state(self, U):
        """flm and fmm from their files, or uniform 0.0256 and 1 (the
        Smagorinsky ratio (0.16)^2)."""
        case = self.case
        s = {"nut": case.read_field("nut")}
        for name, v in (("flm", 0.0256), ("fmm", 1.0)):
            s[name] = case.read_field(name) if case.field_exists(name) \
                else _uniform_like(s["nut"], v, _F4, name)
        return s

    def nut(self, state):
        return state["nut"]

    nu_eff = KEpsilon.nu_eff
    _store = KEpsilon._store

    def correct(self, mesh, state, U, phi, nu, dt=None):
        flm, fmm, nut = state["flm"], state["fmm"], state["nut"]
        flm, fmm = self._store(mesh, flm, dt), self._store(mesh, fmm, dt)
        ddt_scheme, dtv = tm._ddt(self.ddt_scheme, dt)
        d = self.delta
        S = _dev(_sym(fvc.grad(mesh, U).data))
        magS = torch.sqrt(torch.clamp((S * S).sum((-2, -1)), min=0.0))
        u = U.data
        uf = simple_filter(mesh, u)
        Sf = _dev(_sym(fvc.grad(mesh, U.replace(data=uf)).data))
        magSf = torch.sqrt(torch.clamp((Sf * Sf).sum((-2, -1)), min=0.0))
        L = _dev(simple_filter(mesh, u[:, :, None] * u[:, None, :])
                 - uf[:, :, None] * uf[:, None, :])
        M = 2.0 * (d ** 2)[:, None, None] * (
            simple_filter(mesh, magS[:, None, None] * S)
            - 4.0 * magSf[:, None, None] * Sf)
        LM = (L * M).sum((-2, -1))
        MM = (M * M).sum((-2, -1))
        inv_t = (1.0 / (self.theta * d)) * torch.clamp(
            flm.data * fmm.data, min=0.0) ** 0.125

        def transport(f, src, controls):
            rhs = f.with_calculated_bcs(inv_t * src,
                                        torch.zeros_like(f.bvalues),
                                        f.dims / DimensionSet.of(0, 0, 1))
            eqn = (fvm.ddt(mesh, f, dtv, ddt_scheme)
                   + fvm.div(mesh, phi, f, self.div_f)
                   + fvm.Sp(mesh, Dimensioned("1/T", _RTIME, inv_t), f))
            return solve(mesh, eqn.equals(rhs), controls, env={"phi": phi})

        flm_new, flm_perf = transport(flm, LM, self.flm_controls)
        flm_new = bound(flm_new, 0.0)
        fmm_new, fmm_perf = transport(fmm, MM, self.fmm_controls)
        fmm_new = bound(fmm_new, self.fmm0)
        nut_data = torch.clamp(
            flm_new.data / torch.clamp(fmm_new.data, min=self.fmm0),
            min=0.0) * d ** 2 * magS
        nut_new = nut.replace(data=nut_data).correct_boundary_conditions(
            mesh, env={"k": flm_new, "nu": nu})
        return (dict(flm=flm_new, fmm=fmm_new, nut=nut_new),
                {"flm": flm_perf[0], "fmm": fmm_perf[0]})


def _bardina(mesh, U):
    """B = filter(UU) - filter(U) filter(U) (scaleSimilarity.C:70-90)."""
    u = U.data
    uf = simple_filter(mesh, u)
    return simple_filter(mesh, u[:, :, None] * u[:, None, :]) \
        - uf[:, :, None] * uf[:, None, :]


class ScaleSimilarity:
    """Bardina scale similarity (port of rapidcfd_tpu/models/
    turbulence_extra.py:536-567): no eddy viscosity; the whole SGS stress
    is the explicit dev(B), through nonlinear_stress."""
    needs = ()

    def __init__(self, case, coeffs: Dictionary):
        self.case = case

    def init_state(self, U):
        return {}

    def nut(self, state):
        return None

    def nu_eff(self, mesh, state, nu):
        return nu

    def nonlinear_stress(self, mesh, state, U):
        return fvc._extrapolated(mesh, _dev(_bardina(mesh, U)), _STRESS,
                                 "devB")

    def correct(self, mesh, state, U, phi, nu, dt=None):
        return state, {}


class MixedSmagorinsky(Smagorinsky):
    """Smagorinsky's eddy viscosity plus the scale-similarity stress (port
    of rapidcfd_tpu/models/turbulence_extra.py:570-578)."""
    nonlinear_stress = ScaleSimilarity.nonlinear_stress


class Smagorinsky2(Smagorinsky):
    """Smagorinsky with the anisotropic quadratic term -2 cD2 delta (D&D)
    as an explicit stress (port of rapidcfd_tpu/models/
    turbulence_extra.py:581-598; the reference's Smagorinsky2.C:66-95
    treats it as an implicit anisotropic diffusivity)."""

    def __init__(self, case, coeffs: Dictionary):
        super().__init__(case, coeffs)
        self.cd2 = (coeffs or Dictionary()).scalar("cD2", 0.02)

    def nonlinear_stress(self, mesh, state, U):
        D = _dev(_sym(fvc.grad(mesh, U).data))
        nl = -2.0 * self.cd2 * self.delta[:, None, None] * _mm(D, D)
        return fvc._extrapolated(mesh, nl, _STRESS, "aniB")


class HomogeneousDynSmagorinsky:
    """Dynamic Smagorinsky with a volume-averaged coefficient (port of
    rapidcfd_tpu/models/turbulence_extra.py:605-648; reference:
    homogeneousDynSmagorinsky.C:43-100): cD = 0.5 <LL:MM>/<MM:MM>,
    nut = cD delta^2 |D|."""
    needs = ("nut",)

    def __init__(self, case, coeffs: Dictionary):
        self.case = case
        self.delta = les_delta(case, coeffs or Dictionary())

    def init_state(self, U):
        return {"nut": self.case.read_field("nut")}

    def nut(self, state):
        return state["nut"]

    nu_eff = KEpsilon.nu_eff

    def correct(self, mesh, state, U, phi, nu, dt=None):
        nut, d, u = state["nut"], self.delta, U.data
        D = _dev(_sym(fvc.grad(mesh, U).data))
        magD = torch.sqrt(torch.clamp((D * D).sum((-2, -1)), min=0.0))
        Df = simple_filter(mesh, D)
        magDf = torch.sqrt(torch.clamp((Df * Df).sum((-2, -1)), min=0.0))
        MM = (d ** 2)[:, None, None] * (
            simple_filter(mesh, magD[:, None, None] * D)
            - 4.0 * magDf[:, None, None] * Df)
        uf = simple_filter(mesh, u)
        LL = _dev(simple_filter(mesh, u[:, :, None] * u[:, None, :])
                  - uf[:, :, None] * uf[:, None, :])
        mmmm = _vol_avg(mesh, (MM * MM).sum((-2, -1)))
        llmm = _vol_avg(mesh, (LL * MM).sum((-2, -1)))
        cd = torch.where(mmmm > 1e-30,
                         0.5 * llmm / torch.clamp(mmmm, min=1e-30),
                         torch.zeros_like(mmmm))
        new = nut.replace(data=torch.clamp(cd, min=0.0) * d ** 2 * magD)
        return {"nut": new.correct_boundary_conditions(
            mesh, env={"k": new, "nu": nu})}, {}


class SpectEddyVisc:
    """Spectral eddy viscosity (port of rapidcfd_tpu/models/
    turbulence_extra.py:655-711; reference: spectEddyVisc.C:40-55): nut
    from its implicit relation by 5 fixed-point sweeps."""
    needs = ("nut",)

    def __init__(self, case, coeffs: Dictionary):
        self.case = case
        c = coeffs or Dictionary()
        self.cB = c.scalar("cB", 8.22)
        self.cK1 = c.scalar("cK1", 0.83)
        self.cK2 = c.scalar("cK2", 1.03)
        self.cK3 = c.scalar("cK3", 4.75)
        self.cK4 = c.scalar("cK4", 2.55)
        self.delta = les_delta(case, c)

    def init_state(self, U):
        return {"nut": self.case.read_field("nut")}

    def nut(self, state):
        return state["nut"]

    nu_eff = KEpsilon.nu_eff

    def k_sgs(self, mesh, state, U, nu):
        """The Kraichnan-spectrum SGS energy (the reference's k())."""
        nu_c, d = _nu_c(nu), self.delta
        sym = _sym(fvc.grad(mesh, U).data)
        sym2 = torch.clamp((sym * sym).sum((-2, -1)), min=0.0)
        eps = torch.clamp(2.0 * (state["nut"].data + nu_c) * sym2,
                          min=1e-30)
        return (self.cK1 * (d * eps) ** (2.0 / 3.0)
                * torch.exp(-self.cK2 * d ** (-4.0 / 3.0) * nu_c
                            / eps ** (1.0 / 3.0))
                - self.cK3 * torch.sqrt(eps * nu_c)
                * torch.special.erfc(self.cK4 * d ** (-2.0 / 3.0)
                                     * nu_c ** 0.5 * eps ** (-1.0 / 6.0)))

    def correct(self, mesh, state, U, phi, nu, dt=None):
        nut, nu_c = state["nut"], _nu_c(nu)
        sym = _sym(fvc.grad(mesh, U).data)
        mag_sym = torch.sqrt(torch.clamp((sym * sym).sum((-2, -1)), min=0.0))
        re = torch.clamp(self.delta ** 2 * mag_sym / nu_c, min=1e-10)
        nut_data = torch.clamp(nut.data, min=0.0)
        for _ in range(5):
            denom = 1.0 - torch.exp(
                -self.cB * (nu_c / (nut_data + nu_c)) ** (1.0 / 3.0)
                * re ** (-2.0 / 3.0))
            nut_data = nu_c / torch.clamp(denom, min=1e-10)
        new = nut.replace(data=nut_data)
        return {"nut": new.correct_boundary_conditions(
            mesh, env={"k": new, "nu": nu})}, {}


class SpalartAllmarasIDDES(SpalartAllmarasDES):
    """Improved delayed DES (port of rapidcfd_tpu/models/
    turbulence_extra.py:718-790; reference: SpalartAllmarasIDDES.C:40-135):
    d_tilde blends the RANS and LES scales with fHyb and fRestore; hmax
    is the maxDeltaxyz delta, the IDDES delta min(max(Cw d, Cw hmax,
    min(d, hmax)), hmax)."""

    def __init__(self, case, coeffs: Dictionary):
        super().__init__(case, coeffs)
        c = coeffs or Dictionary()
        self.fwStar = c.scalar("fwStar", 0.424)
        self.cl = c.scalar("cl", 3.55)
        self.ct = c.scalar("ct", 1.63)
        self.cw_iddes = c.scalar("Cw", 0.15)
        self.hmax = max_delta_xyz(case.mesh)
        self.delta = torch.minimum(torch.maximum(torch.maximum(
            self.cw_iddes * self.y, self.cw_iddes * self.hmax),
            torch.minimum(self.y, self.hmax)), self.hmax)

    def _rd(self, visc, mag_grad):
        return torch.clamp(visc / (torch.clamp(mag_grad, min=1e-30)
                                   * (self.kappa * self.y) ** 2 + 1e-30),
                           max=10.0)

    def _d_tilde(self, mesh, state, U, nu):
        nu_c = _nu_c(nu)
        g = fvc.grad(mesh, U).data
        mag_grad = torch.sqrt(torch.clamp((g * g).sum((-2, -1)), min=1e-30))
        nt_pos = torch.clamp(state["nuTilda"].data, min=0.0)
        alpha = torch.clamp(0.25 - self.y / torch.clamp(self.hmax,
                                                        min=1e-30), min=-5.0)
        exp_a2 = torch.exp(alpha ** 2)
        f_hill = 2.0 * torch.where(alpha >= 0.0, exp_a2 ** -11.09,
                                   exp_a2 ** -9.0)
        f_step = torch.clamp(2.0 * exp_a2 ** -9.0, max=1.0)
        fd = 1.0 - torch.tanh((8.0 * self._rd(nt_pos + nu_c, mag_grad)) ** 3)
        f_hyb = torch.maximum(1.0 - fd, f_step)
        ft = torch.tanh((self.ct ** 2 * self._rd(nt_pos, mag_grad)) ** 3)
        fl = torch.tanh((self.cl ** 2 * self._rd(
            nu_c * torch.ones_like(nt_pos), mag_grad)) ** 10)
        f_restore = torch.clamp(f_hill - 1.0, min=0.0) \
            * (1.0 - torch.maximum(ft, fl))
        chi = nt_pos / nu_c
        fv1 = chi ** 3 / (chi ** 3 + self.cv1 ** 3)
        fv2 = 1.0 - chi / (1.0 + chi * fv1)
        psi = torch.sqrt(torch.clamp(
            (1.0 - self.cb1 / (self.cw1 * self.kappa ** 2 * self.fwStar)
             * fv2) / torch.clamp(fv1, min=1e-10), max=100.0))
        return torch.clamp(
            f_hyb * (1.0 + f_restore * psi) * self.y
            + (1.0 - f_hyb) * self.cdes * psi * self.delta, min=1e-10)


tm.RAS_MODELS.update(kkLOmega=KkLOmega, LienCubicKE=LienCubicKE)
tm.LES_MODELS.update(
    kOmegaSSTSAS=KOmegaSSTSAS, dynLagrangian=DynLagrangian,
    scaleSimilarity=ScaleSimilarity, mixedSmagorinsky=MixedSmagorinsky,
    Smagorinsky2=Smagorinsky2,
    homogeneousDynSmagorinsky=HomogeneousDynSmagorinsky,
    spectEddyVisc=SpectEddyVisc, SpalartAllmarasIDDES=SpalartAllmarasIDDES)
