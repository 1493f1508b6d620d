"""fvOptions — run-time sources and constraints (port of
rapidcfd_tpu/models/fvoptions.py; reference: src/fvOptions/fvOption.H:71
with its addSup(fvMatrix&) and constrain hooks, read from
system/fvOptions).

Each option is a matrix transformation over a cell-selection mask built
once on the host: selectionMode all | box | cellSet | cellZone (reference:
cellSetOption), the sets and zones read from constant/polyMesh in FILE
numbering and mapped to the device ordering through MeshMaps, as the JAX
package maps them (dead and ghost slots of a gdia lattice included). Every
other host precomputation (rotor frames, blade and polar tables, the heat
exchanger's face mask and effectiveness curve) is done once at
construction; add_sup and constrain are tensor code on the case's device.

Types: MRFSource, explicitPorositySource, semiImplicitSource,
fixedTemperatureConstraint, actuationDiskSource,
pressureGradientExplicitSource, limitTemperature, explicitSetValue,
radialActuationDiskSource, rotorDiskSource, solidificationMeltingSource
and effectivenessHeatExchangerSource. An unknown type raises (the JAX
package skips it with a log line; OpenFOAM stops there too).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..fields.field import Dimensioned, VolField
from ..linalg.solvers import gmax, gsum
from ..utils.dictionary import Dictionary, parse_dictionary, parse_file
from ..utils.logging import info
from ..utils.registry import lookup, register, registered_names


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _like(a, mesh) -> torch.Tensor:
    """A host array as a tensor of the mesh's float type and device."""
    return torch.as_tensor(np.asarray(a, dtype=float), dtype=mesh.V.dtype,
                           device=mesh.V.device)


def _selection_mask(mesh, d: Dictionary, case=None) -> torch.Tensor:
    """(nCells,) 1.0 on the selected cells (slots on gdia meshes)."""
    mode = d.word("selectionMode", "all")
    if mode == "all":
        return torch.ones(mesh.n_cells, dtype=mesh.V.dtype,
                          device=mesh.V.device)
    if mode == "box":
        lo, hi = d.lookup("box", required=True)
        C = _np(mesh.C)
        m = np.all((C >= np.asarray(lo, float))
                   & (C <= np.asarray(hi, float)), axis=1)
        return _like(m, mesh)
    if mode in ("cellSet", "cellZone"):
        if case is None:
            raise KeyError(f"fvOptions: selectionMode {mode} needs a "
                           f"case directory (no case bound)")
        from ..mesh.toposet import read_cell_zones, read_set
        if mode == "cellSet":
            labels = read_set(case.dir,
                              d.word("cellSet", "") or d.word("set"))
        else:
            name = d.word("cellZone", "") or d.word("zone")
            zones = read_cell_zones(case.dir, getattr(case, "region", ""))
            if name not in zones:
                raise KeyError(f"fvOptions: cellZone '{name}' not found "
                               f"(have {sorted(zones)})")
            labels = zones[name]
        m_file = np.zeros(mesh.n_cells, bool)
        m_file[np.asarray(labels, np.int64)] = True
        return _like(case.maps.cells_to_device(m_file), mesh)
    raise KeyError(f"fvOptions: unsupported selectionMode '{mode}' "
                   f"(all|box|cellSet|cellZone)")


class Option:
    """fv::option: the coefficients dictionary (<type>Coeffs if present),
    the selection mask and the fields it applies to."""

    def __init__(self, name, d: Dictionary, mesh, case=None):
        self.name = name
        self.dict = d.subdict(d.word("type") + "Coeffs", required=False) \
            or d
        self.mask = _selection_mask(mesh, self.dict, case)
        flds = self.dict.lookup("fields")
        self.field_names = [str(f) for f in flds] if flds else None

    def applies_to(self, field_name: str) -> bool:
        return self.field_names is None or field_name in self.field_names

    def add_sup(self, mesh, field_name, eqn, env):
        return eqn

    def constrain(self, mesh, field_name, eqn, env):
        return eqn


@register("fvOption", "MRFSource", "MRF")
class MRFSource(Option):
    """Rotating-frame Coriolis source (reference: cfdTools/general/MRF/
    MRFZone.H:66 addCoriolis): Usource -= V*(Omega ^ U)."""

    def __init__(self, name, d, mesh, case=None):
        super().__init__(name, d, mesh, case)
        axis = np.asarray(self.dict.lookup("axis", [0.0, 0.0, 1.0]), float)
        omega = Dimensioned.from_entry(
            self.dict.lookup("omega", required=True)).value
        self.omega_v = _like(axis / np.linalg.norm(axis) * omega, mesh)

    def applies_to(self, field_name):
        return field_name == "U"

    def add_sup(self, mesh, field_name, eqn, env):
        U = eqn.psi.data
        cor = torch.linalg.cross(self.omega_v.expand_as(U), U, dim=-1)
        return eqn.replace(source=eqn.source
                           - (mesh.V * self.mask)[:, None] * cor)


@register("fvOption", "explicitPorositySource")
class ExplicitPorositySource(Option):
    """Darcy-Forchheimer momentum sink (reference: fvOptions sources/
    derived/explicitPorositySource + porosityModel/DarcyForchheimer):
    implicit Sp contribution (nu*d + 0.5*|U|*f)*V. d and f are reduced to
    the means of their components, as the JAX package reduces them (the
    reference keeps the tensor in the zone's coordinate system)."""

    def __init__(self, name, d, mesh, case=None):
        super().__init__(name, d, mesh, case)
        sub = self.dict.subdict("DarcyForchheimerCoeffs", required=False) \
            or self.dict
        dvec = sub.lookup("d", required=True)
        fvec = sub.lookup("f", [0.0, 0.0, 0.0])
        if isinstance(dvec, tuple):
            dvec = Dimensioned.from_entry(dvec).value
        if isinstance(fvec, tuple):
            fvec = Dimensioned.from_entry(fvec).value
        self.d_mean = float(np.mean(np.asarray(dvec, float)))
        self.f_mean = float(np.mean(np.asarray(fvec, float)))

    def applies_to(self, field_name):
        return field_name == "U"

    def add_sup(self, mesh, field_name, eqn, env):
        nu = env.get("nu")
        nu_v = nu.value if isinstance(nu, Dimensioned) else (
            nu.data if isinstance(nu, VolField) else 1e-5)
        umag = torch.linalg.norm(eqn.psi.data, dim=-1)
        sp = (nu_v * self.d_mean + 0.5 * umag * self.f_mean) * self.mask
        return eqn.replace(diag=eqn.diag + mesh.V * sp)


@register("fvOption", "semiImplicitSource",
          "scalarSemiImplicitSource", "vectorSemiImplicitSource")
class SemiImplicitSource(Option):
    """Su/Sp injection (reference: sources/general/semiImplicitSource):
    per field an (Su Sp) pair; volumeMode absolute|specific."""

    def __init__(self, name, d, mesh, case=None):
        super().__init__(name, d, mesh, case)
        self.volume_mode = self.dict.word("volumeMode", "specific")
        inj = self.dict.subdict("injectionRateSuSp", required=True)
        self.rates = {}
        for fname, (su, sp) in inj.items():
            self.rates[str(fname)] = (np.asarray(su, float)
                                      if isinstance(su, list) else float(su),
                                      float(sp))

    def applies_to(self, field_name):
        return field_name in self.rates

    def add_sup(self, mesh, field_name, eqn, env):
        su, sp = self.rates[field_name]
        vol = mesh.V if self.volume_mode == "specific" \
            else mesh.V / (mesh.V * self.mask).sum()
        su_t = torch.as_tensor(su, dtype=eqn.source.dtype,
                               device=eqn.source.device)
        vec = eqn.source.ndim > 1
        m = self.mask[:, None] if vec else self.mask
        v = vol[:, None] if vec else vol
        return eqn.replace(source=eqn.source + v * m * su_t,
                           diag=eqn.diag - mesh.V * self.mask * sp)


@register("fvOption", "fixedTemperatureConstraint")
class FixedTemperatureConstraint(Option):
    """Constraint: fix T (or the energy equation's psi) in the selection
    (reference: constraints/fixedTemperatureConstraint)."""

    def __init__(self, name, d, mesh, case=None):
        super().__init__(name, d, mesh, case)
        self.temperature = float(self.dict.scalar("temperature", 300.0))

    def applies_to(self, field_name):
        return field_name in ("T", "e", "h")

    def constrain(self, mesh, field_name, eqn, env):
        vals = torch.full((mesh.n_cells,), self.temperature,
                          dtype=eqn.diag.dtype, device=eqn.diag.device)
        if field_name != "T" and "thermo" in env:
            vals = env["thermo"].he_from_t(vals)
        return eqn.set_values(mesh, self.mask, vals)


class FvOptions:
    """fv::IOoptionList (reference: fvIOoptionList.H:53): reads
    system/fvOptions and applies each option to matching equations."""

    def __init__(self, case):
        self.options = []
        path = os.path.join(case.dir, "system", "fvOptions")
        if not os.path.isfile(path):
            return
        for name, sub in parse_file(path).items():
            if not isinstance(sub, Dictionary):
                continue
            typ = sub.word("type")
            try:
                cls = lookup("fvOption", typ)
            except KeyError:
                raise NotImplementedError(
                    f"fvOptions entry '{name}': type '{typ}' is not known "
                    f"(types: {', '.join(registered_names('fvOption'))})"
                ) from None
            self.options.append(cls(str(name), sub, case.mesh, case))
            info(f"Creating fvOption {name} of type {typ}")

    def __call__(self, mesh, field_name: str, eqn, env=None):
        """operator()(fvMatrix): addSup of every applicable option."""
        for opt in self.options:
            if opt.applies_to(field_name):
                eqn = opt.add_sup(mesh, field_name, eqn, env or {})
        return eqn

    def constrain(self, mesh, field_name: str, eqn, env=None):
        for opt in self.options:
            if opt.applies_to(field_name):
                eqn = opt.constrain(mesh, field_name, eqn, env or {})
        return eqn


def refuse_options(case, solver: str):
    """Raise when system/fvOptions has an entry: `solver` is a path on
    which the JAX package builds no FvOptions, so an option there would
    be dropped silently (its porous alias included)."""
    path = os.path.join(case.dir, "system", "fvOptions")
    if not os.path.isfile(path):
        return
    names = [str(k) for k, v in parse_file(path).items()
             if isinstance(v, Dictionary)]
    if names:
        raise NotImplementedError(
            f"{solver}: system/fvOptions has entries ({', '.join(names)}), "
            "but the JAX package applies no fvOptions on this path, so the "
            "port refuses them rather than drop them")


def _disk_force(opt, U, env, weight):
    """The actuation disk's momentum sink per cell: T = 2*rho*A*|upU|*
    a*(1-a) along diskDir, a = 1 - Cp/Ct, spread by weight/V_zone."""
    rho = env.get("rho")
    rho_up = rho.data[opt.up_cell] if hasattr(rho, "data") else 1.0
    up_u = U[opt.up_cell]
    a = 1.0 - opt.cp / opt.ct
    t_coeff = 2.0 * rho_up * opt.area * torch.linalg.norm(up_u) \
        * a * (1.0 - a)
    force = t_coeff * (opt.disk_dir.to(U) * up_u)      # E & upU (diagonal E)
    return (weight / opt.v_zone)[:, None] * force


@register("fvOption", "actuationDiskSource")
class ActuationDiskSource(Option):
    """Froude actuation disk momentum sink (reference: fvOptions
    sources/derived/actuationDiskSource/actuationDiskSourceTemplates.C),
    distributed over the selection volume along diskDir. upstreamPoint
    selects the reference-velocity cell (the nearest cell centre, on the
    host once); without it the JAX package takes cell 0, and so does the
    port."""

    def __init__(self, name, d, mesh, case=None):
        super().__init__(name, d, mesh, case)
        disk_dir = np.asarray(self.dict.lookup("diskDir", [1.0, 0.0, 0.0]),
                              float)
        self.disk_dir = _like(disk_dir / np.linalg.norm(disk_dir), mesh)
        self.cp = float(self.dict.scalar("Cp", 0.386))
        self.ct = float(self.dict.scalar("Ct", 0.58))
        self.area = float(self.dict.scalar("diskArea", 1.0))
        up = self.dict.lookup("upstreamPoint")
        if up is not None:
            C = _np(mesh.C)
            self.up_cell = int(np.argmin(
                ((C - np.asarray(up, float)) ** 2).sum(1)))
        else:
            self.up_cell = 0
        self.v_zone = float((_np(mesh.V) * _np(self.mask)).sum())

    def applies_to(self, field_name):
        return field_name == "U"

    def add_sup(self, mesh, field_name, eqn, env):
        return eqn.replace(source=eqn.source - _disk_force(
            self, eqn.psi.data, env, mesh.V * self.mask))


@register("fvOption", "pressureGradientExplicitSource")
class PressureGradientExplicitSource(Option):
    """Driving pressure gradient toward a target bulk velocity Ubar
    (reference: sources/derived/pressureGradientExplicitSource): the
    gradient is adapted each call from the volume-averaged flow-direction
    velocity error with the matrix diagonal as the relaxation scale. As
    in the JAX package the adapted gradient is not stored between calls."""

    def __init__(self, name, d, mesh, case=None):
        super().__init__(name, d, mesh, case)
        ubar = self.dict.lookup("Ubar", required=True)
        if isinstance(ubar, tuple):
            ubar = Dimensioned.from_entry(ubar).value
        ubar = np.asarray(ubar, float)
        self.ubar_mag = float(np.linalg.norm(ubar))
        self.flow_dir = _like(ubar / self.ubar_mag, mesh)
        self.grad_p = float(self.dict.scalar("gradientInitial", 0.0))

    def applies_to(self, field_name):
        return field_name == "U"

    def add_sup(self, mesh, field_name, eqn, env):
        U = eqn.psi.data
        e = self.flow_dir.to(U)
        vw = mesh.V * self.mask
        ubar_now = (vw[:, None] * U).sum(0) / vw.sum()
        mag_err = self.ubar_mag - (ubar_now * e).sum()
        # relaxation scale: the volume-averaged diagonal (rAU-like)
        diag = eqn.diag if eqn.diag.ndim == 1 else eqn.diag.mean(-1)
        tiny = max(1e-300, torch.finfo(mesh.V.dtype).tiny)
        r_ave = (vw * (diag / mesh.V.clamp_min(tiny))).sum() / vw.sum()
        grad_p = self.grad_p + mag_err * r_ave
        info(f"Pressure gradient source: uncorrected Ubar = "
             f"{float((ubar_now * e).sum()):.6g}, pressure gradient = "
             f"{float(grad_p):.6g}\n")
        return eqn.replace(source=eqn.source + vw[:, None] * grad_p * e)


@register("fvOption", "limitTemperature", "temperatureLimitsConstraint")
class TemperatureLimits(Option):
    """Clamp T (through the energy variable) into [Tmin, Tmax] (reference:
    constraints/limitTemperature)."""

    def __init__(self, name, d, mesh, case=None):
        super().__init__(name, d, mesh, case)
        self.t_min = float(self.dict.scalar("Tmin",
                                            self.dict.scalar("min", 0.0)))
        self.t_max = float(self.dict.scalar("Tmax",
                                            self.dict.scalar("max", 1e10)))

    def applies_to(self, field_name):
        return field_name in ("T", "e", "h")

    def constrain(self, mesh, field_name, eqn, env):
        psi = eqn.psi.data
        lo, hi = self.t_min, self.t_max
        if field_name != "T" and "thermo" in env:
            lo = env["thermo"].he_from_t(torch.as_tensor(lo).to(psi))
            hi = env["thermo"].he_from_t(torch.as_tensor(hi).to(psi))
        clamped = torch.clamp(psi, lo, hi)
        changed = ((clamped - psi).abs() > 0).to(psi.dtype) * self.mask
        return eqn.set_values(mesh, changed, clamped)


@register("fvOption", "explicitSetValue", "vectorExplicitSetValue",
          "scalarExplicitSetValue")
class ExplicitSetValue(Option):
    """Hard-set field values in the selection (reference:
    constraints/explicitSetValue): injectionRate { U (1 0 0); }."""

    def __init__(self, name, d, mesh, case=None):
        super().__init__(name, d, mesh, case)
        inj = self.dict.subdict("injectionRate", required=True)
        self.values = {str(k): (np.asarray(v, float)
                                if isinstance(v, list) else float(v))
                       for k, v in inj.items()}

    def applies_to(self, field_name):
        return field_name in self.values

    def constrain(self, mesh, field_name, eqn, env):
        v = self.values[field_name]
        psi = eqn.psi.data
        if psi.ndim == 1:
            vals = torch.full((mesh.n_cells,), float(v), dtype=psi.dtype,
                              device=psi.device)
        else:
            vals = torch.as_tensor(v).to(psi).expand_as(psi)
        return eqn.set_values(mesh, self.mask, vals)


@register("fvOption", "radialActuationDiskSource")
class RadialActuationDiskSource(ActuationDiskSource):
    """Actuation disk with a radial thrust distribution (reference:
    sources/derived/radialActuationDiskSource/
    radialActuationDiskSourceTemplates.C:35-95): Tr(r) = T*(c0 + c1 r^2
    + c2 r^4)/intCoeffs about the zone's volume-averaged centre."""

    def __init__(self, name, d, mesh, case=None):
        super().__init__(name, d, mesh, case)
        c0, c1, c2 = (float(c) for c in
                      self.dict.lookup("coeffs", required=True))
        m = _np(self.mask) > 0
        C, V = _np(mesh.C), _np(mesh.V)
        avg_c = (V[m, None] * C[m]).sum(0) / V[m].sum()
        r2 = ((C - avg_c) ** 2).sum(1)
        max_r = float(np.sqrt(r2[m].max())) if m.any() else 1.0
        int_coeffs = c0 + c1 * max_r ** 2 / 2.0 + c2 * max_r ** 4 / 3.0
        self.radial_w = _like((c0 + c1 * r2 + c2 * r2 ** 2)
                              / max(int_coeffs, 1e-30), mesh)

    def add_sup(self, mesh, field_name, eqn, env):
        return eqn.replace(source=eqn.source - _disk_force(
            self, eqn.psi.data, env, mesh.V * self.mask * self.radial_w))


@register("fvOption", "rotorDiskSource")
class RotorDiskSource(Option):
    """Blade-element rotor disk (reference: sources/derived/
    rotorDiskSource/rotorDiskSourceTemplates.C:34-160 calculate()): a
    per-cell blade-element force from tabulated Cd/Cl profiles in a
    cylindrical rotor frame, fixedTrim collective/cyclic pitch.

    Everything radius-dependent (twist, chord, blended profile tables,
    local axes, coning rotations, disk area) is precomputed on the host
    into per-cell tensors; add_sup is vector math and one searchsorted
    lookup into a shared alpha grid. targetCoeffTrim is not supported:
    use fixedTrim."""

    def __init__(self, name, d, mesh, case=None):
        super().__init__(name, d, mesh, case)
        c = self.dict
        self.n_blades = int(c.scalar("nBlades"))
        self.tip_effect = float(c.scalar("tipEffect", 1.0))
        om = c.lookup("omega")
        if om is None:
            self.omega = float(c.scalar("rpm")) * 2.0 * np.pi / 60.0
        else:
            self.omega = float(om if not isinstance(om, tuple)
                               else Dimensioned.from_entry(om).value)
        self.rho_ref = float(c.scalar("rhoRef", 1.0))
        self.inlet_u = None
        if c.word("inletFlowType", "local") == "fixed":
            self.inlet_u = _like(c.lookup("inletVelocity", required=True),
                                 mesh)

        # geometry: origin + axis (cylindrical rotor frame)
        origin = np.asarray(c.lookup("origin", [0.0, 0.0, 0.0]), float)
        axis = np.asarray(c.lookup("axis", [0.0, 0.0, 1.0]), float)
        axis = axis / np.linalg.norm(axis)
        C = _np(mesh.C)
        m = _np(self.mask) > 0
        rel = C - origin
        z = rel @ axis
        perp = rel - z[:, None] * axis
        r = np.linalg.norm(perp, axis=1)
        er = perp / np.maximum(r, 1e-30)[:, None]
        et = np.cross(axis, er)
        psi = np.arctan2(er @ self._ortho(axis, 1),
                         er @ self._ortho(axis, 0))
        self.r = _like(np.where(m, r, 1.0), mesh)
        # local basis rows (er, et, axis) per cell: world -> local
        self.basis = _like(
            np.stack([er, et, np.broadcast_to(axis, er.shape)], 1), mesh)
        self.r_max = float(r[m].max()) if m.any() else 1.0
        self.area = _like(self._disk_area(mesh, m, axis, C, case), mesh)

        # blade geometry: data ((profile (r twist chord)) ...)
        rows = c.subdict("blade", required=True).lookup("data",
                                                        required=True)
        b_names = [str(row[0]) for row in rows]
        b_r = np.asarray([float(row[1][0]) for row in rows])
        b_twist = np.asarray([np.deg2rad(float(row[1][1])) for row in rows])
        b_chord = np.asarray([float(row[1][2]) for row in rows])
        idx2 = np.clip(np.searchsorted(b_r, r), 1, len(b_r) - 1)
        idx1 = idx2 - 1
        inv_dr = np.clip((r - b_r[idx1])
                         / np.maximum(b_r[idx2] - b_r[idx1], 1e-30),
                         0.0, 1.0)
        self.twist = _like(b_twist[idx1] + inv_dr
                           * (b_twist[idx2] - b_twist[idx1]), mesh)
        self.chord = _like(b_chord[idx1] + inv_dr
                           * (b_chord[idx2] - b_chord[idx1]), mesh)

        # profiles: each Cd/Cl polar resampled onto a shared alpha grid,
        # the two bracketing profiles blended per cell (static invDr)
        alpha_grid = np.linspace(-np.pi, np.pi, 181)
        tables = {}
        for pname, pd in c.subdict("profiles", required=True).items():
            if not isinstance(pd, Dictionary):
                continue
            data = pd.lookup("data", required=True)
            al = np.asarray([np.deg2rad(float(rw[0])) for rw in data])
            cd = np.asarray([float(rw[1]) for rw in data])
            cl = np.asarray([float(rw[2]) for rw in data])
            order = np.argsort(al)
            tables[str(pname)] = (
                np.interp(alpha_grid, al[order], cd[order]),
                np.interp(alpha_grid, al[order], cl[order]))
        w = inv_dr[:, None]

        def blend(k):
            t1 = np.stack([tables[b_names[i]][k] for i in idx1])
            t2 = np.stack([tables[b_names[i]][k] for i in idx2])
            return _like(t1 + w * (t2 - t1), mesh)
        self.alpha_grid = _like(alpha_grid, mesh)
        self.cd_tab, self.cl_tab = blend(0), blend(1)

        # fixedTrim pitch + flap coning (static per cell)
        t = c.subdict("fixedTrimCoeffs", required=False) or Dictionary()
        theta0 = np.deg2rad(float(t.scalar("theta0", 0.0)))
        theta1c = np.deg2rad(float(t.scalar("theta1c", 0.0)))
        theta1s = np.deg2rad(float(t.scalar("theta1s", 0.0)))
        self.thetag = _like(theta0 + theta1c * np.cos(psi)
                            + theta1s * np.sin(psi), mesh)
        f = c.subdict("flapCoeffs", required=False) or Dictionary()
        beta0 = np.deg2rad(float(f.scalar("beta0", 0.0)))
        beta1c = np.deg2rad(float(f.scalar("beta1c", 0.0)))
        beta2s = np.deg2rad(float(f.scalar("beta2s", 0.0)))
        beta = beta0 - beta1c * np.cos(psi) - beta2s * np.sin(psi)
        cb, sb = np.cos(beta), np.sin(beta)
        zer, one = np.zeros_like(cb), np.ones_like(cb)
        R = np.stack([np.stack([cb, zer, -sb], -1),
                      np.stack([zer, one, zer], -1),
                      np.stack([sb, zer, cb], -1)], 1)
        self.R = _like(R, mesh)
        self.invR = _like(np.swapaxes(R, 1, 2), mesh)

    @staticmethod
    def _disk_area(mesh, m, axis, C, case) -> np.ndarray:
        """The selection's exposed faces whose normal aligns with the axis
        (reference setFaceArea, tolerance 0.8), summed per cell; where the
        selection has none, V/h with h the cell's axial extent."""
        n_int = mesh.n_internal
        own = _np(mesh.owner)[:n_int]
        nei = _np(mesh.neighbour)[:n_int]
        sf = _np(mesh.Sf)[:n_int]
        msf = _np(mesh.mag_sf)[:n_int]
        nf = sf / np.maximum(msf, 1e-300)[:, None]
        align = np.abs(nf @ axis) > 0.8
        in_own, in_nei = m[own], m[nei]
        area = np.zeros(mesh.n_cells)
        sel = align & in_own & ~in_nei
        np.add.at(area, own[sel], msf[sel])
        sel = align & ~in_own & in_nei
        np.add.at(area, nei[sel], msf[sel])
        if area[m].any():
            return area
        # a selection without exposed axial internal faces (a one-cell-
        # thick zone whose axial faces are boundaries): area = V/h with
        # h = 2*max_f |(Cf - C).axis|
        if mesh.cell_faces is None:
            raise NotImplementedError(
                "rotorDiskSource: a selection with no internal face normal "
                "to the axis needs the cell-face table of the ELL layout "
                "(not built on a gdia lattice)")
        cf = _np(mesh.Cf)[_np(mesh.cell_faces)]
        dzc = np.abs((cf - C[:, None, :]) @ axis)
        h = 2.0 * (dzc * np.abs(_np(mesh.cell_sign))).max(1)
        if case is not None and not (h[m] > 1e-12).any():
            # axis-normal faces dropped entirely (a 2-D mesh with empty
            # patches): the points' span along the axis
            pz = case.pmesh.points @ axis
            h[:] = max(pz.max() - pz.min(), 1e-12)
        return np.where(m, _np(mesh.V) / np.maximum(h, 1e-30), 0.0)

    @staticmethod
    def _ortho(axis, i):
        """Two unit vectors orthogonal to axis (azimuth reference)."""
        a = np.asarray(axis, float)
        t = np.array([1.0, 0.0, 0.0]) if abs(a[0]) < 0.9 \
            else np.array([0.0, 1.0, 0.0])
        e0 = np.cross(a, t)
        e0 /= np.linalg.norm(e0)
        e1 = np.cross(a, e0)
        return e0 if i == 0 else e1

    def applies_to(self, field_name):
        return field_name == "U"

    def add_sup(self, mesh, field_name, eqn, env):
        U = eqn.psi.data
        u_in = U if self.inlet_u is None else self.inlet_u.to(U).expand_as(U)
        uc = torch.einsum("nij,nj->ni", self.basis, u_in)     # world -> cyl
        uc = torch.einsum("nij,nj->ni", self.R, uc)           # coning
        ur = torch.zeros_like(uc[:, 0])
        ut = self.r * self.omega - uc[:, 1]
        uz = uc[:, 2]
        alpha_geom = self.thetag + self.twist
        if self.omega < 0:
            alpha_geom = np.pi - alpha_geom
        alpha_eff = alpha_geom - torch.atan2(-uz, ut)
        alpha_eff = torch.where(alpha_eff > np.pi, alpha_eff - 2 * np.pi,
                                alpha_eff)
        alpha_eff = torch.where(alpha_eff < -np.pi, alpha_eff + 2 * np.pi,
                                alpha_eff)
        # per-cell polar lookup on the shared alpha grid
        grid = self.alpha_grid
        idx = torch.clamp(torch.searchsorted(grid, alpha_eff.contiguous()),
                          1, grid.shape[0] - 1)
        a0, a1 = grid[idx - 1], grid[idx]
        w = (alpha_eff - a0) / torch.clamp_min(a1 - a0, 1e-30)
        im1, i0 = (idx - 1)[:, None], idx[:, None]
        cd = (1 - w) * self.cd_tab.gather(1, im1)[:, 0] \
            + w * self.cd_tab.gather(1, i0)[:, 0]
        cl = (1 - w) * self.cl_tab.gather(1, im1)[:, 0] \
            + w * self.cl_tab.gather(1, i0)[:, 0]
        tip = (self.r / self.r_max < self.tip_effect).to(cd.dtype)
        p_dyn = 0.5 * (ur ** 2 + ut ** 2 + uz ** 2)   # rho = 1 (kinematic)
        f = p_dyn * self.chord * self.n_blades * self.area \
            / torch.clamp_min(self.r, 1e-30) / (2.0 * np.pi)
        local = torch.stack([torch.zeros_like(f), -f * cd, tip * f * cl], -1)
        local = torch.einsum("nij,nj->ni", self.invR, local)
        force = torch.einsum("nji,nj->ni", self.basis, local)  # cyl -> world
        return eqn.replace(source=eqn.source + self.mask[:, None] * force)


def _env_t(env, t_name):
    T = env.get(t_name)
    return env.get("T") if T is None else T


@register("fvOption", "solidificationMeltingSource")
class SolidificationMeltingSource(Option):
    """Enthalpy-porosity phase change (reference: sources/derived/
    solidificationMeltingSource/solidificationMeltingSource.C:update +
    Templates.C:apply): Carman-Kozeny momentum blockage in the solid
    fraction plus a Boussinesq melt buoyancy source.

    As in the JAX package the liquid fraction is the equilibrium response
    alpha1 = clip(0.5 + Cp*(T - Tmelt)/L, 0, 1) of the cell temperature
    (the reference relaxes a stored alpha1 toward it each step)."""

    def __init__(self, name, d, mesh, case=None):
        super().__init__(name, d, mesh, case)
        c = self.dict
        self.t_melt = float(c.scalar("Tmelt"))
        self.L = float(c.scalar("L"))
        self.cu = float(c.scalar("Cu", 100000.0))
        self.q = float(c.scalar("q", 0.001))
        self.beta = float(c.scalar("beta"))
        self.rho_ref = float(c.scalar("rhoRef", 1.0))
        self.cp = float(c.scalar("Cp", 1.0))       # lookup-mode Cp
        self.t_name = c.word("TName", "T")
        g = [0.0, 0.0, -9.81]
        if case is not None:
            gp = os.path.join(case.dir, "constant", "g")
            if os.path.isfile(gp):
                gv = parse_file(gp).lookup("value")
                if gv is not None:
                    g = [float(x) for x in (
                        gv if isinstance(gv, list) else gv[-1])]
        self.g = _like(g, mesh)

    def alpha1(self, T_data):
        return torch.clamp(0.5 + self.cp * (T_data - self.t_melt) / self.L,
                           0.0, 1.0)

    def applies_to(self, field_name):
        return field_name in ("U", self.t_name, "h", "e")

    def add_sup(self, mesh, field_name, eqn, env):
        T = _env_t(env, self.t_name)
        if T is None:
            return eqn
        a1 = self.alpha1(T.data)
        if field_name == "U":
            # Carman-Kozeny blockage (implicit, stabilising)
            sp = self.cu * (1.0 - a1) ** 2 / (a1 ** 3 + self.q)
            eqn = eqn.replace(diag=eqn.diag + mesh.V * self.mask * sp)
            # melt-pool Boussinesq buoyancy about Tmelt
            sb = self.rho_ref * self.beta * (T.data - self.t_melt)
            return eqn.replace(source=eqn.source - (
                mesh.V * self.mask * sb)[:, None] * self.g.to(eqn.source))
        # energy equation: latent heat -L/Cp * d(alpha1)/dt
        dt = env.get("dt")
        if dt is None or T.old is None:
            return eqn
        dadt = (a1 - self.alpha1(T.old.data)) / dt
        scale = self.L / self.cp if field_name == self.t_name else self.L
        # melting (dadt > 0) absorbs latent heat from the sensible field
        return eqn.replace(source=eqn.source
                           - mesh.V * self.mask * scale * dadt)


def _interp(x, xp, fp):
    """jnp.interp of a 0-d tensor on increasing nodes xp: fp[0] left of
    them, fp[-1] right of them."""
    i = torch.clamp(torch.searchsorted(xp, x.reshape(1), right=True),
                    1, xp.shape[0] - 1)[0]
    dx = xp[i] - xp[i - 1]
    dx0 = dx.abs() <= np.spacing(torch.finfo(xp.dtype).eps)
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (x - xp[i - 1])
                    / torch.where(dx0, torch.ones_like(dx), dx)
                    * (fp[i] - fp[i - 1]))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


@register("fvOption", "effectivenessHeatExchangerSource")
class EffectivenessHeatExchangerSource(Option):
    """Effectiveness-NTU heat exchanger (reference: sources/derived/
    effectivenessHeatExchangerSource/effectivenessHeatExchangerSource.C:
    addSup): Qt = e(|phi_zone|, mdot2)*(T2in - T1in)*Cp*|phi_zone|,
    distributed over the selection weighted by V*|U|*max(Tref - T, 0).

    The 2-D effectiveness table is collapsed on the host to e(|phi|) at
    the fixed secondaryMassFlowRate; add_sup does one interpolation and
    masked reductions (gsum, gmax). For a T equation the source is
    divided by Cp."""

    def __init__(self, name, d, mesh, case=None):
        super().__init__(name, d, mesh, case)
        c = self.dict
        self.mdot2 = float(c.scalar("secondaryMassFlowRate"))
        self.t2_in = float(c.scalar("secondaryInletT"))
        self.t1_in = float(c.scalar("primaryInletT"))
        self.cp = float(c.scalar("Cp", 1005.0))
        self.t_name = c.word("TName", "T")
        zone = c.word("faceZone")

        # faceZone faces (file labels) -> device faces
        from ..mesh.polymesh import read_face_zones
        zones = read_face_zones(case.dir, getattr(case, "region", "")) \
            if case else {}
        if zone not in zones:
            raise KeyError(f"effectivenessHeatExchangerSource: no "
                           f"faceZone '{zone}'")
        labels = np.asarray(zones[zone][0], np.int64)
        inv_face = np.zeros(mesh.n_faces, np.int64)
        inv_face[np.asarray(case.maps.face_perm)] = np.arange(mesh.n_faces)
        fmask = np.zeros(mesh.n_faces)
        fmask[inv_face[labels]] = 1.0
        self.face_mask = _like(fmask, mesh)

        # effectiveness table: inline "table ((mdot1 ((mdot2 e)...))...)"
        # or an OpenFOAM interpolation2DTable file through "fileName"
        rows = c.lookup("table")
        if rows is None:
            fn = c.word("fileName", "")
            if case is not None and fn:
                path = os.path.join(case.dir, fn.strip('"'))
                with open(path.replace("$FOAM_CASE", case.dir)) as fh:
                    rows = parse_dictionary(
                        "table " + fh.read() + ";").lookup("table")
        if rows is None:
            raise KeyError("effectivenessHeatExchangerSource: no "
                           "'table' or readable 'fileName'")
        if len(rows) == 1 and isinstance(rows[0], list):
            rows = rows[0]
        m1, eff = [], []
        for row in rows:
            m1.append(float(row[0]))
            s_m = [float(r[0]) for r in row[1]]
            s_e = [float(r[1]) for r in row[1]]
            eff.append(float(np.interp(self.mdot2, s_m, s_e)))
        order = np.argsort(np.asarray(m1))
        self.e_phi = _like(np.asarray(m1)[order], mesh)
        self.e_val = _like(np.asarray(eff)[order], mesh)

    def applies_to(self, field_name):
        return field_name in (self.t_name, "h", "e")

    def add_sup(self, mesh, field_name, eqn, env):
        T = _env_t(env, self.t_name)
        phi, U = env.get("phi"), env.get("U")
        if T is None or phi is None:
            return eqn
        mag_phi = gsum(self.face_mask * phi.data).abs()
        e = _interp(mag_phi, self.e_phi, self.e_val)
        qt = e * (self.t2_in - self.t1_in) * self.cp * mag_phi

        tc = T.data
        sel = self.mask > 0
        big = torch.tensor(1e30, dtype=tc.dtype, device=tc.device)
        t_max = gmax(torch.where(sel, tc, -big))
        t_min = -gmax(torch.where(sel, -tc, -big))
        t_ref = torch.where(qt > 0, t_max, t_min)
        d_t = torch.where(qt > 0, torch.clamp_min(t_ref - tc, 0.0),
                          torch.clamp_min(tc - t_ref, 0.0))
        umag = torch.linalg.norm(U.data, dim=-1) if U is not None \
            else torch.ones_like(tc)
        w = mesh.V * self.mask * umag * d_t
        scale = 1.0 / self.cp if field_name == self.t_name else 1.0
        return eqn.replace(source=eqn.source + qt * scale * w
                           / torch.clamp_min(gsum(w), 1e-30))
