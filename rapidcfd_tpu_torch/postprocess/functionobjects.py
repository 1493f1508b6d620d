"""functionObjects — run-time postprocessing hooks (port of
rapidcfd_tpu/postprocess/functionobjects.py; reference:
src/OpenFOAM/db/functionObjects/functionObjectList.H:58 executed from
Time::run(), and src/postProcessing/functionObjects/{field,forces,
utilities}).

The hooks of system/controlDict `functions {}` run after every step and
write time series under postProcessing/<name>/<startTime>/ in the JAX
package's file layout. Every type of the JAX package is here but
`surfaces` and `streamLine`, which need its triangulated-surface, mesh
search, point interpolation and iso-surface modules: they raise by name. A
type neither package knows is logged and skipped, as there.

The fields stay on their device: a hook gathers the probed and sampled
cells, reduces minima, maxima and patch integrals there, and copies those
few numbers to the host; fieldAverage keeps its sums on the device and
copies the averages only when it writes them. Cell reductions and the
nearest-cell searches run over the mesh's live cells (on a gdia lattice
the primary slots, through MeshMaps), and a search breaks ties by file
order, so the ELL and gdia layouts of a mesh pick the same cell.

Where the port departs from the JAX package, it follows the reference:
- fieldAverage weights each step by its dt (`base time`; `base
  iteration` by one), keeps one weight per field, takes prime2Mean as the
  mean of x'x' (a symmTensor for a vector) and writes <field>Mean and
  <field>Prime2Mean at write times (the JAX package averages x x with
  equal weights over one shared counter and writes nothing);
- `enabled false` switches a hook off.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..utils.dictionary import Dictionary
from ..utils.dimensions import DimensionSet
from ..utils.logging import info
from ..utils.registry import lookup, register

#: the types the JAX package has and the port does not, with what they need
NOT_PORTED = {
    "surfaces": "mesh/trisurface.py, meshsearch.py, pointinterp.py and "
                "isosurface.py",
    "streamLine": "mesh/meshsearch.py and the particle tracking of "
                  "lagrangian/basic",
}


class FunctionObject:
    def __init__(self, name: str, d: Dictionary, case):
        self.name = name
        self.dict = d
        self.case = case
        self.out_dir = os.path.join(case.dir, "postProcessing", name,
                                    case.time.name)
        self._files = {}

    def file(self, fname: str, header: str = ""):
        if fname not in self._files:
            os.makedirs(self.out_dir, exist_ok=True)
            f = open(os.path.join(self.out_dir, fname), "w")
            if header:
                f.write(header)
            self._files[fname] = f
        return self._files[fname]

    def execute(self, time, fields: dict, mesh):
        raise NotImplementedError

    def close(self):
        for f in self._files.values():
            f.close()


# ---------------------------------------------------------------------------
# helpers: live cells, nearest-cell search, patch faces
# ---------------------------------------------------------------------------

def _live(case) -> torch.Tensor:
    """Bool mask of the device rows that hold a mesh cell (gdia: primary
    slots; ELL: every row)."""
    return torch.as_tensor(np.asarray(case.maps.cell_primary, bool),
                           device=case.mesh.device)


def _nearest_cells(case, pts: np.ndarray) -> np.ndarray:
    """Device rows of the live cells nearest to each point; a tie goes to
    the lower file label."""
    maps = case.maps
    rows = np.nonzero(np.asarray(maps.cell_primary, bool))[0]
    C = case.mesh.C.detach().cpu().numpy().astype(np.float64)[rows]
    order = np.argsort(maps.cell_perm[rows], kind="stable")
    rows, C = rows[order], C[order]
    out = np.empty(len(pts), dtype=np.int64)
    for i, p in enumerate(np.asarray(pts, float).reshape(-1, 3)):
        out[i] = rows[int(np.argmin(((C - p) ** 2).sum(1)))]
    return out


def _rows(case, cells: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(cells, device=case.mesh.device)


def _words(d: Dictionary, key: str) -> list[str]:
    return [str(w) for w in (d.lookup(key, required=True) or [])]


def _active(mesh, patch) -> torch.Tensor:
    """Bool mask of the patch's real faces (gdia pads patches with
    zero-area faces)."""
    return mesh.patch_mag_sf(patch) > 0


def _mag(x: torch.Tensor) -> torch.Tensor:
    return x.norm(dim=-1) if x.dim() > 1 else x


def _g(x: float) -> str:
    return f"{x:.8g}"


def _v3(x) -> str:
    return "(" + " ".join(_g(float(c)) for c in x) + ")"


def _write_derived(case, name, vf):
    # mark=False: a derived-field write must not consume the step's write
    # trigger (the solver's own write follows)
    case.write_fields([vf.replace(name=name)], mark=False)


def _cell_field(like, data: torch.Tensor, mesh, dims, name):
    """A derived cell field with calculated patches whose values are the
    face cells' (the JAX package's `data[owner[n_internal:]]`)."""
    from ..ops.fvc import boundary_owner_values
    return like.with_calculated_bcs(data, boundary_owner_values(mesh, data),
                                    dims, name)


# ---------------------------------------------------------------------------
# sampling and reductions
# ---------------------------------------------------------------------------

@register("functionObject", "probes")
class Probes(FunctionObject):
    """Point probes by nearest live cell (reference: sampling/probes)."""

    def __init__(self, name, d, case):
        super().__init__(name, d, case)
        self.points = np.asarray(d.lookup("probeLocations", required=True),
                                 dtype=float).reshape(-1, 3)
        self.field_names = _words(d, "fields")
        self.cells = _nearest_cells(case, self.points)
        self._rows = _rows(case, self.cells)

    def execute(self, time, fields, mesh):
        hdr = " ".join("(" + " ".join(f"{float(x):g}" for x in pt) + ")"
                       for pt in self.points)
        for name in self.field_names:
            if name not in fields:
                continue
            vals = fields[name].data.index_select(0, self._rows)
            vals = vals.detach().cpu().numpy()
            f = self.file(name, header=f"# probes: {hdr}\n")
            out = [_v3(v) if v.ndim else f"{v:.8g}" for v in vals]
            f.write(f"{time:<14.8g}" + " ".join(out) + "\n")
            f.flush()


@register("functionObject", "fieldMinMax")
class FieldMinMax(FunctionObject):
    """Minimum and maximum (magnitude for a vector) over the live cells
    (reference: postProcessing/field/fieldMinMax)."""

    def __init__(self, name, d, case):
        super().__init__(name, d, case)
        self.field_names = _words(d, "fields")
        self.log = d.boolean("log", True)
        self._live = _live(case)

    def execute(self, time, fields, mesh):
        f = self.file("fieldMinMax.dat", header="# Time field min max\n")
        for name in self.field_names:
            if name not in fields:
                continue
            data = _mag(fields[name].data[self._live])
            mn, mx = torch.stack([data.min(), data.max()]).tolist()
            f.write(f"{time:.8g} {name} {mn:.8g} {mx:.8g}\n")
            if self.log:
                info(f"fieldMinMax {self.name}: min({name}) = {mn:.6g} "
                     f"max({name}) = {mx:.6g}")
        f.flush()


@register("functionObject", "forces")
class Forces(FunctionObject):
    """Pressure and viscous patch force integrals and their moment
    (reference: postProcessing/forces/forces.C, incompressible with
    rhoInf)."""

    def __init__(self, name, d, case):
        super().__init__(name, d, case)
        self.patches = _words(d, "patches")
        self.rho_ref = float(d.scalar("rhoInf", 1.0))
        self.cofr = np.asarray(d.lookup("CofR", [0.0, 0.0, 0.0]),
                               dtype=float)

    def _integrals(self, fields, mesh):
        from ..ops import fvc
        U, p = fields["U"], fields["p"]
        nu_eff = fields.get("nuEff")
        sng = fvc.sn_grad(mesh, U)
        cofr = torch.as_tensor(self.cofr, dtype=mesh.dtype,
                               device=mesh.device)
        total = torch.zeros(3, 3, dtype=mesh.dtype, device=mesh.device)
        for patch in mesh.patches:
            if patch.name not in self.patches:
                continue
            sl = slice(patch.start, patch.start + patch.size)
            bsl = slice(patch.bstart, patch.bstart + patch.size)
            fp = self.rho_ref * mesh.Sf[sl] * p.bvalues[bsl][:, None]
            nu_b = nu_eff.bvalues[bsl] if nu_eff is not None else 0.0
            fv = -self.rho_ref * (nu_b * mesh.mag_sf[sl])[:, None] \
                * sng.data[sl]
            mom = torch.linalg.cross(mesh.Cf[sl] - cofr, fp + fv)
            total = total + torch.stack([fp.sum(0), fv.sum(0), mom.sum(0)])
        return total.detach().cpu().numpy().astype(np.float64)

    def execute(self, time, fields, mesh):
        if "U" not in fields or "p" not in fields:
            return
        fp, fv, mom = self._integrals(fields, mesh)
        f = self.file("forces.dat",
                      header="# Time forces(pressure viscous) moment\n")
        f.write(f"{time:.8g}\t({_v3(fp)} {_v3(fv)})\t{_v3(mom)}\n")
        f.flush()
        self.last = (fp, fv, mom)


@register("functionObject", "forceCoeffs")
class ForceCoeffs(Forces):
    """Cm, Cd and Cl from the patch force integrals (reference:
    postProcessing/forces/forceCoeffs/forceCoeffs.C)."""

    def __init__(self, name, d, case):
        super().__init__(name, d, case)

        def vec(key, default):
            return np.asarray(d.lookup(key, default), dtype=float)
        self.lift_dir = vec("liftDir", [0.0, 1.0, 0.0])
        self.drag_dir = vec("dragDir", [1.0, 0.0, 0.0])
        self.pitch_axis = vec("pitchAxis", [0.0, 0.0, 1.0])
        self.mag_u_inf = float(d.scalar("magUInf", 1.0))
        self.l_ref = float(d.scalar("lRef", 1.0))
        self.a_ref = float(d.scalar("Aref", 1.0))

    def execute(self, time, fields, mesh):
        Forces.execute(self, time, fields, mesh)
        if not hasattr(self, "last"):
            return
        fp, fv, mom = self.last
        q = 0.5 * self.rho_ref * self.mag_u_inf ** 2
        ftot = fp + fv
        cd = float((ftot * self.drag_dir).sum()) / (q * self.a_ref)
        cl = float((ftot * self.lift_dir).sum()) / (q * self.a_ref)
        cm = float((mom * self.pitch_axis).sum()) \
            / (q * self.a_ref * self.l_ref)
        f = self.file("forceCoeffs.dat", header="# Time Cm Cd Cl\n")
        f.write(f"{time:.8g}\t{cm:.8g}\t{cd:.8g}\t{cl:.8g}\n")
        f.flush()
        self.coeffs = (cm, cd, cl)


def _sqr(x: torch.Tensor) -> torch.Tensor:
    """x x: x^2 for a scalar, the symmTensor (xx xy xz yy yz zz) of a
    vector."""
    if x.dim() == 1:
        return x * x
    i, j = (0, 0, 0, 1, 1, 2), (0, 1, 2, 1, 2, 2)
    return x[:, i] * x[:, j]


@register("functionObject", "fieldAverage")
class FieldAverage(FunctionObject):
    """Running time averages (reference: postProcessing/field/
    fieldAverage): mean = alpha mean + beta x and prime2Mean = alpha
    (prime2Mean + mean_old mean_old) + beta x x - mean mean, alpha = (Dt -
    dt)/Dt, beta = dt/Dt, Dt the field's averaged time (its step count
    under `base iteration`). The sums live on the field's device; at a
    write time <field>Mean and <field>Prime2Mean are written."""

    def __init__(self, name, d, case):
        super().__init__(name, d, case)
        entries = d.lookup("fields", required=True)
        self.items = {}
        for i, e in enumerate(entries):
            if isinstance(e, str):
                sub = entries[i + 1] if i + 1 < len(entries) \
                    and isinstance(entries[i + 1], dict) else {}
                sub = Dictionary(sub)
                self.items[e] = dict(
                    mean=sub.boolean("mean", True),
                    prime2Mean=sub.boolean("prime2Mean", False),
                    iteration=sub.word("base", "time") == "iteration")
        self.state = {}

    def execute(self, time, fields, mesh):
        dt = float(self.case.time.delta_t)
        for name, opt in self.items.items():
            if name not in fields:
                continue
            x = fields[name]
            w = 1.0 if opt["iteration"] else dt
            st = self.state.get(name)
            if st is None:
                st = self.state[name] = dict(
                    Dt=0.0, mean=torch.zeros_like(x.data),
                    bmean=torch.zeros_like(x.bvalues),
                    p2=torch.zeros_like(_sqr(x.data)),
                    bp2=torch.zeros_like(_sqr(x.bvalues)))
            st["Dt"] += w
            beta = w / st["Dt"]
            alpha = 1.0 - beta
            for m, p2, v in (("mean", "p2", x.data),
                             ("bmean", "bp2", x.bvalues)):
                old_sq = _sqr(st[m])
                st[m] = alpha * st[m] + beta * v
                st[p2] = alpha * (st[p2] + old_sq) + beta * _sqr(v) \
                    - _sqr(st[m])
        if self.case.time.write_time():
            self.write(fields)

    def mean(self, name):
        st = self.state.get(name)
        return None if st is None else st["mean"]

    def prime2_mean(self, name):
        st = self.state.get(name)
        return None if st is None else st["p2"]

    def write(self, fields):
        for name, opt in self.items.items():
            st = self.state.get(name)
            if st is None:
                continue
            x = fields[name]
            out = []
            if opt["mean"]:
                out.append(x.with_calculated_bcs(
                    st["mean"], st["bmean"], x.dims, name + "Mean"))
            if opt["prime2Mean"]:
                out.append(x.with_calculated_bcs(
                    st["p2"], st["bp2"], x.dims * x.dims,
                    name + "Prime2Mean"))
            if out:
                self.case.write_fields(out, mark=False)


@register("functionObject", "sets")
class SampledSets(FunctionObject):
    """Line sampling by nearest live cell (reference: sampling/sampledSet/
    sampledSets, the uniform set type, raw/csv writers)."""

    def __init__(self, name, d, case):
        super().__init__(name, d, case)
        self.field_names = _words(d, "fields")
        self.writer = str(d.word("setFormat", "raw"))
        self.interval = int(d.scalar("outputInterval", 1))
        self._count = 0
        self.sets = []
        for sname, sd in (d.subdict("sets", required=False)
                          or Dictionary()).items():
            if not isinstance(sd, Dictionary):
                continue
            typ = str(sd.word("type", "uniform"))
            if typ not in ("uniform", "midPoint", "midPointAndFace"):
                info(f"sets: unsupported set type '{typ}' — skipped")
                continue
            start = np.asarray(sd.lookup("start", required=True), float)
            end = np.asarray(sd.lookup("end", required=True), float)
            npts = int(sd.scalar("nPoints", 100))
            pts = start[None, :] + (end - start)[None, :] \
                * np.linspace(0.0, 1.0, npts)[:, None]
            cells = _nearest_cells(case, pts)
            axis = str(sd.word("axis", "distance"))
            coord = pts[:, "xyz".index(axis)] if axis in ("x", "y", "z") \
                else np.linalg.norm(pts - start, axis=1)
            self.sets.append((str(sname), _rows(case, cells), coord))

    def execute(self, time, fields, mesh):
        self._count += 1
        if self._count % self.interval:
            return
        ext = {"csv": "csv", "raw": "xy", "gnuplot": "xy"}.get(self.writer,
                                                              "xy")
        sep = "," if self.writer == "csv" else "\t"
        for sname, rows, coord in self.sets:
            for fname in self.field_names:
                if fname not in fields:
                    continue
                data = fields[fname].data.index_select(0, rows)
                data = data.detach().cpu().numpy()
                out = os.path.join(self.out_dir, f"{time:g}")
                os.makedirs(out, exist_ok=True)
                with open(os.path.join(out, f"{sname}_{fname}.{ext}"),
                          "w") as f:
                    if self.writer == "csv":
                        cols = ([f"{fname}_{c}" for c in "xyz"]
                                if data.ndim > 1 else [fname])
                        f.write("distance," + ",".join(cols) + "\n")
                    for c, v in zip(coord, data):
                        vs = sep.join(_g(x) for x in v) if v.ndim \
                            else _g(v)
                        f.write(f"{c:.8g}{sep}{vs}\n")


@register("functionObject", "fieldValue", "cellSource", "faceSource")
class FieldValue(FunctionObject):
    """Region integrals and averages over the live cells or a patch's
    faces (reference: postProcessing/field/fieldValues cellSource/
    faceSource): volAverage, volIntegrate, areaAverage, areaIntegrate,
    sum, min, max."""

    def __init__(self, name, d, case):
        super().__init__(name, d, case)
        self.field_names = _words(d, "fields")
        self.op = str(d.word("operation", "volAverage"))
        self.source = str(d.word("source", "all"))
        self.source_name = str(d.word("sourceName", ""))
        self.log = d.boolean("log", False)
        self._live = _live(case)

    def execute(self, time, fields, mesh):
        f = self.file("fieldValue.dat", header="# Time field value\n")
        for name in self.field_names:
            if name not in fields:
                continue
            fld = fields[name]
            if self.source == "patch":
                patch = next((p for p in mesh.patches
                              if p.name == self.source_name), None)
                if patch is None:
                    continue
                act = _active(mesh, patch)
                x = fld.bvalues[patch.bstart:patch.bstart + patch.size][act]
                w = mesh.patch_mag_sf(patch)[act]
            else:
                x, w = fld.data[self._live], mesh.V[self._live]
            wx = w[:, None] if x.dim() > 1 else w
            if self.op in ("volAverage", "areaAverage"):
                val = (x * wx).sum(0) / w.sum()
            elif self.op in ("volIntegrate", "areaIntegrate"):
                val = (x * wx).sum(0)
            elif self.op == "sum":
                val = x.sum(0)
            elif self.op == "min":
                val = x.amin(0)
            elif self.op == "max":
                val = x.amax(0)
            else:
                raise KeyError(f"fieldValue: unknown operation '{self.op}'")
            vs = " ".join(_g(v) for v in
                          np.atleast_1d(val.detach().cpu().numpy()))
            f.write(f"{time:.8g} {name} {vs}\n")
            if self.log:
                info(f"fieldValue {self.name}: {self.op}({name}) = {vs}")
        f.flush()


# ---------------------------------------------------------------------------
# derived fields written at write times
# ---------------------------------------------------------------------------

def _curl(t: torch.Tensor) -> torch.Tensor:
    return torch.stack([t[..., 1, 2] - t[..., 2, 1],
                        t[..., 2, 0] - t[..., 0, 2],
                        t[..., 0, 1] - t[..., 1, 0]], dim=-1)


def _parts(t: torch.Tensor):
    tt = t.transpose(-1, -2)
    return 0.5 * (t + tt), 0.5 * (t - tt)


def _q(t: torch.Tensor) -> torch.Tensor:
    s, o = _parts(t)
    return 0.5 * ((o * o).sum((-2, -1)) - (s * s).sum((-2, -1)))


def _lambda2(t: torch.Tensor) -> torch.Tensor:
    s, o = _parts(t)
    return torch.linalg.eigvalsh(s @ s + o @ o)[..., 1]


class _GradField(FunctionObject):
    """A field of grad(U) written at write times."""
    out_name = ""

    def value(self, t: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def dims(self, g):
        return g.dims * g.dims

    def execute(self, time, fields, mesh):
        if "U" not in fields or not self.case.time.write_time():
            return
        from ..ops import fvc
        U = fields["U"]
        g = fvc.grad(mesh, U)
        f = U.with_calculated_bcs(self.value(g.data), self.value(g.bvalues),
                                  self.dims(g), self.out_name)
        _write_derived(self.case, self.out_name, f)


@register("functionObject", "vorticity")
class Vorticity(_GradField):
    """curl(U) (reference: postProcessing/utilities/vorticity)."""
    out_name = "vorticity"
    value = staticmethod(_curl)

    def dims(self, g):
        return g.dims


@register("functionObject", "Q")
class QCriterion(_GradField):
    """Q = 0.5(|Omega|^2 - |S|^2) (reference: postProcessing/utilities/
    Q)."""
    out_name = "Q"
    value = staticmethod(_q)


@register("functionObject", "Lambda2")
class Lambda2(_GradField):
    """The second eigenvalue of S^2 + Omega^2 (reference:
    postProcessing/utilities/Lambda2)."""
    out_name = "Lambda2"
    value = staticmethod(_lambda2)


def _wall_patches(mesh):
    return [p for p in mesh.patches if p.type == "wall" and p.size]


@register("functionObject", "wallShearStress")
class WallShearStress(FunctionObject):
    """|tau_w| = nuEff |snGrad(U)| on the wall patches, min and max
    (reference: postProcessing/utilities/wallShearStress)."""

    def execute(self, time, fields, mesh):
        if "U" not in fields:
            return
        from ..ops import fvc
        nu_eff = fields.get("nuEff")
        sng = fvc.sn_grad(mesh, fields["U"])
        f = self.file("wallShearStress.dat", header="# Time patch min max\n")
        for patch in _wall_patches(mesh):
            sl = slice(patch.start, patch.start + patch.size)
            bsl = slice(patch.bstart, patch.bstart + patch.size)
            nu_b = nu_eff.bvalues[bsl] if nu_eff is not None else 1.0
            tau = (sng.data[sl].norm(dim=-1) * nu_b)[_active(mesh, patch)]
            mn, mx = torch.stack([tau.min(), tau.max()]).tolist()
            f.write(f"{time:.8g} {patch.name} {mn:.8g} {mx:.8g}\n")
        f.flush()


@register("functionObject", "yPlusRAS", "yPlus")
class YPlus(FunctionObject):
    """y+ on the wall patches from nuEff and nu (reference:
    postProcessing/utilities/yPlusRAS), min, max and mean."""

    def execute(self, time, fields, mesh):
        if "U" not in fields:
            return
        from ..ops import fvc
        nu_eff, nu = fields.get("nuEff"), fields.get("nu")
        sng = fvc.sn_grad(mesh, fields["U"])
        f = self.file("yPlus.dat", header="# Time patch min max avg\n")
        for patch in _wall_patches(mesh):
            sl = slice(patch.start, patch.start + patch.size)
            bsl = slice(patch.bstart, patch.bstart + patch.size)
            act = _active(mesh, patch)
            y = 1.0 / mesh.patch_delta_coeffs(patch)[act]
            nu_w = nu_eff.bvalues[bsl][act] if nu_eff is not None else 0.0
            nu_l = nu.bvalues[bsl][act] if nu is not None else 1e-5
            mag = sng.data[sl][act].norm(dim=-1)
            u_tau = torch.sqrt(torch.clamp((nu_w + nu_l) * mag, min=0.0))
            yp = u_tau * y / torch.clamp(torch.as_tensor(nu_l), min=1e-300)
            mn, mx, av = torch.stack([yp.min(), yp.max(),
                                      yp.mean()]).tolist()
            f.write(f"{time:.8g} {patch.name} {mn:.8g} {mx:.8g} "
                    f"{av:.8g}\n")
        f.flush()


def _real_internal(mesh) -> torch.Tensor:
    """Bool mask of the internal faces that are faces of the mesh (gdia
    plane faces into dead or ghost slots have no area)."""
    return mesh.mag_sf[:mesh.n_internal] > 0


@register("functionObject", "Peclet")
class Peclet(FunctionObject):
    """Face Peclet number |phi|/(deltaCoeffs magSf nuEff), min, max and
    mean over the internal faces (reference: postProcessing/utilities/
    Peclet)."""

    def execute(self, time, fields, mesh):
        phi, nu_eff = fields.get("phi"), fields.get("nuEff")
        if phi is None or nu_eff is None:
            return
        from ..ops import fvc
        n = mesh.n_internal
        if hasattr(nu_eff, "bvalues"):
            nu_f = fvc.face_values(mesh, nu_eff)[:n]
        else:
            nu_f = float(getattr(nu_eff, "value", nu_eff))
        real = _real_internal(mesh)
        pe = (phi.data[:n].abs() / (mesh.delta_coeffs * mesh.mag_sf[:n]
                                    * torch.clamp(torch.as_tensor(nu_f),
                                                  min=1e-30)))[real]
        mn, mx, av = torch.stack([pe.min(), pe.max(), pe.mean()]).tolist()
        f = self.file("Peclet.dat", header="# Time min max mean\n")
        f.write(f"{time:.8g} {mn:.8g} {mx:.8g} {av:.8g}\n")
        f.flush()


@register("functionObject", "CourantNo")
class CourantNoFO(FunctionObject):
    """The cell Courant number 0.5 dt sum|phi|/V, written at write times
    (reference: postProcessing/utilities/CourantNo)."""

    def execute(self, time, fields, mesh):
        ref = fields.get("p")
        if "phi" not in fields or ref is None or ref.data.dim() != 1 \
                or not self.case.time.write_time():
            return
        from ..ops import fvc
        sum_phi = fvc.surface_sum_faces(mesh, fields["phi"].data.abs(),
                                        signed=False)
        co = 0.5 * sum_phi / mesh.V * self.case.time.delta_t
        _write_derived(self.case, "Co",
                       _cell_field(ref, co, mesh, DimensionSet(), "Co"))


@register("functionObject", "wallHeatFlux")
class WallHeatFlux(FunctionObject):
    """kappa snGrad(T) on the wall patches: integral, min and max
    (reference: postProcessing/utilities/wallHeatFlux, the kappa form)."""

    def execute(self, time, fields, mesh):
        T = fields.get("T")
        if T is None:
            return
        from ..ops import fvc
        kappa = fields.get("kappaEff") or fields.get("alphaEff") \
            or fields.get("nuEff")
        sng = fvc.sn_grad(mesh, T)
        f = self.file("wallHeatFlux.dat",
                      header="# Time patch integral min max\n")
        for patch in _wall_patches(mesh):
            sl = slice(patch.start, patch.start + patch.size)
            bsl = slice(patch.bstart, patch.bstart + patch.size)
            if kappa is None:
                k_b = 1.0
            elif hasattr(kappa, "bvalues"):
                k_b = kappa.bvalues[bsl]
            else:
                k_b = float(getattr(kappa, "value", kappa))
            act = _active(mesh, patch)
            q = (k_b * sng.data[sl])[act]
            msf = mesh.patch_mag_sf(patch)[act]
            s, mn, mx = torch.stack([(q * msf).sum(), q.min(),
                                     q.max()]).tolist()
            f.write(f"{time:.8g} {patch.name} {s:.8g} {mn:.8g} {mx:.8g}\n")
        f.flush()


@register("functionObject", "pressureTools")
class PressureTools(FunctionObject):
    """Total pressure p + 0.5|U|^2 written at write times (reference:
    postProcessing/utilities/pressureTools, calcTotal)."""

    def execute(self, time, fields, mesh):
        if "p" not in fields or "U" not in fields \
                or not self.case.time.write_time():
            return
        p, U = fields["p"], fields["U"]
        data = p.data + 0.5 * (U.data * U.data).sum(-1)
        bv = p.bvalues + 0.5 * (U.bvalues * U.bvalues).sum(-1)
        _write_derived(self.case, "total(p)",
                       p.with_calculated_bcs(data, bv, p.dims, "total(p)"))


@register("functionObject", "turbulenceFields", "R")
class TurbulenceFields(FunctionObject):
    """The Reynolds stress R = (2/3) k I - 2 nut S as a symmTensor field,
    written at write times (reference: postProcessing/utilities/
    turbulenceFields)."""

    def execute(self, time, fields, mesh):
        if "U" not in fields or "nut" not in fields \
                or not self.case.time.write_time():
            return
        from ..ops import fvc
        U, nut, k = fields["U"], fields["nut"], fields.get("k")
        s, _ = _parts(fvc.grad(mesh, U).data)
        kk = k.data if k is not None else torch.zeros_like(nut.data)
        R = (2.0 / 3.0) * kk[:, None, None] * torch.eye(
            3, dtype=s.dtype, device=s.device) \
            - 2.0 * nut.data[:, None, None] * s
        data = R[:, (0, 0, 0, 1, 1, 2), (0, 1, 2, 1, 2, 2)]
        _write_derived(self.case, "R",
                       _cell_field(U, data, mesh, U.dims * U.dims, "R"))


@register("functionObject", "scalarTransport")
class ScalarTransport(FunctionObject):
    """A passive scalar solved each step (reference: postProcessing/
    utilities/scalarTransport): ddt(s) + div(phi, s) - laplacian(D, s) =
    0, D the `D` entry or nuEff, upwind convection, Euler in time."""

    def __init__(self, name, d, case):
        super().__init__(name, d, case)
        self.field_name = d.word("field", "s")
        self.s = case.read_field(self.field_name) \
            if case.field_exists(self.field_name) else None
        self.d_coeff = float(d.scalar("D", -1.0))
        from ..linalg.solvers import SolverControls
        try:
            self.controls = case.solver_controls(self.field_name)
        except KeyError:
            self.controls = SolverControls(solver="smoothSolver",
                                           tolerance=1e-8)

    def execute(self, time, fields, mesh):
        if self.s is None or "phi" not in fields:
            return
        from ..fields.field import Dimensioned
        from ..linalg.solvers import solve
        from ..ops import fvc, fvm
        phi, nu_eff = fields["phi"], fields.get("nuEff")
        dt = self.case.time.delta_t
        nu_dims = DimensionSet.of(0, 2, -1)
        if self.d_coeff >= 0.0:
            D = Dimensioned("D", nu_dims, self.d_coeff)
        elif nu_eff is None:
            D = Dimensioned("D", nu_dims, torch.zeros(
                mesh.n_faces, dtype=mesh.dtype, device=mesh.device))
        elif hasattr(nu_eff, "bvalues"):
            D = Dimensioned("D", nu_dims, fvc.face_values(mesh, nu_eff))
        else:
            D = Dimensioned("D", nu_dims,
                            float(getattr(nu_eff, "value", nu_eff)))
        s = fvm.store_old(mesh, self.s, dt, "Euler")
        eqn = (fvm.ddt(mesh, s, dt) + fvm.div(mesh, phi, s, "upwind")
               - fvm.laplacian(mesh, D, s))
        self.s, _ = solve(mesh, eqn, self.controls, env={"phi": phi})
        if self.case.time.write_time():
            self.case.write_fields([self.s], mark=False)


@register("functionObject", "blendingFactor")
class BlendingFactor(FunctionObject):
    """The cell average of the owner weights of the field's div scheme,
    written at write times (reference: postProcessing/utilities/
    blendingFactor)."""

    def __init__(self, name, d, case):
        super().__init__(name, d, case)
        self.field_name = d.word("field", "U")

    def execute(self, time, fields, mesh):
        if self.field_name not in fields or "phi" not in fields \
                or not self.case.time.write_time():
            return
        from ..ops import fvc
        from ..ops.interpolation import scheme_weights
        vf, phi = fields[self.field_name], fields["phi"]
        try:
            scheme = self.case.div_scheme(f"div(phi,{self.field_name})")
        except KeyError:
            return
        w = scheme_weights(mesh, vf, scheme, phi)
        face = torch.cat([w, torch.ones(mesh.n_boundary, dtype=w.dtype,
                                        device=w.device)])
        ones = torch.ones_like(face)
        if mesh.gdia is not None:
            ones[:mesh.n_internal] = _real_internal(mesh).to(w.dtype)
        cell = fvc.surface_sum_faces(mesh, face * ones, signed=False) \
            / fvc.surface_sum_faces(mesh, ones, signed=False)
        like = vf if vf.data.dim() == 1 else fields.get("p", vf)
        name = f"blendingFactor({self.field_name})"
        _write_derived(self.case, name,
                       _cell_field(like, cell, mesh, DimensionSet(), name))


# ---------------------------------------------------------------------------
# job control and field bookkeeping
# ---------------------------------------------------------------------------

@register("functionObject", "systemCall")
class SystemCall(FunctionObject):
    """Shell commands (reference: postProcessing/systemCall): executeCalls
    every step, writeCalls at write times."""

    def execute(self, time, fields, mesh):
        import subprocess
        calls = list(self.dict.lookup("executeCalls") or [])
        if self.case.time.write_time():
            calls += list(self.dict.lookup("writeCalls") or [])
        for c in calls:
            subprocess.run(str(c), shell=True, check=False)


@register("functionObject", "abortCalculation", "abort")
class AbortCalculation(FunctionObject):
    """End the run at the current time when the trigger file appears
    (reference: postProcessing/jobControl/abortCalculation)."""

    def execute(self, time, fields, mesh):
        fname = self.dict.word("file", os.path.join(self.case.dir, "ABORT"))
        if os.path.isfile(fname):
            info(f"abortCalculation: triggered by {fname}")
            self.case.time.end_time = self.case.time.value


@register("functionObject", "writeRegisteredObject")
class WriteRegisteredObject(FunctionObject):
    """Write the named fields at write times (reference: postProcessing/
    jobControl/writeRegisteredObject)."""

    def execute(self, time, fields, mesh):
        if not self.case.time.write_time():
            return
        for n in [str(x) for x in (self.dict.lookup("objects") or [])]:
            f = fields.get(n)
            if f is not None and hasattr(f, "bvalues"):
                self.case.write_fields([f.replace(name=n)], mark=False)


def _pairs(d: Dictionary):
    return [(str(a), str(b)) for a, b in
            (item for item in (d.lookup("fields") or [])
             if isinstance(item, (list, tuple)) and len(item) == 2)]


@register("functionObject", "nearWallFields")
class NearWallFields(FunctionObject):
    """A field sampled at `distance` inside each wall face (the live cell
    nearest to Cf - d n), min, max and mean of its magnitude per wall
    patch at write times (reference: postProcessing/field/
    nearWallFields; fields ((U UNear)))."""

    def __init__(self, name, d, case):
        super().__init__(name, d, case)
        self.pairs = _pairs(d)
        self.distance = float(d.scalar("distance", 0.0))
        self._idx = None

    def _build(self, mesh):
        idx = {}
        for p in _wall_patches(mesh):
            act = _active(mesh, p)
            cf = mesh.Cf[p.start:p.start + p.size][act]
            pts = cf - self.distance * mesh.patch_normals(p)[act]
            idx[p.name] = _rows(self.case, _nearest_cells(
                self.case, pts.detach().cpu().numpy().astype(np.float64)))
        return idx

    def execute(self, time, fields, mesh):
        if not self.pairs or not self.case.time.write_time():
            return
        if self._idx is None:
            self._idx = self._build(mesh)
        f = self.file("nearWallFields.dat",
                      header="# Time patch field min max avg\n")
        for src, dst in self.pairs:
            vf = fields.get(src)
            if vf is None:
                continue
            for pname, rows in self._idx.items():
                mag = _mag(vf.data.index_select(0, rows))
                mn, mx, av = torch.stack([mag.min(), mag.max(),
                                          mag.mean()]).tolist()
                f.write(f"{time:.8g} {pname} {dst} {mn:.8g} {mx:.8g} "
                        f"{av:.8g}\n")
        f.flush()


@register("functionObject", "readFields")
class ReadFields(FunctionObject):
    """Read the named fields of the current time directory into the hooks'
    fields (reference: postProcessing/field/readFields)."""

    def execute(self, time, fields, mesh):
        for n in [str(x) for x in (self.dict.lookup("fields") or [])]:
            if n not in fields and self.case.field_exists(n):
                fields[n] = self.case.read_field(n)


@register("functionObject", "surfaceInterpolateFields")
class SurfaceInterpolateFields(FunctionObject):
    """Linear face values of the named fields, min and max of their
    magnitude over the real faces (reference: postProcessing/field/
    surfaceInterpolateFields; fields ((p pf)))."""

    def execute(self, time, fields, mesh):
        from ..ops import fvc
        pairs = _pairs(self.dict)
        if not pairs:
            return
        f = self.file("surfaceInterpolateFields.dat",
                      header="# Time field min max\n")
        real = mesh.mag_sf > 0
        for src, dst in pairs:
            vf = fields.get(src)
            if vf is None or not hasattr(vf, "bvalues"):
                continue
            mag = _mag(fvc.face_values(mesh, vf))[real]
            mn, mx = torch.stack([mag.min(), mag.max()]).tolist()
            f.write(f"{time:.8g} {dst} {mn:.8g} {mx:.8g}\n")
        f.flush()


class FunctionObjectList:
    """The hooks of controlDict.functions, executed after each step
    (reference: functionObjectList::execute from Time::run)."""

    def __init__(self, case):
        self.case = case
        self.objects = []
        funcs = case.control_dict.subdict("functions", required=False)
        for name, d in (funcs or Dictionary()).items():
            if not isinstance(d, Dictionary):
                continue
            if not d.boolean("enabled", True):
                continue
            typ = d.word("type")
            if typ in NOT_PORTED:
                raise NotImplementedError(
                    f"functionObject '{name}': type '{typ}' is not ported "
                    f"(it needs {NOT_PORTED[typ]})")
            try:
                cls = lookup("functionObject", typ)
            except KeyError:
                info(f"functionObjects: unknown type '{typ}' for '{name}' "
                     "— skipped")
                continue
            self.objects.append(cls(str(name), d, case))

    def execute(self, fields: dict):
        t = self.case.time.value
        for obj in self.objects:
            obj.execute(t, fields, self.case.mesh)

    def close(self):
        for obj in self.objects:
            obj.close()
