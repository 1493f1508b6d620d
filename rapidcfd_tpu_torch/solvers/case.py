"""Case — the fvMesh/Time/dictionaries bundle a solver runs on (port of
rapidcfd_tpu/solvers/case.py).

Loads the polyMesh once (or takes one in memory), routes a masked-lattice
mesh onto the gdia mode and every other mesh onto the renumbered
padded-ELL layout, resolves scheme words and per-field solver controls,
and reads/writes fields in case format. The device and the float width
are explicit arguments.
"""

from __future__ import annotations

import os
import re
import time

import torch

from ..fields.io import read_vol_field, write_vol_field
from ..linalg.solvers import SolverControls
from ..mesh.mesharrays import (build_gdia_mesh_arrays, build_mesh_arrays,
                               coupled_patch_names)
from ..mesh.polymesh import read_polymesh
from ..ops.fvm import old_levels
from ..utils import foambin
from ..utils.dictionary import (Dictionary, ParseError, parse_dictionary,
                                parse_file)
from ..utils.logging import info
from ..utils.timecontrol import Time
from ..utils.unstructured import detect_lattice

#: patch-field types that keep their cyclic pair a coupled interface
#: instead of merging it (the reference's jumpCyclic family with
#: `patchType cyclic`)
_JUMP_BC_TYPES = ("fan", "fixedJump", "uniformJump")


def _boundary_field(path: str) -> Dictionary | None:
    """A field file's boundaryField dictionary. The text from the
    `boundaryField` keyword on is parsed alone, so an ascii internalField
    is not tokenised (a binary one is cut out by the decoder); where that
    part does not parse alone (a macro or #include defined above it), the
    whole file is parsed."""
    raw = foambin.read_raw(path)
    if foambin.is_binary(raw):
        text, _ = foambin.decode_binary_dict(raw)
    else:
        text = raw.decode("latin-1")
    m = re.search(r"^\s*boundaryField\b", text, re.M)
    if m is not None:
        case_dir = os.path.dirname(os.path.dirname(os.path.abspath(path)))
        try:
            return parse_dictionary(text[m.start():], path=path,
                                    include_dirs=(case_dir,)
                                    ).subdict("boundaryField")
        except ParseError:
            pass
    return parse_file(path).subdict("boundaryField")


def scan_jump_patches(pmesh, case_dir: str, time_name: str) -> tuple:
    """The cyclic patches that carry a jump-family BC in a field of the
    start time (rapidcfd_tpu/solvers/case.py:29-53): those pairs stay
    coupled patches, since fan curves and jumps live on the interface a
    merge would erase. A file that does not parse is logged by name and
    skipped."""
    cyc = {p.name for p in pmesh.patches if p.type == "cyclic"}
    tdir = os.path.join(case_dir, time_name)
    if not cyc or not os.path.isdir(tdir):
        return ()
    names = set()
    for fn in sorted(os.listdir(tdir)):
        path = os.path.join(tdir, fn)
        if not os.path.isfile(path):
            continue
        try:
            bf = _boundary_field(path)
        except Exception as e:
            info(f"--> FOAM Warning : {path} was not read for jump "
                 f"boundary conditions on the cyclic patches: {e}\n")
            continue
        if not bf:
            continue
        for pname in cyc:
            pd = bf.lookup(pname)
            if isinstance(pd, Dictionary) \
                    and pd.word("type", "") in _JUMP_BC_TYPES:
                names.add(pname)
    return tuple(sorted(names))


class Case:
    def __init__(self, case_dir: str, *, device: torch.device,
                 dtype: torch.dtype, pmesh=None, lattice: dict | None = None,
                 gdia_auto: bool = True, gdia_box: bool = False):
        """pmesh injects an in-memory PolyMesh (large benches skip the
        ascii mesh round-trip); lattice (the embedding that
        utils.unstructured fills through lattice_out) routes the mesh to
        the gdia mode; without one, a masked-lattice mesh is detected
        unless gdia_auto=False (the JAX package's RCFD_GDIA_AUTO=0), which
        sends it to the ELL path too. A full box lattice (no dead slot)
        takes the ELL path too unless gdia_box=True, which routes it onto
        gdia (the JAX package sends full boxes to its structured-box
        layout, which is not ported). A mesh with coupled patches takes
        the ELL path: detection finds no lattice in it, and gdia_box or a
        given lattice raises, naming the patches. A cyclic pair with a
        jump BC in a start-time field stays coupled (scan_jump_patches);
        every other is merged."""
        self.dir = case_dir
        self.device = device
        self.dtype = dtype
        self.time = Time(case_dir)
        #: host seconds of the set-up stages (mesh read, the jump scan on
        #: a mesh with coupled patches, and the build; the GAMG hierarchy
        #: and the wall distance are added by the solver's make_step and
        #: the turbulence model)
        self.setup_seconds: dict[str, float] = {}
        info(f"Create time\n\nCreate mesh for time = {self.time.name}\n")
        if pmesh is None:
            t0 = time.perf_counter()
            pmesh = read_polymesh(case_dir)
            self.setup_seconds["read"] = time.perf_counter() - t0
        coupled = coupled_patch_names(pmesh)
        if coupled and (gdia_box or lattice is not None):
            raise ValueError(
                f"coupled patches {coupled} cannot take the gdia layout "
                "(-gdiaBox): a coupled mesh runs on the ELL layout")
        if lattice is None and gdia_auto:
            t0 = time.perf_counter()
            lattice = detect_lattice(pmesh, full_box=gdia_box)
            self.setup_seconds["detect_lattice"] = time.perf_counter() - t0
            if lattice is not None:
                nz_, ny_, nx_ = lattice["shape"]
                info(f"gdia: lattice {nx_}x{ny_}x{nz_} detected "
                     f"({int(lattice['dead'].sum())} dead slots)\n")
        if lattice is not None:
            t0 = time.perf_counter()
            self.mesh, self.pmesh, self.maps = build_gdia_mesh_arrays(
                pmesh, lattice, device=device, dtype=dtype)
            self.setup_seconds["gdia"] = time.perf_counter() - t0
        else:
            t0 = time.perf_counter()
            keep = scan_jump_patches(pmesh, case_dir, self.time.name)
            if coupled:
                self.setup_seconds["scan"] = time.perf_counter() - t0
            self.mesh, self.pmesh, self.maps = build_mesh_arrays(
                pmesh, device=device, dtype=dtype,
                timings=self.setup_seconds, keep_cyclic=keep)
        self.fv_schemes = parse_file(
            os.path.join(case_dir, "system", "fvSchemes"))
        self.fv_solution = parse_file(
            os.path.join(case_dir, "system", "fvSolution"))
        self.control_dict = self.time.control
        #: wall time of each solver step (host clock), filled by run()
        self.step_seconds: list[float] = []

    # -- fields ---------------------------------------------------------------
    def read_field(self, name: str, time: str | None = None):
        """A field of the current time directory (or of `time`)."""
        return read_vol_field(self.dir, time or self.time.name, name,
                              self.mesh, self.maps)

    def field_exists(self, name: str, time: str | None = None) -> bool:
        """The field's file (or its gzipped form) in the current time
        directory (or in `time`)."""
        path = os.path.join(self.dir, time or self.time.name, name)
        return os.path.isfile(path) or os.path.isfile(path + ".gz")

    def write_format(self) -> tuple[str, bool]:
        """controlDict's (writeFormat, writeCompression on)
        (rapidcfd_tpu/solvers/case.py:126)."""
        return (self.control_dict.word("writeFormat", "ascii"),
                self.control_dict.word("writeCompression", "uncompressed")
                in ("compressed", "on", "yes", "true"))

    def write_fields(self, fields, mark: bool = True):
        """Write the fields into the current time directory in the
        controlDict's writeFormat and writeCompression. mark=False (a
        function object's derived fields) leaves the write-control state
        alone, so that the step's own write still happens."""
        t = self.time.name
        fmt, compress = self.write_format()
        prec = int(self.control_dict.scalar("writePrecision", 8))
        for f in fields:
            write_vol_field(f, self.dir, t, self.mesh, self.maps, prec=prec,
                            fmt=fmt, compress=compress)
        os.makedirs(os.path.join(self.dir, t, "uniform"), exist_ok=True)
        with open(os.path.join(self.dir, t, "uniform", "time"), "w") as fh:
            fh.write(self.time.uniform_time_dict())
        if mark:
            self.time.mark_written()

    # -- constant/ dictionaries --------------------------------------------------
    def transport_properties(self) -> Dictionary:
        return self.constant_dict("transportProperties")

    def constant_dict(self, name: str) -> Dictionary:
        return parse_file(os.path.join(self.dir, "constant", name))

    # -- fvSchemes resolution ------------------------------------------------------
    def ddt_scheme(self):
        """ddtSchemes.default: a word (Euler, steadyState, ...), or
        ('CrankNicolson', ocCoeff) for the off-centred form."""
        d = self.fv_schemes.subdict("ddtSchemes")
        s = d.lookup("default", "Euler")
        if isinstance(s, str):
            return s
        if s and s[0] in ("CrankNicolson", "CrankNicholson"):
            return ("CrankNicolson",
                    float(s[1]) if len(s) > 1 else 1.0)
        return s[0]

    def refuse_second_order_ddt(self, solver: str):
        """Raise when the case asks for backward or CrankNicolson: of the
        transient solvers only pimpleFoam, pisoFoam, laplacianFoam and
        scalarTransportFoam keep the two old levels those schemes read."""
        scheme = self.ddt_scheme()
        name = scheme[0] if isinstance(scheme, tuple) else scheme
        if old_levels(scheme) == 2:
            raise NotImplementedError(
                f"{solver}: ddtScheme '{name}' is not ported for this solver "
                "(Euler only; backward and CrankNicolson run in pimpleFoam, "
                "pisoFoam, laplacianFoam and scalarTransportFoam)")

    def div_scheme(self, key: str):
        """Resolve e.g. div(phi,U) -> interpolation scheme spec."""
        d = self.fv_schemes.subdict("divSchemes")
        s = d.lookup(key)
        if s is None:
            s = d.lookup("default")
        if s is None or s == "none":
            raise KeyError(f"divSchemes: no scheme for '{key}'")
        return self._gauss_spec(s, key)

    @staticmethod
    def _gauss_spec(s, key):
        if isinstance(s, str):
            return s
        items = list(s)
        bounded = False
        if items[0] == "bounded":
            bounded = True
            items = items[1:]
        if items and items[0] == "Gauss":
            items = items[1:]
        if not items:
            raise KeyError(f"divSchemes entry '{key}' has no "
                           f"interpolation scheme")
        spec = items[0] if len(items) == 1 else tuple(items)
        return ("bounded", spec) if bounded else spec

    def laplacian_scheme(self, key: str = "default") -> str:
        """The snGrad correction word: orthogonal/corrected/..."""
        d = self.fv_schemes.subdict("laplacianSchemes")
        s = d.lookup(key) or d.lookup("default")
        if isinstance(s, tuple):
            return str(s[-1])
        return "orthogonal"

    # -- fvSolution resolution ---------------------------------------------------
    def solver_controls(self, field: str, final: bool = False
                        ) -> SolverControls:
        solvers = self.fv_solution.subdict("solvers")
        d = solvers.lookup(field + "Final") if final else None
        if d is None:
            d = solvers.lookup(field)
        if d is None:
            raise KeyError(f"fvSolution.solvers: no entry for '{field}'")
        return SolverControls.from_dict(d)

    def algo_dict(self, name: str) -> Dictionary:
        return self.fv_solution.subdict(name, required=False)

    def relaxation_factor(self, name: str, what: str = "equations",
                          default: float = 0.0) -> float:
        """relaxationFactors.<what>.<name> (or its `default`, or the old
        flat form relaxationFactors.<name>), else `default`."""
        rf = self.fv_solution.subdict("relaxationFactors", required=False)
        if not rf:
            return default
        sub = rf.subdict(what, required=False)
        if sub:
            v = sub.lookup(name)
            if v is not None:
                return float(v)
            v = sub.lookup("default")
            if v is not None:
                return float(v)
        v = rf.lookup(name)
        return float(v) if v is not None else default
