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
import time

import torch

from ..fields.io import read_vol_field, write_vol_field
from ..linalg.solvers import SolverControls
from ..mesh.mesharrays import build_gdia_mesh_arrays, build_mesh_arrays
from ..mesh.polymesh import read_polymesh
from ..utils.dictionary import Dictionary, parse_file
from ..utils.logging import info
from ..utils.timecontrol import Time
from ..utils.unstructured import detect_lattice


class Case:
    def __init__(self, case_dir: str, *, device: torch.device,
                 dtype: torch.dtype, pmesh=None, lattice: dict | None = None,
                 gdia_auto: bool = True):
        """pmesh injects an in-memory PolyMesh (large benches skip the
        ascii mesh round-trip); lattice (the embedding that
        utils.unstructured fills through lattice_out) routes the mesh to
        the gdia mode; without one, a masked-lattice mesh is detected
        unless gdia_auto=False (the JAX package's RCFD_GDIA_AUTO=0), which
        sends it to the ELL path too."""
        self.dir = case_dir
        self.device = device
        self.dtype = dtype
        self.time = Time(case_dir)
        #: host seconds of the set-up stages (mesh read and build; the
        #: GAMG hierarchy and the wall distance are added by the solver's
        #: make_step and the turbulence model)
        self.setup_seconds: dict[str, float] = {}
        info(f"Create time\n\nCreate mesh for time = {self.time.name}\n")
        if pmesh is None:
            t0 = time.perf_counter()
            pmesh = read_polymesh(case_dir)
            self.setup_seconds["read"] = time.perf_counter() - t0
        if lattice is None and gdia_auto:
            t0 = time.perf_counter()
            lattice = detect_lattice(pmesh)
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
            self.mesh, self.pmesh, self.maps = build_mesh_arrays(
                pmesh, device=device, dtype=dtype,
                timings=self.setup_seconds)
        self.fv_schemes = parse_file(
            os.path.join(case_dir, "system", "fvSchemes"))
        self.fv_solution = parse_file(
            os.path.join(case_dir, "system", "fvSolution"))
        self.control_dict = self.time.control
        #: wall time of each solver step (host clock), filled by run()
        self.step_seconds: list[float] = []

    # -- fields ---------------------------------------------------------------
    def read_field(self, name: str):
        return read_vol_field(self.dir, self.time.name, name, self.mesh,
                              self.maps)

    def field_exists(self, name: str) -> bool:
        return os.path.isfile(os.path.join(self.dir, self.time.name, name))

    def write_fields(self, fields):
        t = self.time.name
        if self.control_dict.word("writeFormat", "ascii") != "ascii":
            raise NotImplementedError("the port writes ascii fields only")
        prec = int(self.control_dict.scalar("writePrecision", 8))
        for f in fields:
            write_vol_field(f, self.dir, t, self.mesh, self.maps, prec=prec)
        os.makedirs(os.path.join(self.dir, t, "uniform"), exist_ok=True)
        with open(os.path.join(self.dir, t, "uniform", "time"), "w") as fh:
            fh.write(self.time.uniform_time_dict())
        self.time.mark_written()

    # -- constant/ dictionaries --------------------------------------------------
    def transport_properties(self) -> Dictionary:
        return parse_file(os.path.join(self.dir, "constant",
                                       "transportProperties"))

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
