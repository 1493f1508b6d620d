"""Case — the fvMesh/Time/dictionaries bundle a solver runs on (port of
rapidcfd_tpu/solvers/case.py).

Loads the polyMesh once, routes a masked-lattice mesh onto the gdia mode
(the only mesh layout this slice ports; other meshes raise), resolves
scheme words and per-field solver controls, and reads/writes fields in
case format. The device and the float width are explicit arguments.
"""

from __future__ import annotations

import os

import torch

from rapidcfd_tpu.utils.dictionary import Dictionary, parse_file
from rapidcfd_tpu.utils.timecontrol import Time

from ..fields.io import read_vol_field, write_vol_field
from ..linalg.solvers import SolverControls
from ..mesh.mesharrays import build_gdia_mesh_arrays
from ..mesh.polymesh import read_polymesh
from ..utils.logging import info
from ..utils.unstructured import detect_lattice


class Case:
    def __init__(self, case_dir: str, *, device: torch.device,
                 dtype: torch.dtype):
        self.dir = case_dir
        self.device = device
        self.dtype = dtype
        self.time = Time(case_dir)
        info(f"Create time\n\nCreate mesh for time = {self.time.name}\n")
        pmesh = read_polymesh(case_dir)
        lattice = detect_lattice(pmesh)
        if lattice is None:
            raise NotImplementedError(
                f"{case_dir}: the mesh is not a masked lattice; the port "
                "runs only the gdia lattice mode so far (the padded-ELL "
                "path for general meshes is not ported yet)")
        nz_, ny_, nx_ = lattice["shape"]
        info(f"gdia: lattice {nx_}x{ny_}x{nz_} detected "
             f"({int(lattice['dead'].sum())} dead slots)\n")
        self.mesh, self.pmesh, self.maps = build_gdia_mesh_arrays(
            pmesh, lattice, device=device, dtype=dtype)
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
