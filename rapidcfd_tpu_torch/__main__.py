"""Solver dispatcher: `python -m rapidcfd_tpu_torch [solver] -case DIR
[-precision fp32|fp64] [-device cuda|cpu] [-gdiaBox]`.

Without an explicit solver name, reads `application` from
system/controlDict (the reference's convention). The device defaults to
cuda and is never swapped for another: without a card, `-device cuda`
raises. `-gdiaBox` routes a mesh that is a full box lattice (no blanked
cell) onto the gdia layout and its shift-MAC kernel; without it a full
box takes the padded ELL, as the JAX package's structured-box layout,
which takes such meshes there, is not ported.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys

#: ported solvers: name -> (module with run(case_dir, *, device, dtype,
#: write, ...), extra keyword arguments of run; "_fn" names the module's
#: function when it is not `run`). The porous mains are their base
#: solvers: the porosity is an explicitPorositySource in system/fvOptions
#: (the JAX dispatcher maps them so); interFoam and rhoSimpleFoam refuse
#: an fvOptions entry, as the JAX package applies none there.
SOLVERS = {
    "icoFoam": ("rapidcfd_tpu_torch.solvers.icofoam", {}),
    "nonNewtonianIcoFoam": ("rapidcfd_tpu_torch.solvers.icofoam",
                            {"non_newtonian": True}),
    "simpleFoam": ("rapidcfd_tpu_torch.solvers.simplefoam", {}),
    "porousSimpleFoam": ("rapidcfd_tpu_torch.solvers.simplefoam", {}),
    "porousInterFoam": ("rapidcfd_tpu_torch.solvers.interfoam", {}),
    "rhoPorousSimpleFoam": ("rapidcfd_tpu_torch.solvers.rhosimplefoam", {}),
    "pimpleFoam": ("rapidcfd_tpu_torch.solvers.pimplefoam", {}),
    "pisoFoam": ("rapidcfd_tpu_torch.solvers.pimplefoam",
                 {"piso_mode": True}),
    "sonicFoam": ("rapidcfd_tpu_torch.solvers.sonicfoam", {}),
    "rhoSimpleFoam": ("rapidcfd_tpu_torch.solvers.rhosimplefoam", {}),
    "rhoSimplecFoam": ("rapidcfd_tpu_torch.solvers.rhosimplefoam",
                       {"consistent": True}),
    "rhoPimpleFoam": ("rapidcfd_tpu_torch.solvers.rhopimplefoam", {}),
    "rhoPimplecFoam": ("rapidcfd_tpu_torch.solvers.rhopimplefoam",
                       {"consistent": True}),
    "rhoLTSPimpleFoam": ("rapidcfd_tpu_torch.solvers.rhopimplefoam",
                         {"lts": True}),
    "rhoCentralFoam": ("rapidcfd_tpu_torch.solvers.rhocentralfoam", {}),
    "buoyantBoussinesqSimpleFoam": ("rapidcfd_tpu_torch.solvers.buoyantfoam",
                                    {}),
    "buoyantBoussinesqPimpleFoam": ("rapidcfd_tpu_torch.solvers.buoyantfoam",
                                    {"transient": True}),
    "buoyantSimpleFoam": ("rapidcfd_tpu_torch.solvers.buoyantsimplefoam",
                          {}),
    "buoyantPimpleFoam": ("rapidcfd_tpu_torch.solvers.buoyantpimplefoam",
                          {}),
    "thermoFoam": ("rapidcfd_tpu_torch.solvers.thermofoam", {}),
    "interFoam": ("rapidcfd_tpu_torch.solvers.interfoam", {}),
    "LTSInterFoam": ("rapidcfd_tpu_torch.solvers.interfoam", {"lts": True}),
    "twoLiquidMixingFoam": ("rapidcfd_tpu_torch.solvers.interfoam",
                            {"mixing": True}),
    "interMixingFoam": ("rapidcfd_tpu_torch.solvers.intermixingfoam", {}),
    "interPhaseChangeFoam": ("rapidcfd_tpu_torch.solvers."
                             "interphasechangefoam", {}),
    "multiphaseInterFoam": ("rapidcfd_tpu_torch.solvers."
                            "multiphaseinterfoam", {}),
    "driftFluxFoam": ("rapidcfd_tpu_torch.solvers.driftfluxfoam", {}),
    "potentialFreeSurfaceFoam": ("rapidcfd_tpu_torch.solvers."
                                 "potentialfreesurfacefoam", {}),
    "cavitatingFoam": ("rapidcfd_tpu_torch.solvers.cavitatingfoam", {}),
    "laplacianFoam": ("rapidcfd_tpu_torch.solvers.basic",
                      {"_fn": "run_laplacian_foam"}),
    "scalarTransportFoam": ("rapidcfd_tpu_torch.solvers.basic",
                            {"_fn": "run_scalar_transport_foam"}),
    "potentialFoam": ("rapidcfd_tpu_torch.solvers.basic",
                      {"_fn": "run_potential_foam"}),
    "SRFSimpleFoam": ("rapidcfd_tpu_torch.solvers.srffoam", {}),
    "SRFPimpleFoam": ("rapidcfd_tpu_torch.solvers.srffoam",
                      {"_fn": "run_pimple"}),
}


def main(argv=None):
    from .utils.dictionary import parse_file

    from . import resolve_device, solver_dtype
    ap = argparse.ArgumentParser(prog="rapidcfd_tpu_torch")
    ap.add_argument("solver", nargs="?", default=None,
                    help="solver name (default: controlDict application)")
    ap.add_argument("-case", dest="case", default=".")
    ap.add_argument("-noWrite", action="store_true")
    ap.add_argument("-precision", choices=["fp32", "fp64"], default=None,
                    help="override the solver's default float width")
    ap.add_argument("-device", default="cuda",
                    help="torch device to run on (cuda or cpu)")
    ap.add_argument("-gdiaBox", action="store_true",
                    help="route a full box lattice onto the gdia layout")
    args = ap.parse_args(argv)

    name = args.solver
    if name is None:
        cd = parse_file(os.path.join(args.case, "system", "controlDict"))
        name = cd.word("application")
    if name not in SOLVERS:
        sys.exit(f"solver '{name}' is not ported. Available: "
                 f"{', '.join(sorted(SOLVERS))}")
    device = resolve_device(args.device)
    dtype = solver_dtype(name, args.precision)
    module, kwargs = SOLVERS[name]
    kwargs = dict(kwargs)
    run = getattr(importlib.import_module(module), kwargs.pop("_fn", "run"))
    if args.gdiaBox:
        from .solvers.case import Case
        kwargs = dict(kwargs, case=Case(args.case, device=device,
                                        dtype=dtype, gdia_box=True))
    run(args.case, device=device, dtype=dtype, write=not args.noWrite,
        **kwargs)


if __name__ == "__main__":
    main()
