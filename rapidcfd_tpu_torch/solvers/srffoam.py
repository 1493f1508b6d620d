"""SRFSimpleFoam / SRFPimpleFoam — incompressible solvers in a single
rotating frame (port of rapidcfd_tpu/solvers/srffoam.py; reference:
applications/solvers/incompressible/simpleFoam/SRFSimpleFoam/
SRFSimpleFoam.C and pimpleFoam/SRFPimpleFoam).

They solve for the relative velocity Urel: simpleFoam's and pimpleFoam's
runs with the case's SRFModel (`srf=`), which puts the frame's Coriolis
and centrifugal acceleration SRF->Su() on the momentum LHS, reads Urel's
fvSolution/fvSchemes entries and writes Uabs = Urel + the frame velocity
beside Urel. As in the JAX package no function objects run (a
`functions` entry is refused) and SRFPimpleFoam keeps the controlDict's
deltaT.
"""

from __future__ import annotations

import torch

from ..models.srf import SRFModel
from . import pimplefoam, simplefoam
from .case import Case


def run(case_dir: str, *, device: torch.device, dtype: torch.dtype,
        write: bool = True, max_steps: int | None = None,
        case: Case | None = None):
    """SRFSimpleFoam (reference: SRFSimpleFoam.C:36-100) until
    residualControl is met, endTime or max_steps. Returns (case, Urel, p,
    phi, turb_state); case.step_seconds and case.step_log as in
    simplefoam.run."""
    if case is None:
        case = Case(case_dir, device=device, dtype=dtype)
    return simplefoam.run(case_dir, device=device, dtype=dtype, write=write,
                          max_steps=max_steps, case=case,
                          srf=SRFModel(case))


def run_pimple(case_dir: str, *, device: torch.device, dtype: torch.dtype,
               write: bool = True, max_steps: int | None = None,
               case: Case | None = None):
    """SRFPimpleFoam (reference: pimpleFoam/SRFPimpleFoam, UrelEqn.H: ddt +
    div + divDevReff + SRF->Su()) at the controlDict's fixed deltaT until
    endTime or max_steps. Returns (case, Urel, p, phi, turb_state)."""
    if case is None:
        case = Case(case_dir, device=device, dtype=dtype)
    return pimplefoam.run(case_dir, device=device, dtype=dtype, write=write,
                          max_steps=max_steps, case=case,
                          srf=SRFModel(case))
