"""Solution controls: the SIMPLE outer-iteration driver (port of
rapidcfd_tpu/solvers/controls.py:18-73; reference: cfdTools/general/
solutionControl/simpleControl.H:47).

Corrector counts and the pressure reference come from fvSolution;
residualControl ends the run once every initial residual it names is
below its target. PisoControl and PimpleControl (JAX :76-95; reference:
pimpleControl.H:47) carry pisoFoam's and pimpleFoam's corrector counts;
icoFoam reads its PISO dictionary directly.
"""

from __future__ import annotations

import re

from ..utils.dictionary import Dictionary
from ..utils.logging import info


class SolutionControl:
    dict_name = "SIMPLE"

    def __init__(self, case):
        self.case = case
        self.dict = case.algo_dict(self.dict_name) or Dictionary()
        self.n_non_orth = int(self.dict.scalar(
            "nNonOrthogonalCorrectors", 0))
        self.momentum_predictor = self.dict.boolean(
            "momentumPredictor", True)
        self.p_ref_cell = int(self.dict.scalar("pRefCell", 0))
        self.p_ref_value = float(self.dict.scalar("pRefValue", 0.0))
        self._residual_targets = self._read_residual_control()

    def _read_residual_control(self) -> dict:
        rc = self.dict.subdict("residualControl", required=False)
        out = {}
        if rc:
            for key, val in rc.items():
                if isinstance(val, Dictionary):     # PIMPLE form
                    out[str(key)] = float(val.scalar("tolerance", 0.0))
                else:
                    out[str(key)] = float(val)
        return out

    def criteria_satisfied(self, initial_residuals: dict) -> bool:
        """initial_residuals: field -> initial residual this iteration.
        Keys of residualControl are field names or regular expressions
        such as "(k|epsilon)"."""
        if not self._residual_targets:
            return False
        checked = False
        for pattern, target in self._residual_targets.items():
            for field, res in initial_residuals.items():
                if re.fullmatch(pattern, field) or pattern == field:
                    checked = True
                    if res > target:
                        return False
        return checked


class SimpleControl(SolutionControl):
    """simpleControl::loop: steady iterations until the residualControl
    targets are met or endTime is reached."""
    dict_name = "SIMPLE"

    def loop(self, initial_residuals: dict | None = None) -> bool:
        if initial_residuals and self.criteria_satisfied(initial_residuals):
            info("\nSIMPLE solution converged in "
                 f"{self.case.time.name} iterations\n")
            return False
        return self.case.time.loop()


class PisoControl(SolutionControl):
    dict_name = "PISO"

    def __init__(self, case):
        super().__init__(case)
        self.n_correctors = int(self.dict.scalar("nCorrectors", 1))


class PimpleControl(SolutionControl):
    """nOuterCorrectors outer loops of nCorrectors PISO corrections; the
    solver switches to the Final solver controls on the last one."""
    dict_name = "PIMPLE"

    def __init__(self, case):
        super().__init__(case)
        self.n_outer = int(self.dict.scalar("nOuterCorrectors", 1))
        self.n_correctors = int(self.dict.scalar("nCorrectors", 1))
        self.turb_on_final_only = self.dict.boolean(
            "turbOnFinalIterOnly", True)
