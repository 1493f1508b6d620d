"""Transport models (port of rapidcfd_tpu/models/transport.py:31-39 and
:132-144; reference: singlePhaseTransportModel.H:56).

Only the Newtonian viscosity model is ported; any other transportModel
word raises."""

from __future__ import annotations

from ..fields.field import Dimensioned
from ..utils.dictionary import Dictionary


class Newtonian:
    def __init__(self, d: Dictionary):
        self.nu0 = Dimensioned.from_entry(d.lookup("nu", required=True),
                                          "nu")

    def nu(self, mesh, U):
        return self.nu0


VISCOSITY_MODELS = {"Newtonian": Newtonian}


class SinglePhaseTransportModel:
    """The runtime-selected viscosity model, providing nu()."""

    def __init__(self, props: Dictionary):
        name = props.word("transportModel", "Newtonian")
        cls = VISCOSITY_MODELS.get(name)
        if cls is None:
            raise NotImplementedError(
                f"transportModel '{name}' is not ported yet (ported: "
                f"{', '.join(sorted(VISCOSITY_MODELS))})")
        self.model = cls(props)

    def nu(self, mesh, U):
        return self.model.nu(mesh, U)
