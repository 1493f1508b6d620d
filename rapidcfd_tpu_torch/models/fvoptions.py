"""fvOptions (port of rapidcfd_tpu/models/fvoptions.py:191-233, the
fv::IOoptionList; reference: fvIOoptionList.H:53).

No option type is ported yet: without system/fvOptions the list is the
identity on every equation, and a file with any option entry raises."""

from __future__ import annotations

import os

from ..utils.dictionary import Dictionary, parse_file


class FvOptions:
    def __init__(self, case):
        self.options = []
        path = os.path.join(case.dir, "system", "fvOptions")
        if not os.path.isfile(path):
            return
        for name, sub in parse_file(path).items():
            if isinstance(sub, Dictionary):
                raise NotImplementedError(
                    f"fvOptions entry '{name}' of type "
                    f"'{sub.word('type', '?')}' is not ported yet (no "
                    "fvOption type is ported)")

    def __call__(self, mesh, field_name: str, eqn, env=None):
        """addSup of every applicable option (none)."""
        return eqn

    def constrain(self, mesh, field_name: str, eqn, env=None):
        return eqn
