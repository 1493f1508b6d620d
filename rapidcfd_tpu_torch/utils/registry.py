"""Runtime-selection registry (port of rapidcfd_tpu/utils/registry.py).

Python equivalent of the reference's runTimeSelectionTables macro system
(reference: src/OpenFOAM/db/runTimeSelection/construction/
runTimeSelectionTables.H): a table per extension point mapping dictionary
words to factories, so model names in case files select implementations.
"""

from __future__ import annotations

from collections import defaultdict

_TABLES: dict[str, dict[str, object]] = defaultdict(dict)


def register(table: str, *names: str):
    """Decorator: register a factory under one or more selection words."""
    def deco(obj):
        for name in names:
            _TABLES[table][name] = obj
        return obj
    return deco


def lookup(table: str, name: str):
    tbl = _TABLES.get(table, {})
    if name not in tbl:
        known = ", ".join(sorted(tbl)) or "<empty>"
        raise KeyError(
            f"Unknown {table} '{name}'.\nValid {table} entries: {known}")
    return tbl[name]


def registered_names(table: str):
    return sorted(_TABLES.get(table, {}))
