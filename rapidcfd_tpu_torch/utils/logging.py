"""OpenFOAM-format solver log of the port: the JAX package's jax-free
logger (rapidcfd_tpu/utils/logging.py) re-exported, so that the port's
modules and its callers reach it through one place, plus `captured`."""

from __future__ import annotations

import contextlib
import io

from rapidcfd_tpu.utils.logging import (ExecutionTimer, Info, info,  # noqa: F401
                                        log_continuity, log_courant,
                                        log_solve)


@contextlib.contextmanager
def captured():
    """Send the solver log to a StringIO for the duration of the block;
    yields the StringIO."""
    buf = io.StringIO()
    old = Info.stream
    Info.stream = buf
    try:
        yield buf
    finally:
        Info.stream = old
