"""OpenFOAM-format solver logging (the port's copy of rapidcfd_tpu/utils/
logging.py, plus `captured`).

Preserves the reference's "the log is the metrics bus" contract
(SURVEY.md §5.5): residual lines in the exact textual shape foamLog-style
tooling scrapes, Info on rank 0 only.
"""

from __future__ import annotations

import contextlib
import io
import sys
import time as _time


class Info:
    """Master-only message stream (reference: messageStream.H `Info`)."""

    enabled = True
    stream = sys.stdout

    @classmethod
    def __call__(cls, *args):  # pragma: no cover
        cls.write(*args)

    @classmethod
    def write(cls, *args):
        if cls.enabled:
            print(*args, file=cls.stream)


def info(*args):
    Info.write(*args)


def log_solve(solver_name: str, field_name: str, initial_residual: float,
              final_residual: float, n_iterations: int):
    """Exact shape of lduMatrix solver performance print."""
    info(f"{solver_name}:  Solving for {field_name}, "
         f"Initial residual = {float(initial_residual):.12g}, "
         f"Final residual = {float(final_residual):.12g}, "
         f"No Iterations {int(n_iterations)}")


def log_continuity(cumulative, local, global_):
    info(f"time step continuity errors : sum local = {float(local):.12g}"
         f", global = {float(global_):.12g}"
         f", cumulative = {float(cumulative):.12g}")


def log_courant(co_mean, co_max):
    info(f"Courant Number mean: {float(co_mean):.12g} "
         f"max: {float(co_max):.12g}")


class ExecutionTimer:
    def __init__(self):
        self._t0 = _time.perf_counter()
        self._cpu0 = _time.process_time()

    def log(self):
        info(f"ExecutionTime = {_time.process_time() - self._cpu0:.2f} s"
             f"  ClockTime = {_time.perf_counter() - self._t0:.0f} s\n")


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
