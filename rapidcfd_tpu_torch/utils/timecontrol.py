"""Simulation clock + run controller (the port's copy of
rapidcfd_tpu/utils/timecontrol.py).

Capability parity with the reference's Time class (reference:
src/OpenFOAM/db/Time/Time.H:69, Time.C:825-1024): reads system/controlDict,
drives the outer time loop, decides write times, supports restart from the
latest time directory and adjustable time stepping.
"""

from __future__ import annotations

import os
import re

from .dictionary import Dictionary, parse_file


def _time_dirs(case_dir: str) -> list[float]:
    out = []
    for name in os.listdir(case_dir):
        if re.fullmatch(r"-?\d+(\.\d+)?([eE][-+]?\d+)?", name) and \
                os.path.isdir(os.path.join(case_dir, name)):
            out.append(float(name))
    return sorted(out)


import weakref

_SIGNAL_CLOCKS: list = []      # weakrefs to live Time objects
_SIGNALS_INSTALLED = False


def _install_signal_handlers(clock: "Time"):
    """sigWriteNow/sigStopAtWriteNow (reference:
    src/OSspecific/POSIX/signals/sigWriteNow.C): SIGUSR1 checkpoints at
    the end of the current step and continues; SIGUSR2 checkpoints and
    stops cleanly. Handlers only set flags — the time loop does the IO —
    so they are async-signal-safe. Installed once per process, on the
    main thread only; every live Time instance responds, and a Python
    handler installed before (another package's Time in the same
    process) is called after them rather than replaced."""
    global _SIGNALS_INSTALLED
    _SIGNAL_CLOCKS.append(weakref.ref(clock))
    if _SIGNALS_INSTALLED:
        return
    import signal
    import threading
    if threading.current_thread() is not threading.main_thread():
        return

    def _fan_out(stop: bool):
        for ref in list(_SIGNAL_CLOCKS):
            t = ref()
            if t is None:
                _SIGNAL_CLOCKS.remove(ref)
                continue
            t._write_now = True
            if stop:
                t._stop_requested = True

    def chained(stop: bool, prev):
        def handle(signum, frame):
            _fan_out(stop)
            if callable(prev):
                prev(signum, frame)
        return handle

    try:
        signal.signal(signal.SIGUSR1, chained(
            False, signal.getsignal(signal.SIGUSR1)))
        signal.signal(signal.SIGUSR2, chained(
            True, signal.getsignal(signal.SIGUSR2)))
        _SIGNALS_INSTALLED = True
    except (ValueError, OSError):      # non-main thread / exotic host
        pass


def time_name(t: float) -> str:
    """Format a time value the way OpenFOAM names time directories."""
    if t == int(t) and abs(t) < 1e15:
        return str(int(t))
    return f"{t:.6g}"


#: the index of the Time last built or incremented (reference:
#: Time::timeIndex()); boundary conditions that update once per time step
#: (turbulentInlet) read it
_CURRENT_INDEX = 0


def current_time_index() -> int:
    return _CURRENT_INDEX


def _set_current_index(index: int) -> None:
    global _CURRENT_INDEX
    _CURRENT_INDEX = index


class Time:
    def __init__(self, case_dir: str, control_dict: Dictionary | None = None):
        self.case_dir = case_dir
        if control_dict is None:
            control_dict = parse_file(
                os.path.join(case_dir, "system", "controlDict"))
        self.control = control_dict
        c = control_dict

        self.start_time = c.scalar("startTime", 0.0)
        start_from = c.word("startFrom", "startTime")
        if start_from == "latestTime":
            dirs = _time_dirs(case_dir)
            if dirs:
                self.start_time = dirs[-1]
        elif start_from == "firstTime":
            dirs = _time_dirs(case_dir)
            if dirs:
                self.start_time = dirs[0]

        self.end_time = c.scalar("endTime")
        self.delta_t = c.scalar("deltaT")
        self.delta_t0 = self.delta_t
        self.write_control = c.word("writeControl", "timeStep")
        self.write_interval = c.scalar("writeInterval", 1.0)
        self.purge_write = int(c.scalar("purgeWrite", 0))
        self.adjust_time_step = c.boolean("adjustTimeStep", False)
        self.max_co = c.scalar("maxCo", 1.0) if c.lookup("maxCo") is not None else 1.0
        self.max_delta_t = (c.scalar("maxDeltaT", 1e30)
                            if c.lookup("maxDeltaT") is not None else 1e30)
        self.write_precision = int(c.scalar("writePrecision", 6))
        self.write_format = c.word("writeFormat", "ascii")

        # restore deltaT from <start>/uniform/time on restart
        tdir = os.path.join(case_dir, time_name(self.start_time),
                            "uniform", "time")
        self.time_index = 0
        if os.path.isfile(tdir):
            u = parse_file(tdir)
            self.delta_t = u.scalar("deltaT", self.delta_t)
            self.delta_t0 = u.scalar("deltaT0", self.delta_t)
            self.time_index = int(u.scalar("index", 0))
        _set_current_index(self.time_index)

        self.value = self.start_time
        self._stop_requested = False
        self._write_now = False
        self._written_times: list[str] = []
        self._steps_since_write = 0
        self.run_time_modifiable = c.boolean("runTimeModifiable", False)
        self._control_path = os.path.join(case_dir, "system",
                                          "controlDict")
        self._control_mtime = (os.path.getmtime(self._control_path)
                               if os.path.isfile(self._control_path)
                               else None)
        _install_signal_handlers(self)

    # -- loop protocol ------------------------------------------------------
    def run(self) -> bool:
        if self._stop_requested:
            return False
        return self.value < self.end_time - 0.5 * self.delta_t

    def loop(self) -> bool:
        if self.run_time_modifiable:
            self.re_read_if_modified()
        if not self.run():
            return False
        self.increment()
        return True

    # -- external control ---------------------------------------------------
    def write_now(self):
        """Force a checkpoint at the end of the current step (the
        reference's sigWriteNow / writeControl writeNow semantics)."""
        self._write_now = True

    def re_read_if_modified(self):
        """runTimeModifiable: re-read system/controlDict when its mtime
        changes and apply endTime / stopAt / writeInterval /
        writeControl / deltaT on the fly (reference:
        Time::readModifiedObjects, regIOobject re-read)."""
        try:
            mtime = os.path.getmtime(self._control_path)
        except OSError:
            return
        if self._control_mtime is not None and mtime == self._control_mtime:
            return
        self._control_mtime = mtime
        try:
            c = parse_file(self._control_path)
        except Exception as e:      # mid-edit torn file: keep old dict
            from .logging import info
            info(f"--> controlDict re-read failed, keeping previous "
                 f"({e})")
            return
        self.control = c
        self.end_time = c.scalar("endTime", self.end_time)
        self.write_control = c.word("writeControl", self.write_control)
        self.write_interval = c.scalar("writeInterval",
                                       self.write_interval)
        self.purge_write = int(c.scalar("purgeWrite", self.purge_write))
        self.adjust_time_step = c.boolean("adjustTimeStep",
                                          self.adjust_time_step)
        if c.lookup("maxCo") is not None:
            self.max_co = c.scalar("maxCo", self.max_co)
        if c.lookup("maxDeltaT") is not None:
            self.max_delta_t = c.scalar("maxDeltaT", self.max_delta_t)
        if not self.adjust_time_step:
            self.delta_t = c.scalar("deltaT", self.delta_t)
        stop_at = c.word("stopAt", "endTime")
        if stop_at == "writeNow":
            self._write_now = True
            self._stop_requested = True
        elif stop_at == "noWriteNow":
            self._stop_requested = True
        elif stop_at == "nextWrite":
            self._stop_at_next_write = True

    def increment(self):
        self.delta_t0 = self.delta_t
        self.time_index += 1
        _set_current_index(self.time_index)
        self.value += self.delta_t
        self._steps_since_write += 1

    def set_delta_t(self, dt: float):
        self.delta_t = min(float(dt), self.max_delta_t)

    def stop_at_write_now(self):
        self._stop_requested = True

    @property
    def name(self) -> str:
        return time_name(self.value)

    # -- write control ------------------------------------------------------
    def write_time(self) -> bool:
        if self._write_now:
            return True
        wc = self.write_control
        if wc == "timeStep":
            return self._steps_since_write >= int(self.write_interval)
        if wc in ("runTime", "adjustableRunTime"):
            n = int((self.value - self.start_time) / self.write_interval
                    + 0.5 * self.delta_t / self.write_interval)
            prev = int((self.value - self.delta_t - self.start_time)
                       / self.write_interval
                       + 0.5 * self.delta_t / self.write_interval)
            return n > prev
        return False

    def mark_written(self):
        self._write_now = False
        if getattr(self, "_stop_at_next_write", False):
            self._stop_requested = True
        self._steps_since_write = 0
        self._written_times.append(self.name)
        if self.purge_write > 0 and len(self._written_times) > self.purge_write:
            import shutil
            victim = self._written_times.pop(0)
            if victim not in ("0", time_name(self.start_time)):
                p = os.path.join(self.case_dir, victim)
                if os.path.isdir(p):
                    shutil.rmtree(p)

    def uniform_time_dict(self) -> str:
        from .dictionary import foamfile_header
        return (foamfile_header("dictionary", "time", "uniform") +
                f"\nvalue           {self.name};\n"
                f"name            \"{self.name}\";\n"
                f"index           {self.time_index};\n"
                f"deltaT          {self.delta_t};\n"
                f"deltaT0         {self.delta_t0};\n")
