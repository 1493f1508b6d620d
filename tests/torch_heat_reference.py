"""Shared drivers of the heat-transfer comparison tests
(tests/test_torch_heattransfer.py, test_torch_buoyant.py and
test_torch_thermo.py): run a JAX package solver and the port's on the
same case directory, record the JAX step's iteration counts, and compare
the fields. Not a test module itself.

The JAX package's own run() builds its Case; for the gdia layout of a
full box (the port's gdia_box routing; the JAX package sends a full box
to its structured layout, which the port has not ported) run_jax hands
it the port's lattice embedding, and for the ELL layout it sets
RCFD_GDIA_AUTO=0 and RCFD_FORCE_RCM=1 and gives the pressure reference
as the device row of file cell 0, as the port maps pRefCell.
"""

from __future__ import annotations

import contextlib
import sys

import jax
import numpy as np
import pytest
import torch

from rapidcfd_tpu.fields.field import SurfaceField as JSurface
from rapidcfd_tpu.solvers import controls as jcontrols
from rapidcfd_tpu.solvers.case import Case as JCase
from rapidcfd_tpu.utils import logging as jlog
from rapidcfd_tpu.utils import switches
from rapidcfd_tpu_torch.mesh.polymesh import read_polymesh
from rapidcfd_tpu_torch.solvers.case import Case
from rapidcfd_tpu_torch.utils.logging import captured
from rapidcfd_tpu_torch.utils.unstructured import detect_lattice

CPU = torch.device("cpu")
F64 = torch.float64


@contextlib.contextmanager
def jax_switches(**env):
    """Set RCFD_<name> for the JAX package, clearing its switch cache on
    the way in and out."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv("RCFD_" + k, v)
            switches._CACHE.pop(k, None)
        try:
            yield
        finally:
            for k in env:
                switches._CACHE.pop(k, None)


@contextlib.contextmanager
def jax_quiet(unoptimized: bool = True):
    """The JAX package's log off and, with unoptimized, XLA's
    optimisations off (restored on the way out)."""
    old = jlog.Info.enabled, jax.config.read("jax_disable_most_optimizations")
    jlog.Info.enabled = False
    jax.config.update("jax_disable_most_optimizations", unoptimized)
    try:
        yield
    finally:
        jlog.Info.enabled = old[0]
        jax.config.update("jax_disable_most_optimizations", old[1])


def rel(a, b) -> float:
    a, b = np.broadcast_arrays(np.asarray(a, dtype=float),
                               np.asarray(b, dtype=float))
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _with_old(x):
    """x with an old time level stored (each field of a list of them)."""
    if isinstance(x, (list, tuple)):
        return type(x)(_with_old(f) for f in x)
    return x.store_old() if getattr(x, "old", 0) is None else x


class RecordingJax:
    """The jax module for a JAX solver module whose step is a jitted
    closure: its jit records each step's iteration counts (its_of(stats))
    and keeps the step's input structure, and with it the compiled
    program, the same from the first call: before it, the arguments at
    `prestore` get their old level (the step stores it itself; each field
    of a list argument too) and the
    flux `phi` takes the name the step's returned flux carries
    (phiHbyA; a name is static in a JAX pytree). A jitted helper that
    returns no tuple (a solver's initial flux) records nothing."""

    def __init__(self, record, its_of, prestore=()):
        self.record, self.its_of, self.prestore = record, its_of, prestore

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kw):
        jitted = jax.jit(fn, **kw)

        def recorded(*a):
            a = list(a)
            for i in self.prestore:
                if i < len(a):
                    a[i] = _with_old(a[i])
            for i, x in enumerate(a):
                if isinstance(x, JSurface) and x.name == "phi":
                    a[i] = JSurface(x.data, x.dims, "phiHbyA")
            out = jitted(*a)
            if isinstance(out, tuple):      # a step, not a helper jit
                self.record.append(self.its_of(out[-1]))
            return out
        return recorded


def port_case(d, layout: str, dtype=F64) -> Case:
    with captured():
        return Case(d, device=CPU, dtype=dtype, gdia_box=layout == "gdia",
                    gdia_auto=layout == "gdia")


def run_jax(module, d, steps: int, layout: str, its_of, *, prestore=(),
            mac: bool = True, **kw):
    """(JAX outputs of module.run, per-step iteration counts). layout
    'gdia' or 'ell'; mac=False sets RCFD_GDIA_MAC=0 (the generic gdia
    pipeline)."""
    record = []
    lattice = (detect_lattice(read_polymesh(d), full_box=True)
               if layout == "gdia" else None)
    ref = port_case(d, layout).maps.device_cell(0)

    def with_ref(cls):
        class Ref(cls):
            def __init__(self, case):
                super().__init__(case)
                self.p_ref_cell = ref
        return Ref

    env = dict(GDIA_AUTO="0", FORCE_RCM="1") if layout == "ell" else {}
    if not mac:
        env["GDIA_MAC"] = "0"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "jax", RecordingJax(record, its_of, prestore))
        mp.setattr(module, "Case",
                   lambda case_dir, **k: JCase(case_dir, lattice=lattice,
                                               **k))
        for name in ("SimpleControl", "PimpleControl"):
            cls = with_ref(getattr(jcontrols, name))
            mp.setattr(jcontrols, name, cls)
            if hasattr(module, name):
                mp.setattr(module, name, cls)
        with jax_switches(**env), jax_quiet():
            out = module.run(d, write=False, max_steps=steps, **kw)
    return out, record


def run_port(module, d, steps: int, layout: str, **kw):
    case = port_case(d, layout)
    with captured():
        out = module.run(d, device=CPU, dtype=F64, write=False,
                         max_steps=steps, case=case, **kw)
    return out, [s["iterations"] for s in case.step_log]


def cell_errors(tcase, jcase, fields: dict) -> dict:
    """name -> largest difference over the cells, relative to the largest
    magnitude; fields maps a name to (port VolField, JAX VolField), both
    read in file cell order."""
    return {name: rel(tcase.maps.cells_to_file(a.data.numpy()),
                      jcase.maps.cells_to_file(np.asarray(b.data)))
            for name, (a, b) in fields.items()}


def flux_error(tcase, jcase, a, b) -> float:
    """The face flux's largest difference relative to its largest
    magnitude, on the faces a face sum reads: file order and orientation
    on gdia meshes, the shared device order on ELL meshes; the faces of
    empty patches (which no sum reads) left out."""
    a, b = a.data.numpy(), np.asarray(b.data)
    mesh = tcase.mesh
    if mesh.gdia is not None:
        nf = tcase.maps.n_file_faces
        a = tcase.maps.faces_to_file(a, flux=True)
        b = jcase.maps.faces_to_file(b)[:nf]
        n_int = nf - mesh.n_boundary
        starts = [(n_int + p.bstart, p.size) for p in mesh.patches
                  if p.is_empty]
    else:
        starts = [(p.start, p.size) for p in mesh.patches if p.is_empty]
    keep = np.ones(a.shape[0], bool)
    for s, n in starts:
        keep[s:s + n] = False
    return rel(a[keep], b[keep])


def counts_close(port_its, jax_its) -> bool:
    """Equal solve sequences with every iteration count within one."""
    if len(port_its) != len(jax_its):
        return False
    for ps, js in zip(port_its, jax_its):
        if [n for n, _ in ps] != [n for n, _ in js]:
            return False
        if any(abs(a - b) > 1 for (_, a), (_, b) in zip(ps, js)):
            return False
    return True


def basic_pair(fn: str, d: str, steps: int = 5):
    """((JAX case, JAX T), JAX counts, (port case, port T), port counts)
    of `steps` steps of a basic solver (fn: run_laplacian_foam or
    run_scalar_transport_foam) on the padded ELL in both packages, fp64.
    The JAX package's basic solvers return their perf before their last
    output, so its recorder hands its_of each jitted call's whole
    output."""
    from rapidcfd_tpu.solvers import basic as jbasic
    from rapidcfd_tpu_torch.solvers import basic as tbasic

    class WholeOut(RecordingJax):
        def jit(self, f, **kw):
            jitted = jax.jit(f, **kw)

            def recorded(*a):
                out = jitted(*a)
                self.record.append(self.its_of(out))
                return out
            return recorded

    def run(case_dir, write, max_steps):
        return getattr(jbasic, fn)(case_dir, write=write,
                                   max_steps=max_steps)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys.modules[__name__], "RecordingJax", WholeOut)
        mp.setattr(jbasic, "run", run, raising=False)
        jout, jits = run_jax(jbasic, d, steps, "ell",
                             lambda out: [("T", int(out[1][0][2]))])
    tcase = port_case(d, "ell")
    with captured():
        tout = getattr(tbasic, fn)(d, device=CPU, dtype=F64, write=False,
                                   case=tcase, max_steps=steps)
    return (jout[0], jout[1]), jits, (tout[0], tout[1]), \
        [s["iterations"] for s in tcase.step_log]
