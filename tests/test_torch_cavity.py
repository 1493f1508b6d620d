"""The port's icoFoam lid-driven cavity (padded-ELL mesh) against the JAX
package, fp64 on the CPU:

- 10 PISO steps of the 20x20 tutorial setup (PCG/DIC p, smoothSolver U)
  and 5 steps of the 48x48 bench setup (PCG with a GAMG preconditioner
  for p, PBiCGStab/DILU for U), every solve to 1e-12, against the JAX
  package's ELL path (RCFD_FORCE_RCM=1, its pRefCell given as the device
  row of file cell 0): U, p and phi in file order to 1e-8 relative to
  their largest magnitude, iteration counts within one per solve (the
  packages sum in different orders);
- 40 steps of the 20x20 tutorial at its own tolerances against the
  committed fp64 golden fields (tests/golden/cavity20_fp64.npz, written
  by the JAX package's structured path, whose MeshMaps take them to file
  order): U and p to 1e-8, phi in the file's face orientation to 1e-12.
"""

import contextlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapidcfd_tpu.fields.field import Dimensioned as JDimensioned
from rapidcfd_tpu.ops import fvc as jfvc
from rapidcfd_tpu.solvers import icofoam as jico
from rapidcfd_tpu.solvers.case import Case as JCase
from rapidcfd_tpu.utils import logging as jlog
from rapidcfd_tpu.utils import switches
from rapidcfd_tpu_torch.fields.field import Dimensioned as TDimensioned
from rapidcfd_tpu_torch.ops import fvc as tfvc
from rapidcfd_tpu_torch.solvers import icofoam as tico
from rapidcfd_tpu_torch.solvers.case import Case as TCase
from rapidcfd_tpu_torch.utils import logging as tlog
from rapidcfd_tpu_torch.utils.casegen import cavity_case

CPU = torch.device("cpu")
F64 = torch.float64
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "cavity20_fp64.npz")
_BENCH = dict(p_solver="PCG", p_precond="GAMG", u_solver="PBiCGStab",
              u_precond="DILU")


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
def quiet():
    """Silence both packages' solver logs."""
    old = jlog.Info.enabled, tlog.Info.enabled
    jlog.Info.enabled = tlog.Info.enabled = False
    try:
        yield
    finally:
        jlog.Info.enabled, tlog.Info.enabled = old


def _iterations(stats):
    return [int(x[2]) for x in stats["u_perf"] + stats["p_perf"]]


def _run_port(d, dt, steps):
    """(case, U, p, phi, iterations per step) of the port's make_step."""
    case = TCase(d, device=CPU, dtype=F64)
    nu = TDimensioned.from_entry(
        case.transport_properties().lookup("nu", required=True), "nu")
    step = tico.make_step(case, nu, 2, 0, 0, 0.0)
    U, p = case.read_field("U"), case.read_field("p")
    phi = tfvc.flux(case.mesh, U)
    its = []
    for _ in range(steps):
        U, p, phi, stats = step(U, p, phi, dt)
        its.append(_iterations(stats))
    return case, U, p, phi, its


def _run_jax_ell(d, dt, steps):
    """The JAX package's ELL path on the same case: (U, p, phi, its) as
    numpy in device order (the same RCM order as the port's)."""
    with jax_switches(FORCE_RCM="1"):
        case = JCase(d, dtype=jnp.float64)
    nu = JDimensioned.from_entry(
        case.transport_properties().lookup("nu", required=True), "nu")
    p_ref = int(np.nonzero(np.asarray(case.maps.cell_perm) == 0)[0][0])
    step = jico.make_step(case, nu, 2, 0, p_ref, 0.0)
    U, p = case.read_field("U"), case.read_field("p")
    phi = jfvc.flux(case.mesh, U)
    # the step stores U's old time level first thing; giving it one from
    # the start keeps the inputs' structure fixed (one compile, not two)
    U = U.store_old()
    its = []
    for _ in range(steps):
        U, p, phi, stats = step(U, p, phi, dt)
        its.append(_iterations(stats))
    return (np.asarray(case.maps.cell_perm), np.asarray(U.data),
            np.asarray(p.data), np.asarray(phi.data), its)


def _setup(d, name):
    if name == "tutorial20":
        dt = 0.005
        cavity_case(d, n=20, delta_t=dt, end_time=1.0, tight_tol=True)
        return dt, 10
    dt = 0.005 * 20 / 48
    cavity_case(d, n=48, delta_t=dt, end_time=1.0, tight_tol=True,
                **_BENCH)
    return dt, 5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for name in ("tutorial20", "bench48"):
        d = str(tmp_path_factory.mktemp(name))
        dt, steps = _setup(d, name)
        with quiet():
            out[name] = (_run_port(d, dt, steps), _run_jax_ell(d, dt, steps))
    return out


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("field", ["U", "p", "phi"])
@pytest.mark.parametrize("setup", ["tutorial20", "bench48"])
def test_cavity_fields_match_jax_ell(runs, setup, field):
    (case, U, p, phi, _), (jperm, jU, jp, jphi, _) = runs[setup]
    maps = case.maps
    np.testing.assert_array_equal(maps.cell_perm, jperm)
    if field == "phi":
        t = maps.faces_to_file(phi.data.numpy(), flux=True)
        j = maps.faces_to_file(jphi, flux=True)
    else:
        t = maps.cells_to_file({"U": U, "p": p}[field].data.numpy())
        j = maps.cells_to_file({"U": jU, "p": jp}[field])
    assert np.isfinite(t).all()
    assert _rel(t, j) <= 1e-8


@pytest.mark.parametrize("setup", ["tutorial20", "bench48"])
def test_cavity_iteration_counts_match_jax_ell(runs, setup):
    (case, *_, its), (*_, jits) = runs[setup]
    assert len(its) == len(jits) and all(len(s) == 5 for s in its)
    diffs = [(k, a, b) for k, (a, b) in enumerate(zip(its, jits))
             if a != b]
    for k, a, b in diffs:
        print(f"step {k}: port {a}, JAX {b}")
    assert all(abs(x - y) <= 1 for _, a, b in diffs for x, y in zip(a, b))
    if setup == "bench48":   # p really went through the GAMG V-cycle
        assert case.solver_controls("p").preconditioner == "GAMG"


@pytest.fixture(scope="module")
def golden_run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("golden20"))
    cavity_case(d, n=20, delta_t=0.005, end_time=1.0)
    with quiet():
        case, U, p, phi, _ = _run_port(d, 0.005, 40)
        # the golden's device order: the JAX package's default
        # (structured) layout of the same case
        gmaps = JCase(d, dtype=jnp.float64).maps
    return case.maps, U, p, phi, gmaps, np.load(GOLDEN)


@pytest.mark.parametrize("field", ["U", "p", "phi"])
def test_cavity20_matches_golden(golden_run, field):
    maps, U, p, phi, gmaps, g = golden_run
    if field == "phi":
        t = maps.faces_to_file(phi.data.numpy(), flux=True)
        assert _rel(t, gmaps.faces_to_file(g["phi"])) <= 1e-12
    else:
        t = maps.cells_to_file({"U": U, "p": p}[field].data.numpy())
        assert _rel(t, gmaps.cells_to_file(g[field])) <= 1e-8
