"""The port's VOF family against the JAX package in fp64 on the CPU:
interFoam with explicit MULES on the 16x16 dam break (gdia and ELL), its
MULESCorr form (dt 0.004), LTSInterFoam (localEuler, gdia: fvc.smooth on
the lattice), twoLiquidMixingFoam on the stratified dam break,
interMixingFoam on a 12x12 air-over-two-liquids box and
interPhaseChangeFoam (SchnerrSauer) on the 30x6 cavitating channel
(ELL), each for 5 steps: the reduced cases of the JAX package's tests
(tests/test_interfoam.py, test_intermixing.py:17, test_phasechange.py:22).

alpha, U, p_rgh and phi within 1e-8 of the JAX package's relative to
their largest magnitude, p_rgh iteration counts within one per solve,
and the boundedness and volume change each JAX test asserts. Each JAX run
happens once, in a module-scoped fixture; the JAX package runs with
XLA's optimisations off (the limiters' rounding, as in
test_torch_compressible.py).
"""

import os

import pytest
import torch

from rapidcfd_tpu.solvers import interfoam as jif
from rapidcfd_tpu.solvers import interphasechangefoam as jipc
from rapidcfd_tpu.solvers import intermixingfoam as jimf
from rapidcfd_tpu_torch.solvers import interfoam as tif
from rapidcfd_tpu_torch.solvers import interphasechangefoam as tipc
from rapidcfd_tpu_torch.solvers import intermixingfoam as timf
from rapidcfd_tpu_torch.utils.casegen import (cavitating_channel_case,
                                              dam_break_case,
                                              intermixing_case, local_euler,
                                              mixing_dam_break_case)
from rapidcfd_tpu_torch.utils.logging import captured
from torch_heat_reference import (cell_errors, counts_close, flux_error,
                                  port_case, run_jax, run_port)

STEPS = 5
RTOL = 1e-8
def _p_its(its):
    """The p_rgh solves of each step's iteration counts."""
    return [[(n, k) for n, k in step if n == "p_rgh"] for step in its]


def _jax_its(stats):
    return [("p_rgh", int(pf[2])) for pf in stats["p_perf"]]


def _compare(tout, jout, names, t_its, j_its):
    """Fields named `names` (the runs' outputs after the case) within
    RTOL, phi (the last output) on the faces a sum reads, p_rgh counts
    within one."""
    tcase, jcase = tout[0], jout[0]
    errs = cell_errors(tcase, jcase, {n: (a, b) for n, a, b in zip(
        names, tout[1:-1], jout[1:-1])})
    errs["phi"] = flux_error(tcase, jcase, tout[-1], jout[-1])
    assert all(v <= RTOL for v in errs.values()), errs
    assert counts_close(_p_its(t_its), _p_its(j_its)), (t_its, j_its)
    return errs


def _volume_change(case, field, name):
    """|integral of field - its initial integral| relative to the latter."""
    V = case.mesh.V_asm
    v0 = (case.read_field(name, "0").data * V).sum()
    return float(((field.data * V).sum() - v0).abs() / v0)


def _interfoam_pair(d, layout, **kw):
    jout, j_its = run_jax(jif, d, STEPS, layout, _jax_its, prestore=(1, 2),
                          **kw)
    tout, t_its = run_port(tif, d, STEPS, layout, **kw)
    return tout, jout, t_its, j_its


# -- interFoam, explicit MULES -------------------------------------------------

@pytest.fixture(scope="module")
def dam(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dam16"))
    with captured():
        dam_break_case(d, n=16)
    return d


@pytest.fixture(scope="module", params=["gdia", "ell"])
def dam_runs(request, dam):
    return request.param, _interfoam_pair(dam, request.param)


def test_interfoam_dam_break_matches_jax(dam_runs):
    """5 steps of explicit MULES on the 16x16 dam break: alpha, U, p_rgh
    and phi within 1e-8 (measured ~1e-12), p_rgh counts within one; alpha
    in [-1e-6, 1 + 1e-6] and the closed box's water volume within 1e-10
    (tests/test_interfoam.py's bounds)."""
    layout, (tout, jout, t_its, j_its) = dam_runs
    _compare(tout, jout, ("alpha", "U", "p_rgh"), t_its, j_its)
    case, alpha = tout[0], tout[1]
    assert (case.mesh.gdia is not None) == (layout == "gdia")
    assert float(alpha.data.min()) > -1e-6
    assert float(alpha.data.max()) < 1.0 + 1e-6
    assert _volume_change(case, alpha, "alpha1") < 1e-10
    assert len(case.step_log) == STEPS


# -- MULESCorr -----------------------------------------------------------------

@pytest.fixture(scope="module")
def corr_runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("damc"))
    with captured():
        dam_break_case(d, n=16, delta_t=0.004, mules_corr=True)
    return _interfoam_pair(d, "gdia")


def test_mules_corr_matches_jax(corr_runs):
    """MULESCorr (implicit upwind alpha plus the limited correction) at
    dt 0.004 on the 16x16 dam break (gdia): fields within 1e-8, counts
    within one; alpha within [-1e-9, 1 + 1e-9] and the volume within 1e-9
    (tests/test_interfoam.py::test_mules_implicit_high_courant)."""
    tout, jout, t_its, j_its = corr_runs
    _compare(tout, jout, ("alpha", "U", "p_rgh"), t_its, j_its)
    case, alpha = tout[0], tout[1]
    assert float(alpha.data.min()) > -1e-9
    assert float(alpha.data.max()) < 1.0 + 1e-9
    assert _volume_change(case, alpha, "alpha1") < 1e-9


def test_mules_corr_override_selects_implicit(tmp_path):
    """make_step's mules_corr=True on the writer's explicit case runs the
    same steps as the writer's MULESCorr case."""
    a, b = str(tmp_path / "e"), str(tmp_path / "c")
    with captured():
        dam_break_case(a, n=8, delta_t=0.004)
        dam_break_case(b, n=8, delta_t=0.004, mules_corr=True)
    x, _ = run_port(tif, b, 2, "gdia")
    case = port_case(a, "gdia")
    with captured():
        state, _, _, _ = tif.setup(case)
        step = tif.make_step(case, tif.read_constants(case),
                             tif.PimpleControl(case), mules_corr=True)
        for _ in range(2):
            *state, _ = step(*state, 0.004)
    assert torch.equal(state[0].data, x[1].data)
    assert torch.equal(state[2].data, x[3].data)


# -- LTSInterFoam ---------------------------------------------------------------

@pytest.fixture(scope="module")
def lts_runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("damlts"))
    with captured():
        dam_break_case(d, n=16, end_time=0.02)
    local_euler(d)
    return _interfoam_pair(d, "gdia")


def test_lts_interfoam_matches_jax(lts_runs):
    """LTSInterFoam (localEuler: rDeltaT with the interface band, smoothed
    by fvc.smooth on the gdia lattice) on the 16x16 dam break: fields
    within 1e-8, counts within one; alpha bounded to 1e-6 and the volume
    drift under 0.15 (tests/test_interfoam.py::test_lts_interfoam)."""
    tout, jout, t_its, j_its = lts_runs
    _compare(tout, jout, ("alpha", "U", "p_rgh"), t_its, j_its)
    case, alpha = tout[0], tout[1]
    assert case.mesh.gdia is not None
    assert case.ddt_scheme() == "localEuler"
    assert float(alpha.data.min()) > -1e-6
    assert float(alpha.data.max()) < 1.0 + 1e-6
    assert _volume_change(case, alpha, "alpha1") < 0.15


# -- twoLiquidMixingFoam ------------------------------------------------------------

@pytest.fixture(scope="module")
def mixing_runs(tmp_path_factory):
    """tests/test_interfoam.py::test_two_liquid_mixing_stratified's Dab
    (2e-3) on the 16x16 dam break's collapsing column: the JAX test's
    stable stratification leaves U at the rounding of the hydrostatic
    balance, whose relative differences are noise."""
    d = str(tmp_path_factory.mktemp("mix"))
    with captured():
        mixing_dam_break_case(d, n=16)
    return _interfoam_pair(d, "gdia", mixing=True)


def test_two_liquid_mixing_matches_jax(mixing_runs):
    """twoLiquidMixingFoam (no compression, no surface tension, the
    implicit Dab diffusion of alpha): fields within 1e-8, p_rgh counts
    within one; alpha bounded to 1e-6, the phase conserved to 1e-6."""
    tout, jout, t_its, j_its = mixing_runs
    _compare(tout, jout, ("alpha", "U", "p_rgh"), t_its, j_its)
    case, alpha = tout[0], tout[1]
    assert t_its[0][0][0] == "alpha"
    assert float(alpha.data.min()) > -1e-6
    assert float(alpha.data.max()) < 1.0 + 1e-6
    assert _volume_change(case, alpha, "alpha1") < 1e-6


# -- interMixingFoam ----------------------------------------------------------------

@pytest.fixture(scope="module")
def intermixing_runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("imix"))
    with captured():
        intermixing_case(d, n=12)
    jout, j_its = run_jax(jimf, d, STEPS, "gdia", _jax_its,
                          prestore=(0, 1, 2))
    tout, t_its = run_port(timf, d, STEPS, "gdia")
    return tout, jout, t_its, j_its


def test_intermixing_matches_jax(intermixing_runs):
    """interMixingFoam (one MULES limiter for alpha1 and alpha2, the
    implicit D23 diffusion, the three-phase CSF): alpha1, alpha2, U, p_rgh
    and phi within 1e-8, p_rgh counts within one; the JAX test's bounds
    (alpha1 to 1e-4, alpha2 and alpha3 to 0.02, air volume to 1%, oil
    volume to 2%)."""
    tout, jout, t_its, j_its = intermixing_runs
    _compare(tout, jout, ("alpha1", "alpha2", "U", "p_rgh"), t_its, j_its)
    case, a1, a2 = tout[:3]
    a3 = 1.0 - a1.data - a2.data
    assert -1e-4 < float(a1.data.min()) and float(a1.data.max()) < 1 + 1e-4
    assert -0.02 < float(a2.data.min()) and float(a2.data.max()) < 1.02
    assert float(a3.min()) > -0.02
    assert _volume_change(case, a1, "alpha.air") < 0.01
    assert _volume_change(case, a2, "alpha.oil") < 0.02


# -- interPhaseChangeFoam -----------------------------------------------------------

@pytest.fixture(scope="module")
def phase_change_runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cav"))
    with captured():
        cavitating_channel_case(d)
    jout, j_its = run_jax(jipc, d, STEPS, "ell", _jax_its, prestore=(1, 2))
    tout, t_its = run_port(tipc, d, STEPS, "ell")
    return tout, jout, t_its, j_its


def test_phase_change_matches_jax(phase_change_runs):
    """interPhaseChangeFoam (SchnerrSauer) on the cavitating channel
    (ELL): fields within 1e-8, p_rgh counts within one; alpha within
    [-1e-9, 1 + 1e-9], vapour formed at the outlet (p below pSat), |U|
    below 100 m/s (tests/test_phasechange.py's bounds)."""
    tout, jout, t_its, j_its = phase_change_runs
    _compare(tout, jout, ("alpha", "U", "p_rgh"), t_its, j_its)
    case, alpha, U = tout[:3]
    a = alpha.data
    assert bool(((a >= -1e-9) & (a <= 1.0 + 1e-9)).all())
    assert float(a.min()) < 0.9999
    assert float(U.data.abs().max()) < 100.0


def test_phase_change_dym_and_interfoam_dym_raise(tmp_path):
    """The dynamic-mesh forms are not ported: both raise and name it."""
    d = str(tmp_path / "dam")
    with captured():
        dam_break_case(d, n=4)
    with pytest.raises(NotImplementedError, match="dynamic mesh"):
        tipc.run(d, device=torch.device("cpu"), dtype=torch.float64,
                 dym=True)
    case = run_port(tif, d, 1, "gdia")[0][0]
    with pytest.raises(NotImplementedError, match="dynamic mesh"):
        tif.make_step(case, tif.read_constants(case),
                      tif.PimpleControl(case), dym=True)


def test_dispatcher_runs_vof_solvers(tmp_path):
    """`python -m rapidcfd_tpu_torch interFoam -case D -gdiaBox -device
    cpu` (and LTSInterFoam, twoLiquidMixingFoam) run through the
    dispatcher, fp32 by default, and write alpha1, U and p_rgh."""
    from rapidcfd_tpu_torch import __main__ as cli
    from rapidcfd_tpu_torch import solver_dtype
    for name in ("interFoam", "LTSInterFoam", "twoLiquidMixingFoam",
                 "interMixingFoam", "interPhaseChangeFoam"):
        assert name in cli.SOLVERS
        assert solver_dtype(name) == torch.float32
    d = str(tmp_path / "dam")
    with captured():
        dam_break_case(d, n=6, end_time=0.002)
        cli.main(["interFoam", "-case", d, "-gdiaBox", "-device", "cpu"])
    for name in ("alpha1", "U", "p_rgh"):
        assert os.path.isfile(os.path.join(d, "0.002", name))


def test_u_scheme_is_linear_upwind_whatever_the_case_names(tmp_path):
    """The JAX package's interFoam convects U with linearUpwind whatever
    div(rhoPhi,U) names (rapidcfd_tpu/solvers/interfoam.py:213; ROADMAP
    Queue 3), and the port mirrors it: with `Gauss linear` there the dam
    break runs the same steps as with the writer's `Gauss upwind`, and
    matches the JAX package's run of the `Gauss linear` case."""
    a, b = str(tmp_path / "upwind"), str(tmp_path / "linear")
    with captured():
        dam_break_case(a, n=8)
        dam_break_case(b, n=8)
    p = os.path.join(b, "system", "fvSchemes")
    s = open(p).read()
    assert "div(rhoPhi,U)   Gauss upwind;" in s
    with open(p, "w") as f:
        f.write(s.replace("div(rhoPhi,U)   Gauss upwind;",
                          "div(rhoPhi,U)   Gauss linear;"))
    x, _ = run_port(tif, a, 3, "gdia")
    y, y_its = run_port(tif, b, 3, "gdia")
    for i in (1, 2, 3, 4):
        assert torch.equal(x[i].data, y[i].data)
    jout, j_its = run_jax(jif, b, 3, "gdia", _jax_its, prestore=(1, 2))
    _compare(y, jout, ("alpha", "U", "p_rgh"), y_its, j_its)


@pytest.mark.parametrize("n", [4, 7, 16])
def test_dam_break_lattice_out_is_detect_lattice(tmp_path, n):
    """dam_break_case(write_mesh=False, lattice_out=) builds in memory the
    mesh it writes and the gdia embedding detect_lattice(full_box=True)
    finds on that mesh read back from disk, key for key."""
    import numpy as np
    from rapidcfd_tpu_torch.mesh.polymesh import read_polymesh
    from rapidcfd_tpu_torch.utils.unstructured import detect_lattice
    disk, mem = str(tmp_path / "disk"), str(tmp_path / "mem")
    lat = {}
    with captured():
        dam_break_case(disk, n=n)
        pm = dam_break_case(mem, n=n, write_mesh=False, lattice_out=lat)
    read = read_polymesh(disk)
    assert np.array_equal(pm.owner, read.owner)
    assert np.array_equal(pm.neighbour, read.neighbour)
    want = detect_lattice(read, full_box=True)
    assert sorted(lat) == sorted(want)
    assert lat["shape"] == want["shape"] == (1, n, n)
    for key in want:
        assert np.array_equal(np.asarray(lat[key]), np.asarray(want[key])), \
            key
