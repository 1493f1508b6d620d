"""The port against the repo's independent anchors, on the CPU.

- icoFoam PISO on the 12x12 lid-driven cavity against CavityRef, the
  from-scratch numpy/scipy discretisation of tests/test_independent_fv.py
  (the only anchor that does not come from the repo's solvers), on the
  padded ELL and on the gdia box: U to 1e-8, p to 1e-7, as that test
  holds the JAX package.
- tests/golden/handcase, the case hand-written in OpenFOAM syntax
  (#include, $macro, regex boundaryField keys), run by the port's
  icoFoam unchanged: its mesh, its BCs, a finite run that writes.
- The 20x20 cavity's 40 fp32 steps against the committed fp64 golden
  fields (tests/golden/cavity20_fp64.npz) at tests/test_golden.py's fp32
  tolerances (U 1e-5, p 5e-5, phi 1e-9), and its fp64 run at 1e-8.
- The port's Time keeps a SIGUSR handler installed before it (the JAX
  package's, in a process that runs both packages' tests).

No JAX test file is edited: CavityRef is imported from it."""

import os
import shutil

import numpy as np
import pytest
import torch

from rapidcfd_tpu_torch.mesh.polymesh import read_polymesh
from rapidcfd_tpu_torch.solvers import icofoam
from rapidcfd_tpu_torch.solvers.case import Case
from rapidcfd_tpu_torch.utils.casegen import cavity_case
from rapidcfd_tpu_torch.utils.logging import captured
from rapidcfd_tpu_torch.utils.unstructured import face_centres_and_areas
from test_independent_fv import CavityRef

CPU = torch.device("cpu")
GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _run(d, dtype, box=False, write=False):
    with captured():
        case = Case(d, device=CPU, dtype=dtype, gdia_box=box)
        return icofoam.run(d, device=CPU, dtype=dtype, write=write,
                           case=case)[:4]


@pytest.mark.parametrize("box", [False, True], ids=["ell", "gdia"])
def test_cavity_matches_independent_reference(tmp_path, box):
    n, size, d3, nu, dt, steps = 12, 0.1, 0.01, 0.01, 0.005, 10
    d = str(tmp_path)
    cavity_case(d, n=n, d=size, nu=nu, delta_t=dt, end_time=dt * steps,
                tight_tol=True)
    case, U, p, _ = _run(d, torch.float64, box)
    assert (case.mesh.gdia is not None) == box
    u = case.maps.cells_to_file(U.data.numpy())
    pp = case.maps.cells_to_file(p.data.numpy())
    ref = CavityRef(n, size, d3, nu, dt)
    ur, pr = np.zeros((n * n, 2)), np.zeros(n * n)
    phix, phiy = np.zeros(ref.ox.size), np.zeros(ref.oy.size)
    for _ in range(steps):
        ur, pr, phix, phiy = ref.step(ur, pr, phix, phiy)
    assert np.abs(u[:, :2] - ur).max() < 1e-8
    assert np.abs(u[:, 2]).max() < 1e-14
    assert np.abs(pp - pr).max() < 1e-7


@pytest.fixture(scope="module")
def handcase(tmp_path_factory):
    d = os.path.join(str(tmp_path_factory.mktemp("hand")), "case")
    shutil.copytree(os.path.join(GOLD, "handcase"), d)
    return (d,) + tuple(_run(d, torch.float64, write=True))


def test_handcase_mesh_geometry(handcase):
    _, case, *_ = handcase
    m = case.mesh
    assert int(case.maps.cell_primary.sum()) == 9
    assert abs(float(m.V_asm.sum()) - 8.1e-5) < 1e-9
    assert [p.name for p in m.patches] == [
        "left", "right", "bottom", "lid", "back", "front"]
    assert [p.type for p in m.patches[-2:]] == ["empty", "empty"]


def test_handcase_regex_and_macro_bcs(handcase):
    """The lid takes $lidSpeed from the #include'd file; the
    "(left|right|bottom)" regex entry covers all three walls."""
    _, case, U, *_ = handcase
    for p in case.mesh.patches:
        bv = U.bvalues[p.bstart:p.bstart + p.size].numpy()
        if p.name == "lid":
            assert np.allclose(bv, [1.5, 0.0, 0.0])
        elif p.name in ("left", "right", "bottom"):
            assert np.allclose(bv, 0.0)


def test_handcase_runs_and_writes(handcase):
    d, case, U, *_ = handcase
    assert torch.isfinite(U.data).all()
    assert float(U.data.abs().max()) < 1.5
    assert os.path.isdir(os.path.join(d, "0.05"))


def _golden_face_order(d):
    """The golden's face order: the internal faces normal to x, then
    those normal to y, each in owner order (the JAX package's structured
    layout of the box); the boundary faces as in the file."""
    mesh = read_polymesh(d)
    _, Sf = face_centres_and_areas(mesh)
    n_int = mesh.n_internal_faces
    axis = np.abs(Sf[:n_int]).argmax(1)
    internal = np.lexsort((mesh.owner[:n_int], axis))
    return np.concatenate([internal, np.arange(n_int, mesh.n_faces)])


@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, dict(U=1e-5, p=5e-5, phi=1e-9)),
    (torch.float64, dict(U=1e-8, p=1e-8, phi=1e-8))], ids=["fp32", "fp64"])
def test_cavity20_matches_fp64_golden(tmp_path, dtype, tol):
    """40 steps of dt 0.005 on the 20x20 cavity (BASELINE config 1)
    against the committed fp64 fields, at tests/test_golden.py's fp32
    tolerances and its 1e-8 field-match class in fp64."""
    d = str(tmp_path)
    cavity_case(d, n=20, delta_t=0.005, end_time=0.2)
    case, U, p, phi = _run(d, dtype)
    g = np.load(os.path.join(GOLD, "cavity20_fp64.npz"))
    got = dict(
        U=case.maps.cells_to_file(U.data.double().numpy()),
        p=case.maps.cells_to_file(p.data.double().numpy()),
        phi=case.maps.faces_to_file(phi.data.double().numpy(),
                                    flux=True)[_golden_face_order(d)])
    for name, lim in tol.items():
        assert got[name].shape == g[name].shape, name
        assert np.abs(got[name] - g[name]).max() < lim, name


def test_port_time_keeps_an_earlier_signal_handler(tmp_path):
    """The port's Time installs its SIGUSR1/SIGUSR2 handlers once per
    process; a Python handler installed before it (the JAX package's
    Time in a shared test process) is still called, so a checkpoint
    request reaches both packages' clocks."""
    import signal
    import time as _time

    from rapidcfd_tpu_torch.utils import timecontrol
    d = str(tmp_path)
    cavity_case(d, n=3)
    seen = []
    saved = [signal.getsignal(s) for s in (signal.SIGUSR1, signal.SIGUSR2)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(timecontrol, "_SIGNALS_INSTALLED", False)
        mp.setattr(timecontrol, "_SIGNAL_CLOCKS", [])
        try:
            signal.signal(signal.SIGUSR1, lambda s, f: seen.append(s))
            t = timecontrol.Time(d)
            assert not t.write_time()
            os.kill(os.getpid(), signal.SIGUSR1)
            _time.sleep(0.01)
            assert t.write_time() and seen == [signal.SIGUSR1]
        finally:
            for s, h in zip((signal.SIGUSR1, signal.SIGUSR2), saved):
                signal.signal(s, h)
