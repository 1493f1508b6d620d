"""SRFSimpleFoam and SRFPimpleFoam of the port against the JAX package on
the CPU in fp64, on utils/casegen.srf_box_case (the JAX package's
tests/test_srf.py box at 16x16).

- With `relative no` walls the fluid spins up against the frame: 20
  SRFSimpleFoam iterations and 5 SRFPimpleFoam steps, the JAX package on
  its RCM-ordered ELL (on a laminar gdia box it meets its div_dev_t_grad
  fault: ROADMAP Queue 3), the port on the ELL and on the gdia box: Urel,
  p and phi to 1e-8 of their largest magnitude, iteration counts within
  one; Uabs (written beside Urel) to 1e-8.
- The JAX test's solid-body case (`relative yes`, tests/test_srf.py:113):
  Urel stays at rest and p takes the centrifugal parabola; and
  SRFModel.velocity drops the axial component (tests/test_srf.py:133).
"""

import math
import os

import numpy as np
import pytest
import torch

from rapidcfd_tpu.solvers import pimplefoam as jpimple
from rapidcfd_tpu.solvers import simplefoam as jsimple
from rapidcfd_tpu.solvers import srffoam as jsrf
from rapidcfd_tpu_torch.models.srf import SRFModel
from rapidcfd_tpu_torch.solvers import srffoam as tsrf
from rapidcfd_tpu_torch.solvers.case import Case
from rapidcfd_tpu_torch.utils.casegen import srf_box_case
from rapidcfd_tpu_torch.utils.logging import captured
from torch_heat_reference import CPU, F64, jax_quiet, jax_switches, rel

N = 16
STEPS = {"simple": 20, "pimple": 5}


def _its(st):
    return ([(f"U{c}", int(pf[2])) for c, pf in zip("xyz", st["u_perf"])]
            + [("p", int(pf[2])) for pf in st["p_perf"]])


def _run_jax(d, kind):
    """The JAX package's run (ELL), pRefCell at the device row of file
    cell 0 (as the port maps it), each step's counts recorded."""
    record = []
    module = jsimple if kind == "simple" else jpimple
    orig = module.make_step

    def make_step(case, transport, turb, ctrl, *a, **kw):
        perm = np.asarray(case.maps.cell_perm)
        ctrl.p_ref_cell = int(np.nonzero(perm == ctrl.p_ref_cell)[0][0])
        step = orig(case, transport, turb, ctrl, *a, **kw)

        def recorded(U, p, phi, ts, *dt):
            if dt and U.old is None:
                U = U.store_old()
            out = step(U, p, phi, ts, *dt)
            record.append(_its(out[4]))
            return out
        return recorded
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "make_step", make_step)
        with jax_switches(GDIA_AUTO="0", FORCE_RCM="1"), jax_quiet():
            run = jsrf.run if kind == "simple" else jsrf.run_pimple
            case, U, p, phi, _ = run(d, write=True,
                                     max_steps=STEPS[kind])
    return case, dict(Urel=U, p=p), record


@pytest.fixture(scope="module", params=["simple", "pimple"])
def srf_runs(request, tmp_path_factory):
    kind = request.param
    dirs = {}
    for who in ("jax", "ell", "gdia"):
        d = dirs[who] = str(tmp_path_factory.mktemp(f"srf_{kind}_{who}"))
        srf_box_case(d, N, pimple=kind == "pimple",
                     end_time=STEPS[kind] * (0.002 if kind == "pimple"
                                             else 1),
                     write_interval=1000)
    jcase, jf, jits = _run_jax(dirs["jax"], kind)
    out = {"jax": (jcase, {k: np.asarray(jcase.maps.cells_to_file(
        np.asarray(f.data))) for k, f in jf.items()}, jits)}
    run = tsrf.run if kind == "simple" else tsrf.run_pimple
    for layout in ("ell", "gdia"):
        with captured():
            case = Case(dirs[layout], device=CPU, dtype=F64,
                        gdia_auto=layout == "gdia",
                        gdia_box=layout == "gdia")
            assert (case.mesh.gdia is not None) == (layout == "gdia")
            case, U, p, _, _ = run(dirs[layout], device=CPU, dtype=F64,
                                   case=case)
        out[layout] = (case, {k: case.maps.cells_to_file(f.data.numpy())
                              for k, f in dict(Urel=U, p=p).items()},
                       [s["iterations"] for s in case.step_log])
    return kind, dirs, out


def test_srf_runs_match_jax(srf_runs):
    kind, dirs, out = srf_runs
    _, jf, jits = out["jax"]
    assert np.abs(jf["Urel"]).max() > 1e-3      # the fluid spins up
    for layout in ("ell", "gdia"):
        _, tf, tits = out[layout]
        for name in jf:
            assert rel(tf[name], jf[name]) <= 1e-8, (layout, name)
        assert len(tits) == len(jits) == STEPS[kind]
        for j, t in zip(jits, tits):
            jo = [x for x in j if x[0] != "p"]
            to = [x for x in t if x[0] != "p"]
            assert [f for f, _ in jo] == [f for f, _ in to]
            jp_ = [n for f, n in j if f == "p"]
            tp_ = [n for f, n in t if f == "p"][-len(jp_):]
            assert all(abs(a - b) <= 1 for (_, a), (_, b) in zip(jo, to))
            assert all(abs(a - b) <= 1 for a, b in zip(jp_, tp_))


def test_srf_uabs_written_matches_jax(srf_runs):
    from rapidcfd_tpu_torch.fields.io import _parse_value
    from rapidcfd_tpu_torch.utils.dictionary import parse_file
    kind, dirs, out = srf_runs
    vals = {}
    for who in ("jax", "ell", "gdia"):
        case = out[who][0]
        t = case.time.name
        e = parse_file(os.path.join(dirs[who], t, "Uabs")).lookup(
            "internalField")
        vals[who] = np.asarray(_parse_value(e, N * N, np.float64))
    for layout in ("ell", "gdia"):
        # 8 written digits
        assert np.abs(vals[layout] - vals["jax"]).max() \
            <= 1e-7 * np.abs(vals["jax"]).max()


def test_srf_simple_solid_body(tmp_path):
    """The JAX test's case: walls at `relative yes`, Urel stays at rest
    and p - p0 = 0.5 omega^2 r^2 (omega = 1 rad/s)."""
    d = str(tmp_path)
    srf_box_case(d, N, relative=True)
    with captured():
        case, U, p, _, _ = tsrf.run(d, device=CPU, dtype=F64, max_steps=60,
                                    write=False)
    C = case.mesh.C.numpy()
    pr = p.data.numpy()
    assert np.abs(U.data.numpy()).max() < 1e-4
    r2 = C[:, 0] ** 2 + C[:, 1] ** 2
    got = pr - pr[0] + 0.5 * r2[0]
    assert np.abs(got - 0.5 * r2).max() < 5e-4


def test_uabs_velocity(tmp_path):
    """SRFModel.velocity removes the axial component (reference
    SRFModel.C:167), and u_abs adds it to Urel."""
    d = str(tmp_path)
    srf_box_case(d, 4)

    class FakeCase:
        dir = d
    with captured():
        srf = SRFModel(FakeCase)
    v = srf.velocity(torch.tensor([[1.0, 0.0, 5.0]], dtype=F64))
    np.testing.assert_allclose(v.numpy(), [[0.0, 1.0, 0.0]], atol=1e-12)
    assert math.isclose(float(np.linalg.norm(srf.omega)), 1.0)


@pytest.mark.parametrize("kind", ["simple", "pimple"])
def test_srf_refuses_function_objects(tmp_path, kind):
    """The JAX package runs no function objects in the SRF solvers: a
    `functions` entry is refused by name, not skipped."""
    d = str(tmp_path)
    srf_box_case(d, 4, pimple=kind == "pimple")
    with open(os.path.join(d, "system", "controlDict"), "a") as f:
        f.write("\nfunctions\n{\n    minmax { type fieldMinMax; "
                "fields (p); }\n}\n")
    run = tsrf.run if kind == "simple" else tsrf.run_pimple
    name = "SRFSimpleFoam" if kind == "simple" else "SRFPimpleFoam"
    with captured(), pytest.raises(NotImplementedError, match=name):
        run(d, device=CPU, dtype=F64, max_steps=1, write=False)
