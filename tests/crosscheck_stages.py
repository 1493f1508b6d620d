"""One SIMPLE iteration of the polyhedral channel or its curved duct, in the
JAX package and in the port, compared intermediate by intermediate in
fp64 on the CPU.

    python tests/crosscheck_stages.py [--dims 128 64 64] [--curve 1.2
        --grade 4.0] [--perturb] [--vcycle-scale S]

Both packages build bench_unstructured.py's case from the same generated
mesh (as tests/crosscheck_channel.py does) and run one SIMPLE iteration
eagerly (the JAX step under `jax.disable_jit()`), with hooks that record,
in the order the iteration makes them:

- every matrix handed to a linear solve (U, p per corrector, omega, k)
  and the solve's result;
- HbyA (constrain_hbya) and phi_hbya (adjust_phi);
- inside each GAMG-preconditioned p solve, the matrix of every coarse
  level and the coarsest level's dense matrix, its inverse and its
  2-norm condition number, and every application of the V-cycle
  preconditioner: its input (the PCG residual r) and output w, with
  <w, r> / (|w| |r|), which keeps one sign for every r only while the
  preconditioner is definite (negative here: the pressure matrix is the
  negative semi-definite FV laplacian).

It prints each intermediate's largest difference between the packages
relative to its largest magnitude, and marks the first one above 1e-12.
With --perturb it then runs each package a second time with the
coarsest inverse taken as inv(A^T)^T (the same matrix, another order of
the floating-point operations) and prints how far each package's own
fields move. --vcycle-scale sets the p solver's vCycleScale (the
over-relaxation of the V-cycle's coarse corrections, 2.0 when unset) in
the case. Like crosscheck_channel.py it imports both packages; pytest
does not collect it.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


class Recorder:
    """Hooks on one package's modules; `events` is the ordered record
    [(name, {array name: numpy array})]."""

    def __init__(self, to_np):
        self.to_np = to_np
        self.events = []
        self.transpose_inverse = False

    def add(self, name, **arrays):
        self.events.append((name, {k: self.to_np(v)
                                   for k, v in arrays.items()}))


def _install(rec: Recorder, *, simple_mod, turb_mod, fvc_mod, gamg_mod,
             solvers_mod, inv_owner, inv_attr):
    """Wrap solve, constrain_hbya, adjust_phi, _coarsen_matrix, the V-cycle
    preconditioner and the dense inverse of one package; returns the undo
    function."""
    saved = []

    def patch(obj, attr, new):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, new)

    def wrap_solve(orig):
        def solve(mesh, m, controls, env=None):
            name = m.psi.name
            rec.add(f"{name} matrix", diag=m.diag, lower=m.lower,
                    upper=m.upper, source=m.source)
            new, perf = orig(mesh, m, controls, env)
            rec.add(f"{name} solve", x=new.data,
                    iterations=[int(p[2]) for p in perf])
            return new, perf
        return solve

    for mod in (simple_mod, turb_mod):
        patch(mod, "solve", wrap_solve(mod.solve))

    orig_hbya, orig_adj = fvc_mod.constrain_hbya, fvc_mod.adjust_phi

    def constrain_hbya(mesh, hbya, U):
        out = orig_hbya(mesh, hbya, U)
        rec.add("HbyA", data=out.data, bvalues=out.bvalues)
        return out

    def adjust_phi(mesh, phi, U):
        out = orig_adj(mesh, phi, U)
        rec.add("phi_hbya", data=out.data)
        return out
    patch(fvc_mod, "constrain_hbya", constrain_hbya)
    patch(fvc_mod, "adjust_phi", adjust_phi)

    orig_coarsen = gamg_mod._coarsen_matrix

    def coarsen(lv, *args, **kw):
        d, lo, up = orig_coarsen(lv, *args, **kw)
        rec.add(f"coarse level {int(lv.n_coarse)} cells", diag=d, lower=lo,
                upper=up)
        return d, lo, up
    patch(gamg_mod, "_coarsen_matrix", coarsen)

    orig_precond = solvers_mod._gamg_precond

    def gamg_precond(*args, **kw):
        apply = orig_precond(*args, **kw)

        def recorded(r):
            w = apply(r)
            rec.add("V-cycle", r=r, w=w)
            return w
        return recorded
    patch(solvers_mod, "_gamg_precond", gamg_precond)

    orig_inv = getattr(inv_owner, inv_attr)

    def inv(a):
        out = orig_inv(a.T).T if rec.transpose_inverse else orig_inv(a)
        rec.add("coarsest dense", A=a, inverse=out)
        return out
    patch(inv_owner, inv_attr, inv)

    def undo():
        for obj, attr, val in reversed(saved):
            setattr(obj, attr, val)
    return undo


def _rel(a, b):
    import numpy as np
    a, b = np.asarray(a, float), np.asarray(b, float)
    if a.shape != b.shape:
        return float("nan")
    scale = np.abs(b).max() if b.size else 0.0
    return float(np.abs(a - b).max() / scale) if scale > 0 else \
        float(np.abs(a - b).max() if a.size else 0.0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dims", type=int, nargs=3, default=(32, 16, 16),
                    metavar=("NX", "NY", "NZ"))
    ap.add_argument("--curve", type=float, default=0.0)
    ap.add_argument("--grade", type=float, default=1.0)
    ap.add_argument("--perturb", action="store_true")
    ap.add_argument("--vcycle-scale", type=float, default=None)
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    import torch

    import rapidcfd_tpu.linalg.gamg as jgamg
    import rapidcfd_tpu.linalg.solvers as jsolvers
    import rapidcfd_tpu_torch.linalg.solvers as tsolvers
    import rapidcfd_tpu.models.turbulence as jturbmod
    import rapidcfd_tpu.ops.fvc as jfvc
    import rapidcfd_tpu.solvers.simplefoam as jsimple
    import rapidcfd_tpu_torch.linalg.gamg as tgamg
    import rapidcfd_tpu_torch.models.turbulence as tturbmod
    import rapidcfd_tpu_torch.ops.fvc as tfvc
    import rapidcfd_tpu_torch.solvers.simplefoam as tsimple
    from rapidcfd_tpu.linalg.precompute import attach_solver_layouts
    from rapidcfd_tpu.models.transport import \
        SinglePhaseTransportModel as JTransport
    from rapidcfd_tpu.solvers.case import Case as JCase
    from rapidcfd_tpu.solvers.controls import SimpleControl as JControl
    from rapidcfd_tpu.utils import logging as jlogging
    from rapidcfd_tpu.utils.unstructured import unstructured_channel_case
    from rapidcfd_tpu_torch.linalg.precompute import \
        attach_solver_layouts as t_attach
    from rapidcfd_tpu_torch.models.transport import \
        SinglePhaseTransportModel as TTransport
    from rapidcfd_tpu_torch.models.turbulence import make_ras_model as tras
    from rapidcfd_tpu_torch.solvers.case import Case as TCase
    from rapidcfd_tpu_torch.solvers.controls import SimpleControl as TControl
    from rapidcfd_tpu_torch.utils.logging import captured

    jlogging.Info.enabled = False
    nx, ny, nz = args.dims
    geometry = dict(curve=args.curve, grade=args.grade)
    lattice = args.curve == 0.0 and args.grade == 1.0
    d = tempfile.mkdtemp(prefix="crosscheck_stages_")
    lat = {} if lattice else None
    t0 = time.perf_counter()
    pm = unstructured_channel_case(
        d, nx=nx, ny=ny, nz=nz, end_time=10 ** 9, perturb=0.12,
        merge_fraction=0.04, seed=3, write_mesh=False, lattice_out=lat,
        **geometry)
    if args.vcycle_scale is not None:
        path = os.path.join(d, "system", "fvSolution")
        with open(path) as f:
            text = f.read()
        text = text.replace("preconditioner  GAMG;", "preconditioner  GAMG;"
                            f"\n        vCycleScale     {args.vcycle_scale};",
                            1)
        with open(path, "w") as f:
            f.write(text)
    jcase = JCase(d, pmesh=pm, lattice=lat)
    jU, jp = jcase.read_field("U"), jcase.read_field("p")
    jturb = jsimple.make_ras_model(jcase, jU)
    jkw = jsimple.step_kwargs_from_case(
        jcase, JControl(jcase), JTransport(jcase.transport_properties()),
        jturb)
    jmesh = attach_solver_layouts(
        jcase.mesh, (jkw["u_controls"], jkw["p_controls"]), case=jcase)
    j0 = (jU, jp, jfvc.flux(jmesh, jU), jturb.init_state(jU))
    print(f"{'x'.join(map(str, args.dims))} {geometry}: {pm.n_cells} "
          f"cells; JAX set-up {time.perf_counter() - t0:.1f} s", flush=True)

    dev, dt = torch.device("cpu"), torch.float64
    with captured():
        t0 = time.perf_counter()
        tcase = TCase(d, device=dev, dtype=dt, pmesh=pm, lattice=lat)
        tU, tp = tcase.read_field("U"), tcase.read_field("p")
        tturb = tras(tcase, tU)
        tkw = tsimple.step_kwargs_from_case(
            tcase, TControl(tcase), TTransport(tcase.transport_properties()),
            tturb)
        tmesh = t_attach(tcase.mesh, (tkw["u_controls"], tkw["p_controls"]),
                         timings=tcase.setup_seconds)
        t0_state = (tU, tp, tfvc.flux(tmesh, tU), tturb.init_state(tU))
        print(f"port set-up {time.perf_counter() - t0:.1f} s", flush=True)
    same_perm = (np.array_equal(np.asarray(jcase.maps.cell_perm),
                                np.asarray(tcase.maps.cell_perm))
                 if hasattr(tcase.maps, "cell_perm") else None)
    print(f"same device cell order: {same_perm}", flush=True)

    jrec = Recorder(lambda v: np.asarray(v))
    trec = Recorder(lambda v: (v.detach().cpu().numpy()
                               if isinstance(v, torch.Tensor)
                               else np.asarray(v)))
    undo_j = _install(jrec, simple_mod=jsimple, turb_mod=jturbmod,
                      fvc_mod=jfvc, gamg_mod=jgamg, solvers_mod=jsolvers,
                      inv_owner=jnp.linalg, inv_attr="inv")
    undo_t = _install(trec, simple_mod=tsimple, turb_mod=tturbmod,
                      fvc_mod=tfvc, gamg_mod=tgamg, solvers_mod=tsolvers,
                      inv_owner=torch.linalg, inv_attr="inv")

    def run_jax():
        jrec.events.clear()
        t = time.perf_counter()
        with jax.disable_jit():
            out = jsimple.simple_step(jmesh, *j0, **jkw)
        print(f"JAX iteration {time.perf_counter() - t:.1f} s", flush=True)
        return out

    def run_port():
        trec.events.clear()
        t = time.perf_counter()
        with captured():
            out = tsimple.simple_step(tmesh, *t0_state, **tkw)
        print(f"port iteration {time.perf_counter() - t:.1f} s", flush=True)
        return out

    try:
        jout, tout = run_jax(), run_port()
        jev, tev = list(jrec.events), list(trec.events)
        print(f"\n{len(jev)} JAX and {len(tev)} port intermediates",
              flush=True)
        first = None
        for i, ((jn, ja), (tn, ta)) in enumerate(zip(jev, tev)):
            if jn != tn:
                print(f"  #{i}: JAX '{jn}' against port '{tn}': the "
                      "sequences part here")
                break
            rels = {k: _rel(ta[k], ja[k]) for k in ja}
            worst = max(rels.values()) if rels else 0.0
            mark = ""
            if first is None and worst > 1e-12:
                first, mark = jn, "   <- first above 1e-12"
            text = ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
            if jn == "V-cycle":
                r, w = ja["r"], ja["w"]
                cos = float((w * r).sum() / (np.linalg.norm(w)
                                             * np.linalg.norm(r)))
                text += f"; JAX |r|_1 {np.abs(r).sum():.4e}, cos(w, r) " \
                        f"{cos:.4e}"
            if jn == "coarsest dense":
                text += (f"; cond(A) JAX {np.linalg.cond(ja['A']):.4e}"
                         f" port {np.linalg.cond(ta['A']):.4e}"
                         f"; n = {ja['A'].shape[0]}")
                b = np.random.default_rng(0).standard_normal(
                    ja["A"].shape[0])
                text += (f"; |inv b| rel "
                         f"{_rel(ta['inverse'] @ b, ja['inverse'] @ b):.3e}")
            print(f"  #{i} {jn}: {text}{mark}", flush=True)
        print(f"first intermediate above 1e-12: {first}", flush=True)

        def fields(out, to_np):
            U, p, phi, ts, _ = out
            f = {"U": to_np(U.data), "p": to_np(p.data),
                 "phi": to_np(phi.data)}
            f.update({k: to_np(v.data) for k, v in ts.items()})
            return f
        jf = fields(jout, jrec.to_np)
        tf = fields(tout, trec.to_np)
        print("after the iteration, port vs JAX: " + ", ".join(
            f"{k} {_rel(tf[k], jf[k]):.3e}" for k in jf), flush=True)

        if args.perturb:
            jrec.transpose_inverse = trec.transpose_inverse = True
            jf2 = fields(run_jax(), jrec.to_np)
            tf2 = fields(run_port(), trec.to_np)
            print("JAX with inv(A^T)^T vs JAX: " + ", ".join(
                f"{k} {_rel(jf2[k], jf[k]):.3e}" for k in jf), flush=True)
            print("port with inv(A^T)^T vs port: " + ", ".join(
                f"{k} {_rel(tf2[k], tf[k]):.3e}" for k in tf), flush=True)
    finally:
        undo_j()
        undo_t()


if __name__ == "__main__":
    main()
