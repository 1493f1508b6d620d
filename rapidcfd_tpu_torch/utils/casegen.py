"""Case generator — a numpy copy of rapidcfd_tpu/utils/casegen.py's
box_mesh, masked_grid_mesh (by array operations, with its gdia embedding),
cavity_case, pitz_daily_case, forward_step_case, hot_channel_case and
write_field,
plus pitz_daily_ico_case (the pitzDaily mesh under the cavity's icoFoam
dictionaries), tjunction_case (pimpleFoam's T-junction, which the JAX
package has no writer for), the heat-transfer cases the JAX package's
tests write inline (boussinesq_cavity_case, heated_cavity_case,
thermo_channel_case) and hot_room_case, and the turbulence family's
pitz_daily_les_case (pisoFoam's LES tutorial), pitz_daily_ras_case (any RAS
model) and les_channel_case / les_model_channel_case (the JAX tests' LES
channel). These write case files only; the JAX solver runs the same
directories unchanged."""

from __future__ import annotations

import math
import os

import numpy as np

from ..mesh.polymesh import BoundaryPatch, PolyMesh, write_polymesh
from .dictionary import foamfile_header

_STEP_H = 0.0254          # pitzDaily step height / inlet height
_NY_HALF = 20             # cells across the inlet half-height at scale 1


def box_mesh(nx: int, ny: int, nz: int,
             size=(1.0, 1.0, 1.0), origin=(0.0, 0.0, 0.0),
             patch_spec: dict | None = None,
             grading=(1.0, 1.0, 1.0)) -> PolyMesh:
    """Structured hex mesh of a box; patch_spec maps side->(name, type).

    Sides sharing a patch name are merged into one patch; a
    (name, 'cyclic', neighbourPatch) spec carries the coupled-patch
    entry. Simple geometric grading per direction (blockMeshDict
    simpleGrading equivalent). Delegates to the vectorized
    unstructured.box_mesh_fast (identical mesh, million-cell capable —
    the python-loop builder made >500^2 benches take minutes to start).
    """
    from .unstructured import box_mesh_fast

    def coords(n, length, ratio):
        if ratio == 1.0:
            return np.linspace(0.0, length, n + 1)
        r = ratio ** (1.0 / (n - 1)) if n > 1 else 1.0
        widths = r ** np.arange(n)
        widths *= length / widths.sum()
        return np.concatenate([[0.0], np.cumsum(widths)])

    xs = origin[0] + coords(nx, size[0], grading[0])
    ys = origin[1] + coords(ny, size[1], grading[1])
    zs = origin[2] + coords(nz, size[2], grading[2])
    return box_mesh_fast(nx, ny, nz, patch_spec=patch_spec,
                         coords=(xs, ys, zs))


def masked_grid_mesh(xs, ys, zs, mask, patch_rule,
                     lattice_out: dict | None = None) -> PolyMesh:
    """Structured 2D-extruded mesh with blanked cells (backward-facing
    steps, obstacles, T-junctions), built by array operations (a million
    cells in seconds). mask[i,j] selects active cells; patch_rule(i, j,
    side) takes the index arrays of one side's boundary faces, side in
    {xmin,xmax,ymin,ymax,zmin,zmax}, and returns an array of their patch
    names. Patch types are given via patch_rule.types: dict name->type,
    their order by patch_rule.order. Cells are numbered x fastest, then
    y, then z; internal faces are sorted by (owner, neighbour); each
    patch's faces by owner, then side in the order xmax, xmin, ymax,
    ymin, zmax, zmin (the JAX package's cell loop gives the same mesh).
    lattice_out receives the gdia embedding detect_lattice would return:
    the lattice is the grid and the blanked cells are its dead slots.
    """
    xs, ys, zs = map(np.asarray, (xs, ys, zs))
    nx, ny, nz = len(xs) - 1, len(ys) - 1, len(zs) - 1
    mask = np.asarray(mask, dtype=bool)
    if mask.shape != (nx, ny):
        raise ValueError(f"mask shape {mask.shape} != {(nx, ny)}")
    live = np.broadcast_to(mask.T[None], (nz, ny, nx)).ravel()
    slot = np.nonzero(live)[0]                   # cells in slot order
    n_cells = slot.size
    cid = np.full(nz * ny * nx, -1, dtype=np.int64)
    cid[slot] = np.arange(n_cells)
    k, rem = np.divmod(slot, nx * ny)
    j, i = np.divmod(rem, nx)

    def nid(i_, j_, k_):
        return i_ + j_ * (nx + 1) + k_ * (nx + 1) * (ny + 1)

    def nodes(side):
        n = {"xmax": [(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 0, 1)],
             "xmin": [(0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0)],
             "ymax": [(0, 1, 0), (0, 1, 1), (1, 1, 1), (1, 1, 0)],
             "ymin": [(0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1)],
             "zmax": [(0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)],
             "zmin": [(0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 0, 0)]}[side]
        return np.stack([nid(i + a, j + b, k + c) for a, b, c in n], 1)

    own, nei, quads = [], [], []
    bnd = []                                     # (cell, side rank, name, q)
    c = np.arange(n_cells)
    for rank, side in enumerate(("xmax", "xmin", "ymax", "ymin", "zmax",
                                 "zmin")):
        di, dj, dk = {"xmax": (1, 0, 0), "xmin": (-1, 0, 0),
                      "ymax": (0, 1, 0), "ymin": (0, -1, 0),
                      "zmax": (0, 0, 1), "zmin": (0, 0, -1)}[side]
        i_, j_, k_ = i + di, j + dj, k + dk
        ok = (i_ >= 0) & (i_ < nx) & (j_ >= 0) & (j_ < ny) & (k_ >= 0) \
            & (k_ < nz)
        s = np.where(ok, i_ + j_ * nx + k_ * nx * ny, 0)
        has = ok & live[s]
        q = nodes(side)
        if side.endswith("max"):
            own.append(c[has])
            nei.append(cid[s[has]])
            quads.append(q[has])
        b = ~has
        bnd.append((c[b], np.full(int(b.sum()), rank),
                    np.asarray(patch_rule(i[b], j[b], side)), q[b]))
    own, nei = np.concatenate(own), np.concatenate(nei)
    o = np.lexsort((nei, own))
    own, nei = own[o], nei[o]
    owners, faces, patches = [own], [np.concatenate(quads)[o]], []
    start = own.size
    bc, br, bn, bq = (np.concatenate([b[m] for b in bnd]) for m in range(4))
    for name in patch_rule.order:
        sel = np.nonzero(bn == name)[0]
        sel = sel[np.lexsort((br[sel], bc[sel]))]
        owners.append(bc[sel])
        faces.append(bq[sel])
        patches.append(BoundaryPatch(name, patch_rule.types[name], start,
                                     sel.size))
        start += sel.size
    # compact points to the used subset
    flat = np.concatenate(faces).ravel()
    used = np.unique(flat)
    remap = np.full((nx + 1) * (ny + 1) * (nz + 1), -1, dtype=np.int64)
    remap[used] = np.arange(used.size)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    pts = np.stack([X.ravel(order="F"), Y.ravel(order="F"),
                    Z.ravel(order="F")], axis=1)[used]
    owner = np.concatenate(owners)
    if lattice_out is not None:
        n_int, n_lat = nei.size, nz * ny * nx
        slot_cell = np.zeros(n_lat, dtype=np.int64)
        slot_cell[slot] = np.arange(n_cells)
        lattice_out.update(
            shape=(nz, ny, nx), slot_cell=slot_cell,
            ghost_lead=np.arange(n_lat, dtype=np.int64),
            orig_own_int=slot[owner[:n_int]], orig_nei_int=slot[nei],
            orig_own_bnd=slot[owner[n_int:]],
            flip_int=np.zeros(n_int, dtype=bool), dead=~live)
    return PolyMesh(pts, remap[flat],
                    np.arange(owner.size + 1, dtype=np.int64) * 4, owner,
                    nei, patches)


def _pitz_daily_grid(scale: int):
    """(xs, ys, zs, mask) of the pitzDaily step's masked grid."""
    h = _STEP_H
    xs = np.concatenate([np.linspace(-0.0206, 0.0, 12 * scale + 1)[:-1],
                         np.linspace(0.0, 0.29, 100 * scale + 1)])
    ys = np.linspace(-h, h, 2 * _NY_HALF * scale + 1)
    zs = np.array([-0.0005, 0.0005])
    xc = 0.5 * (xs[:-1] + xs[1:])
    yc = 0.5 * (ys[:-1] + ys[1:])
    mask = np.ones((len(xc), len(yc)), dtype=bool)
    mask[np.ix_(xc < 0.0, yc < 0.0)] = False
    return xs, ys, zs, mask


def _pitz_daily_mesh(scale: int,
                     lattice_out: dict | None = None) -> PolyMesh:
    """The backward-facing step (BASELINE config 2's geometry): 12*scale
    upstream and 100*scale downstream columns, 40*scale rows, the
    upstream lower half blanked; lattice_out receives its gdia
    embedding (masked_grid_mesh)."""
    xs, ys, zs, mask = _pitz_daily_grid(scale)
    nx = len(xs) - 1

    def rule(i, j, side):
        if side in ("zmin", "zmax"):
            return np.full(i.shape, "frontAndBack", dtype=object)
        if side == "ymax":
            return np.full(i.shape, "upperWall", dtype=object)
        out = np.full(i.shape, "lowerWall", dtype=object)
        if side == "xmin":
            out[i == 0] = "inlet"
        if side == "xmax":
            out[i == nx - 1] = "outlet"
        return out
    rule.order = ["inlet", "outlet", "upperWall", "lowerWall",
                  "frontAndBack"]
    rule.types = {"inlet": "patch", "outlet": "patch",
                  "upperWall": "wall", "lowerWall": "wall",
                  "frontAndBack": "empty"}
    return masked_grid_mesh(xs, ys, zs, mask, rule, lattice_out)


_ZG = "        type            zeroGradient;\n"
_EMPTY = "        type            empty;\n"


def _fixed(value: str) -> str:
    return ("        type            fixedValue;\n"
            f"        value           uniform {value};\n")


def _write_pitz_u_p(case_dir: str, u_in: float, u_internal: float):
    write_field(case_dir, "0", "p", "volScalarField", "[0 2 -2 0 0 0 0]",
                "uniform 0", {
                    "inlet": _ZG, "outlet": _fixed("0"),
                    "upperWall": _ZG, "lowerWall": _ZG,
                    "frontAndBack": _EMPTY})
    write_field(case_dir, "0", "U", "volVectorField", "[0 1 -1 0 0 0 0]",
                f"uniform ({u_internal} 0 0)", {
                    "inlet": _fixed(f"({u_in} 0 0)"), "outlet": _ZG,
                    "upperWall": _fixed("(0 0 0)"),
                    "lowerWall": _fixed("(0 0 0)"),
                    "frontAndBack": _EMPTY})


def _write_transport(case_dir: str, nu: float):
    _write(os.path.join(case_dir, "constant", "transportProperties"),
           foamfile_header("dictionary", "transportProperties", "constant"),
           f"\ntransportModel  Newtonian;\nnu              nu "
           f"[ 0 2 -1 0 0 0 0 ] {nu};\n")


def pitz_daily_case(case_dir: str, scale: int = 1,
                    u_in: float = 10.0, nu: float = 1e-05,
                    end_time: int = 500, model: str = "kEpsilon",
                    tight_tol: bool = False):
    """Backward-facing-step case in the spirit of the pitzDaily tutorial
    (BASELINE config 2): ~6k cells at scale=1, kEpsilon + wall functions,
    GAMG pressure, SIMPLE with residualControl. The same files as the JAX
    package's pitz_daily_case."""
    h = _STEP_H
    mesh = _pitz_daily_mesh(scale)
    write_polymesh(mesh, case_dir)
    _write(os.path.join(case_dir, "system", "controlDict"),
           foamfile_header("dictionary", "controlDict", "system"), f"""
application     simpleFoam;
startFrom       startTime;
startTime       0;
stopAt          endTime;
endTime         {end_time};
deltaT          1;
writeControl    timeStep;
writeInterval   100;
purgeWrite      0;
writeFormat     ascii;
writePrecision  6;
runTimeModifiable true;
""")
    bnd = "bounded " if "kOmega" not in model else ""
    _write(os.path.join(case_dir, "system", "fvSchemes"),
           foamfile_header("dictionary", "fvSchemes", "system"), f"""
ddtSchemes      {{ default steadyState; }}
gradSchemes     {{ default Gauss linear; }}
divSchemes
{{
    default         none;
    div(phi,U)      {bnd}Gauss upwind;
    div(phi,k)      {bnd}Gauss upwind;
    div(phi,epsilon) {bnd}Gauss upwind;
    div(phi,omega)  {bnd}Gauss upwind;
    div(phi,nuTilda) {bnd}Gauss upwind;
    div((nuEff*dev(T(grad(U))))) Gauss linear;
}}
laplacianSchemes {{ default Gauss linear orthogonal; }}
interpolationSchemes {{ default linear; }}
snGradSchemes   {{ default orthogonal; }}
""")
    p_tol, p_rel, u_tol, u_rel = ("1e-12", "0", "1e-12", "0") \
        if tight_tol else ("1e-06", "0.1", "1e-05", "0.1")
    _write(os.path.join(case_dir, "system", "fvSolution"),
           foamfile_header("dictionary", "fvSolution", "system"), f"""
solvers
{{
    p
    {{
        solver          GAMG;
        tolerance       {p_tol};
        relTol          {p_rel};
        smoother        GaussSeidel;
        nCellsInCoarsestLevel 32;
    }}
    "(U|k|epsilon|omega|nuTilda)"
    {{
        solver          smoothSolver;
        smoother        symGaussSeidel;
        tolerance       {u_tol};
        relTol          {u_rel};
    }}
}}
SIMPLE
{{
    nNonOrthogonalCorrectors 0;
    pRefCell        0;
    pRefValue       0;
    residualControl
    {{
        p               1e-3;
        U               1e-4;
        "(k|epsilon)"   1e-4;
    }}
}}
relaxationFactors
{{
    fields    {{ p 0.3; }}
    equations {{ U 0.7; k 0.7; epsilon 0.7; omega 0.7; nuTilda 0.7; }}
}}
""")
    _write_transport(case_dir, nu)
    _write(os.path.join(case_dir, "constant", "RASProperties"),
           foamfile_header("dictionary", "RASProperties", "constant"),
           f"""
RASModel        {model};
turbulence      on;
printCoeffs     on;
""")

    k_in = 1.5 * (0.05 * u_in) ** 2          # 5% intensity
    eps_in = 0.09 ** 0.75 * k_in ** 1.5 / (0.1 * h)
    _write_pitz_u_p(case_dir, u_in, 0)

    def wall_fn(word, v):
        return (f"        type            {word};\n"
                f"        value           uniform {v};\n")

    write_field(case_dir, "0", "k", "volScalarField", "[0 2 -2 0 0 0 0]",
                f"uniform {k_in}", {
                    "inlet": _fixed(k_in), "outlet": _ZG,
                    "upperWall": wall_fn("kqRWallFunction", k_in),
                    "lowerWall": wall_fn("kqRWallFunction", k_in),
                    "frontAndBack": _EMPTY})
    if "kOmega" in model:
        om_in = eps_in / (0.09 * k_in)
        write_field(case_dir, "0", "omega", "volScalarField",
                    "[0 0 -1 0 0 0 0]", f"uniform {om_in}", {
                        "inlet": _fixed(om_in), "outlet": _ZG,
                        "upperWall": wall_fn("omegaWallFunction", om_in),
                        "lowerWall": wall_fn("omegaWallFunction", om_in),
                        "frontAndBack": _EMPTY})
    else:
        write_field(case_dir, "0", "epsilon", "volScalarField",
                    "[0 2 -3 0 0 0 0]", f"uniform {eps_in}", {
                        "inlet": _fixed(eps_in), "outlet": _ZG,
                        "upperWall": wall_fn("epsilonWallFunction", eps_in),
                        "lowerWall": wall_fn("epsilonWallFunction", eps_in),
                        "frontAndBack": _EMPTY})
    if model == "SpalartAllmaras":
        nt_in = 4.0 * nu
        write_field(case_dir, "0", "nuTilda", "volScalarField",
                    "[0 2 -1 0 0 0 0]", f"uniform {nt_in}", {
                        "inlet": _fixed(nt_in), "outlet": _ZG,
                        "upperWall": _fixed("0"), "lowerWall": _fixed("0"),
                        "frontAndBack": _EMPTY})
    calc0 = ("        type            calculated;\n"
             "        value           uniform 0;\n")
    write_field(case_dir, "0", "nut", "volScalarField", "[0 2 -1 0 0 0 0]",
                "uniform 0", {
                    "inlet": calc0, "outlet": calc0,
                    "upperWall": wall_fn("nutkWallFunction", 0),
                    "lowerWall": wall_fn("nutkWallFunction", 0),
                    "frontAndBack": _EMPTY})
    return mesh


def pitz_daily_ico_dt(scale: int, u_in: float = 1.0) -> float:
    """Time step of pitz_daily_ico_case: Courant 0.5 at u_in on the
    finest cell height."""
    return 0.5 * (_STEP_H / (_NY_HALF * scale)) / u_in


def pitz_daily_ico_case(case_dir: str, scale: int = 1, u_in: float = 1.0,
                        nu: float = 1e-3, tight_tol: bool = False,
                        n_steps: int = 200, write_interval: int = 50):
    """The pitzDaily backward-facing step run by icoFoam: the pitzDaily
    mesh, 0/U and 0/p, and the lid-driven cavity's icoFoam dictionaries
    (p by PCG/DIC, U by PBiCGStab/DILU, PISO with 2 correctors), with a
    time step of Courant ~0.5 at u_in. endTime is n_steps steps.
    tight_tol drives every linear solve to 1e-12 (solver-independent
    steps, for comparisons).

    The interior starts at the inlet velocity, not at rest: from rest the
    first pressure solve is the hardest of the run, and in fp32 the
    solvers' stall guard (100 iterations without a 0.1% drop of the L1
    residual, linalg/solvers.py) cuts it off unconverged; at scale 5 the
    run then diverges within ten steps, in the JAX package as in the
    port."""
    mesh = _pitz_daily_mesh(scale)
    write_polymesh(mesh, case_dir)
    dt = pitz_daily_ico_dt(scale, u_in)
    _write(os.path.join(case_dir, "system", "controlDict"),
           foamfile_header("dictionary", "controlDict", "system"), f"""
application     icoFoam;
startFrom       startTime;
startTime       0;
stopAt          endTime;
endTime         {n_steps * dt!r};
deltaT          {dt!r};
writeControl    timeStep;
writeInterval   {write_interval};
purgeWrite      0;
writeFormat     ascii;
writePrecision  6;
writeCompression off;
timeFormat      general;
timePrecision   6;
runTimeModifiable true;
""")
    _write(os.path.join(case_dir, "system", "fvSchemes"),
           foamfile_header("dictionary", "fvSchemes", "system"), """
ddtSchemes      { default Euler; }
gradSchemes     { default Gauss linear; grad(p) Gauss linear; }
divSchemes      { default none; div(phi,U) Gauss linear; }
laplacianSchemes { default Gauss linear orthogonal; }
interpolationSchemes { default linear; }
snGradSchemes   { default orthogonal; }
fluxRequired    { default no; p; }
""")
    p_tol, p_rel, u_tol = ("1e-12", "0", "1e-12") if tight_tol \
        else ("1e-06", "0.05", "1e-05")
    _write(os.path.join(case_dir, "system", "fvSolution"),
           foamfile_header("dictionary", "fvSolution", "system"), f"""
solvers
{{
    p
    {{
        solver          PCG;
        preconditioner  DIC;
        tolerance       {p_tol};
        relTol          {p_rel};
    }}
    pFinal
    {{
        solver          PCG;
        preconditioner  DIC;
        tolerance       {p_tol};
        relTol          0;
    }}
    U
    {{
        solver          PBiCGStab;
        preconditioner  DILU;
        tolerance       {u_tol};
        relTol          0;
    }}
}}
PISO
{{
    nCorrectors     2;
    nNonOrthogonalCorrectors 0;
    pRefCell        0;
    pRefValue       0;
}}
""")
    _write_transport(case_dir, nu)
    _write_pitz_u_p(case_dir, u_in, u_in)
    return mesh


def cavity_case(case_dir: str, n: int = 20, d: float = 0.1,
                nu: float = 0.01, end_time: float = 0.5,
                delta_t: float = 0.005, write_interval: int = 20,
                p_solver: str = "PCG",
                u_solver: str = "smoothSolver",
                p_precond: str = "DIC", nz: int = 1,
                u_precond: str = "DILU", tight_tol: bool = False,
                write_mesh: bool = True):
    """The icoFoam lid-driven cavity tutorial (BASELINE config 1).
    nz > 1 gives the 3D cavity (front/back become no-slip walls).
    write_mesh=False skips the ascii polyMesh round-trip (big benches:
    pass the returned mesh to Case(pmesh=...))."""
    spec = {
        "ymax": ("movingWall", "wall"),
        "xmin": ("fixedWalls", "wall"),
        "xmax": ("fixedWalls", "wall"),
        "ymin": ("fixedWalls", "wall"),
        "zmin": ("frontAndBack", "empty" if nz == 1 else "wall"),
        "zmax": ("frontAndBack", "empty" if nz == 1 else "wall"),
    }
    mesh = box_mesh(n, n, nz, size=(d, d, 0.01 if nz == 1 else d),
                    patch_spec=spec)
    if write_mesh:
        write_polymesh(mesh, case_dir)
    else:
        os.makedirs(os.path.join(case_dir, "system"), exist_ok=True)

    _write(os.path.join(case_dir, "system", "controlDict"),
           foamfile_header("dictionary", "controlDict", "system"), f"""
application     icoFoam;
startFrom       startTime;
startTime       0;
stopAt          endTime;
endTime         {end_time};
deltaT          {delta_t};
writeControl    timeStep;
writeInterval   {write_interval};
purgeWrite      0;
writeFormat     ascii;
writePrecision  6;
writeCompression off;
timeFormat      general;
timePrecision   6;
runTimeModifiable true;
""")
    _write(os.path.join(case_dir, "system", "fvSchemes"),
           foamfile_header("dictionary", "fvSchemes", "system"), """
ddtSchemes      { default Euler; }
gradSchemes     { default Gauss linear; grad(p) Gauss linear; }
divSchemes      { default none; div(phi,U) Gauss linear; }
laplacianSchemes { default Gauss linear orthogonal; }
interpolationSchemes { default linear; }
snGradSchemes   { default orthogonal; }
fluxRequired    { default no; p; }
""")
    # tight_tol: drive every linear solve to fp64 round-off so the
    # timestep result is solver-algorithm independent (the fp64 8-dev ==
    # 1-chip dryrun check compares against this unique solution)
    p_tol, p_rel, u_tol = ("1e-12", "0", "1e-12") if tight_tol \
        else ("1e-06", "0.05", "1e-05")
    _write(os.path.join(case_dir, "system", "fvSolution"),
           foamfile_header("dictionary", "fvSolution", "system"), f"""
solvers
{{
    p
    {{
        solver          {p_solver};
        preconditioner  {p_precond};
        smoother        Chebyshev;
        mergeLevels     4;
        nCellsInCoarsestLevel 512;
        tolerance       {p_tol};
        relTol          {p_rel};
    }}
    pFinal
    {{
        solver          {p_solver};
        preconditioner  {p_precond};
        smoother        Chebyshev;
        mergeLevels     4;
        nCellsInCoarsestLevel 512;
        tolerance       {p_tol};
        relTol          0;
    }}
    U
    {{
        solver          {u_solver};
        smoother        symGaussSeidel;
        preconditioner  {u_precond};
        vCycleScale     1.0;
        tolerance       {u_tol};
        relTol          0;
    }}
}}
PISO
{{
    nCorrectors     2;
    nNonOrthogonalCorrectors 0;
    pRefCell        0;
    pRefValue       0;
}}
""")
    _write(os.path.join(case_dir, "constant", "transportProperties"),
           foamfile_header("dictionary", "transportProperties", "constant"),
           f"\nnu              nu [ 0 2 -1 0 0 0 0 ] {nu};\n")

    fb_p = ("        type            empty;\n" if nz == 1 else
            "        type            zeroGradient;\n")
    fb_u = ("        type            empty;\n" if nz == 1 else
            "        type            fixedValue;\n"
            "        value           uniform (0 0 0);\n")
    write_field(case_dir, "0", "p", "volScalarField", "[0 2 -2 0 0 0 0]",
                "uniform 0", {
                    "movingWall": "        type            zeroGradient;\n",
                    "fixedWalls": "        type            zeroGradient;\n",
                    "frontAndBack": fb_p,
                })
    write_field(case_dir, "0", "U", "volVectorField", "[0 1 -1 0 0 0 0]",
                "uniform (0 0 0)", {
                    "movingWall":
                        "        type            fixedValue;\n"
                        "        value           uniform (1 0 0);\n",
                    "fixedWalls":
                        "        type            fixedValue;\n"
                        "        value           uniform (0 0 0);\n",
                    "frontAndBack": fb_u,
                })
    return mesh


def _tjunction_mesh(section: int, leg: int, bar: int, depth: int,
                    side: float) -> PolyMesh:
    """The T-junction lattice: an inlet leg of `leg` x `section` cells
    along x, centred on a cross-bar `section` cells wide and `bar` cells
    long along y, extruded `depth` cells in z; cubic cells of side
    side/section."""
    if (bar - section) % 2:
        raise ValueError("bar - section must be even (the leg is centred)")
    h = side / section
    nx, ny = leg + section, bar
    xs = h * np.arange(nx + 1)
    ys = h * (np.arange(ny + 1) - 0.5 * bar)
    zs = h * np.arange(depth + 1)
    mask = np.zeros((nx, ny), dtype=bool)
    j0 = (bar - section) // 2
    mask[:leg, j0:j0 + section] = True
    mask[leg:, :] = True

    def rule(i, j, side_):
        out = np.full(i.shape, "walls", dtype=object)
        if side_ == "xmin":
            out[i == 0] = "inlet"
        if side_ == "ymin":
            out[j == 0] = "outlet1"
        if side_ == "ymax":
            out[j == ny - 1] = "outlet2"
        return out
    rule.order = ["inlet", "outlet1", "outlet2", "walls"]
    rule.types = {"inlet": "patch", "outlet1": "patch", "outlet2": "patch",
                  "walls": "wall"}
    return masked_grid_mesh(xs, ys, zs, mask, rule)


def tjunction_case(case_dir: str, *, section: int = 32, leg: int = 160,
                   bar: int = 128, depth: int | None = None,
                   side: float = 0.05, nu: float = 1e-05,
                   p0_inlet: float = 10.0, delta_t: float = 1e-3,
                   end_time: float = 0.1, max_co: float = 5.0,
                   write_interval: int = 100, model: str = "kEpsilon",
                   write_mesh: bool = True) -> PolyMesh:
    """pimpleFoam on a 3-D T-junction after OpenFOAM's
    incompressible/pimpleFoam/TJunction tutorial: a square duct of side
    `side` (section x depth cells) enters along x the middle of a
    cross-bar along y with an outlet at each end. The inlet holds a total
    pressure p0 = p0_inlet (uniformTotalPressure) and both outlets p0 = 0
    (totalPressure), with pressureInletOutletVelocity on all three;
    the walls are noSlip. kEpsilon with nutkWallFunction, kqRWallFunction
    and epsilonWallFunction, k from turbulentIntensityKineticEnergyInlet
    (intensity 0.05) and epsilon from turbulentMixingLengthDissipation-
    RateInlet (mixing length 0.01 m) at the inlet, inletOutlet at the
    outlets; Euler in time, adjustTimeStep with maxCo; PIMPLE with one
    outer and two pressure correctors; p by GAMG (tolerance 1e-6, relTol
    0.01, pFinal relTol 0), U, k and epsilon by smoothSolver
    symGaussSeidel (1e-5, relTol 0.1, Final relTol 0).

    Departures from the tutorial: the geometry is the one lattice above
    (uniform cells, no grading); p0 at the inlet is a constant (the
    tutorial ramps it from a table, which neither package reads);
    convection is `Gauss upwind` for U as for k and epsilon (the
    tutorial's linearUpwind for U is not ported). The run starts at the
    tutorial's deltaT, 1e-3 s, by default. model="kOmegaSST" writes
    omega in place of epsilon
    (turbulentMixingLengthFrequencyInlet, omegaWallFunction).
    write_mesh=False skips the ascii polyMesh (pass the returned mesh to
    Case(pmesh=...))."""
    depth = section if depth is None else depth
    mesh = _tjunction_mesh(section, leg, bar, depth, side)
    if write_mesh:
        write_polymesh(mesh, case_dir)
    _write(os.path.join(case_dir, "system", "controlDict"),
           foamfile_header("dictionary", "controlDict", "system"), f"""
application     pimpleFoam;
startFrom       startTime;
startTime       0;
stopAt          endTime;
endTime         {end_time};
deltaT          {delta_t};
writeControl    timeStep;
writeInterval   {write_interval};
purgeWrite      0;
writeFormat     ascii;
writePrecision  8;
writeCompression off;
timeFormat      general;
timePrecision   8;
runTimeModifiable false;
adjustTimeStep  yes;
maxCo           {max_co};
""")
    _write(os.path.join(case_dir, "system", "fvSchemes"),
           foamfile_header("dictionary", "fvSchemes", "system"), """
ddtSchemes      { default Euler; }
gradSchemes     { default Gauss linear; }
divSchemes
{
    default         none;
    div(phi,U)      Gauss upwind;
    div(phi,k)      Gauss upwind;
    div(phi,epsilon) Gauss upwind;
    div(phi,omega)  Gauss upwind;
    div((nuEff*dev(T(grad(U))))) Gauss linear;
}
laplacianSchemes { default Gauss linear corrected; }
interpolationSchemes { default linear; }
snGradSchemes   { default corrected; }
""")
    smooth = ("        solver          smoothSolver;\n"
              "        smoother        symGaussSeidel;\n"
              "        tolerance       1e-05;\n")
    gamg = ("        solver          GAMG;\n"
            "        smoother        GaussSeidel;\n"
            "        tolerance       1e-06;\n")
    entries = "".join(
        f"    {name}\n    {{\n{body}        relTol          {rel};\n    }}\n"
        for name, body, rel in (
            ("p", gamg, "0.01"), ("pFinal", gamg, "0"),
            ("U", smooth, "0.1"), ("UFinal", smooth, "0"),
            ("k", smooth, "0.1"), ("kFinal", smooth, "0"),
            ("epsilon", smooth, "0.1"), ("epsilonFinal", smooth, "0"),
            ("omega", smooth, "0.1"), ("omegaFinal", smooth, "0")))
    _write(os.path.join(case_dir, "system", "fvSolution"),
           foamfile_header("dictionary", "fvSolution", "system"), f"""
solvers
{{
{entries}}}
PIMPLE
{{
    nOuterCorrectors 1;
    nCorrectors     2;
    nNonOrthogonalCorrectors 0;
    pRefCell        0;
    pRefValue       0;
}}
relaxationFactors
{{
    equations
    {{
        ".*"            1;
    }}
}}
""")
    _write_transport(case_dir, nu)
    _write(os.path.join(case_dir, "constant", "turbulenceProperties"),
           foamfile_header("dictionary", "turbulenceProperties", "constant"),
           f"\nsimulationType  RAS;\n\nRAS\n{{\n    RASModel        {model};\n"
           "    turbulence      on;\n    printCoeffs     on;\n}\n")

    def entries_of(inlet, outlet, wall):
        return {"inlet": inlet, "outlet1": outlet, "outlet2": outlet,
                "walls": wall}
    piov = ("        type            pressureInletOutletVelocity;\n"
            "        value           uniform (0 0 0);\n")
    write_field(case_dir, "0", "U", "volVectorField", "[0 1 -1 0 0 0 0]",
                "uniform (0 0 0)", entries_of(
                    piov, piov, "        type            noSlip;\n"))
    write_field(case_dir, "0", "p", "volScalarField", "[0 2 -2 0 0 0 0]",
                "uniform 0", entries_of(
                    "        type            uniformTotalPressure;\n"
                    f"        p0              {p0_inlet};\n"
                    f"        value           uniform {p0_inlet};\n",
                    "        type            totalPressure;\n"
                    "        p0              uniform 0;\n"
                    "        value           uniform 0;\n",
                    _ZG))

    def turb(name, dims, value, inlet):
        def typed(word, extra=""):
            return (f"        type            {word};\n{extra}"
                    f"        value           uniform {value};\n")
        write_field(case_dir, "0", name, "volScalarField", dims,
                    f"uniform {value}", entries_of(
                        inlet(typed),
                        typed("inletOutlet", f"        inletValue      "
                                             f"uniform {value};\n"),
                        typed({"k": "kqRWallFunction",
                               "epsilon": "epsilonWallFunction",
                               "omega": "omegaWallFunction"}[name])))
    turb("k", "[0 2 -2 0 0 0 0]", 0.2, lambda t: t(
        "turbulentIntensityKineticEnergyInlet",
        "        intensity       0.05;\n"))
    if model == "kOmegaSST":
        turb("omega", "[0 0 -1 0 0 0 0]", 200 / (0.09 * 0.2), lambda t: t(
            "turbulentMixingLengthFrequencyInlet",
            "        mixingLength    0.01;\n"))
    else:
        turb("epsilon", "[0 2 -3 0 0 0 0]", 200, lambda t: t(
            "turbulentMixingLengthDissipationRateInlet",
            "        mixingLength    0.01;\n"))
    calc = ("        type            calculated;\n"
            "        value           uniform 0;\n")
    write_field(case_dir, "0", "nut", "volScalarField", "[0 2 -1 0 0 0 0]",
                "uniform 0", entries_of(
                    calc, calc, "        type            nutkWallFunction;\n"
                                "        value           uniform 0;\n"))
    return mesh


def _write(path: str, header: str, body: str):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(header + body)


def write_field(case_dir: str, time: str, name: str, cls: str,
                dims: str, internal: str, boundary: dict[str, str],
                fmt: str = "ascii", compress: bool = False):
    """A field file from its entries' text. fmt='binary' marks it a
    binary file (its uniform values stay text, as in the reference's; a
    nonuniform internal field is then given as bytes, as
    fields/io._body_value writes it); compress writes <name>.gz."""
    from ..fields.io import _emit, _header
    lines = [f"\ndimensions      {dims};\n", "\ninternalField   ", internal,
             ";\n", "\nboundaryField\n{\n"]
    for pname, bspec in boundary.items():
        lines.append(f"    {pname}\n    {{\n{bspec}    }}\n")
    lines.append("}\n")
    _emit(os.path.join(case_dir, time, name),
          [_header(cls, name, time, fmt)] + lines, compress)


def forward_step_case(case_dir: str, scale: int = 1, end_time: float = 0.5,
                      delta_t: float = 0.0005, write_mesh: bool = True,
                      write_interval: float = 0.5) -> PolyMesh:
    """Mach-3 flow over a forward step (sonicFoam forwardStep tutorial,
    BASELINE config 4): normalized gas (R=0.714286, Cv=1.78571), inviscid
    walls as slip. A 60 scale x 16 scale lattice over 3 x 1 with the step
    (x > 0.6, y < 0.2) masked out. write_mesh=False skips the ascii
    polyMesh (pass the returned mesh to Case(pmesh=...)); write_interval
    is the controlDict's (in simulated seconds)."""
    nx, ny = 60 * scale, 16 * scale
    xs = np.linspace(0.0, 3.0, nx + 1)
    ys = np.linspace(0.0, 1.0, ny + 1)
    zs = np.array([-0.05, 0.05])
    mask = np.ones((nx, ny), dtype=bool)
    xc = 0.5 * (xs[:-1] + xs[1:])
    yc = 0.5 * (ys[:-1] + ys[1:])
    mask[np.ix_(xc > 0.6, yc < 0.2)] = False

    def rule(i, j, side):
        if side in ("zmin", "zmax"):
            return np.full(i.shape, "frontAndBack", dtype=object)
        out = np.full(i.shape, "obstacle", dtype=object)
        if side == "xmin":
            out[i == 0] = "inlet"
        if side == "xmax":
            out[i == nx - 1] = "outlet"
        return out
    rule.order = ["inlet", "outlet", "obstacle", "frontAndBack"]
    rule.types = {"inlet": "patch", "outlet": "patch",
                  "obstacle": "wall", "frontAndBack": "empty"}
    mesh = masked_grid_mesh(xs, ys, zs, mask, rule)
    if write_mesh:
        write_polymesh(mesh, case_dir)

    _write(os.path.join(case_dir, "system", "controlDict"),
           foamfile_header("dictionary", "controlDict", "system"), f"""
application     sonicFoam;
startFrom       startTime;
startTime       0;
stopAt          endTime;
endTime         {end_time};
deltaT          {delta_t};
writeControl    runTime;
writeInterval   {write_interval};
writeFormat     ascii;
writePrecision  6;
""")
    _write(os.path.join(case_dir, "system", "fvSchemes"),
           foamfile_header("dictionary", "fvSchemes", "system"), """
ddtSchemes      { default Euler; }
gradSchemes     { default Gauss linear; }
divSchemes
{
    default         none;
    div(phi,U)      Gauss limitedLinear 1;
    div(phi,e)      Gauss limitedLinear 1;
    div(phi,Ekp)    Gauss limitedLinear 1;
    div(phid,p)     Gauss limitedLinear 1;
}
laplacianSchemes { default Gauss linear orthogonal; }
interpolationSchemes { default linear; }
snGradSchemes   { default orthogonal; }
""")
    _write(os.path.join(case_dir, "system", "fvSolution"),
           foamfile_header("dictionary", "fvSolution", "system"), """
solvers
{
    p
    {
        solver          PBiCGStab;
        preconditioner  DILU;
        tolerance       1e-09;
        relTol          0.01;
    }
    pFinal
    {
        solver          PBiCGStab;
        preconditioner  DILU;
        tolerance       1e-09;
        relTol          0;
    }
    "(U|e)"
    {
        solver          smoothSolver;
        smoother        symGaussSeidel;
        tolerance       1e-09;
        relTol          0;
    }
}
PISO
{
    nCorrectors     2;
    nNonOrthogonalCorrectors 0;
    pMin            0.02;
    TMin            0.02;
}
""")
    _write(os.path.join(case_dir, "constant", "thermophysicalProperties"),
           foamfile_header("dictionary", "thermophysicalProperties",
                           "constant"), """
thermoType
{
    type            hePsiThermo;
    mixture         pureMixture;
    transport       const;
    thermo          eConst;
    equationOfState perfectGas;
    specie          specie;
    energy          sensibleInternalEnergy;
}
mixture
{
    specie         { nMoles 1; molWeight 11640.3; }
    thermodynamics { Cv 1.78571; Hf 0; }
    transport      { mu 0; Pr 1; }
}
""")
    _write(os.path.join(case_dir, "constant", "turbulenceProperties"),
           foamfile_header("dictionary", "turbulenceProperties",
                           "constant"),
           "\nsimulationType  laminar;\n")

    write_field(case_dir, "0", "p", "volScalarField", "[1 -1 -2 0 0 0 0]",
                "uniform 1", {
                    "inlet": "        type            fixedValue;\n"
                             "        value           uniform 1;\n",
                    "outlet": "        type            zeroGradient;\n",
                    "obstacle": "        type            zeroGradient;\n",
                    "frontAndBack": "        type            empty;\n"})
    write_field(case_dir, "0", "T", "volScalarField", "[0 0 0 1 0 0 0]",
                "uniform 1", {
                    "inlet": "        type            fixedValue;\n"
                             "        value           uniform 1;\n",
                    "outlet": "        type            zeroGradient;\n",
                    "obstacle": "        type            zeroGradient;\n",
                    "frontAndBack": "        type            empty;\n"})
    write_field(case_dir, "0", "U", "volVectorField", "[0 1 -1 0 0 0 0]",
                "uniform (3 0 0)", {
                    "inlet": "        type            fixedValue;\n"
                             "        value           uniform (3 0 0);\n",
                    "outlet": "        type            zeroGradient;\n",
                    "obstacle": "        type            slip;\n",
                    "frontAndBack": "        type            empty;\n"})
    return mesh


def hot_channel_case(case_dir: str, nx: int = 50, ny: int = 10,
                     end_time: int = 200, u_in: float = 10.0,
                     write_mesh: bool = True) -> PolyMesh:
    """Subsonic heated-channel case for rhoSimpleFoam (air, hot walls):
    a 1 x 0.1 m box of nx x ny cells, laminar (no turbulenceProperties).
    write_mesh=False skips the ascii polyMesh."""
    mesh = box_mesh(nx, ny, 1, size=(1.0, 0.1, 0.01), patch_spec={
        "xmin": ("inlet", "patch"),
        "xmax": ("outlet", "patch"),
        "ymin": ("walls", "wall"),
        "ymax": ("walls", "wall"),
        "zmin": ("frontAndBack", "empty"),
        "zmax": ("frontAndBack", "empty"),
    })
    if write_mesh:
        write_polymesh(mesh, case_dir)
    _write(os.path.join(case_dir, "system", "controlDict"),
           foamfile_header("dictionary", "controlDict", "system"), f"""
application     rhoSimpleFoam;
startFrom       startTime;
startTime       0;
stopAt          endTime;
endTime         {end_time};
deltaT          1;
writeControl    timeStep;
writeInterval   {end_time};
writeFormat     ascii;
""")
    _write(os.path.join(case_dir, "system", "fvSchemes"),
           foamfile_header("dictionary", "fvSchemes", "system"), """
ddtSchemes      { default steadyState; }
gradSchemes     { default Gauss linear; }
divSchemes
{
    default         none;
    div(phi,U)      bounded Gauss upwind;
    div(phi,h)      bounded Gauss upwind;
}
laplacianSchemes { default Gauss linear orthogonal; }
interpolationSchemes { default linear; }
snGradSchemes   { default orthogonal; }
""")
    _write(os.path.join(case_dir, "system", "fvSolution"),
           foamfile_header("dictionary", "fvSolution", "system"), """
solvers
{
    p
    {
        solver          GAMG;
        smoother        GaussSeidel;
        tolerance       1e-08;
        relTol          0.05;
    }
    "(U|h)"
    {
        solver          smoothSolver;
        smoother        symGaussSeidel;
        tolerance       1e-08;
        relTol          0.1;
    }
}
SIMPLE
{
    nNonOrthogonalCorrectors 0;
    pRefCell        0;
    pRefValue       100000;
    residualControl { p 1e-4; U 1e-5; h 1e-5; }
}
relaxationFactors
{
    fields    { p 0.3; rho 0.05; }
    equations { U 0.7; h 0.7; }
}
""")
    _write(os.path.join(case_dir, "constant", "thermophysicalProperties"),
           foamfile_header("dictionary", "thermophysicalProperties",
                           "constant"), """
thermoType
{
    type            heRhoThermo;
    mixture         pureMixture;
    transport       const;
    thermo          hConst;
    equationOfState perfectGas;
    specie          specie;
    energy          sensibleEnthalpy;
}
mixture
{
    specie         { nMoles 1; molWeight 28.9; }
    thermodynamics { Cp 1005; Hf 0; }
    transport      { mu 1.8e-05; Pr 0.7; }
}
""")
    write_field(case_dir, "0", "p", "volScalarField", "[1 -1 -2 0 0 0 0]",
                "uniform 100000", {
                    "inlet": "        type            zeroGradient;\n",
                    "outlet": "        type            fixedValue;\n"
                              "        value           uniform 100000;\n",
                    "walls": "        type            zeroGradient;\n",
                    "frontAndBack": "        type            empty;\n"})
    write_field(case_dir, "0", "T", "volScalarField", "[0 0 0 1 0 0 0]",
                "uniform 300", {
                    "inlet": "        type            fixedValue;\n"
                             "        value           uniform 300;\n",
                    "outlet": "        type            zeroGradient;\n",
                    "walls": "        type            fixedValue;\n"
                             "        value           uniform 350;\n",
                    "frontAndBack": "        type            empty;\n"})
    write_field(case_dir, "0", "U", "volVectorField", "[0 1 -1 0 0 0 0]",
                f"uniform ({u_in} 0 0)", {
                    "inlet": "        type            fixedValue;\n"
                             f"        value           uniform ({u_in} 0 0);\n",
                    "outlet": "        type            zeroGradient;\n",
                    "walls": "        type            fixedValue;\n"
                             "        value           uniform (0 0 0);\n",
                    "frontAndBack": "        type            empty;\n"})
    return mesh


def rhocentral_forward_step_case(case_dir: str, scale: int = 1,
                                 viscous: bool = False,
                                 end_time: float = 1.0,
                                 adjust_time_step: bool = False,
                                 write_mesh: bool = True) -> PolyMesh:
    """rhoCentralFoam on the Mach-3 forward step (OpenFOAM's
    compressible/rhoCentralFoam/forwardStep tutorial): forward_step_case's
    mesh, fields and gas with the controlDict and fvSchemes of
    tests/test_compressible.py's rhoCentralFoam tests (Kurganov fluxes,
    reconstruct(rho|T) vanLeer and reconstruct(U) vanLeerV, Euler,
    deltaT 0.002/scale, which keeps the Courant number near 0.2 at every
    scale). viscous=True sets mu 0.002 as the viscous test does.
    adjust_time_step writes adjustTimeStep yes with maxCo 0.2 and
    maxDeltaT 0.003.
    Departures from the tutorial: a uniform lattice, inviscid slip walls
    (the tutorial's walls are slip too), no write during the run
    (writeInterval 10000 steps). write_mesh=False skips the ascii
    polyMesh."""
    delta_t = 0.002 / scale
    mesh = forward_step_case(case_dir, scale=scale, end_time=end_time,
                             delta_t=delta_t, write_mesh=write_mesh)
    adjust = ("adjustTimeStep yes; maxCo 0.2; maxDeltaT 0.003;\n"
              if adjust_time_step else "")
    _write(os.path.join(case_dir, "system", "controlDict"),
           foamfile_header("dictionary", "controlDict", "system"), f"""
application rhoCentralFoam; startFrom startTime; startTime 0;
stopAt endTime; endTime {end_time}; deltaT {delta_t};
writeControl timeStep; writeInterval 10000; writeFormat ascii;
{adjust}""")
    _write(os.path.join(case_dir, "system", "fvSchemes"),
           foamfile_header("dictionary", "fvSchemes", "system"), """
fluxScheme      Kurganov;
ddtSchemes { default Euler; }
gradSchemes { default Gauss linear; }
divSchemes { default none; }
laplacianSchemes { default Gauss linear corrected; }
interpolationSchemes
{
    default         linear;
    reconstruct(rho) vanLeer;
    reconstruct(U)  vanLeerV;
    reconstruct(T)  vanLeer;
}
snGradSchemes { default corrected; }
""")
    if viscous:
        tp = os.path.join(case_dir, "constant", "thermophysicalProperties")
        with open(tp) as f:
            body = f.read()
        with open(tp, "w") as f:
            f.write(body.replace("mu 0;", "mu 0.002;"))
    return mesh


def transient_hot_channel_case(case_dir: str, nx: int = 50, ny: int = 10,
                               end_time: float = 0.01, lts: bool = False,
                               p_solver: str = "PCG",
                               write_mesh: bool = True) -> PolyMesh:
    """rhoPimpleFoam (lts=True: rhoLTSPimpleFoam) on the heated channel:
    hot_channel_case's mesh, fields and air with the controlDict,
    fvSchemes and fvSolution of tests/test_compressible.py's transient
    tests (Euler or localEuler, Gauss upwind for U, h and K, PIMPLE 1 x 2;
    under LTS maxCo 0.5, rDeltaTSmoothingCoeff 0.02, rDeltaTDampingCoeff
    0.5, maxDeltaT 0.01 and deltaT 0.0005, which only advances the
    clock). deltaT is 0.0002 * 50/nx, which keeps that case's Courant
    number (~0.1) at every width. p_solver: "PCG" (DIC, the tests' setup)
    or "GAMG" (GaussSeidel smoother, the heated channel's steady setup),
    relTol 0.01 and 0 for pFinal either way. Departures: the tests write
    only at the end (writeInterval 1000 steps) and so does this case;
    "(U|h)" solve to 1e-8 with relTol 0, as the tests do.
    write_mesh=False skips the ascii polyMesh."""
    if p_solver not in ("PCG", "GAMG"):
        raise ValueError(f"p_solver must be PCG or GAMG, got '{p_solver}'")
    mesh = hot_channel_case(case_dir, nx=nx, ny=ny, write_mesh=write_mesh)
    app, ddt, delta_t = (("rhoLTSPimpleFoam", "localEuler", 0.0005) if lts
                         else ("rhoPimpleFoam", "Euler", 0.0002 * 50 / nx))
    _write(os.path.join(case_dir, "system", "controlDict"),
           foamfile_header("dictionary", "controlDict", "system"), f"""
application {app}; startFrom startTime; startTime 0;
stopAt endTime; endTime {end_time}; deltaT {delta_t};
writeControl timeStep; writeInterval 1000; writeFormat ascii;
""")
    _write(os.path.join(case_dir, "system", "fvSchemes"),
           foamfile_header("dictionary", "fvSchemes", "system"), f"""
ddtSchemes {{ default {ddt}; }}
gradSchemes {{ default Gauss linear; }}
divSchemes
{{
    default none;
    div(phi,U) Gauss upwind;
    div(phi,h) Gauss upwind;
    div(phi,K) Gauss upwind;
}}
laplacianSchemes {{ default Gauss linear orthogonal; }}
interpolationSchemes {{ default linear; }}
snGradSchemes {{ default orthogonal; }}
""")
    p_spec = ("solver PCG; preconditioner DIC;" if p_solver == "PCG"
              else "solver GAMG; smoother GaussSeidel;")
    lts_controls = ("\n         maxCo 0.5; rDeltaTSmoothingCoeff 0.02;\n"
                    "         rDeltaTDampingCoeff 0.5; maxDeltaT 0.01;"
                    if lts else "")
    _write(os.path.join(case_dir, "system", "fvSolution"),
           foamfile_header("dictionary", "fvSolution", "system"), f"""
solvers
{{
    p      {{ {p_spec} tolerance 1e-08; relTol 0.01; }}
    pFinal {{ {p_spec} tolerance 1e-08; relTol 0; }}
    "(U|h)" {{ solver smoothSolver; smoother symGaussSeidel;
              tolerance 1e-08; relTol 0; }}
    "(U|h)Final" {{ solver smoothSolver; smoother symGaussSeidel;
                   tolerance 1e-08; relTol 0; }}
}}
PIMPLE {{ nOuterCorrectors 1; nCorrectors 2;
         nNonOrthogonalCorrectors 0;{lts_controls} }}
""")
    return mesh


def dam_break_case(case_dir: str, n: int = 23, end_time: float = 0.1,
                   delta_t: float = 0.001, mules_corr: bool = False,
                   n_alpha_sub: int = 1, write_mesh: bool = True,
                   lattice_out: dict | None = None):
    """Closed-box dam break for interFoam (water column collapse; closed
    lid keeps total water volume exactly conserved — a strong MULES
    check). write_mesh=False skips the ascii polyMesh (a million cells):
    the returned PolyMesh then goes to Case(pmesh=, lattice=), and
    lattice_out receives its gdia embedding (the box itself, cells in
    lattice order, no dead slot; detect_lattice(full_box=True)'s)."""
    from ..mesh.geometry import cell_centres_and_vols, face_centres_and_areas
    from ..fields.io import _body_value

    L = 0.584
    mesh = box_mesh(n, n, 1, size=(L, L, 0.0146), patch_spec={
        "xmin": ("walls", "wall"), "xmax": ("walls", "wall"),
        "ymin": ("walls", "wall"), "ymax": ("walls", "wall"),
        "zmin": ("frontAndBack", "empty"),
        "zmax": ("frontAndBack", "empty"),
    })
    if write_mesh:
        write_polymesh(mesh, case_dir)
    if lattice_out is not None:
        n_int = mesh.n_internal_faces
        lattice_out.update(
            shape=(1, n, n), slot_cell=np.arange(n * n, dtype=np.int64),
            ghost_lead=np.arange(n * n, dtype=np.int64),
            orig_own_int=mesh.owner[:n_int].copy(),
            orig_nei_int=mesh.neighbour.copy(),
            orig_own_bnd=mesh.owner[n_int:].copy(),
            flip_int=np.zeros(n_int, dtype=bool),
            dead=np.zeros(n * n, dtype=bool))
    Cf, Sf = face_centres_and_areas(mesh)
    C, V = cell_centres_and_vols(mesh, Cf, Sf)
    alpha0 = ((C[:, 0] < 0.25 * L) & (C[:, 1] < 0.5 * L)).astype(float)

    _write(os.path.join(case_dir, "system", "controlDict"),
           foamfile_header("dictionary", "controlDict", "system"), f"""
application     interFoam;
startFrom       startTime;
startTime       0;
stopAt          endTime;
endTime         {end_time};
deltaT          {delta_t};
writeControl    runTime;
writeInterval   {end_time};
writeFormat     ascii;
adjustTimeStep  no;
maxCo           0.5;
""")
    _write(os.path.join(case_dir, "system", "fvSchemes"),
           foamfile_header("dictionary", "fvSchemes", "system"), """
ddtSchemes      { default Euler; }
gradSchemes     { default Gauss linear; }
divSchemes
{
    default         none;
    div(phi,alpha)  Gauss vanLeer;
    div(phirb,alpha) Gauss linear;
    div(rhoPhi,U)   Gauss upwind;
}
laplacianSchemes { default Gauss linear orthogonal; }
interpolationSchemes { default linear; }
snGradSchemes   { default orthogonal; }
""")
    alpha_block = f"""
    alpha1
    {{
        nAlphaSubCycles {n_alpha_sub};
        cAlpha          1;
        MULESCorr       {"yes" if mules_corr else "no"};
        nAlphaCorr      2;
        nLimiterIter    3;
        solver          smoothSolver;
        smoother        symGaussSeidel;
        tolerance       1e-8;
        relTol          0;
    }}"""
    _write(os.path.join(case_dir, "system", "fvSolution"),
           foamfile_header("dictionary", "fvSolution", "system"), """
solvers
{""" + alpha_block + """
    p_rgh
    {
        solver          PCG;
        preconditioner  DIC;
        tolerance       1e-07;
        relTol          0.05;
    }
    p_rghFinal
    {
        solver          PCG;
        preconditioner  DIC;
        tolerance       1e-07;
        relTol          0;
    }
    U
    {
        solver          smoothSolver;
        smoother        symGaussSeidel;
        tolerance       1e-06;
        relTol          0;
    }
}
PIMPLE
{
    momentumPredictor no;
    nOuterCorrectors 1;
    nCorrectors     3;
    nNonOrthogonalCorrectors 0;
    nAlphaSubCycles 1;
    pRefCell        0;
    pRefValue       0;
}
""")
    _write(os.path.join(case_dir, "constant", "transportProperties"),
           foamfile_header("dictionary", "transportProperties", "constant"),
           """
phases          (water air);
water { rho rho [1 -3 0 0 0 0 0] 1000; nu nu [0 2 -1 0 0 0 0] 1e-06; }
air   { rho rho [1 -3 0 0 0 0 0] 1;    nu nu [0 2 -1 0 0 0 0] 1.48e-05; }
sigma           sigma [1 0 -2 0 0 0 0] 0.07;
""")
    _write(os.path.join(case_dir, "constant", "g"),
           foamfile_header("uniformDimensionedVectorField", "g", "constant"),
           "\ndimensions      [0 1 -2 0 0 0 0];\nvalue           (0 -9.81 0);\n")

    wall_a = "        type            zeroGradient;\n"
    write_field(case_dir, "0", "alpha1", "volScalarField", "[0 0 0 0 0 0 0]",
                "nonuniform List<scalar>\n"
                + _body_value(alpha0).split("nonuniform List<scalar>\n")[-1]
                if alpha0.std() > 0 else "uniform 0",
                {"walls": wall_a, "frontAndBack":
                 "        type            empty;\n"})
    write_field(case_dir, "0", "p_rgh", "volScalarField", "[1 -1 -2 0 0 0 0]",
                "uniform 0", {"walls": wall_a, "frontAndBack":
                              "        type            empty;\n"})
    write_field(case_dir, "0", "U", "volVectorField", "[0 1 -1 0 0 0 0]",
                "uniform (0 0 0)", {
                    "walls": "        type            fixedValue;\n"
                             "        value           uniform (0 0 0);\n",
                    "frontAndBack": "        type            empty;\n"})
    return mesh


def depth_charge_case(case_dir: str, n: int = 24, end_time: float = 5e-4,
                      delta_t: float = 1e-5):
    """compressibleInterFoam depth charge: a high-pressure air bubble in
    water inside a closed 2D box (reference tutorial family:
    multiphase/compressibleInterFoam/laminar/depthCharge2D)."""
    from ..mesh.geometry import cell_centres_and_vols, face_centres_and_areas
    from ..fields.io import _body_value

    L = 1.0
    mesh = box_mesh(n, n, 1, size=(L, L, L / n), patch_spec={
        "xmin": ("walls", "wall"), "xmax": ("walls", "wall"),
        "ymin": ("walls", "wall"), "ymax": ("walls", "wall"),
        "zmin": ("frontAndBack", "empty"),
        "zmax": ("frontAndBack", "empty"),
    })
    write_polymesh(mesh, case_dir)
    Cf, Sf = face_centres_and_areas(mesh)
    C, V = cell_centres_and_vols(mesh, Cf, Sf)
    r = np.sqrt((C[:, 0] - 0.5 * L) ** 2 + (C[:, 1] - 0.5 * L) ** 2)
    bubble = r < 0.15 * L
    alpha0 = (~bubble).astype(float)          # water = phase 1
    p0 = np.where(bubble, 1e6, 1e5)

    _write(os.path.join(case_dir, "system", "controlDict"),
           foamfile_header("dictionary", "controlDict", "system"), f"""
application     compressibleInterFoam;
startFrom       startTime;
startTime       0;
stopAt          endTime;
endTime         {end_time};
deltaT          {delta_t};
writeControl    runTime;
writeInterval   {end_time};
writeFormat     ascii;
adjustTimeStep  no;
maxCo           0.5;
""")
    _write(os.path.join(case_dir, "system", "fvSchemes"),
           foamfile_header("dictionary", "fvSchemes", "system"), """
ddtSchemes      { default Euler; }
gradSchemes     { default Gauss linear; }
divSchemes
{
    default         none;
    div(phi,alpha)  Gauss vanLeer;
    div(phirb,alpha) Gauss linear;
    div(rhoPhi,U)   Gauss upwind;
    div(phi,p)      Gauss upwind;
    div(rhoPhi,T)   Gauss upwind;
}
laplacianSchemes { default Gauss linear orthogonal; }
interpolationSchemes { default linear; }
snGradSchemes   { default orthogonal; }
""")
    _write(os.path.join(case_dir, "system", "fvSolution"),
           foamfile_header("dictionary", "fvSolution", "system"), """
solvers
{
    alpha.water { nAlphaSubCycles 2; cAlpha 1; }
    p_rgh
    {
        solver          PCG;
        preconditioner  DIC;
        tolerance       1e-08;
        relTol          0.01;
    }
    p_rghFinal
    {
        solver          PCG;
        preconditioner  DIC;
        tolerance       1e-08;
        relTol          0;
    }
    T
    {
        solver          PBiCGStab;
        preconditioner  DILU;
        tolerance       1e-08;
        relTol          0;
    }
    U
    {
        solver          PBiCGStab;
        preconditioner  DILU;
        tolerance       1e-08;
        relTol          0;
    }
}
PIMPLE
{
    momentumPredictor no;
    nOuterCorrectors 1;
    nCorrectors     2;
    nNonOrthogonalCorrectors 0;
    nAlphaSubCycles 2;
}
""")
    _write(os.path.join(case_dir, "constant", "thermophysicalProperties"),
           foamfile_header("dictionary", "thermophysicalProperties",
                           "constant"), """
phases          (water air);
pMin            pMin [1 -1 -2 0 0 0 0] 10000;
sigma           sigma [1 0 -2 0 0 0 0] 0.07;
""")
    _write(os.path.join(case_dir, "constant",
                        "thermophysicalProperties.water"),
           foamfile_header("dictionary", "thermophysicalProperties.water",
                           "constant"), """
thermoType
{
    type            heRhoThermo;
    mixture         pureMixture;
    transport       const;
    thermo          hConst;
    equationOfState perfectFluid;
    specie          specie;
    energy          sensibleInternalEnergy;
}
mixture
{
    specie          { nMoles 1; molWeight 18.0; }
    equationOfState { R 3000; rho0 1027; }
    thermodynamics  { Cp 4195; Hf 0; }
    transport       { mu 3.645e-4; Pr 2.289; }
}
""")
    _write(os.path.join(case_dir, "constant",
                        "thermophysicalProperties.air"),
           foamfile_header("dictionary", "thermophysicalProperties.air",
                           "constant"), """
thermoType
{
    type            hePsiThermo;
    mixture         pureMixture;
    transport       const;
    thermo          hConst;
    equationOfState perfectGas;
    specie          specie;
    energy          sensibleInternalEnergy;
}
mixture
{
    specie          { nMoles 1; molWeight 28.9; }
    thermodynamics  { Cp 1007; Hf 0; }
    transport       { mu 1.84e-5; Pr 0.7; }
}
""")
    _write(os.path.join(case_dir, "constant", "g"),
           foamfile_header("uniformDimensionedVectorField", "g", "constant"),
           "\ndimensions      [0 1 -2 0 0 0 0];\n"
           "value           (0 -9.81 0);\n")

    wall_zg = "        type            zeroGradient;\n"
    emp = "        type            empty;\n"
    write_field(case_dir, "0", "alpha.water", "volScalarField",
                "[0 0 0 0 0 0 0]", _body_value(alpha0),
                {"walls": wall_zg, "frontAndBack": emp})
    write_field(case_dir, "0", "p_rgh", "volScalarField",
                "[1 -1 -2 0 0 0 0]", _body_value(p0),
                {"walls": wall_zg, "frontAndBack": emp})
    write_field(case_dir, "0", "p", "volScalarField",
                "[1 -1 -2 0 0 0 0]", _body_value(p0),
                {"walls": wall_zg, "frontAndBack": emp})
    write_field(case_dir, "0", "T", "volScalarField",
                "[0 0 0 1 0 0 0]", "uniform 300",
                {"walls": wall_zg, "frontAndBack": emp})
    write_field(case_dir, "0", "U", "volVectorField", "[0 1 -1 0 0 0 0]",
                "uniform (0 0 0)", {
                    "walls": "        type            fixedValue;\n"
                             "        value           uniform (0 0 0);\n",
                    "frontAndBack": emp})
    return mesh


def bubble_column_case(case_dir: str, nx: int = 12, ny: int = 30,
                       end_time: float = 0.05, delta_t: float = 1e-3,
                       turbulence: str | None = None,
                       forces: bool = False):
    """twoPhaseEulerFoam bubble column: air initially in the lower half
    of a closed water box rises under buoyancy against SchillerNaumann
    drag (reference tutorial family: multiphase/twoPhaseEulerFoam/
    bubbleColumn). turbulence='mixtureKEpsilon'/'LaheyKEpsilon' adds
    turbulenceProperties.<phase> + k/epsilon fields; forces=True turns
    on the Tomiyama lift + Frank wall lubrication + Burns turbulent
    dispersion closures (reference bubbleColumnEvaporatingReacting
    tutorial set)."""
    from ..mesh.geometry import cell_centres_and_vols, face_centres_and_areas
    from ..fields.io import _body_value

    W, H = 0.15, 1.0
    mesh = box_mesh(nx, ny, 1, size=(W, H, 0.05), patch_spec={
        "xmin": ("walls", "wall"), "xmax": ("walls", "wall"),
        "ymin": ("walls", "wall"), "ymax": ("walls", "wall"),
        "zmin": ("frontAndBack", "empty"),
        "zmax": ("frontAndBack", "empty"),
    })
    write_polymesh(mesh, case_dir)
    Cf, Sf = face_centres_and_areas(mesh)
    C, V = cell_centres_and_vols(mesh, Cf, Sf)
    alpha0 = np.where(C[:, 1] < 0.5 * H, 0.1, 0.0)

    _write(os.path.join(case_dir, "system", "controlDict"),
           foamfile_header("dictionary", "controlDict", "system"), f"""
application     twoPhaseEulerFoam;
startFrom       startTime;
startTime       0;
stopAt          endTime;
endTime         {end_time};
deltaT          {delta_t};
writeControl    runTime;
writeInterval   {end_time};
writeFormat     ascii;
adjustTimeStep  no;
maxCo           0.5;
""")
    _write(os.path.join(case_dir, "system", "fvSchemes"),
           foamfile_header("dictionary", "fvSchemes", "system"), """
ddtSchemes      { default Euler; }
gradSchemes     { default Gauss linear; }
divSchemes      { default Gauss upwind; div(phi,alpha.air) Gauss vanLeer; }
laplacianSchemes { default Gauss linear orthogonal; }
interpolationSchemes { default linear; }
snGradSchemes   { default orthogonal; }
""")
    _write(os.path.join(case_dir, "system", "fvSolution"),
           foamfile_header("dictionary", "fvSolution", "system"), """
solvers
{
    "alpha.air.*" { nAlphaSubCycles 2; nAlphaCorr 1; }
    p
    {
        solver          PCG;
        preconditioner  DIC;
        tolerance       1e-08;
        relTol          0.01;
    }
    pFinal
    {
        solver          PCG;
        preconditioner  DIC;
        tolerance       1e-08;
        relTol          0;
    }
    T
    {
        solver          PBiCGStab;
        preconditioner  DILU;
        tolerance       1e-08;
        relTol          0;
    }
}
PIMPLE
{
    nOuterCorrectors 1;
    nCorrectors      2;
    nNonOrthogonalCorrectors 0;
}
""")
    _write(os.path.join(case_dir, "constant", "phaseProperties"),
           foamfile_header("dictionary", "phaseProperties", "constant"), """
phases          (air water);

air
{
    diameterModel   constant;
    constantCoeffs  { d  d [0 1 0 0 0 0 0] 3e-3; }
    alphaMax        0.62;
    residualAlpha   1e-6;
}
water
{
    diameterModel   constant;
    constantCoeffs  { d  d [0 1 0 0 0 0 0] 1e-4; }
    residualAlpha   1e-6;
}

drag            { type SchillerNaumann; }
virtualMass     { type constantCoefficient; Cvm 0.5; }
heatTransfer    { type RanzMarshall; }
sigma           sigma [1 0 -2 0 0 0 0] 0.07;
""" + ("""
lift            { type Tomiyama; }
turbulentDispersion { type Burns; sigma 0.9; }
wallLubrication { type Frank; Cwd 6.8; Cwc 10; p 1.7; }
""" if forces else """
lift            { type none; }
turbulentDispersion { type none; }
wallLubrication { type none; }
""") + """
pMin            pMin [1 -1 -2 0 0 0 0] 10000;
""")
    _write(os.path.join(case_dir, "constant",
                        "thermophysicalProperties.air"),
           foamfile_header("dictionary", "thermophysicalProperties.air",
                           "constant"), """
thermoType
{
    type            hePsiThermo;
    mixture         pureMixture;
    transport       const;
    thermo          hConst;
    equationOfState perfectGas;
    specie          specie;
    energy          sensibleInternalEnergy;
}
mixture
{
    specie          { nMoles 1; molWeight 28.9; }
    thermodynamics  { Cp 1007; Hf 0; }
    transport       { mu 1.84e-5; Pr 0.7; }
}
""")
    _write(os.path.join(case_dir, "constant",
                        "thermophysicalProperties.water"),
           foamfile_header("dictionary",
                           "thermophysicalProperties.water",
                           "constant"), """
thermoType
{
    type            heRhoThermo;
    mixture         pureMixture;
    transport       const;
    thermo          hConst;
    equationOfState perfectFluid;
    specie          specie;
    energy          sensibleInternalEnergy;
}
mixture
{
    specie          { nMoles 1; molWeight 18.0; }
    equationOfState { R 3000; rho0 1027; }
    thermodynamics  { Cp 4195; Hf 0; }
    transport       { mu 1.0e-3; Pr 7.0; }
}
""")
    _write(os.path.join(case_dir, "constant", "g"),
           foamfile_header("uniformDimensionedVectorField", "g",
                           "constant"),
           "\ndimensions      [0 1 -2 0 0 0 0];\n"
           "value           (0 -9.81 0);\n")

    zg = "        type            zeroGradient;\n"
    emp = "        type            empty;\n"
    noslip = ("        type            fixedValue;\n"
              "        value           uniform (0 0 0);\n")
    write_field(case_dir, "0", "alpha.air", "volScalarField",
                "[0 0 0 0 0 0 0]", _body_value(alpha0),
                {"walls": zg, "frontAndBack": emp})
    write_field(case_dir, "0", "p", "volScalarField",
                "[1 -1 -2 0 0 0 0]", "uniform 1e5",
                {"walls": zg, "frontAndBack": emp})
    for name in ("T.air", "T.water"):
        write_field(case_dir, "0", name, "volScalarField",
                    "[0 0 0 1 0 0 0]", "uniform 300",
                    {"walls": zg, "frontAndBack": emp})
    for name in ("U.air", "U.water"):
        write_field(case_dir, "0", name, "volVectorField",
                    "[0 1 -1 0 0 0 0]", "uniform (0 0 0)",
                    {"walls": noslip, "frontAndBack": emp})
    if turbulence:
        for ph in ("air", "water"):
            _write(os.path.join(case_dir, "constant",
                                f"turbulenceProperties.{ph}"),
                   foamfile_header("dictionary",
                                   f"turbulenceProperties.{ph}",
                                   "constant"), f"""
simulationType  RAS;
RAS
{{
    RASModel        {turbulence};
    turbulence      on;
    printCoeffs     on;
}}
""")
        write_field(case_dir, "0", "k.water", "volScalarField",
                    "[0 2 -2 0 0 0 0]", "uniform 1e-4",
                    {"walls": zg, "frontAndBack": emp})
        write_field(case_dir, "0", "epsilon.water", "volScalarField",
                    "[0 2 -3 0 0 0 0]", "uniform 1e-4",
                    {"walls": zg, "frontAndBack": emp})
        # k/epsilon solver controls for the mixture system
        fvs = os.path.join(case_dir, "system", "fvSolution")
        txt = open(fvs).read()
        txt = txt.replace(
            "solvers\n{", "solvers\n{\n"
            '    "(k|epsilon)" { solver PBiCGStab; preconditioner '
            "DILU;\n                    tolerance 1e-08; relTol 0; }")
        open(fvs, "w").write(txt)
    return mesh


def wedge_mesh(nx: int = 10, nr: int = 12, r0: float = 0.5,
               r1: float = 1.5, length: float = 1.0,
               angle_deg: float = 5.0) -> PolyMesh:
    """Axisymmetric wedge mesh about the x-axis: one cell thick in the
    circumferential direction with `wedge` front/back patches (reference
    mesh form consumed by wedgePolyPatch, SURVEY §2.3; the annulus
    [r0, r1] avoids collapsed axis faces). Patches: inner (r=r0),
    outer (r=r1), left (x=0), right (x=length), front/back (wedge)."""
    m = box_mesh(nx, nr, 1, size=(length, r1 - r0, 1.0),
                 origin=(0.0, r0, 0.0),
                 patch_spec={
                     "xmin": ("left", "patch"),
                     "xmax": ("right", "patch"),
                     "ymin": ("inner", "patch"),
                     "ymax": ("outer", "patch"),
                     "zmin": ("front", "wedge"),
                     "zmax": ("back", "wedge")})
    pts = m.points.copy()
    theta = np.deg2rad(angle_deg)
    r = pts[:, 1].copy()
    phi = (pts[:, 2] - 0.5) * theta
    pts[:, 1] = r * np.cos(phi)
    pts[:, 2] = r * np.sin(phi)
    return PolyMesh(pts, m.face_points, m.face_offsets, m.owner,
                    m.neighbour, m.patches)


def reacting_box_case(case_dir: str, n: int = 16, end_time: float = 2e-3,
                      delta_t: float = 1e-4,
                      y_scheme: str = "Gauss upwind"):
    """reactingFoam ignition box: a closed 2D box of premixed fuel F +
    inert N2 with a hot kernel in the middle; one irreversible
    Arrhenius reaction F = P releases heat (reference tutorial family:
    combustion/reactingFoam)."""
    from ..mesh.geometry import cell_centres_and_vols, face_centres_and_areas
    from ..fields.io import _body_value

    L = 0.1
    mesh = box_mesh(n, n, 1, size=(L, L, L / n), patch_spec={
        "xmin": ("walls", "wall"), "xmax": ("walls", "wall"),
        "ymin": ("walls", "wall"), "ymax": ("walls", "wall"),
        "zmin": ("frontAndBack", "empty"),
        "zmax": ("frontAndBack", "empty"),
    })
    write_polymesh(mesh, case_dir)
    Cf, Sf = face_centres_and_areas(mesh)
    C, V = cell_centres_and_vols(mesh, Cf, Sf)
    r = np.sqrt((C[:, 0] - 0.5 * L) ** 2 + (C[:, 1] - 0.5 * L) ** 2)
    T0 = np.where(r < 0.2 * L, 1500.0, 600.0)

    _write(os.path.join(case_dir, "system", "controlDict"),
           foamfile_header("dictionary", "controlDict", "system"), f"""
application     reactingFoam;
startFrom       startTime;
startTime       0;
stopAt          endTime;
endTime         {end_time};
deltaT          {delta_t};
writeControl    runTime;
writeInterval   {end_time};
writeFormat     ascii;
""")
    _write(os.path.join(case_dir, "system", "fvSchemes"),
           foamfile_header("dictionary", "fvSchemes", "system"), f"""
ddtSchemes      {{ default Euler; }}
gradSchemes     {{ default Gauss linear; }}
divSchemes
{{
    default         none;
    div(phi,U)      Gauss upwind;
    div(phi,Yi_h)   {y_scheme};
    div(phi,K)      Gauss upwind;
}}
laplacianSchemes {{ default Gauss linear orthogonal; }}
interpolationSchemes {{ default linear; }}
snGradSchemes   {{ default orthogonal; }}
""")
    _write(os.path.join(case_dir, "system", "fvSolution"),
           foamfile_header("dictionary", "fvSolution", "system"), """
solvers
{
    p
    {
        solver          PCG;
        preconditioner  DIC;
        tolerance       1e-07;
        relTol          0.01;
    }
    pFinal
    {
        solver          PCG;
        preconditioner  DIC;
        tolerance       1e-07;
        relTol          0;
    }
    "(U|h|Yi)"
    {
        solver          PBiCGStab;
        preconditioner  DILU;
        tolerance       1e-07;
        relTol          0;
    }
}
PIMPLE
{
    nOuterCorrectors 1;
    nCorrectors     2;
    nNonOrthogonalCorrectors 0;
    nChemistrySubSteps 2;
}
""")
    _write(os.path.join(case_dir, "constant", "thermophysicalProperties"),
           foamfile_header("dictionary", "thermophysicalProperties",
                           "constant"), """
thermoType
{
    type            hePsiThermo;
    mixture         multiComponentMixture;
    transport       const;
    thermo          hConst;
    energy          sensibleEnthalpy;
    equationOfState perfectGas;
    specie          specie;
}

inertSpecie     N2;

species         ( F P N2 );

F
{
    specie          { molWeight 16; }
    thermodynamics  { Cp 2200; Hf 5e7; }
    transport       { mu 1.8e-05; Pr 0.7; }
}
P
{
    specie          { molWeight 16; }
    thermodynamics  { Cp 2200; Hf 0; }
    transport       { mu 1.8e-05; Pr 0.7; }
}
N2
{
    specie          { molWeight 28; }
    thermodynamics  { Cp 1040; Hf 0; }
    transport       { mu 1.8e-05; Pr 0.7; }
}

reactions
{
    fuelReaction
    {
        type            irreversibleArrheniusReaction;
        reaction        "F = P";
        A               5e6;
        beta            0;
        Ta              10000;
    }
}
""")
    wall_zg = "        type            zeroGradient;\n"
    wall_empty = "        type            empty;\n"
    write_field(case_dir, "0", "p", "volScalarField", "[1 -1 -2 0 0 0 0]",
                "uniform 1e5",
                {"walls": wall_zg, "frontAndBack": wall_empty})
    write_field(case_dir, "0", "T", "volScalarField", "[0 0 0 1 0 0 0]",
                _body_value(T0),
                {"walls": wall_zg, "frontAndBack": wall_empty})
    write_field(case_dir, "0", "U", "volVectorField", "[0 1 -1 0 0 0 0]",
                "uniform (0 0 0)",
                {"walls": "        type            fixedValue;\n"
                          "        value           uniform (0 0 0);\n",
                 "frontAndBack": wall_empty})
    for name, val in (("F", 0.1), ("P", 0.0), ("N2", 0.9)):
        write_field(case_dir, "0", name, "volScalarField",
                    "[0 0 0 0 0 0 0]", f"uniform {val}",
                    {"walls": wall_zg, "frontAndBack": wall_empty})
    _write(os.path.join(case_dir, "constant", "transportProperties"),
           foamfile_header("dictionary", "transportProperties",
                           "constant"), "\n")


def merge_disjoint_meshes(m1: PolyMesh, m2: PolyMesh) -> PolyMesh:
    """Concatenate two meshes into one (no topological connection —
    interfaces between them are coupled via cyclicAMI patch pairs).
    Same-named patches merge; patch metadata comes from whichever mesh
    defines the name first. By array operations: the face order of the
    JAX package's face loop (m1's internal faces, m2's, then each patch
    name's faces, m1's before m2's)."""
    np1, nc1, nf1 = len(m1.points), m1.n_cells, m1.n_faces
    pts = np.concatenate([m1.points, m2.points])
    fp = np.concatenate([m1.face_points, m2.face_points + np1])
    off = np.concatenate([m1.face_offsets,
                          m2.face_offsets[1:] + m1.face_offsets[-1]])
    own = np.concatenate([m1.owner, m2.owner + nc1])
    order = [np.arange(m1.n_internal_faces),
             nf1 + np.arange(m2.n_internal_faces)]
    groups: dict[str, tuple[str, object, list]] = {}
    for m, base in ((m1, 0), (m2, nf1)):
        for p in m.patches:
            groups.setdefault(p.name, (p.type, p.extra, []))[2].append(
                base + np.arange(p.start_face, p.start_face + p.n_faces))
    patches, start = [], m1.n_internal_faces + m2.n_internal_faces
    for name, (typ, extra, lst) in groups.items():
        n = int(sum(a.size for a in lst))
        patches.append(BoundaryPatch(name, typ, start, n, extra))
        order += lst
        start += n
    order = np.concatenate(order).astype(np.int64)
    sizes = np.diff(off)[order]
    offsets = np.zeros(order.size + 1, dtype=np.int64)
    np.cumsum(sizes, out=offsets[1:])
    face_of = np.repeat(np.arange(order.size), sizes)
    flat = fp[off[order][face_of] + np.arange(offsets[-1])
              - offsets[face_of]]
    return PolyMesh(pts, flat, offsets, own[order],
                    np.concatenate([m1.neighbour, m2.neighbour + nc1]),
                    patches)


def ami_channel_case(case_dir: str, ny1: int = 8, ny2: int = 12,
                     nx: int = 6, end_time: float = 0.5,
                     delta_t: float = 0.01, t_left: float = 400.0,
                     t_right: float = 300.0, max_iter: int = 1000,
                     write_mesh: bool = True) -> PolyMesh:
    """laplacianFoam conduction across a NON-CONFORMING cyclicAMI
    interface: two blocks of different y-resolution joined at x=0.5.
    The steady solution is linear in x, so any interface error shows
    directly (reference test analog: AMI tutorials). max_iter is T's
    PCG maxIter; write_mesh=False skips writing the polyMesh (the
    returned PolyMesh then goes to Case(pmesh=))."""
    from ..utils.dictionary import Dictionary as _D
    L, H = 1.0, 0.2
    mk = lambda name: _D()
    e1 = _D()
    e1["neighbourPatch"] = "ami2"
    e2 = _D()
    e2["neighbourPatch"] = "ami1"
    m1 = box_mesh(nx, ny1, 1, size=(L / 2, H, 0.05), patch_spec={
        "xmin": ("left", "patch"), "xmax": ("ami1", "cyclicAMI"),
        "ymin": ("walls", "wall"), "ymax": ("walls", "wall"),
        "zmin": ("fb", "empty"), "zmax": ("fb", "empty")})
    m2 = box_mesh(nx, ny2, 1, size=(L / 2, H, 0.05),
                  origin=(L / 2, 0, 0), patch_spec={
        "xmin": ("ami2", "cyclicAMI"), "xmax": ("right", "patch"),
        "ymin": ("walls", "wall"), "ymax": ("walls", "wall"),
        "zmin": ("fb", "empty"), "zmax": ("fb", "empty")})
    for m, nbr in ((m1, "ami2"), (m2, "ami1")):
        for p in m.patches:
            if p.type == "cyclicAMI":
                p.extra["neighbourPatch"] = nbr
                p.extra["transform"] = "none"
    mesh = merge_disjoint_meshes(m1, m2)
    if write_mesh:
        write_polymesh(mesh, case_dir)

    _write(os.path.join(case_dir, "system", "controlDict"),
           foamfile_header("dictionary", "controlDict", "system"), f"""
application     laplacianFoam;
startFrom       startTime;
startTime       0;
stopAt          endTime;
endTime         {end_time};
deltaT          {delta_t};
writeControl    runTime;
writeInterval   {end_time};
writeFormat     ascii;
""")
    _write(os.path.join(case_dir, "system", "fvSchemes"),
           foamfile_header("dictionary", "fvSchemes", "system"), """
ddtSchemes      { default Euler; }
gradSchemes     { default Gauss linear; }
divSchemes      { default none; }
laplacianSchemes { default Gauss linear orthogonal; }
interpolationSchemes { default linear; }
snGradSchemes   { default orthogonal; }
""")
    _write(os.path.join(case_dir, "system", "fvSolution"),
           foamfile_header("dictionary", "fvSolution", "system"), """
solvers
{
    T
    {
        solver          PCG;
        preconditioner  DIC;
        tolerance       1e-09;
        relTol          0;
        maxIter         %d;
    }
}
SIMPLE { nNonOrthogonalCorrectors 0; }
""" % max_iter)
    _write(os.path.join(case_dir, "constant", "transportProperties"),
           foamfile_header("dictionary", "transportProperties",
                           "constant"), """
DT              DT [0 2 -1 0 0 0 0] 0.05;
""")
    write_field(case_dir, "0", "T", "volScalarField", "[0 0 0 1 0 0 0]",
                f"uniform {t_right}",
                {"left": "        type            fixedValue;\n"
                         f"        value           uniform {t_left};\n",
                 "right": "        type            fixedValue;\n"
                          f"        value           uniform {t_right};\n",
                 "walls": "        type            zeroGradient;\n",
                 "fb": "        type            empty;\n",
                 '"(ami1|ami2)"': "        type            cyclicAMI;\n"})
    return mesh


def duplicate_patch(mesh: PolyMesh, name: str, new_name: str,
                    new_type: str) -> PolyMesh:
    """Append a patch duplicating `name`'s faces (same polygons, same
    owners) — the createBaffles couple/blockage construction the
    reference's cyclicACMI cases use (each interface face exists twice:
    once on the coupled patch, once on the non-overlap wall; mesh-build
    area scaling makes the pair sum to one physical face)."""
    src = next(p for p in mesh.patches if p.name == name)
    fp = [mesh.face_points[mesh.face_offsets[f]:mesh.face_offsets[f + 1]]
          for f in range(src.start_face, src.start_face + src.n_faces)]
    add_pts = np.concatenate(fp) if fp else np.zeros(0, np.int64)
    add_off = np.cumsum([len(f) for f in fp])
    nf0 = mesh.n_faces
    face_points = np.concatenate([mesh.face_points, add_pts])
    offsets = np.concatenate([mesh.face_offsets,
                              mesh.face_offsets[-1] + add_off])
    owner = np.concatenate([
        mesh.owner,
        mesh.owner[src.start_face:src.start_face + src.n_faces]])
    patches = list(mesh.patches) + [
        BoundaryPatch(new_name, new_type, nf0, src.n_faces)]
    return PolyMesh(mesh.points, face_points, offsets, owner,
                    mesh.neighbour, patches)


def acmi_channel_case(case_dir: str, ny: int = 8, nx: int = 6,
                      shift_frac: float = 0.5, end_time: float = 0.5,
                      delta_t: float = 0.01, t_left: float = 400.0,
                      t_right: float = 300.0):
    """laplacianFoam conduction across a PARTIALLY-overlapping
    cyclicACMI interface (reference: cyclicACMIPolyPatch + tutorial
    oscillatingInletACMI2D topology): two blocks joined at x=0.5, the
    right block shifted +y by shift_frac*H so only (1-shift_frac) of
    the interface couples; each side's interface faces are duplicated
    into a couple patch (cyclicACMI) and a non-overlap blockage wall.
    shift_frac=0 reduces to a conforming AMI (mask ~ 1); shift_frac>=1
    isolates the blocks (mask ~ tol)."""
    L, H = 1.0, 0.2
    yshift = shift_frac * H
    m1 = box_mesh(nx, ny, 1, size=(L / 2, H, 0.05), patch_spec={
        "xmin": ("left", "patch"), "xmax": ("ACMI1_couple", "cyclicACMI"),
        "ymin": ("walls", "wall"), "ymax": ("walls", "wall"),
        "zmin": ("fb", "empty"), "zmax": ("fb", "empty")})
    m2 = box_mesh(nx, ny, 1, size=(L / 2, H, 0.05),
                  origin=(L / 2, yshift, 0), patch_spec={
        "xmin": ("ACMI2_couple", "cyclicACMI"), "xmax": ("right", "patch"),
        "ymin": ("walls", "wall"), "ymax": ("walls", "wall"),
        "zmin": ("fb", "empty"), "zmax": ("fb", "empty")})
    m1 = duplicate_patch(m1, "ACMI1_couple", "ACMI1_blockage", "wall")
    m2 = duplicate_patch(m2, "ACMI2_couple", "ACMI2_blockage", "wall")
    for m, me, nbr, no in ((m1, "ACMI1_couple", "ACMI2_couple",
                            "ACMI1_blockage"),
                           (m2, "ACMI2_couple", "ACMI1_couple",
                            "ACMI2_blockage")):
        for p in m.patches:
            if p.name == me:
                p.extra["neighbourPatch"] = nbr
                p.extra["nonOverlapPatch"] = no
                p.extra["transform"] = "none"
    mesh = merge_disjoint_meshes(m1, m2)
    write_polymesh(mesh, case_dir)

    _write(os.path.join(case_dir, "system", "controlDict"),
           foamfile_header("dictionary", "controlDict", "system"), f"""
application     laplacianFoam;
startFrom       startTime;
startTime       0;
stopAt          endTime;
endTime         {end_time};
deltaT          {delta_t};
writeControl    runTime;
writeInterval   {end_time};
writeFormat     ascii;
""")
    _write(os.path.join(case_dir, "system", "fvSchemes"),
           foamfile_header("dictionary", "fvSchemes", "system"), """
ddtSchemes      { default Euler; }
gradSchemes     { default Gauss linear; }
divSchemes      { default none; }
laplacianSchemes { default Gauss linear orthogonal; }
interpolationSchemes { default linear; }
snGradSchemes   { default orthogonal; }
""")
    _write(os.path.join(case_dir, "system", "fvSolution"),
           foamfile_header("dictionary", "fvSolution", "system"), """
solvers
{
    T
    {
        solver          PCG;
        preconditioner  DIC;
        tolerance       1e-09;
        relTol          0;
    }
}
SIMPLE { nNonOrthogonalCorrectors 0; }
""")
    _write(os.path.join(case_dir, "constant", "transportProperties"),
           foamfile_header("dictionary", "transportProperties",
                           "constant"), """
DT              DT [0 2 -1 0 0 0 0] 0.05;
""")
    write_field(case_dir, "0", "T", "volScalarField", "[0 0 0 1 0 0 0]",
                f"uniform {t_right}",
                {"left": "        type            fixedValue;\n"
                         f"        value           uniform {t_left};\n",
                 "right": "        type            fixedValue;\n"
                          f"        value           uniform {t_right};\n",
                 "walls": "        type            zeroGradient;\n",
                 "fb": "        type            empty;\n",
                 '"ACMI.*_blockage"':
                     "        type            zeroGradient;\n",
                 '"ACMI.*_couple"':
                     "        type            cyclicACMI;\n"})


def fluidized_bed_case(case_dir: str, nx: int = 15, ny: int = 45,
                       end_time: float = 0.02, delta_t: float = 5e-4,
                       u_gas: float = 0.3, alpha_pack: float = 0.55,
                       equilibrium: str = "on",
                       drag: str = "GidaspowErgunWenYu"):
    """twoPhaseEulerFoam gas-solid fluidized bed with kinetic theory on
    the particle phase (reference tutorial: multiphase/
    twoPhaseEulerFoam/fluidisedBed — Gidaspow drag, kineticTheory
    RASModel with JohnsonJackson frictional stress). Air blows upward
    through a packed particle bed occupying the lower third."""
    from ..mesh.geometry import cell_centres_and_vols, face_centres_and_areas
    from ..fields.io import _body_value

    W, H = 0.15, 0.7
    mesh = box_mesh(nx, ny, 1, size=(W, H, 0.01), patch_spec={
        "xmin": ("walls", "wall"), "xmax": ("walls", "wall"),
        "ymin": ("inlet", "patch"), "ymax": ("outlet", "patch"),
        "zmin": ("frontAndBack", "empty"),
        "zmax": ("frontAndBack", "empty"),
    })
    write_polymesh(mesh, case_dir)
    Cf, Sf = face_centres_and_areas(mesh)
    C, V = cell_centres_and_vols(mesh, Cf, Sf)
    alpha0 = np.where(C[:, 1] < 0.28 * H, alpha_pack, 0.0)
    # hydrostatic initial p (mixture column weight): starting from
    # uniform p slams the packed bed with a ~kPa pressure shock that
    # fixed-dt runs cannot survive (the reference tutorial relies on
    # adjustable maxCo during the same transient)
    rho_mix = alpha0 * 2500.0 + (1.0 - alpha0) * 1.2
    y = C[:, 1]
    order = np.argsort(-y)
    p0 = np.full(C.shape[0], 1e5)
    # integrate downward column weight per x-column
    xcol = np.floor(C[:, 0] / (W / nx)).astype(int)
    dy = H / ny
    for col in np.unique(xcol):
        sel = np.nonzero(xcol == col)[0]
        s = sel[np.argsort(-y[sel])]
        p0[s] = 1e5 + 9.81 * np.cumsum(rho_mix[s] * dy) \
            - 0.5 * 9.81 * rho_mix[s] * dy

    _write(os.path.join(case_dir, "system", "controlDict"),
           foamfile_header("dictionary", "controlDict", "system"), f"""
application     twoPhaseEulerFoam;
startFrom       startTime;
startTime       0;
stopAt          endTime;
endTime         {end_time};
deltaT          {delta_t};
writeControl    runTime;
writeInterval   {end_time};
writeFormat     ascii;
adjustTimeStep  no;
maxCo           0.5;
""")
    _write(os.path.join(case_dir, "system", "fvSchemes"),
           foamfile_header("dictionary", "fvSchemes", "system"), """
ddtSchemes      { default Euler; }
gradSchemes     { default Gauss linear; }
divSchemes      { default Gauss upwind;
                  div(phi,alpha.particles) Gauss vanLeer; }
laplacianSchemes { default Gauss linear orthogonal; }
interpolationSchemes { default linear; }
snGradSchemes   { default orthogonal; }
""")
    _write(os.path.join(case_dir, "system", "fvSolution"),
           foamfile_header("dictionary", "fvSolution", "system"), """
solvers
{
    "alpha.particles.*" { nAlphaSubCycles 2; nAlphaCorr 1; }
    p
    {
        solver          PCG;
        preconditioner  DIC;
        tolerance       1e-08;
        relTol          0.01;
    }
    pFinal
    {
        solver          PCG;
        preconditioner  DIC;
        tolerance       1e-08;
        relTol          0;
    }
    T
    {
        solver          PBiCGStab;
        preconditioner  DILU;
        tolerance       1e-08;
        relTol          0;
    }
}
PIMPLE
{
    nOuterCorrectors 2;
    nCorrectors      2;
    nNonOrthogonalCorrectors 0;
}
""")
    _write(os.path.join(case_dir, "constant", "phaseProperties"),
           foamfile_header("dictionary", "phaseProperties",
                           "constant"), f"""
phases          (particles air);

particles
{{
    diameterModel   constant;
    constantCoeffs  {{ d  d [0 1 0 0 0 0 0] 3e-4; }}
    alphaMax        0.62;
    residualAlpha   1e-6;
}}
air
{{
    diameterModel   constant;
    constantCoeffs  {{ d  d [0 1 0 0 0 0 0] 1; }}
    residualAlpha   0;
}}

drag            {{ type {drag}; }}
virtualMass     {{ type none; }}
heatTransfer    {{ type RanzMarshall; }}
lift            {{ type none; }}
turbulentDispersion {{ type none; }}
wallLubrication {{ type none; }}
sigma           sigma [1 0 -2 0 0 0 0] 0;
pMin            pMin [1 -1 -2 0 0 0 0] 10000;
""")
    _write(os.path.join(case_dir, "constant",
                        "turbulenceProperties.particles"),
           foamfile_header("dictionary",
                           "turbulenceProperties.particles",
                           "constant"), f"""
simulationType  RAS;
RAS
{{
    RASModel        kineticTheory;
    turbulence      on;
    printCoeffs     on;

    kineticTheoryCoeffs
    {{
        equilibrium             {equilibrium};
        e                       0.8;
        alphaMax                0.62;
        alphaMinFriction        0.5;
        residualAlpha           1e-4;
        viscosityModel          Gidaspow;
        conductivityModel       Gidaspow;
        granularPressureModel   Lun;
        frictionalStressModel   JohnsonJackson;
        radialModel             SinclairJackson;

        JohnsonJacksonCoeffs
        {{
            Fr                      0.05;
            eta                     2;
            p                       5;
            phi                     28.5;
        }}
    }}
}}
""")
    _write(os.path.join(case_dir, "constant",
                        "turbulenceProperties.air"),
           foamfile_header("dictionary", "turbulenceProperties.air",
                           "constant"), """
simulationType  laminar;
""")
    _write(os.path.join(case_dir, "constant",
                        "thermophysicalProperties.air"),
           foamfile_header("dictionary",
                           "thermophysicalProperties.air",
                           "constant"), """
thermoType
{
    type            hePsiThermo;
    mixture         pureMixture;
    transport       const;
    thermo          hConst;
    equationOfState perfectGas;
    specie          specie;
    energy          sensibleInternalEnergy;
}
mixture
{
    specie          { nMoles 1; molWeight 28.9; }
    thermodynamics  { Cp 1007; Hf 0; }
    transport       { mu 1.84e-5; Pr 0.7; }
}
""")
    _write(os.path.join(case_dir, "constant",
                        "thermophysicalProperties.particles"),
           foamfile_header("dictionary",
                           "thermophysicalProperties.particles",
                           "constant"), """
thermoType
{
    type            heRhoThermo;
    mixture         pureMixture;
    transport       const;
    thermo          hConst;
    equationOfState perfectFluid;
    specie          specie;
    energy          sensibleInternalEnergy;
}
mixture
{
    specie          { nMoles 1; molWeight 100; }
    equationOfState { R 1e10; rho0 2500; }
    thermodynamics  { Cp 800; Hf 0; }
    transport       { mu 0; Pr 1; }
}
""")
    _write(os.path.join(case_dir, "constant", "g"),
           foamfile_header("uniformDimensionedVectorField", "g",
                           "constant"),
           "\ndimensions      [0 1 -2 0 0 0 0];\n"
           "value           (0 -9.81 0);\n")

    zg = "        type            zeroGradient;\n"
    emp = "        type            empty;\n"
    noslip = ("        type            fixedValue;\n"
              "        value           uniform (0 0 0);\n")
    io0 = ("        type            inletOutlet;\n"
           "        inletValue      uniform 0;\n"
           "        value           uniform 0;\n")
    write_field(case_dir, "0", "alpha.particles", "volScalarField",
                "[0 0 0 0 0 0 0]", _body_value(alpha0),
                {"inlet": ("        type            fixedValue;\n"
                           "        value           uniform 0;\n"),
                 "outlet": io0, "walls": zg, "frontAndBack": emp})
    ffp = ("        type            fixedFluxPressure;\n"
           "        value           uniform 1e5;\n")
    write_field(case_dir, "0", "p", "volScalarField",
                "[1 -1 -2 0 0 0 0]", _body_value(p0),
                {"inlet": ffp,
                 "outlet": ("        type            fixedValue;\n"
                            "        value           uniform 1e5;\n"),
                 "walls": ffp, "frontAndBack": emp})
    for name in ("T.particles", "T.air"):
        write_field(case_dir, "0", name, "volScalarField",
                    "[0 0 0 1 0 0 0]", "uniform 300",
                    {"inlet": zg, "outlet": zg, "walls": zg,
                     "frontAndBack": emp})
    write_field(case_dir, "0", "U.air", "volVectorField",
                "[0 1 -1 0 0 0 0]", "uniform (0 0 0)",
                {"inlet": (f"        type            fixedValue;\n"
                           f"        value           uniform "
                           f"(0 {u_gas} 0);\n"),
                 "outlet": ("        type            inletOutlet;\n"
                            "        inletValue      uniform (0 0 0);\n"
                            "        value           uniform (0 0 0);\n"),
                 "walls": noslip, "frontAndBack": emp})
    write_field(case_dir, "0", "U.particles", "volVectorField",
                "[0 1 -1 0 0 0 0]", "uniform (0 0 0)",
                {"inlet": noslip,
                 "outlet": ("        type            inletOutlet;\n"
                            "        inletValue      uniform (0 0 0);\n"
                            "        value           uniform (0 0 0);\n"),
                 "walls": noslip, "frontAndBack": emp})
    return mesh


# ---------------------------------------------------------------------------
# heat transfer: the JAX package's test cavities and the hot room
# ---------------------------------------------------------------------------

_EMPTY = "        type            empty;\n"
_ZG = "        type            zeroGradient;\n"

#: air as tests/test_heattransfer.py:18-34 writes it
_AIR_THERMO = """
thermoType
{
    type            heRhoThermo;
    mixture         pureMixture;
    transport       const;
    thermo          hConst;
    equationOfState perfectGas;
    specie          specie;
    energy          sensibleEnthalpy;
}
mixture
{
    specie         { nMoles 1; molWeight 28.9; }
    thermodynamics { Cp 1005; Hf 0; }
    transport      { mu 1.8e-05; Pr 0.7; }
}
"""

#: the radiationProperties of tests/test_heattransfer.py:339-358
_P1_PROPERTIES = """
radiation       on;
radiationModel  P1;
absorptionEmissionModel constantAbsorptionEmission;
constantAbsorptionEmissionCoeffs
{
    absorptivity    absorptivity [ 0 -1 0 0 0 0 0 ] 0.5;
    emissivity      emissivity [ 0 -1 0 0 0 0 0 ] 0.5;
    E               E [ 1 -1 -3 0 0 0 0 ] 0;
}
scatterModel    constantScatter;
constantScatterCoeffs
{
    sigma           sigma [ 0 -1 0 0 0 0 0 ] 0;
    C               C [ 0 0 0 0 0 0 0 ] 0;
}
"""


def _fv(v) -> str:
    return ("        type            fixedValue;\n"
            f"        value           uniform {v};\n")


def _write_dict(case_dir: str, where: str, name: str, body: str,
                cls: str = "dictionary"):
    _write(os.path.join(case_dir, where, name),
           foamfile_header(cls, name, where), body)


def _write_g(case_dir: str):
    _write_dict(case_dir, "constant", "g",
                "\ndimensions      [0 1 -2 0 0 0 0];\n"
                "value           (0 -9.81 0);\n",
                cls="uniformDimensionedVectorField")


def _cavity_mesh(case_dir: str, n: int, size, names) -> PolyMesh:
    """An n x n x 1 closed 2-D cavity with the given wall names on
    (xmin, xmax, ymin, ymax) and an empty front and back."""
    mesh = box_mesh(n, n, 1, size=size, patch_spec={
        "xmin": (names[0], "wall"), "xmax": (names[1], "wall"),
        "ymin": (names[2], "wall"), "ymax": (names[3], "wall"),
        "zmin": (names[4], "empty"), "zmax": (names[4], "empty")})
    write_polymesh(mesh, case_dir)
    return mesh


def boussinesq_cavity_case(case_dir: str, n: int = 16,
                           transient: bool = False,
                           p_bc: str = "zeroGradient") -> PolyMesh:
    """The differentially heated 1 x 1 m cavity of tests/test_buoyant.py:
    15-97 (buoyantBoussinesqSimpleFoam: walls at 310 and 290 K, GAMG
    p_rgh, laminar) or, transient=True, its buoyantBoussinesqPimpleFoam
    form of :100-150 (Euler, dt 0.05, PCG p_rgh, PIMPLE 1 x 2). p_bc:
    the walls' p_rgh condition, zeroGradient as in the tests or
    fixedFluxPressure."""
    names = ("hotWall", "coldWall", "floor", "ceiling", "frontAndBack")
    mesh = _cavity_mesh(case_dir, n, (1.0, 1.0, 0.1), names)
    if transient:
        control = """
application buoyantBoussinesqPimpleFoam;
startFrom startTime; startTime 0; stopAt endTime; endTime 2.0;
deltaT 0.05; writeControl timeStep; writeInterval 1000;
writeFormat ascii;
"""
        schemes = """
ddtSchemes { default Euler; }
gradSchemes { default Gauss linear; }
divSchemes { default none; div(phi,U) Gauss upwind;
             div(phi,T) Gauss upwind; }
laplacianSchemes { default Gauss linear orthogonal; }
interpolationSchemes { default linear; }
snGradSchemes { default orthogonal; }
"""
        solution = """
solvers
{
    p_rgh { solver PCG; preconditioner DIC; tolerance 1e-08;
            relTol 0.01; }
    p_rghFinal { solver PCG; preconditioner DIC; tolerance 1e-08;
                 relTol 0; }
    "(U|T)" { solver smoothSolver; smoother symGaussSeidel;
              tolerance 1e-08; relTol 0; }
    "(U|T)Final" { solver smoothSolver; smoother symGaussSeidel;
                   tolerance 1e-08; relTol 0; }
}
PIMPLE { nOuterCorrectors 1; nCorrectors 2;
         nNonOrthogonalCorrectors 0; }
"""
    else:
        control = """
application buoyantBoussinesqSimpleFoam;
startFrom startTime; startTime 0; stopAt endTime; endTime 100;
deltaT 1; writeControl timeStep; writeInterval 100; writeFormat ascii;
"""
        schemes = """
ddtSchemes { default steadyState; }
gradSchemes { default Gauss linear; }
divSchemes { default none; div(phi,U) bounded Gauss upwind;
             div(phi,T) bounded Gauss upwind; }
laplacianSchemes { default Gauss linear orthogonal; }
interpolationSchemes { default linear; }
snGradSchemes { default orthogonal; }
"""
        solution = """
solvers
{
    p_rgh { solver GAMG; smoother GaussSeidel; tolerance 1e-08;
            relTol 0.05; }
    "(U|T)" { solver smoothSolver; smoother symGaussSeidel;
              tolerance 1e-07; relTol 0.1; }
}
SIMPLE { nNonOrthogonalCorrectors 0; pRefCell 0; pRefValue 0; }
relaxationFactors
{
    fields { p_rgh 0.5; }
    equations { U 0.5; T 0.5; }
}
"""
    _write_dict(case_dir, "system", "controlDict", control)
    _write_dict(case_dir, "system", "fvSchemes", schemes)
    _write_dict(case_dir, "system", "fvSolution", solution)
    _write_dict(case_dir, "constant", "transportProperties", """
transportModel Newtonian;
nu              nu [0 2 -1 0 0 0 0] 1e-03;
beta            beta [0 0 0 -1 0 0 0] 3e-03;
TRef            TRef [0 0 0 1 0 0 0] 300;
Pr              Pr [0 0 0 0 0 0 0] 0.7;
Prt             Prt [0 0 0 0 0 0 0] 0.85;
""")
    _write_g(case_dir)
    _write_dict(case_dir, "constant", "RASProperties",
                "\nRASModel laminar;\nturbulence off;\n")
    walls = names[:4]
    write_field(case_dir, "0", "U", "volVectorField", "[0 1 -1 0 0 0 0]",
                "uniform (0 0 0)", {**{w: _fv("(0 0 0)") for w in walls},
                                    names[4]: _EMPTY})
    p_spec = (_ZG if p_bc == "zeroGradient" else
              f"        type            {p_bc};\n"
              "        value           uniform 0;\n")
    write_field(case_dir, "0", "p_rgh", "volScalarField", "[0 2 -2 0 0 0 0]",
                "uniform 0", {**{w: p_spec for w in walls},
                              names[4]: _EMPTY})
    write_field(case_dir, "0", "T", "volScalarField", "[0 0 0 1 0 0 0]",
                "uniform 300", {"hotWall": _fv(310), "coldWall": _fv(290),
                                "floor": _ZG, "ceiling": _ZG,
                                names[4]: _EMPTY})
    return mesh


def heated_cavity_case(case_dir: str, solver: str = "buoyantSimpleFoam",
                       radiation: bool = False) -> PolyMesh:
    """The closed air cavities of tests/test_heattransfer.py (0.1 m, walls
    hot and cold, p_rgh and p at 1e5 Pa with zeroGradient walls):
    buoyantSimpleFoam on 16 x 16 (:41-96: 310/290 K, GAMG p_rgh,
    residualControl), buoyantPimpleFoam on 12 x 12 (:156-230: 320/280 K,
    dt 0.005, PCG p_rgh, PIMPLE 1 x 2), or, radiation=True,
    buoyantSimpleFoam with P1 on 12 x 12 (:233-326 and :330-366: G by
    PCG, Marshak walls of emissivity 1)."""
    steady = solver == "buoyantSimpleFoam"
    n = 16 if steady and not radiation else 12
    names = ("hot", "cold", "floor", "ceiling", "fb")
    mesh = _cavity_mesh(case_dir, n, (0.1, 0.1, 0.01), names)
    hot, cold = (310, 290) if steady else (320, 280)
    schemes = """
gradSchemes { default Gauss linear; }
laplacianSchemes { default Gauss linear orthogonal; }
interpolationSchemes { default linear; }
snGradSchemes { default orthogonal; }
"""
    if steady:
        end = 12 if radiation else 60
        control = f"""
application buoyantSimpleFoam; startFrom startTime; startTime 0;
stopAt endTime; endTime {end}; deltaT 1;
writeControl timeStep; writeInterval 1000; writeFormat ascii;
"""
        schemes += """
ddtSchemes { default steadyState; }
divSchemes { default none; div(phi,U) bounded Gauss upwind;
             div(phi,h) bounded Gauss upwind; }
"""
        residual = ("residualControl { }" if radiation else
                    "residualControl { p_rgh 1e-5; U 1e-6; h 1e-6; }")
        g_solver = ("    G { solver PCG; preconditioner DIC; "
                    "tolerance 1e-10; relTol 0; }\n" if radiation else "")
        solution = f"""
solvers
{{
    p_rgh {{ solver GAMG; smoother GaussSeidel; tolerance 1e-08;
            relTol 0.01; }}
    "(U|h)" {{ solver smoothSolver; smoother symGaussSeidel;
              tolerance 1e-08; relTol 0.1; }}
{g_solver}}}
SIMPLE
{{
    nNonOrthogonalCorrectors 0;
    pRefCell 0; pRefValue 100000;
    {residual}
}}
relaxationFactors
{{
    fields    {{ p_rgh 0.7; rho 0.3; }}
    equations {{ U 0.3; h 0.7; }}
}}
"""
    else:
        control = """
application buoyantPimpleFoam; startFrom startTime; startTime 0;
stopAt endTime; endTime 0.2; deltaT 0.005;
writeControl timeStep; writeInterval 1000; writeFormat ascii;
"""
        schemes += """
ddtSchemes { default Euler; }
divSchemes { default none; div(phi,U) Gauss upwind;
             div(phi,h) Gauss upwind; div(phi,K) Gauss upwind; }
"""
        solution = """
solvers
{
    p_rgh { solver PCG; preconditioner DIC; tolerance 1e-08;
            relTol 0.01; }
    p_rghFinal { solver PCG; preconditioner DIC; tolerance 1e-08;
                 relTol 0; }
    "(U|h)" { solver smoothSolver; smoother symGaussSeidel;
              tolerance 1e-08; relTol 0; }
    "(U|h)Final" { solver smoothSolver; smoother symGaussSeidel;
                   tolerance 1e-08; relTol 0; }
}
PIMPLE { nOuterCorrectors 1; nCorrectors 2;
         nNonOrthogonalCorrectors 0; }
"""
    _write_dict(case_dir, "system", "controlDict", control)
    _write_dict(case_dir, "system", "fvSchemes", schemes)
    _write_dict(case_dir, "system", "fvSolution", solution)
    _write_dict(case_dir, "constant", "thermophysicalProperties",
                _AIR_THERMO)
    _write_g(case_dir)
    walls = {"hot": _fv(hot), "cold": _fv(cold), "floor": _ZG,
             "ceiling": _ZG, "fb": _EMPTY}
    write_field(case_dir, "0", "T", "volScalarField", "[0 0 0 1 0 0 0]",
                "uniform 300", walls)
    write_field(case_dir, "0", "U", "volVectorField", "[0 1 -1 0 0 0 0]",
                "uniform (0 0 0)",
                {k: (_fv("(0 0 0)") if k != "fb" else _EMPTY)
                 for k in walls})
    zgs = {k: (_ZG if k != "fb" else _EMPTY) for k in walls}
    for name in ("p_rgh", "p"):
        write_field(case_dir, "0", name, "volScalarField",
                    "[1 -1 -2 0 0 0 0]", "uniform 100000", zgs)
    if radiation:
        _write_dict(case_dir, "constant", "radiationProperties",
                    _P1_PROPERTIES)
        marshak = ("        type            MarshakRadiation;\n"
                   "        emissivity      uniform 1.0;\n"
                   "        value           uniform 0;\n")
        write_field(case_dir, "0", "G", "volScalarField", "[1 0 -3 0 0 0 0]",
                    "uniform 0", {k: (marshak if k != "fb" else _EMPTY)
                                  for k in walls})
    return mesh


def thermo_channel_case(case_dir: str) -> PolyMesh:
    """thermoFoam's frozen channel flow of tests/test_heattransfer.py:
    99-153: a 0.3 x 0.05 m channel of 30 x 6 cells, U = 1 m/s, the lower
    wall at 400 K, dt 0.002 s, PBiCGStab/DILU h."""
    mesh = box_mesh(30, 6, 1, size=(0.3, 0.05, 0.01), patch_spec={
        "xmin": ("inlet", "patch"), "xmax": ("outlet", "patch"),
        "ymin": ("hotWall", "wall"), "ymax": ("topWall", "wall"),
        "zmin": ("fb", "empty"), "zmax": ("fb", "empty")})
    write_polymesh(mesh, case_dir)
    _write_dict(case_dir, "system", "controlDict", """
application thermoFoam; startFrom startTime; startTime 0;
stopAt endTime; endTime 0.1; deltaT 0.002;
writeControl timeStep; writeInterval 1000; writeFormat ascii;
""")
    _write_dict(case_dir, "system", "fvSchemes", """
ddtSchemes { default Euler; }
gradSchemes { default Gauss linear; }
divSchemes { default none; div(phi,h) Gauss upwind; }
laplacianSchemes { default Gauss linear orthogonal; }
interpolationSchemes { default linear; }
snGradSchemes { default orthogonal; }
""")
    _write_dict(case_dir, "system", "fvSolution", """
solvers { h { solver PBiCGStab; preconditioner DILU;
              tolerance 1e-09; relTol 0; } }
""")
    _write_dict(case_dir, "constant", "thermophysicalProperties",
                _AIR_THERMO)
    write_field(case_dir, "0", "T", "volScalarField", "[0 0 0 1 0 0 0]",
                "uniform 300", {"inlet": _fv(300), "outlet": _ZG,
                                "hotWall": _fv(400), "topWall": _ZG,
                                "fb": _EMPTY})
    write_field(case_dir, "0", "U", "volVectorField", "[0 1 -1 0 0 0 0]",
                "uniform (1 0 0)", {"inlet": _fv("(1 0 0)"), "outlet": _ZG,
                                    "hotWall": _fv("(0 0 0)"),
                                    "topWall": _fv("(0 0 0)"),
                                    "fb": _EMPTY})
    write_field(case_dir, "0", "p", "volScalarField", "[1 -1 -2 0 0 0 0]",
                "uniform 100000", {"inlet": _ZG, "outlet": _ZG,
                                   "hotWall": _ZG, "topWall": _ZG,
                                   "fb": _EMPTY})
    return mesh


ROOM_SIZE = (10.0, 6.0, 4.0)


def _room_mesh(nx: int, ny: int, nz: int) -> PolyMesh:
    """The room's box with its floor split into `floor` and the 1 x 1 m
    `heater` at its centre: the floor faces whose centre lies within
    0.5 m (or half a cell, where cells are coarser) of the floor's centre
    in x and in z."""
    mesh = box_mesh(nx, ny, nz, size=ROOM_SIZE, patch_spec={
        "ymin": ("floor", "wall"), "ymax": ("ceiling", "wall"),
        "xmin": ("fixedWalls", "wall"), "xmax": ("fixedWalls", "wall"),
        "zmin": ("fixedWalls", "wall"), "zmax": ("fixedWalls", "wall")})
    floor = mesh.patches[0]
    s, e = floor.start_face, floor.start_face + floor.n_faces
    quads = mesh.face_points.reshape(-1, 4)
    centre = mesh.points[quads[s:e]].mean(axis=1)
    half = [max(0.5, 0.5 * ROOM_SIZE[a] / n + 1e-9)
            for a, n in ((0, nx), (2, nz))]
    heat = ((np.abs(centre[:, 0] - 0.5 * ROOM_SIZE[0]) <= half[0])
            & (np.abs(centre[:, 2] - 0.5 * ROOM_SIZE[2]) <= half[1]))
    order = np.concatenate([np.nonzero(~heat)[0], np.nonzero(heat)[0]]) + s
    quads = quads.copy()
    owner = mesh.owner.copy()
    quads[s:e], owner[s:e] = quads[order], owner[order]
    n_floor = int((~heat).sum())
    patches = [BoundaryPatch("floor", "wall", s, n_floor),
               BoundaryPatch("heater", "wall", s + n_floor,
                             int(heat.sum()))] + list(mesh.patches[1:])
    return PolyMesh(mesh.points, quads.ravel(), mesh.face_offsets, owner,
                    mesh.neighbour, patches)


def hot_room_case(case_dir: str, nx: int = 160, ny: int = 96, nz: int = 64,
                  *, solver: str = "buoyantBoussinesqSimpleFoam",
                  turbulence: str = "kEpsilon", end_time: float = 2000,
                  delta_t: float = 1.0, write_mesh: bool = True,
                  lattice_out: dict | None = None) -> PolyMesh:
    """A closed 10 x 6 x 4 m room heated from the floor, written after
    OpenFOAM's heatTransfer/buoyantBoussinesqSimpleFoam/hotRoom tutorial.
    No copy of that tutorial is at hand: every number here is this
    writer's choice. y is up, g = (0 -9.81 0); a uniform nx x ny x nz
    lattice (the default 160 x 96 x 64 is 983,040 cells of 0.0625 m);
    patches floor, heater (1 x 1 m at the floor's centre), ceiling and
    fixedWalls. The room starts at rest at 300 K; the heater is held at
    600 K, every other wall at 300 K.

    solver "buoyantBoussinesqSimpleFoam": transportProperties nu 1e-5,
    beta 3e-3, TRef 300, Pr 0.9, Prt 0.7; noSlip U; p_rgh [m2/s2]
    fixedFluxPressure on every wall, pRefCell 0, pRefValue 0; kEpsilon
    (turbulence="laminar" for none) with nutkWallFunction,
    epsilonWallFunction and kqRWallFunction, k and epsilon starting at
    8e-2 m2/s2 and 0.23 m2/s3; `bounded Gauss upwind` for U, T, k and
    epsilon, Gauss linear gradients, orthogonal laplacians (the lattice
    is orthogonal); p_rgh by GAMG (the structured V-cycle on gdia),
    relaxation p_rgh 0.7, U 0.3, T 0.5, k and epsilon 0.5. No patch has
    an outflow, so adjustPhi has nothing to scale.

    solver "buoyantPimpleFoam": the same room filled with air (perfect
    gas, Cp 1005, mu 1.8e-5, Pr 0.7), p_rgh and p [Pa] at 1e5,
    fixedFluxPressure walls, laminar, Euler with dt delta_t, PIMPLE 1 x 2,
    GAMG p_rgh.

    write_mesh=False skips the ascii polyMesh (a million cells); the
    returned PolyMesh then goes to Case(pmesh=, lattice=).
    lattice_out receives the gdia embedding: the lattice is the box
    itself, cells in lattice order, no dead slot."""
    if solver not in ("buoyantBoussinesqSimpleFoam", "buoyantPimpleFoam"):
        raise ValueError(f"hot_room_case: unsupported solver '{solver}'")
    boussinesq = solver == "buoyantBoussinesqSimpleFoam"
    if not boussinesq and turbulence != "laminar":
        raise ValueError("buoyantPimpleFoam is laminar")
    mesh = _room_mesh(nx, ny, nz)
    if write_mesh:
        write_polymesh(mesh, case_dir)
    if lattice_out is not None:
        n_int = mesh.n_internal_faces
        nc = nx * ny * nz
        lattice_out.update(
            shape=(nz, ny, nx), slot_cell=np.arange(nc, dtype=np.int64),
            ghost_lead=np.arange(nc, dtype=np.int64),
            orig_own_int=mesh.owner[:n_int].copy(),
            orig_nei_int=mesh.neighbour.copy(),
            orig_own_bnd=mesh.owner[n_int:].copy(),
            flip_int=np.zeros(n_int, dtype=bool),
            dead=np.zeros(nc, dtype=bool))
    walls = ("floor", "heater", "ceiling", "fixedWalls")
    write_interval = max(1, int(round(end_time / delta_t)))
    _write_dict(case_dir, "system", "controlDict", f"""
application     {solver};
startFrom       startTime;
startTime       0;
stopAt          endTime;
endTime         {end_time:g};
deltaT          {delta_t:g};
writeControl    timeStep;
writeInterval   {write_interval};
writeFormat     ascii;
""")
    no_slip = "        type            noSlip;\n"
    write_field(case_dir, "0", "U", "volVectorField", "[0 1 -1 0 0 0 0]",
                "uniform (0 0 0)", {w: no_slip for w in walls})
    write_field(case_dir, "0", "T", "volScalarField", "[0 0 0 1 0 0 0]",
                "uniform 300", {w: _fv(600 if w == "heater" else 300)
                                for w in walls})
    _write_g(case_dir)
    if boussinesq:
        turb_words = ("k", "epsilon") if turbulence != "laminar" else ()
        div = "".join(f"    div(phi,{f}) bounded Gauss upwind;\n"
                      for f in ("U", "T") + turb_words)
        _write_dict(case_dir, "system", "fvSchemes", f"""
ddtSchemes      {{ default steadyState; }}
gradSchemes     {{ default Gauss linear; }}
divSchemes
{{
    default         none;
{div}    div((nuEff*dev(T(grad(U))))) Gauss linear;
}}
laplacianSchemes {{ default Gauss linear orthogonal; }}
interpolationSchemes {{ default linear; }}
snGradSchemes   {{ default orthogonal; }}
""")
        _write_dict(case_dir, "system", "fvSolution", """
solvers
{
    p_rgh
    {
        solver          GAMG;
        smoother        GaussSeidel;
        tolerance       1e-08;
        relTol          0.01;
    }
    "(U|T|k|epsilon)"
    {
        solver          smoothSolver;
        smoother        symGaussSeidel;
        tolerance       1e-08;
        relTol          0.1;
    }
}
SIMPLE
{
    nNonOrthogonalCorrectors 0;
    pRefCell        0;
    pRefValue       0;
    residualControl { p_rgh 1e-2; U 1e-3; T 1e-3; "(k|epsilon)" 1e-3; }
}
relaxationFactors
{
    fields    { p_rgh 0.7; }
    equations { U 0.3; T 0.5; k 0.5; epsilon 0.5; }
}
""")
        _write_dict(case_dir, "constant", "transportProperties", """
transportModel  Newtonian;
nu              nu [0 2 -1 0 0 0 0] 1e-05;
beta            beta [0 0 0 -1 0 0 0] 3e-03;
TRef            TRef [0 0 0 1 0 0 0] 300;
Pr              Pr [0 0 0 0 0 0 0] 0.9;
Prt             Prt [0 0 0 0 0 0 0] 0.7;
""")
        ffp = ("        type            fixedFluxPressure;\n"
               "        value           uniform 0;\n")
        write_field(case_dir, "0", "p_rgh", "volScalarField",
                    "[0 2 -2 0 0 0 0]", "uniform 0", {w: ffp for w in walls})
        if turbulence == "laminar":
            _write_dict(case_dir, "constant", "RASProperties",
                        "\nRASModel laminar;\nturbulence off;\n")
            return mesh
        if turbulence != "kEpsilon":
            raise ValueError(f"hot_room_case: turbulence '{turbulence}' "
                             "(kEpsilon or laminar)")
        _write_dict(case_dir, "constant", "RASProperties",
                    "\nRASModel kEpsilon;\nturbulence on;\n"
                    "printCoeffs on;\n")
        for name, dims, value, word in (
                ("k", "[0 2 -2 0 0 0 0]", "8e-2", "kqRWallFunction"),
                ("epsilon", "[0 2 -3 0 0 0 0]", "0.23",
                 "epsilonWallFunction"),
                ("nut", "[0 2 -1 0 0 0 0]", "0", "nutkWallFunction")):
            spec = (f"        type            {word};\n"
                    f"        value           uniform {value};\n")
            write_field(case_dir, "0", name, "volScalarField", dims,
                        f"uniform {value}", {w: spec for w in walls})
        return mesh
    _write_dict(case_dir, "system", "fvSchemes", """
ddtSchemes      { default Euler; }
gradSchemes     { default Gauss linear; }
divSchemes
{
    default         none;
    div(phi,U)      Gauss upwind;
    div(phi,h)      Gauss upwind;
    div(phi,K)      Gauss upwind;
}
laplacianSchemes { default Gauss linear orthogonal; }
interpolationSchemes { default linear; }
snGradSchemes   { default orthogonal; }
""")
    _write_dict(case_dir, "system", "fvSolution", """
solvers
{
    p_rgh
    {
        solver          GAMG;
        smoother        GaussSeidel;
        tolerance       1e-08;
        relTol          0.01;
    }
    p_rghFinal
    {
        solver          GAMG;
        smoother        GaussSeidel;
        tolerance       1e-08;
        relTol          0;
    }
    "(U|h)"
    {
        solver          smoothSolver;
        smoother        symGaussSeidel;
        tolerance       1e-08;
        relTol          0;
    }
}
PIMPLE
{
    nOuterCorrectors 1;
    nCorrectors     2;
    nNonOrthogonalCorrectors 0;
}
""")
    _write_dict(case_dir, "constant", "thermophysicalProperties",
                _AIR_THERMO)
    ffp = ("        type            fixedFluxPressure;\n"
           "        value           uniform 100000;\n")
    write_field(case_dir, "0", "p_rgh", "volScalarField", "[1 -1 -2 0 0 0 0]",
                "uniform 100000", {w: ffp for w in walls})
    calc = ("        type            calculated;\n"
            "        value           uniform 100000;\n")
    write_field(case_dir, "0", "p", "volScalarField", "[1 -1 -2 0 0 0 0]",
                "uniform 100000", {w: calc for w in walls})
    return mesh


# ---------------------------------------------------------------------------
# the VOF family's small cases (the JAX package's tests write them inline:
# tests/test_interfoam.py, test_intermixing.py, test_phasechange.py)
# ---------------------------------------------------------------------------

def local_euler(case_dir: str):
    """Switch a case's ddtSchemes default to localEuler (LTSInterFoam, as
    tests/test_interfoam.py::test_lts_interfoam does)."""
    p = os.path.join(case_dir, "system", "fvSchemes")
    with open(p) as f:
        s = f.read()
    with open(p, "w") as f:
        f.write(s.replace("default Euler", "default localEuler"))


def mixing_dam_break_case(case_dir: str, n: int = 23, dab: float = 2e-3,
                          **kw) -> PolyMesh:
    """dam_break_case with the miscible pair's diffusivity Dab
    (twoLiquidMixingFoam; Dab of tests/test_interfoam.py::
    test_two_liquid_mixing_stratified)."""
    mesh = dam_break_case(case_dir, n=n, **kw)
    with open(os.path.join(case_dir, "constant", "transportProperties"),
              "a") as f:
        f.write(f"\nDab             Dab [0 2 -1 0 0 0 0] {dab};\n"
                "alphatab        alphatab [0 0 0 0 0 0 0] 1;\n")
    return mesh


def intermixing_case(case_dir: str, n: int = 20) -> PolyMesh:
    """interMixingFoam: air (alpha.air) over oil (alpha.oil, the left half
    of the liquid) and water in a closed 0.1 m box, D23 3e-5 (the case of
    tests/test_intermixing.py, n x n cells)."""
    from ..fields.io import _body_value
    from ..mesh.geometry import cell_centres_and_vols, face_centres_and_areas
    mesh = box_mesh(n, n, 1, size=(0.1, 0.1, 0.005), patch_spec={
        "xmin": ("walls", "wall"), "xmax": ("walls", "wall"),
        "ymin": ("walls", "wall"), "ymax": ("walls", "wall"),
        "zmin": ("fb", "empty"), "zmax": ("fb", "empty")})
    write_polymesh(mesh, case_dir)
    Cf, Sf = face_centres_and_areas(mesh)
    C, _ = cell_centres_and_vols(mesh, Cf, Sf)
    air = (C[:, 1] > 0.06).astype(float)
    oil = ((C[:, 1] <= 0.06) & (C[:, 0] < 0.05)).astype(float)
    _write_dict(case_dir, "system", "controlDict", """
application interMixingFoam; startFrom startTime; startTime 0;
stopAt endTime; endTime 0.05; deltaT 0.001;
writeControl runTime; writeInterval 0.05; writeFormat ascii;
""")
    _write_dict(case_dir, "system", "fvSchemes", """
ddtSchemes { default Euler; }
gradSchemes { default Gauss linear; }
divSchemes { default none; div(phi,alpha) Gauss vanLeer;
             div(phirb,alpha) Gauss linear;
             div(rhoPhi,U) Gauss upwind; }
laplacianSchemes { default Gauss linear orthogonal; }
interpolationSchemes { default linear; }
snGradSchemes { default orthogonal; }
""")
    _write_dict(case_dir, "system", "fvSolution", """
solvers
{
    alpha.air { nAlphaSubCycles 1; cAlpha 1; }
    alpha2 { solver PBiCGStab; preconditioner DILU; tolerance 1e-08;
             relTol 0; }
    p_rgh { solver PCG; preconditioner DIC; tolerance 1e-07;
            relTol 0.05; }
    p_rghFinal { solver PCG; preconditioner DIC; tolerance 1e-07;
                 relTol 0; }
    U { solver smoothSolver; smoother symGaussSeidel; tolerance 1e-06;
        relTol 0; }
}
PIMPLE
{
    momentumPredictor no; nOuterCorrectors 1; nCorrectors 2;
    nNonOrthogonalCorrectors 0; pRefCell 0; pRefValue 0;
}
""")
    _write_dict(case_dir, "constant", "transportProperties", """
phases (air oil water);

air   { transportModel Newtonian; nu nu [0 2 -1 0 0 0 0] 1.48e-05;
        rho rho [1 -3 0 0 0 0 0] 1; }
oil   { transportModel Newtonian; nu nu [0 2 -1 0 0 0 0] 1e-05;
        rho rho [1 -3 0 0 0 0 0] 900; }
water { transportModel Newtonian; nu nu [0 2 -1 0 0 0 0] 1e-06;
        rho rho [1 -3 0 0 0 0 0] 1000; }

D23     D23 [0 2 -1 0 0 0 0] 3e-05;
sigma12 sigma12 [1 0 -2 0 0 0 0] 0.05;
sigma13 sigma13 [1 0 -2 0 0 0 0] 0.04;
""")
    _write_g(case_dir)
    bc = {"walls": _ZG, "fb": _EMPTY}
    write_field(case_dir, "0", "alpha.air", "volScalarField",
                "[0 0 0 0 0 0 0]", _body_value(air), bc)
    write_field(case_dir, "0", "alpha.oil", "volScalarField",
                "[0 0 0 0 0 0 0]", _body_value(oil), bc)
    write_field(case_dir, "0", "p_rgh", "volScalarField", "[1 -1 -2 0 0 0 0]",
                "uniform 0", bc)
    write_field(case_dir, "0", "U", "volVectorField", "[0 1 -1 0 0 0 0]",
                "uniform (0 0 0)", {"walls": _fv("(0 0 0)"), "fb": _EMPTY})
    return mesh


def cavitating_channel_case(case_dir: str, nx: int = 30,
                            ny: int = 6) -> PolyMesh:
    """interPhaseChangeFoam (SchnerrSauer): water entering a 0.1 x 0.02 m
    channel at 5 m/s and leaving through an outlet held at 1000 Pa, below
    pSat 2300 Pa, so vapour forms there (the case of
    tests/test_phasechange.py::test_cavitating_channel)."""
    mesh = box_mesh(nx, ny, 1, size=(0.1, 0.02, 0.005), patch_spec={
        "xmin": ("inlet", "patch"), "xmax": ("outlet", "patch"),
        "ymin": ("walls", "wall"), "ymax": ("walls", "wall"),
        "zmin": ("fb", "empty"), "zmax": ("fb", "empty")})
    write_polymesh(mesh, case_dir)
    _write_dict(case_dir, "system", "controlDict", """
application interPhaseChangeFoam; startFrom startTime; startTime 0;
stopAt endTime; endTime 0.002; deltaT 5e-05;
writeControl timeStep; writeInterval 1000; writeFormat ascii;
""")
    _write_dict(case_dir, "system", "fvSchemes", """
ddtSchemes { default Euler; }
gradSchemes { default Gauss linear; }
divSchemes { default none; div(phi,alpha) Gauss vanLeer;
             div(rhoPhi,U) Gauss upwind; }
laplacianSchemes { default Gauss linear orthogonal; }
interpolationSchemes { default linear; }
snGradSchemes { default orthogonal; }
""")
    _write_dict(case_dir, "system", "fvSolution", """
solvers
{
    alpha1 { solver PBiCGStab; preconditioner DILU; tolerance 1e-10;
             relTol 0; }
    p_rgh { solver PCG; preconditioner DIC; tolerance 1e-08;
            relTol 0.01; }
    p_rghFinal { solver PCG; preconditioner DIC; tolerance 1e-08;
                 relTol 0; }
    U { solver smoothSolver; smoother symGaussSeidel; tolerance 1e-07;
        relTol 0; }
}
PIMPLE { nOuterCorrectors 1; nCorrectors 2;
         nNonOrthogonalCorrectors 0; }
""")
    _write_dict(case_dir, "constant", "transportProperties", """
phases (water vapour);
phase1 { rho rho [1 -3 0 0 0 0 0] 1000; nu nu [0 2 -1 0 0 0 0] 9e-07; }
phase2 { rho rho [1 -3 0 0 0 0 0] 0.02; nu nu [0 2 -1 0 0 0 0] 4e-05; }
sigma           sigma [1 0 -2 0 0 0 0] 0.07;
phaseChangeTwoPhaseMixture SchnerrSauer;
pSat            pSat [1 -1 -2 0 0 0 0] 2300;
SchnerrSauerCoeffs
{
    n               n [0 -3 0 0 0 0 0] 1.6e+13;
    dNuc            dNuc [0 1 0 0 0 0 0] 2e-06;
    Cc              Cc [0 0 0 0 0 0 0] 1;
    Cv              Cv [0 0 0 0 0 0 0] 1;
}
""")
    _write_dict(case_dir, "constant", "g",
                "\ndimensions      [0 1 -2 0 0 0 0];\n"
                "value           (0 0 0);\n",
                cls="uniformDimensionedVectorField")
    write_field(case_dir, "0", "alpha1", "volScalarField", "[0 0 0 0 0 0 0]",
                "uniform 1", {"inlet": _fv(1), "outlet": _ZG, "walls": _ZG,
                              "fb": _EMPTY})
    write_field(case_dir, "0", "U", "volVectorField", "[0 1 -1 0 0 0 0]",
                "uniform (5 0 0)", {"inlet": _fv("(5 0 0)"), "outlet": _ZG,
                                    "walls": _fv("(0 0 0)"), "fb": _EMPTY})
    write_field(case_dir, "0", "p_rgh", "volScalarField", "[1 -1 -2 0 0 0 0]",
                "uniform 1000", {"inlet": _ZG, "outlet": _fv(1000),
                                 "walls": _ZG, "fb": _EMPTY})
    return mesh


# -- the rest of the incompressible multiphase family -------------------------

_MULTIPHASE_TRANSPORT = """
phases
(
    water { rho rho [1 -3 0 0 0 0 0] 1000; nu nu [0 2 -1 0 0 0 0] 1e-06; }
    oil { rho rho [1 -3 0 0 0 0 0] 500; nu nu [0 2 -1 0 0 0 0] 1e-06; }
    air { rho rho [1 -3 0 0 0 0 0] 1; nu nu [0 2 -1 0 0 0 0] 1.48e-05; }
);
sigmas
(
    (water oil) 0.01
    (water air) 0.07
    (oil air) 0.03
);
"""

_MULTIPHASE_SCHEMES = """
ddtSchemes { default Euler; }
gradSchemes { default Gauss linear; }
divSchemes { default none; div(phi,alpha) Gauss vanLeer;
             div(rhoPhi,U) Gauss linearUpwind grad(U); }
laplacianSchemes { default Gauss linear orthogonal; }
interpolationSchemes { default linear; }
snGradSchemes { default orthogonal; }
"""

_MULTIPHASE_SOLUTION = """
solvers
{
    alpha { cAlpha 1; }
    p_rgh { solver PCG; preconditioner DIC; tolerance 1e-07;
            relTol 0.05; }
    p_rghFinal { solver PCG; preconditioner DIC; tolerance 1e-07;
                 relTol 0; }
    U { solver smoothSolver; smoother symGaussSeidel; tolerance 1e-06;
        relTol 0; }
}
PIMPLE { nOuterCorrectors 1; nCorrectors 3;
         nNonOrthogonalCorrectors 0; }
"""


def _cell_centres(mesh: PolyMesh) -> np.ndarray:
    from ..mesh.geometry import cell_centres_and_vols, face_centres_and_areas
    Cf, Sf = face_centres_and_areas(mesh)
    return cell_centres_and_vols(mesh, Cf, Sf)[0]


def _multiphase_case(case_dir: str, fractions: dict, walls: dict,
                     empty: str, end_time: float, delta_t: float):
    """multiphaseInterFoam's dictionaries, alpha<phase> fields (fractions
    maps a phase to its cell values), U at rest and p_rgh 0; walls maps a
    patch to its U entry, empty names the empty patch."""
    from ..fields.io import _body_value
    _write_dict(case_dir, "system", "controlDict", f"""
application multiphaseInterFoam; startFrom startTime; startTime 0;
stopAt endTime; endTime {end_time}; deltaT {delta_t};
writeControl timeStep; writeInterval 1000; writeFormat ascii;
""")
    _write_dict(case_dir, "system", "fvSchemes", _MULTIPHASE_SCHEMES)
    _write_dict(case_dir, "system", "fvSolution", _MULTIPHASE_SOLUTION)
    _write_dict(case_dir, "constant", "transportProperties",
                _MULTIPHASE_TRANSPORT)
    _write_g(case_dir)
    bcs = {name: _ZG for name in walls}
    bcs[empty] = _EMPTY
    for name, arr in fractions.items():
        write_field(case_dir, "0", f"alpha{name}", "volScalarField",
                    "[0 0 0 0 0 0 0]", _body_value(arr, prec=10), bcs)
    write_field(case_dir, "0", "U", "volVectorField", "[0 1 -1 0 0 0 0]",
                "uniform (0 0 0)", dict(walls, **{empty: _EMPTY}))
    write_field(case_dir, "0", "p_rgh", "volScalarField",
                "[1 -1 -2 0 0 0 0]", "uniform 0", bcs)


def stratified_tank_case(case_dir: str, nx: int = 20, ny: int = 12,
                         end_time: float = 0.03,
                         delta_t: float = 0.00025) -> PolyMesh:
    """multiphaseInterFoam: water below, oil in the middle and air on top
    of a closed 0.2 x 0.12 m box (1000/500/1 kg/m^3, sigma 0.01/0.07/0.03
    N/m; the case of tests/test_phasechange.py::
    test_multiphase_inter_three_phase_dam)."""
    mesh = box_mesh(nx, ny, 1, size=(0.2, 0.12, 0.01), patch_spec={
        "xmin": ("walls", "wall"), "xmax": ("walls", "wall"),
        "ymin": ("walls", "wall"), "ymax": ("top", "wall"),
        "zmin": ("fb", "empty"), "zmax": ("fb", "empty")})
    write_polymesh(mesh, case_dir)
    y = _cell_centres(mesh)[:, 1]
    water = (y < 0.04).astype(float)
    oil = ((y >= 0.04) & (y < 0.08)).astype(float)
    _multiphase_case(case_dir,
                     {"water": water, "oil": oil, "air": 1.0 - water - oil},
                     {"walls": _fv("(0 0 0)"), "top": _fv("(0 0 0)")},
                     "fb", end_time, delta_t)
    return mesh


def multiphase_dam_break_case(case_dir: str, n: int = 64,
                              delta_t: float = 1e-4, end_time: float = 0.1,
                              write_mesh: bool = True) -> PolyMesh:
    """A three-phase dam break for multiphaseInterFoam, after OpenFOAM's
    multiphase/multiphaseInterFoam/laminar/damBreak4phase tutorial as
    dam_break_case simplifies damBreak: the closed 0.584 m box without the
    obstacle, a water column of damBreak's 0.1461 x 0.292 m at the left
    wall and an oil column of the same size beside it, air elsewhere
    (stratified_tank_case's phases and sigmas; no mercury and no
    contact-angle walls). n x n cells, the mesh of dam_break_case(n=n);
    write_mesh=False leaves it unwritten (pass the returned PolyMesh, or
    dam_break_case's, to Case(pmesh=))."""
    L = 0.584
    mesh = box_mesh(n, n, 1, size=(L, L, 0.0146), patch_spec={
        "xmin": ("walls", "wall"), "xmax": ("walls", "wall"),
        "ymin": ("walls", "wall"), "ymax": ("walls", "wall"),
        "zmin": ("frontAndBack", "empty"),
        "zmax": ("frontAndBack", "empty")})
    if write_mesh:
        write_polymesh(mesh, case_dir)
    C = _cell_centres(mesh)
    low = C[:, 1] < 0.5 * L
    water = (low & (C[:, 0] < 0.25 * L)).astype(float)
    oil = (low & (C[:, 0] >= 0.25 * L) & (C[:, 0] < 0.5 * L)).astype(float)
    _multiphase_case(case_dir,
                     {"water": water, "oil": oil, "air": 1.0 - water - oil},
                     {"walls": _fv("(0 0 0)")}, "frontAndBack", end_time,
                     delta_t)
    return mesh


def settling_column_case(case_dir: str, nx: int = 4, ny: int = 40,
                         delta_t: float = 0.05, end_time: float = 2.0,
                         write_mesh: bool = True) -> PolyMesh:
    """driftFluxFoam: sludge (1996 kg/m^3, alpha 0.005) settling in water
    (996 kg/m^3) in a closed 0.05 x 0.5 m column, the simple relative
    velocity model with V0 (0 -0.05 0) and the plastic viscosity (the case
    of tests/test_phasechange.py::test_drift_flux_settling at nx x ny)."""
    mesh = box_mesh(nx, ny, 1, size=(0.05, 0.5, 0.01), patch_spec={
        "xmin": ("walls", "wall"), "xmax": ("walls", "wall"),
        "ymin": ("bottom", "wall"), "ymax": ("top", "wall"),
        "zmin": ("fb", "empty"), "zmax": ("fb", "empty")})
    if write_mesh:
        write_polymesh(mesh, case_dir)
    _write_dict(case_dir, "system", "controlDict", f"""
application driftFluxFoam; startFrom startTime; startTime 0;
stopAt endTime; endTime {end_time}; deltaT {delta_t};
writeControl timeStep; writeInterval 1000; writeFormat ascii;
""")
    _write_dict(case_dir, "system", "fvSchemes", """
ddtSchemes { default Euler; }
gradSchemes { default Gauss linear; }
divSchemes { default none; div(phi,alpha) Gauss vanLeer;
             div(rhoPhi,U) Gauss upwind; }
laplacianSchemes { default Gauss linear orthogonal; }
interpolationSchemes { default linear; }
snGradSchemes { default orthogonal; }
""")
    _write_dict(case_dir, "system", "fvSolution", """
solvers
{
    "alpha.*" { solver PBiCGStab; preconditioner DILU;
                tolerance 1e-10; relTol 0; }
    p_rgh { solver PCG; preconditioner DIC; tolerance 1e-08;
            relTol 0.01; }
    p_rghFinal { solver PCG; preconditioner DIC; tolerance 1e-08;
                 relTol 0; }
    alpha1 { solver PBiCGStab; preconditioner DILU; tolerance 1e-10;
             relTol 0; }
    U { solver smoothSolver; smoother symGaussSeidel; tolerance 1e-07;
        relTol 0; }
}
PIMPLE { nOuterCorrectors 1; nCorrectors 2;
         nNonOrthogonalCorrectors 0; }
""")
    _write_dict(case_dir, "constant", "transportProperties", """
phases (sludge water);
sludge { rho rho [1 -3 0 0 0 0 0] 1996; }
water { rho rho [1 -3 0 0 0 0 0] 996; nu nu [0 2 -1 0 0 0 0] 1e-06; }
plasticCoeffs
{
    plasticViscosityCoeff plasticViscosityCoeff [1 -1 -1 0 0] 0.001;
    plasticViscosityExponent plasticViscosityExponent [0 0 0 0 0] 2;
    muMax muMax [1 -1 -1 0 0] 10;
}
relativeVelocityModel simple;
simpleCoeffs
{
    V0 V0 [0 1 -1 0 0 0 0] (0 -0.05 0);
    a a [0 0 0 0 0 0 0] 5;
    a1 a1 [0 0 0 0 0 0 0] 0.1;
    residualAlpha residualAlpha [0 0 0 0 0 0 0] 0;
}
""")
    _write_g(case_dir)
    bcs = {"walls": _ZG, "bottom": _ZG, "top": _ZG, "fb": _EMPTY}
    write_field(case_dir, "0", "alpha1", "volScalarField", "[0 0 0 0 0 0 0]",
                "uniform 0.005", bcs)
    write_field(case_dir, "0", "U", "volVectorField", "[0 1 -1 0 0 0 0]",
                "uniform (0 0 0)", {
                    "walls": _fv("(0 0 0)"), "bottom": _fv("(0 0 0)"),
                    "top": _fv("(0 0 0)"), "fb": _EMPTY})
    write_field(case_dir, "0", "p_rgh", "volScalarField", "[1 -1 -2 0 0 0 0]",
                "uniform 0", bcs)
    return mesh


def sloshing_tank_case(case_dir: str, nx: int = 20, ny: int = 10,
                       delta_t: float = 0.002,
                       end_time: float = 0.1) -> PolyMesh:
    """potentialFreeSurfaceFoam: a 0.2 x 0.1 m tank whose top is the
    waveSurfacePressure patch, set sloshing by U = 0.2 sin(pi x / 0.2)
    (the case of tests/test_phasechange.py::
    test_potential_free_surface_sloshing at nx x ny)."""
    mesh = box_mesh(nx, ny, 1, size=(0.2, 0.1, 0.01), patch_spec={
        "xmin": ("left", "wall"), "xmax": ("right", "wall"),
        "ymin": ("bottom", "wall"), "ymax": ("freeSurface", "patch"),
        "zmin": ("fb", "empty"), "zmax": ("fb", "empty")})
    write_polymesh(mesh, case_dir)
    _write_dict(case_dir, "system", "controlDict", f"""
application potentialFreeSurfaceFoam; startFrom startTime; startTime 0;
stopAt endTime; endTime {end_time}; deltaT {delta_t};
writeControl timeStep; writeInterval 1000; writeFormat ascii;
""")
    _write_dict(case_dir, "system", "fvSchemes", """
ddtSchemes { default Euler; }
gradSchemes { default Gauss linear; }
divSchemes { default none; div(phi,U) Gauss upwind; }
laplacianSchemes { default Gauss linear orthogonal; }
interpolationSchemes { default linear; }
snGradSchemes { default orthogonal; }
""")
    _write_dict(case_dir, "system", "fvSolution", """
solvers
{
    p_gh { solver PCG; preconditioner DIC; tolerance 1e-08;
           relTol 0.01; }
    p_ghFinal { solver PCG; preconditioner DIC; tolerance 1e-08;
                relTol 0; }
    U { solver smoothSolver; smoother symGaussSeidel; tolerance 1e-07;
        relTol 0; }
}
PIMPLE { nOuterCorrectors 1; nCorrectors 2;
         nNonOrthogonalCorrectors 0; }
""")
    _write_dict(case_dir, "constant", "transportProperties",
                "\nnu              nu [0 2 -1 0 0 0 0] 1e-05;\n")
    _write_g(case_dir)
    x = _cell_centres(mesh)[:, 0]
    body = "nonuniform List<vector>\n%d\n(\n%s\n)" % (
        len(x), "\n".join(f"({a:.8g} 0 0)"
                          for a in 0.2 * np.sin(np.pi * x / 0.2)))
    walls = {"left": _fv("(0 0 0)"), "right": _fv("(0 0 0)"),
             "bottom": _fv("(0 0 0)")}
    write_field(case_dir, "0", "U", "volVectorField", "[0 1 -1 0 0 0 0]",
                body, dict(walls, freeSurface=_ZG, fb=_EMPTY))
    write_field(case_dir, "0", "p_gh", "volScalarField", "[0 2 -2 0 0 0 0]",
                "uniform 0", {
                    "left": _ZG, "right": _ZG, "bottom": _ZG,
                    "freeSurface":
                        "        type            waveSurfacePressure;\n"
                        "        value           uniform 0;\n",
                    "fb": _EMPTY})
    return mesh


def cavitating_expansion_case(case_dir: str, nx: int = 40, ny: int = 4,
                              delta_t: float = 2e-6,
                              end_time: float = 0.0004) -> PolyMesh:
    """cavitatingFoam: liquid (830 kg/m^3) driven through a 0.04 x 0.004 m
    channel from 3e5 Pa into an outlet held at 3000 Pa, below pSat 8000
    Pa, where it flashes to vapour through the barotropic relation (the
    case of tests/test_phasechange.py::test_cavitating_foam_expansion at
    nx x ny)."""
    mesh = box_mesh(nx, ny, 1, size=(0.04, 0.004, 0.001), patch_spec={
        "xmin": ("inlet", "patch"), "xmax": ("outlet", "patch"),
        "ymin": ("walls", "wall"), "ymax": ("walls", "wall"),
        "zmin": ("fb", "empty"), "zmax": ("fb", "empty")})
    write_polymesh(mesh, case_dir)
    _write_dict(case_dir, "system", "controlDict", f"""
application cavitatingFoam; startFrom startTime; startTime 0;
stopAt endTime; endTime {end_time}; deltaT {delta_t};
writeControl timeStep; writeInterval 1000; writeFormat ascii;
""")
    _write_dict(case_dir, "system", "fvSchemes", """
ddtSchemes { default Euler; }
gradSchemes { default Gauss linear; }
divSchemes { default none; div(phi,rho) Gauss upwind;
             div(rhoPhi,U) Gauss upwind; }
laplacianSchemes { default Gauss linear orthogonal; }
interpolationSchemes { default linear; }
snGradSchemes { default orthogonal; }
""")
    _write_dict(case_dir, "system", "fvSolution", """
solvers
{
    rho { solver PBiCGStab; preconditioner DILU; tolerance 1e-08;
          relTol 0; }
    p { solver PCG; preconditioner DIC; tolerance 1e-08; relTol 0.01; }
    pFinal { solver PCG; preconditioner DIC; tolerance 1e-08; relTol 0; }
    U { solver smoothSolver; smoother symGaussSeidel; tolerance 1e-07;
        relTol 0; }
}
PIMPLE { nOuterCorrectors 2; nCorrectors 1;
         nNonOrthogonalCorrectors 0; }
""")
    _write_dict(case_dir, "constant", "thermodynamicProperties", """
psil            psil [0 -2 2 0 0] 4.54e-07;
rholSat         rholSat [1 -3 0 0 0] 830;
psiv            psiv [0 -2 2 0 0] 2.5e-06;
pSat            pSat [1 -1 -2 0 0] 8000;
rhoMin          rhoMin [1 -3 0 0 0] 0.001;
""")
    _write_dict(case_dir, "constant", "transportProperties", """
phases (liquid vapour);
phase1 { rho rho [1 -3 0 0 0 0 0] 830; nu nu [0 2 -1 0 0 0 0] 7.8e-06; }
phase2 { rho rho [1 -3 0 0 0 0 0] 0.02; nu nu [0 2 -1 0 0 0 0] 4e-05; }
sigma           sigma [1 0 -2 0 0 0 0] 0;
""")
    write_field(case_dir, "0", "p", "volScalarField", "[1 -1 -2 0 0 0 0]",
                "uniform 100000", {"inlet": _fv(300000), "outlet": _fv(3000),
                                   "walls": _ZG, "fb": _EMPTY})
    write_field(case_dir, "0", "U", "volVectorField", "[0 1 -1 0 0 0 0]",
                "uniform (0 0 0)", {"inlet": _ZG, "outlet": _ZG,
                                    "walls": _fv("(0 0 0)"), "fb": _EMPTY})
    return mesh


# ---------------------------------------------------------------------------
# porousSimpleFoam's duct
# ---------------------------------------------------------------------------

DUCT_LENGTHS = (0.15, 0.10, 0.10)   # inlet, porous and outlet sections, m
DUCT_SECTION = 0.05                 # square cross-section side, m


def porous_duct_case(case_dir: str, nx: int = 448, ny: int = 48,
                     nz: int = 48, *, write_mesh: bool = True,
                     lattice_out: dict | None = None,
                     zone: str = "cellZone", end_time: float = 100
                     ) -> PolyMesh:
    """A straight square duct with a porous block, modelled on OpenFOAM's
    porousSimpleFoam/angledDuctImplicit tutorial and straightened into a
    box lattice (the angled duct is not one). No copy of the tutorial is
    in the repository: every number here is this writer's choice. x runs
    along the duct: a 0.15 m inlet section, a 0.10 m porous section and a
    0.10 m outlet section, 0.35 m in all, with a 0.05 x 0.05 m section; a
    uniform nx x ny x nz lattice (the default 448 x 48 x 48 is 1,032,192
    cells); patches inlet (xmin), outlet (xmax) and walls.

    The porous section is the cellZone `porosity` (the cells whose centre
    lies in 0.15 <= x <= 0.25), written to constant/polyMesh/cellZones
    even with write_mesh=False, and an explicitPorositySource in
    system/fvOptions selects it by that zone (zone="cellZone") or by the
    same box (zone="box"), with DarcyForchheimer d (5e7 -1000 -1000) and
    f (0 0 0); the selection is written in the source's coefficients
    dictionary too, where the JAX package reads it. nu 1.5e-5; U fixed at
    (1 0 0) m/s on the inlet, noSlip walls, zeroGradient outlet; p
    fixed at 0 on the outlet, zeroGradient elsewhere; kEpsilon with
    nutkWallFunction, epsilonWallFunction and kqRWallFunction walls, k
    3.75e-3 m2/s2 (5% intensity) and epsilon 1.08e-2 m2/s3 (mixing
    length 3.5 mm) at the inlet and inside. `bounded Gauss upwind` for U,
    k and epsilon, Gauss linear gradients, orthogonal laplacians (the
    lattice is orthogonal); p by GAMG (the structured V-cycle on gdia),
    U, k and epsilon by smoothSolver; SIMPLE with relaxation p 0.3, U
    0.7, k and epsilon 0.7.

    write_mesh=False skips the ascii polyMesh (a million cells); the
    returned PolyMesh then goes to Case(pmesh=, lattice=). lattice_out
    receives the gdia embedding: the lattice is the box itself, cells in
    lattice order, no dead slot."""
    if zone not in ("cellZone", "box"):
        raise ValueError(f"porous_duct_case: zone '{zone}' (cellZone|box)")
    length = sum(DUCT_LENGTHS)
    lo, hi = DUCT_LENGTHS[0], DUCT_LENGTHS[0] + DUCT_LENGTHS[1]
    mesh = box_mesh(nx, ny, nz, size=(length, DUCT_SECTION, DUCT_SECTION),
                    patch_spec={
                        "xmin": ("inlet", "patch"),
                        "xmax": ("outlet", "patch"),
                        "ymin": ("walls", "wall"), "ymax": ("walls", "wall"),
                        "zmin": ("walls", "wall"), "zmax": ("walls", "wall")})
    if write_mesh:
        write_polymesh(mesh, case_dir)
    nc = nx * ny * nz
    if lattice_out is not None:
        n_int = mesh.n_internal_faces
        lattice_out.update(
            shape=(nz, ny, nx), slot_cell=np.arange(nc, dtype=np.int64),
            ghost_lead=np.arange(nc, dtype=np.int64),
            orig_own_int=mesh.owner[:n_int].copy(),
            orig_nei_int=mesh.neighbour.copy(),
            orig_own_bnd=mesh.owner[n_int:].copy(),
            flip_int=np.zeros(n_int, dtype=bool),
            dead=np.zeros(nc, dtype=bool))
    # cells in lattice order (x fastest): the zone is a run of x indices
    xc = (np.arange(nx) + 0.5) * (length / nx)
    ix = np.nonzero((xc >= lo) & (xc <= hi))[0]
    cells = (ix[None, :] + nx * np.arange(ny * nz)[:, None]).ravel()
    _write_dict(case_dir, "constant/polyMesh", "cellZones",
                f"\n1\n(\nporosity\n{{\n    type cellZone;\ncellLabels "
                f"List<label>\n{cells.size}\n(\n"
                + "\n".join(map(str, np.sort(cells))) + "\n)\n;\n}\n)\n",
                cls="regIOobject")
    def select(indent):
        pad = "\n" + " " * indent
        if zone == "cellZone":
            return f"selectionMode   cellZone;{pad}cellZone        porosity;"
        return (f"selectionMode   box;{pad}box             (({lo:g} 0 0) "
                f"({hi:g} {DUCT_SECTION:g} {DUCT_SECTION:g}));")
    _write_dict(case_dir, "system", "fvOptions", f"""
porosity1
{{
    type            explicitPorositySource;
    active          yes;
    {select(4)}

    explicitPorositySourceCoeffs
    {{
        type            DarcyForchheimer;
        {select(8)}

        DarcyForchheimerCoeffs
        {{
            d   d [0 -2 0 0 0 0 0] (5e7 -1000 -1000);
            f   f [0 -1 0 0 0 0 0] (0 0 0);
            coordinateSystem {{ e1 (1 0 0); e2 (0 1 0); }}
        }}
    }}
}}
""")
    _write_dict(case_dir, "system", "controlDict", f"""
application     porousSimpleFoam;
startFrom       startTime;
startTime       0;
stopAt          endTime;
endTime         {end_time:g};
deltaT          1;
writeControl    timeStep;
writeInterval   100;
writeFormat     ascii;
writePrecision  8;
""")
    _write_dict(case_dir, "system", "fvSchemes", """
ddtSchemes      { default steadyState; }
gradSchemes     { default Gauss linear; }
divSchemes
{
    default         none;
    div(phi,U)      bounded Gauss upwind;
    div(phi,k)      bounded Gauss upwind;
    div(phi,epsilon) bounded Gauss upwind;
    div((nuEff*dev(T(grad(U))))) Gauss linear;
}
laplacianSchemes { default Gauss linear orthogonal; }
interpolationSchemes { default linear; }
snGradSchemes   { default orthogonal; }
""")
    _write_dict(case_dir, "system", "fvSolution", """
solvers
{
    p
    {
        solver          GAMG;
        smoother        GaussSeidel;
        tolerance       1e-08;
        relTol          0.05;
    }
    "(U|k|epsilon)"
    {
        solver          smoothSolver;
        smoother        symGaussSeidel;
        tolerance       1e-08;
        relTol          0.1;
    }
}
SIMPLE
{
    nNonOrthogonalCorrectors 0;
    residualControl { p 1e-2; U 1e-3; "(k|epsilon)" 1e-3; }
}
relaxationFactors
{
    fields    { p 0.3; }
    equations { U 0.7; k 0.7; epsilon 0.7; }
}
""")
    _write_dict(case_dir, "constant", "transportProperties", """
transportModel  Newtonian;
nu              nu [0 2 -1 0 0 0 0] 1.5e-05;
""")
    _write_dict(case_dir, "constant", "RASProperties",
                "\nRASModel kEpsilon;\nturbulence on;\nprintCoeffs on;\n")
    write_field(case_dir, "0", "U", "volVectorField", "[0 1 -1 0 0 0 0]",
                "uniform (0 0 0)", {
                    "inlet": _fv("(1 0 0)"), "outlet": _ZG,
                    "walls": "        type            noSlip;\n"})
    write_field(case_dir, "0", "p", "volScalarField", "[0 2 -2 0 0 0 0]",
                "uniform 0", {"inlet": _ZG, "outlet": _fv(0),
                              "walls": _ZG})
    for name, dims, value, word in (
            ("k", "[0 2 -2 0 0 0 0]", "0.00375", "kqRWallFunction"),
            ("epsilon", "[0 2 -3 0 0 0 0]", "0.0108",
             "epsilonWallFunction"),
            ("nut", "[0 2 -1 0 0 0 0]", "0", "nutkWallFunction")):
        wall = (f"        type            {word};\n"
                f"        value           uniform {value};\n")
        inlet = _fv(value) if name != "nut" else \
            "        type            calculated;\n" \
            "        value           uniform 0;\n"
        outlet = _ZG if name != "nut" else inlet
        write_field(case_dir, "0", name, "volScalarField", dims,
                    f"uniform {value}", {"inlet": inlet, "outlet": outlet,
                                         "walls": wall})
    return mesh


# ---------------------------------------------------------------------------
# the small cases of the JAX package's fvOptions, basic-solver and
# non-Newtonian tests (tests/test_fvoptions.py, test_fvoptions_extra.py,
# test_basic_solvers.py and test_electromagnetics.py write them inline)
# ---------------------------------------------------------------------------

#: viscosity-model coefficients for transportProperties (the writers'
#: choice: each model varies over the strain rates of the cavities here)
VISCOSITY_COEFFS = {
    "powerLaw": "powerLawCoeffs { k k [0 2 -1 0 0 0 0] 0.01; n n [0 0 0 0 "
                "0 0 0] 0.6; nuMin nuMin [0 2 -1 0 0 0 0] 1e-4; nuMax nuMax "
                "[0 2 -1 0 0 0 0] 5e-3; }",
    "BirdCarreau": "BirdCarreauCoeffs { nu0 nu0 [0 2 -1 0 0 0 0] 1e-2; nuInf "
                   "nuInf [0 2 -1 0 0 0 0] 1e-4; k k [0 0 1 0 0 0 0] 0.05; "
                   "n n [0 0 0 0 0 0 0] 0.5; }",
    "CrossPowerLaw": "CrossPowerLawCoeffs { nu0 nu0 [0 2 -1 0 0 0 0] 1e-2; "
                     "nuInf nuInf [0 2 -1 0 0 0 0] 1e-3; m m [0 0 1 0 0 0 0] "
                     "0.1; n n [0 0 0 0 0 0 0] 0.8; }",
    "HerschelBulkley": "HerschelBulkleyCoeffs { nu0 nu0 [0 2 -1 0 0 0 0] "
                       "1e-2; tau0 tau0 [0 2 -2 0 0 0 0] 0.05; k k [0 2 -1 0 "
                       "0 0 0] 2e-3; n n [0 0 0 0 0 0 0] 0.7; }",
}


def write_viscosity_model(case_dir: str, model: str, nu: float = 0.01):
    """constant/transportProperties selecting `model` with its
    VISCOSITY_COEFFS (nonNewtonianIcoFoam's input)."""
    _write_dict(case_dir, "constant", "transportProperties",
                f"\ntransportModel  {model};\nnu              nu [0 2 -1 0 0 "
                f"0 0] {nu:g};\n{VISCOSITY_COEFFS.get(model, '')}\n")


def thermal_cavity_case(case_dir: str, n: int = 20, *,
                        end_time: float = 0.05, delta_t: float = 0.005,
                        tol: float = 1e-8,
                        u_internal: str = "uniform (0.5 0 0)",
                        write_mesh: bool = True) -> PolyMesh:
    """tests/test_basic_solvers.py's thermal cavity for laplacianFoam,
    scalarTransportFoam and potentialFoam: the n x n cavity with DT 0.01,
    T fixed at 350 K on the lid and 300 K on the other walls, U (the
    frozen velocity of scalarTransportFoam) u_internal inside and (0.5 0
    0) on the walls, vanLeer for div(phi,T), and Phi [m2/s] (zeroGradient
    walls), which potentialFoam solves for. T and Phi by PCG/DIC to tol."""
    mesh = cavity_case(case_dir, n=n, end_time=end_time, delta_t=delta_t,
                       write_mesh=write_mesh)
    _write_dict(case_dir, "constant", "transportProperties",
                "\nDT              DT [ 0 2 -1 0 0 0 0 ] 0.01;\n"
                "nu              nu [ 0 2 -1 0 0 0 0 ] 0.01;\n")
    _write_dict(case_dir, "system", "fvSolution", f"""
solvers
{{
    T {{ solver PCG; preconditioner DIC; tolerance {tol:g}; relTol 0; }}
    Phi {{ solver PCG; preconditioner DIC; tolerance {tol:g}; relTol 0; }}
    p {{ solver PCG; preconditioner DIC; tolerance 1e-06; relTol 0.05; }}
    pFinal {{ solver PCG; preconditioner DIC; tolerance 1e-06; relTol 0; }}
    U {{ solver smoothSolver; smoother symGaussSeidel; tolerance 1e-05;
        relTol 0; }}
}}
SIMPLE {{ nNonOrthogonalCorrectors 0; }}
PISO {{ nCorrectors 2; nNonOrthogonalCorrectors 0; pRefCell 0;
       pRefValue 0; }}
""")
    _write_dict(case_dir, "system", "fvSchemes", """
ddtSchemes      { default Euler; }
gradSchemes     { default Gauss linear; }
divSchemes      { default none; div(phi,U) Gauss linear;
                  div(phi,T) Gauss vanLeer; }
laplacianSchemes { default Gauss linear orthogonal; }
interpolationSchemes { default linear; }
snGradSchemes   { default orthogonal; }
""")
    walls = ("movingWall", "fixedWalls")
    write_field(case_dir, "0", "T", "volScalarField", "[0 0 0 1 0 0 0]",
                "uniform 300", {"movingWall": _fv(350),
                                "fixedWalls": _fv(300),
                                "frontAndBack": _EMPTY})
    write_field(case_dir, "0", "U", "volVectorField", "[0 1 -1 0 0 0 0]",
                u_internal, dict({w: _fv("(0.5 0 0)") for w in walls},
                                 frontAndBack=_EMPTY))
    write_field(case_dir, "0", "Phi", "volScalarField", "[0 2 -1 0 0 0 0]",
                "uniform 0", dict({w: _ZG for w in walls},
                                  frontAndBack=_EMPTY))
    return mesh


_ACTUATION_DISK = """
disk1
{
    type            actuationDiskSource;
    selectionMode   box;
    box             ((0.45 0 0) (0.55 0.2 0.01));
    diskDir         (1 0 0);
    Cp              0.386;
    Ct              0.58;
    diskArea        0.002;
    upstreamPoint   (0.2 0.1 0.005);
}
"""


def disk_channel_case(case_dir: str) -> PolyMesh:
    """tests/test_fvoptions.py's pisoFoam channel (1 x 0.2 m, 40 x 8,
    laminar, U 1 m/s in, slip sides) with the test's actuation disk
    across the middle in system/fvOptions."""
    mesh = box_mesh(40, 8, 1, size=(1.0, 0.2, 0.01), patch_spec={
        "xmin": ("inlet", "patch"), "xmax": ("outlet", "patch"),
        "ymin": ("sides", "patch"), "ymax": ("sides", "patch"),
        "zmin": ("fb", "empty"), "zmax": ("fb", "empty")})
    write_polymesh(mesh, case_dir)
    _write_dict(case_dir, "system", "controlDict", """
application pisoFoam; startFrom startTime; startTime 0;
stopAt endTime; endTime 0.5; deltaT 0.01;
writeControl timeStep; writeInterval 1000; writeFormat ascii;
""")
    _write_dict(case_dir, "system", "fvSchemes", """
ddtSchemes { default Euler; }
gradSchemes { default Gauss linear; }
divSchemes { default none; div(phi,U) Gauss upwind; }
laplacianSchemes { default Gauss linear orthogonal; }
interpolationSchemes { default linear; }
snGradSchemes { default orthogonal; }
""")
    _write_dict(case_dir, "system", "fvSolution", """
solvers
{
    p { solver PCG; preconditioner DIC; tolerance 1e-08; relTol 0.01; }
    pFinal { solver PCG; preconditioner DIC; tolerance 1e-08; relTol 0; }
    U { solver smoothSolver; smoother symGaussSeidel;
        tolerance 1e-08; relTol 0; }
}
PISO { nCorrectors 2; nNonOrthogonalCorrectors 0; }
""")
    _write_dict(case_dir, "constant", "transportProperties",
                "\nnu              nu [0 2 -1 0 0 0 0] 1e-05;\n")
    _write_dict(case_dir, "constant", "RASProperties",
                "\nRASModel        laminar;\nturbulence      off;\n")
    _write_dict(case_dir, "system", "fvOptions", _ACTUATION_DISK)
    write_field(case_dir, "0", "p", "volScalarField", "[0 2 -2 0 0 0 0]",
                "uniform 0", {"inlet": _ZG, "outlet": _fv(0), "sides": _ZG,
                              "fb": _EMPTY})
    write_field(case_dir, "0", "U", "volVectorField", "[0 1 -1 0 0 0 0]",
                "uniform (1 0 0)", {
                    "inlet": _fv("(1 0 0)"), "outlet": _ZG,
                    "sides": "        type            slip;\n",
                    "fb": _EMPTY})
    return mesh


_BOUSSINESQ_SOURCES = """
heat1
{
    type            scalarSemiImplicitSource;
    selectionMode   box;
    box             ((0 0 0) (0.3 0.2 0.01));
    volumeMode      specific;
    injectionRateSuSp { T (2 0); }
}
limit1
{
    type            limitTemperature;
    selectionMode   all;
    Tmin            299;
    Tmax            300.3;
}
melt1
{
    type            solidificationMeltingSource;
    selectionMode   box;
    box             ((0.4 0 0) (0.8 0.1 0.01));
    Tmelt           400;
    L               100000;
    beta            3e-03;
    rhoRef          1000;
    Cp              1000;
}
"""


def boussinesq_channel_case(case_dir: str) -> PolyMesh:
    """tests/test_fvoptions_extra.py's laminar Boussinesq channel (1 x 0.2
    m, 30 x 8, U 0.1 m/s and T 300 K in, g (0 -1e-6 0)) with three
    sources in system/fvOptions: a heating semiImplicitSource in the
    first 0.3 m, limitTemperature to 299-300.3 K (the second iteration
    takes some cells above it, the first none) and the test's
    solidificationMeltingSource, whose box stays solid (T < Tmelt)."""
    mesh = box_mesh(30, 8, 1, size=(1.0, 0.2, 0.01), patch_spec={
        "xmin": ("inlet", "patch"), "xmax": ("outlet", "patch"),
        "ymin": ("walls", "wall"), "ymax": ("walls", "wall"),
        "zmin": ("fb", "empty"), "zmax": ("fb", "empty")})
    write_polymesh(mesh, case_dir)
    _write_dict(case_dir, "system", "controlDict", """
application buoyantBoussinesqSimpleFoam;
startFrom startTime; startTime 0; stopAt endTime; endTime 60;
deltaT 1; writeControl timeStep; writeInterval 100; writeFormat ascii;
""")
    _write_dict(case_dir, "system", "fvSchemes", """
ddtSchemes { default steadyState; }
gradSchemes { default Gauss linear; }
divSchemes { default none; div(phi,U) bounded Gauss upwind;
             div(phi,T) bounded Gauss upwind; }
laplacianSchemes { default Gauss linear orthogonal; }
interpolationSchemes { default linear; }
snGradSchemes { default orthogonal; }
""")
    _write_dict(case_dir, "system", "fvSolution", """
solvers
{
    p_rgh { solver GAMG; smoother GaussSeidel; tolerance 1e-08;
            relTol 0.05; }
    "(U|T)" { solver smoothSolver; smoother symGaussSeidel;
              tolerance 1e-07; relTol 0.1; }
}
SIMPLE { nNonOrthogonalCorrectors 0; pRefCell 0; pRefValue 0; }
relaxationFactors
{
    fields { p_rgh 0.5; }
    equations { U 0.5; T 0.5; }
}
""")
    _write_dict(case_dir, "constant", "transportProperties", """
transportModel Newtonian;
nu              nu [0 2 -1 0 0 0 0] 1e-3;
beta            beta [0 0 0 -1 0 0 0] 3e-03;
TRef            TRef [0 0 0 1 0 0 0] 300;
Pr              Pr [0 0 0 0 0 0 0] 0.7;
Prt             Prt [0 0 0 0 0 0 0] 0.85;
""")
    _write_dict(case_dir, "constant", "g",
                "\ndimensions [0 1 -2 0 0 0 0];\nvalue (0 -1e-06 0);\n",
                cls="uniformDimensionedVectorField")
    _write_dict(case_dir, "constant", "RASProperties",
                "\nRASModel laminar;\nturbulence off;\n")
    _write_dict(case_dir, "system", "fvOptions", _BOUSSINESQ_SOURCES)
    write_field(case_dir, "0", "U", "volVectorField", "[0 1 -1 0 0 0 0]",
                "uniform (0.1 0 0)", {"inlet": _fv("(0.1 0 0)"),
                                      "outlet": _ZG,
                                      "walls": _fv("(0 0 0)"), "fb": _EMPTY})
    write_field(case_dir, "0", "p_rgh", "volScalarField", "[0 2 -2 0 0 0 0]",
                "uniform 0", {"inlet": _ZG, "outlet": _fv(0), "walls": _ZG,
                              "fb": _EMPTY})
    write_field(case_dir, "0", "T", "volScalarField", "[0 0 0 1 0 0 0]",
                "uniform 300", {"inlet": _fv(300), "outlet": _ZG,
                                "walls": _ZG, "fb": _EMPTY})
    return mesh


# ---------------------------------------------------------------------------
# the turbulence family: pisoFoam LES on the pitzDaily step, the LES channel
# ---------------------------------------------------------------------------

def pitz_daily_les_dt(scale: int, u_in: float = 10.0,
                      courant: float = 0.3) -> float:
    """pitz_daily_les_case's time step: the inlet Courant number
    u_in dt/dx on the upstream cells (0.0206 m over 12*scale columns)."""
    return courant * (0.0206 / (12 * scale)) / u_in


#: the probe locations of OpenFOAM 2.3's pisoFoam/les/pitzDaily
#: controlDict (along the channel, 0.1 mm under the upper wall)
PITZ_LES_PROBES = tuple((0.0254 * i, 0.0253, 0.0) for i in range(1, 8))

#: that controlDict's function objects
PITZ_LES_FUNCTIONS = """
functions
{
    probes
    {
        type            probes;
        functionObjectLibs ("libsampling.so");
        enabled         true;
        outputControl   timeStep;
        outputInterval  1;
        fields          ( p );
        probeLocations
        (
%s
        );
    }
    fieldAverage1
    {
        type            fieldAverage;
        functionObjectLibs ( "libfieldFunctionObjects.so" );
        enabled         true;
        outputControl   outputTime;
        fields
        (
            U
            {
                mean        on;
                prime2Mean  on;
                base        time;
            }
            p
            {
                mean        on;
                prime2Mean  on;
                base        time;
            }
        );
    }
}
""" % "\n".join(f"            ({x:g} {y:g} {z:g})"
                for x, y, z in PITZ_LES_PROBES)


def pitz_daily_les_case(case_dir: str, scale: int = 1, *,
                        u_in: float = 10.0, nu: float = 1e-05,
                        model: str = "dynOneEqEddy",
                        delta_t: float | None = None,
                        end_time: float | None = None,
                        write_interval: int = 1000,
                        ddt: str = "backward",
                        tutorial: bool = False,
                        fmt: str = "ascii", compress: bool = False,
                        u_seed: int | None = None,
                        write_mesh: bool = True,
                        lattice_out: dict | None = None) -> PolyMesh:
    """pisoFoam LES on the backward-facing step, after OpenFOAM 2.3's
    tutorial incompressible/pisoFoam/les/pitzDaily: LESModel dynOneEqEddy
    (model=) with the cubeRootVol delta and the simple filter; ddt
    backward (ddt=); div(phi,U) Gauss LUST grad(U), div(phi,k) Gauss
    limitedLinear 1; p by GAMG (tolerance 1e-6, relTol 0.05; pFinal
    relTol 0), U and k by smoothSolver symGaussSeidel to 1e-5; PISO with
    2 correctors; nu 1e-5; k starts at 2e-5 with fixedValue 2e-5 at the
    inlet, inletOutlet at the outlet and 0 on the walls; the flow starts
    from rest. The mesh is pitz_daily_case's masked lattice (12*scale +
    100*scale columns, 40*scale rows, the upstream lower half blanked:
    4,240 cells at scale 1, 1,085,440 in 1,146,880 lattice slots at
    scale 16).

    tutorial=True takes the tutorial's U inlet, turbulentInlet
    (referenceField uniform (u_in 0 0), fluctuationScale (0.02 0.01
    0.01), alpha 0.1), and its controlDict functions: probes of p at
    PITZ_LES_PROBES and fieldAverage1 of U and p with mean and
    prime2Mean (PITZ_LES_FUNCTIONS). Without it the inlet is fixedValue
    (u_in 0 0) and there are no functions. fmt ('ascii' or 'binary') and
    compress are the mesh's and the fields' format, on disk and in the
    controlDict's writeFormat and writeCompression.

    Where it departs from the tutorial:
    - the eddy viscosity is the field nut, as the JAX package reads it
      (OpenFOAM 2.3 writes nuSgs);
    - deltaT holds the inlet Courant number near 0.3
      (pitz_daily_les_dt), endTime is 20 steps unless given;
    - the laplacians are Gauss linear orthogonal: the lattice is
      orthogonal, where the tutorial's corrected adds nothing;
    - the delta and the filter are also written inside the model's
      Coeffs dictionary, where the JAX package and the port read them;
    - the mesh is the masked lattice above, not the tutorial's graded
      blockMesh (pitz_daily_case).

    u_seed starts U from a numpy-seeded field (x and y components of 0.5
    m/s standard deviation about rest) in place of rest: from rest
    dynOneEqEddy's coefficients are ratios of rounding residues wherever
    the flow is uniform, so two evaluation orders (two devices, two
    packages) part at 1e-3 in k within a few steps.

    write_mesh=False skips writing the polyMesh: the returned PolyMesh
    then goes to Case(pmesh=, lattice=), and lattice_out receives its gdia
    embedding (masked_grid_mesh)."""
    mesh = _pitz_daily_mesh(scale, lattice_out)
    u_internal = "uniform (0 0 0)"
    if u_seed is not None:
        from ..fields.io import _body_value
        u = 0.5 * np.random.default_rng(u_seed).standard_normal(
            (mesh.n_cells, 3))
        u[:, 2] = 0.0
        u_internal = _body_value(u, 17, binary=fmt == "binary")
    if write_mesh:
        write_polymesh(mesh, case_dir, fmt=fmt, compress=compress)
    dt = pitz_daily_les_dt(scale, u_in) if delta_t is None else delta_t
    if end_time is None:
        end_time = 20 * dt
    _write(os.path.join(case_dir, "system", "controlDict"),
           foamfile_header("dictionary", "controlDict", "system"), f"""
application     pisoFoam;
startFrom       startTime;
startTime       0;
stopAt          endTime;
endTime         {end_time!r};
deltaT          {dt!r};
writeControl    timeStep;
writeInterval   {write_interval};
purgeWrite      0;
writeFormat     {fmt};
writePrecision  6;
writeCompression {"compressed" if compress else "uncompressed"};
runTimeModifiable true;
""" + (PITZ_LES_FUNCTIONS if tutorial else ""))
    _write(os.path.join(case_dir, "system", "fvSchemes"),
           foamfile_header("dictionary", "fvSchemes", "system"), f"""
ddtSchemes      {{ default {ddt}; }}
gradSchemes     {{ default Gauss linear; }}
divSchemes
{{
    default         none;
    div(phi,U)      Gauss LUST grad(U);
    div(phi,k)      Gauss limitedLinear 1;
    div(phi,nuTilda) Gauss limitedLinear 1;
    div((nuEff*dev(T(grad(U))))) Gauss linear;
}}
laplacianSchemes {{ default Gauss linear orthogonal; }}
interpolationSchemes {{ default linear; }}
snGradSchemes   {{ default orthogonal; }}
""")
    _write(os.path.join(case_dir, "system", "fvSolution"),
           foamfile_header("dictionary", "fvSolution", "system"), """
solvers
{
    p
    {
        solver          GAMG;
        tolerance       1e-06;
        relTol          0.05;
        smoother        GaussSeidel;
        nCellsInCoarsestLevel 10;
    }
    pFinal
    {
        solver          GAMG;
        tolerance       1e-06;
        relTol          0;
        smoother        GaussSeidel;
        nCellsInCoarsestLevel 10;
    }
    "(U|k|nuTilda)"
    {
        solver          smoothSolver;
        smoother        symGaussSeidel;
        tolerance       1e-05;
        relTol          0;
    }
}
PISO
{
    nCorrectors     2;
    nNonOrthogonalCorrectors 0;
    pRefCell        0;
    pRefValue       0;
}
""")
    _write_transport(case_dir, nu)
    _write(os.path.join(case_dir, "constant", "turbulenceProperties"),
           foamfile_header("dictionary", "turbulenceProperties", "constant"),
           f"""
simulationType  LESModel;
LESModel        {model};
turbulence      on;
printCoeffs     on;
delta           cubeRootVol;
{model}Coeffs
{{
    filter          simple;
    delta           cubeRootVol;
    cubeRootVolCoeffs {{ deltaCoeff 1; }}
}}
cubeRootVolCoeffs {{ deltaCoeff 1; }}
""")
    write_field(case_dir, "0", "p", "volScalarField", "[0 2 -2 0 0 0 0]",
                "uniform 0", {
                    "inlet": _ZG, "outlet": _fixed("0"),
                    "upperWall": _ZG, "lowerWall": _ZG,
                    "frontAndBack": _EMPTY}, fmt, compress)
    write_field(case_dir, "0", "U", "volVectorField", "[0 1 -1 0 0 0 0]",
                u_internal, {
                    "inlet": (
                        "        type            turbulentInlet;\n"
                        f"        referenceField  uniform ({u_in} 0 0);\n"
                        "        fluctuationScale (0.02 0.01 0.01);\n"
                        "        alpha           0.1;\n"
                        f"        value           uniform ({u_in} 0 0);\n")
                    if tutorial else _fixed(f"({u_in} 0 0)"),
                    "outlet": "        type            inletOutlet;\n"
                              "        inletValue      uniform (0 0 0);\n"
                              "        value           uniform (0 0 0);\n",
                    "upperWall": _fixed("(0 0 0)"),
                    "lowerWall": _fixed("(0 0 0)"),
                    "frontAndBack": _EMPTY}, fmt, compress)
    write_field(case_dir, "0", "k", "volScalarField", "[0 2 -2 0 0 0 0]",
                "uniform 2e-05", {
                    "inlet": _fixed("2e-05"),
                    "outlet": "        type            inletOutlet;\n"
                              "        inletValue      uniform 2e-05;\n"
                              "        value           uniform 2e-05;\n",
                    "upperWall": _fixed("0"), "lowerWall": _fixed("0"),
                    "frontAndBack": _EMPTY}, fmt, compress)
    write_field(case_dir, "0", "nut", "volScalarField", "[0 2 -1 0 0 0 0]",
                "uniform 0", {
                    "inlet": _ZG, "outlet": _ZG, "upperWall": _ZG,
                    "lowerWall": _ZG, "frontAndBack": _EMPTY}, fmt, compress)
    if "SpalartAllmaras" in model:
        write_field(case_dir, "0", "nuTilda", "volScalarField",
                    "[0 2 -1 0 0 0 0]", "uniform 0", {
                        "inlet": _fixed("0"), "outlet": _ZG,
                        "upperWall": _fixed("0"), "lowerWall": _fixed("0"),
                        "frontAndBack": _EMPTY}, fmt, compress)
    return mesh


def les_channel_case(case_dir: str, model: str, coeffs: str = "",
                     extra_schemes: str = "", solver_fields: str = "U",
                     fields=(), end_time: float = 0.01, nx: int = 30,
                     ny: int = 10, ddt: str = "Euler",
                     u_seed: int | None = None) -> PolyMesh:
    """The transient LES channel of the JAX package's tests (a copy of
    tests/test_turbulence_extra.py:21-96's _les_channel, which writes and
    runs it; this writes it only): 0.3 x 0.05 x 0.01 m on nx x ny x 1
    cells, inlet (2 0 0), walls, the empty fb pair; pimpleFoam 1 x 2
    with PCG/DIC p and smoothSolver for solver_fields; nu 1e-5; deltaT
    5e-4; the LES model and its coeffs in constant/turbulenceProperties;
    U, p and nut, and each (name, class, dims, internal, bcs) of fields.
    U starts uniform at (2 0 0), or with u_seed a numpy-seeded stream
    about it (x: 0.2, y: 0.1 standard deviations): in a uniform stream
    the dynamic LES coefficients are ratios of rounding residues
    (filter(UU) - filter(U)filter(U) cancels), which no two evaluation
    orders share."""
    mesh = box_mesh(nx, ny, 1, size=(0.3, 0.05, 0.01), patch_spec={
        "xmin": ("inlet", "patch"), "xmax": ("outlet", "patch"),
        "ymin": ("walls", "wall"), "ymax": ("walls", "wall"),
        "zmin": ("fb", "empty"), "zmax": ("fb", "empty")})
    write_polymesh(mesh, case_dir)
    _write(os.path.join(case_dir, "system", "controlDict"),
           foamfile_header("dictionary", "controlDict", "system"), f"""
application pimpleFoam; startFrom startTime; startTime 0;
stopAt endTime; endTime {end_time}; deltaT 0.0005;
writeControl timeStep; writeInterval 1000; writeFormat ascii;
""")
    _write(os.path.join(case_dir, "system", "fvSchemes"),
           foamfile_header("dictionary", "fvSchemes", "system"), f"""
ddtSchemes {{ default {ddt}; }}
gradSchemes {{ default Gauss linear; }}
divSchemes {{ default none; div(phi,U) Gauss upwind;
             div(phi,k) Gauss upwind; {extra_schemes} }}
laplacianSchemes {{ default Gauss linear orthogonal; }}
interpolationSchemes {{ default linear; }}
snGradSchemes {{ default orthogonal; }}
""")
    _write(os.path.join(case_dir, "system", "fvSolution"),
           foamfile_header("dictionary", "fvSolution", "system"), f"""
solvers
{{
    p {{ solver PCG; preconditioner DIC; tolerance 1e-07; relTol 0.01; }}
    pFinal {{ solver PCG; preconditioner DIC; tolerance 1e-07; relTol 0; }}
    "({solver_fields})" {{ solver smoothSolver; smoother symGaussSeidel;
              tolerance 1e-07; relTol 0; }}
    "({solver_fields})Final" {{ solver smoothSolver;
              smoother symGaussSeidel; tolerance 1e-07; relTol 0; }}
}}
PIMPLE {{ nOuterCorrectors 1; nCorrectors 2;
         nNonOrthogonalCorrectors 0; momentumPredictor yes; }}
""")
    _write(os.path.join(case_dir, "constant", "transportProperties"),
           foamfile_header("dictionary", "transportProperties", "constant"),
           "\nnu              nu [0 2 -1 0 0 0 0] 1e-05;\n")
    _write(os.path.join(case_dir, "constant", "turbulenceProperties"),
           foamfile_header("dictionary", "turbulenceProperties", "constant"),
           f"""
simulationType  LES;
LES
{{
    LESModel        {model};
    turbulence      on;
    {coeffs}
}}
""")
    u_internal = "uniform (2 0 0)"
    if u_seed is not None:
        rng = np.random.default_rng(u_seed)
        n = nx * ny
        u = np.stack([2.0 + 0.2 * rng.standard_normal(n),
                      0.1 * rng.standard_normal(n), np.zeros(n)], 1)
        u_internal = f"nonuniform List<vector> {n} (" + " ".join(
            f"({float(a)!r} {float(b)!r} {float(c)!r})" for a, b, c in u) \
            + ")"
    write_field(case_dir, "0", "U", "volVectorField", "[0 1 -1 0 0 0 0]",
                u_internal, {
                    "inlet": _fixed("(2 0 0)"), "outlet": _ZG,
                    "walls": _fixed("(0 0 0)"), "fb": _EMPTY})
    write_field(case_dir, "0", "p", "volScalarField", "[0 2 -2 0 0 0 0]",
                "uniform 0", {"inlet": _ZG, "outlet": _fixed(0),
                              "walls": _ZG, "fb": _EMPTY})
    write_field(case_dir, "0", "nut", "volScalarField", "[0 2 -1 0 0 0 0]",
                "uniform 0", {"inlet": _ZG, "outlet": _ZG, "walls": _ZG,
                              "fb": _EMPTY})
    for name, ftype, dims, internal, bcs in fields:
        write_field(case_dir, "0", name, ftype, dims, internal, bcs)
    return mesh


#: the LES channel's dictionaries and extra fields per LES model, as the
#: JAX package's tests write them (tests/test_turbulence_extra.py):
#: (coeffs, extra div schemes, solver regex, fields)
def _les_field(name, dims, value, walls):
    return (name, "volScalarField", dims, f"uniform {value}",
            {"inlet": _fixed(value), "outlet": _ZG,
             "walls": _fixed(walls), "fb": _EMPTY})


_LES_K = _les_field("k", "[0 2 -2 0 0 0 0]", 2e-05, 0)
_LES_NUTILDA = _les_field("nuTilda", "[0 2 -1 0 0 0 0]", "4e-05", 0)
LES_CHANNEL_SPECS = {
    "Smagorinsky": ("", "", "U", ()),
    "Smagorinsky2": ("Smagorinsky2Coeffs { cD2 0.02; }", "", "U", ()),
    "scaleSimilarity": ("", "", "U", ()),
    "mixedSmagorinsky": ("", "", "U", ()),
    "homogeneousDynSmagorinsky": ("", "", "U", ()),
    "spectEddyVisc": ("", "", "U", ()),
    "oneEqEddy": ("", "", "U|k", (_LES_K,)),
    "kEqn": ("", "", "U|k", (_LES_K,)),
    "dynOneEqEddy": ("", "", "U|k", (_LES_K,)),
    "homogeneousDynOneEqEddy": ("", "", "U|k", (_LES_K,)),
    "SpalartAllmarasDES": ("", "div(phi,nuTilda) Gauss upwind;",
                           "U|nuTilda", (_LES_NUTILDA,)),
    "SpalartAllmaras": ("", "div(phi,nuTilda) Gauss upwind;", "U|nuTilda",
                        (_LES_NUTILDA,)),
    "SpalartAllmarasDDES": ("", "div(phi,nuTilda) Gauss upwind;",
                            "U|nuTilda", (_LES_NUTILDA,)),
    "SpalartAllmarasIDDES": ("", "div(phi,nuTilda) Gauss upwind;",
                             "U|nuTilda", (_LES_NUTILDA,)),
    "kOmegaSSTSAS": ("", "div(phi,omega) Gauss upwind;", "U|k|omega", (
        _les_field("k", "[0 2 -2 0 0 0 0]", 0.015, 1e-10),
        _les_field("omega", "[0 0 -1 0 0 0 0]", 100.0, 100.0))),
    "dynLagrangian": ("dynLagrangianCoeffs { theta 1.5; }",
                      "div(phi,flm) Gauss upwind; div(phi,fmm) Gauss "
                      "upwind;", "U|flm|fmm", ()),
    "laminar": ("", "", "U", ()),
}


def les_model_channel_case(case_dir: str, model: str, **kw) -> PolyMesh:
    """les_channel_case with the model's dictionaries and fields from
    LES_CHANNEL_SPECS (kw: end_time, nx, ny, ddt, u_seed)."""
    coeffs, schemes, fields_re, fields = LES_CHANNEL_SPECS[model]
    return les_channel_case(case_dir, model, coeffs=coeffs,
                            extra_schemes=schemes, solver_fields=fields_re,
                            fields=fields, **kw)


def pitz_daily_ras_case(case_dir: str, model: str, scale: int = 1,
                        **kw) -> PolyMesh:
    """pitz_daily_case for any RAS model: the solver entry widened to v2,
    f, kt and kl, and the fields kkLOmega (omega, kt, kl, as the JAX
    package's test writes them) and v2f (v2 with v2WallFunction, f with
    fWallFunction; v2 = 2/3 k) read beside k and epsilon."""
    mesh = pitz_daily_case(case_dir, scale=scale, model=model, **kw)
    path = os.path.join(case_dir, "system", "fvSolution")
    with open(path) as fh:
        txt = fh.read()
    with open(path, "w") as fh:
        fh.write(txt.replace("(U|k|epsilon|omega|nuTilda)",
                             "(U|k|epsilon|omega|nuTilda|v2|f|kt|kl)"))
    u_in = kw.get("u_in", 10.0)
    k_in = 1.5 * (0.05 * u_in) ** 2
    walls = ("upperWall", "lowerWall")

    def bcs(inlet, wall):
        out = {"inlet": inlet, "outlet": _ZG, "frontAndBack": _EMPTY}
        out.update({w: wall for w in walls})
        return out
    if model == "kkLOmega":
        om_in = 0.09 ** 0.75 * k_in ** 1.5 / (0.1 * _STEP_H) / (0.09 * k_in)
        write_field(case_dir, "0", "omega", "volScalarField",
                    "[0 0 -1 0 0 0 0]", f"uniform {om_in}",
                    bcs(_fixed(om_in), _ZG))
        for name, v in (("kt", k_in), ("kl", 1e-8)):
            write_field(case_dir, "0", name, "volScalarField",
                        "[0 2 -2 0 0 0 0]", f"uniform {v}",
                        bcs(_fixed(v), _fixed(1e-10)))
    if model == "v2f":
        v2 = 2.0 / 3.0 * k_in
        write_field(case_dir, "0", "v2", "volScalarField",
                    "[0 2 -2 0 0 0 0]", f"uniform {v2}",
                    bcs(_fixed(v2), "        type            v2WallFunction;"
                        "\n        value           uniform 1e-10;\n"))
        write_field(case_dir, "0", "f", "volScalarField",
                    "[0 0 -1 0 0 0 0]", "uniform 0",
                    bcs(_fixed(0), "        type            fWallFunction;"
                        "\n        value           uniform 0;\n"))
    return mesh


# ---------------------------------------------------------------------------
# the rotating frame: SRFSimpleFoam and SRFPimpleFoam
# ---------------------------------------------------------------------------

def srf_box_case(case_dir: str, n: int = 16, *, pimple: bool = False,
                 relative: bool = False, rpm: float = 60.0 / (2 * math.pi),
                 end_time: float | None = None,
                 delta_t: float | None = None, p_solver: str = "PCG",
                 write_interval: int = 1000, fmt: str = "ascii",
                 compress: bool = False, write_mesh: bool = True
                 ) -> PolyMesh:
    """A closed 0.1 m square box of fluid (n x n x 1 cells, centred on the
    axis, frontAndBack empty) in a frame rotating about z at `rpm` (1
    rad/s by default), laminar, nu 0.01: the JAX package's SRF test case
    (tests/test_srf.py:22-111), SRFSimpleFoam (200 iterations) or with
    pimple=True SRFPimpleFoam (deltaT 0.002 to 0.2 s).

    The walls are SRFVelocity with inletValue 0 and `relative no` unless
    relative=True: with `relative no` they stand still in the absolute
    frame, so Urel starts at minus the frame velocity on them and the
    fluid is set spinning against the frame (with `relative yes`, the
    JAX test's, it stays at rest in the frame). p_solver 'PCG' (DIC) is
    the JAX test's; 'GAMG' takes multigrid (the smoke's 1024 x 1024
    box). fmt and compress as in pitz_daily_les_case."""
    d = 0.1
    mesh = box_mesh(n, n, 1, size=(d, d, 0.01),
                    origin=(-d / 2, -d / 2, 0.0), patch_spec={
                        "ymax": ("walls", "wall"),
                        "xmin": ("walls", "wall"),
                        "xmax": ("walls", "wall"),
                        "ymin": ("walls", "wall"),
                        "zmin": ("frontAndBack", "empty"),
                        "zmax": ("frontAndBack", "empty"),
                    })
    if write_mesh:
        write_polymesh(mesh, case_dir, fmt=fmt, compress=compress)
    app = "SRFPimpleFoam" if pimple else "SRFSimpleFoam"
    if delta_t is None:
        delta_t = 0.002 if pimple else 1
    if end_time is None:
        end_time = 0.2 if pimple else 200
    _write(os.path.join(case_dir, "system", "controlDict"),
           foamfile_header("dictionary", "controlDict", "system"), f"""
application     {app};
startFrom       startTime;
startTime       0;
stopAt          endTime;
endTime         {end_time!r};
deltaT          {delta_t!r};
writeControl    timeStep;
writeInterval   {write_interval};
writeFormat     {fmt};
writeCompression {"compressed" if compress else "uncompressed"};
""")
    _write(os.path.join(case_dir, "system", "fvSchemes"),
           foamfile_header("dictionary", "fvSchemes", "system"), """
ddtSchemes      { default Euler; }
gradSchemes     { default Gauss linear; }
divSchemes      { default none; div(phi,Urel) Gauss upwind;
                  div(phi,k) Gauss upwind; div(phi,epsilon) Gauss upwind; }
laplacianSchemes { default Gauss linear orthogonal; }
interpolationSchemes { default linear; }
snGradSchemes   { default orthogonal; }
""")
    p_entry = ("solver GAMG; smoother GaussSeidel; "
               "nCellsInCoarsestLevel 10;" if p_solver == "GAMG"
               else "solver PCG; preconditioner DIC;")
    algo = "PIMPLE" if pimple else "SIMPLE"
    _write(os.path.join(case_dir, "system", "fvSolution"),
           foamfile_header("dictionary", "fvSolution", "system"), f"""
solvers
{{
    p {{ {p_entry} tolerance 1e-07; relTol 0.01; }}
    pFinal {{ {p_entry} tolerance 1e-07; relTol 0; }}
    Urel {{ solver smoothSolver; smoother symGaussSeidel;
           tolerance 1e-07; relTol 0; }}
    UrelFinal {{ solver smoothSolver; smoother symGaussSeidel;
           tolerance 1e-07; relTol 0; }}
}}
{algo}
{{
    nOuterCorrectors 1;
    nCorrectors     2;
    nNonOrthogonalCorrectors 0;
    pRefCell        0;
    pRefValue       0;
    residualControl {{ }}
}}
relaxationFactors
{{
    fields    {{ p 0.3; }}
    equations {{ Urel 0.7; }}
}}
""")
    _write(os.path.join(case_dir, "constant", "transportProperties"),
           foamfile_header("dictionary", "transportProperties", "constant"),
           "\nnu              nu [ 0 2 -1 0 0 0 0 ] 0.01;\n")
    _write(os.path.join(case_dir, "constant", "RASProperties"),
           foamfile_header("dictionary", "RASProperties", "constant"),
           "\nRASModel        laminar;\nturbulence      off;\n")
    _write(os.path.join(case_dir, "constant", "SRFProperties"),
           foamfile_header("dictionary", "SRFProperties", "constant"), f"""
SRFModel        rpm;
origin          (0 0 0);
axis            (0 0 1);
rpmCoeffs       {{ rpm {rpm!r}; }}
""")
    write_field(case_dir, "0", "p", "volScalarField", "[0 2 -2 0 0 0 0]",
                "uniform 0", {
                    "walls": _ZG, "frontAndBack": _EMPTY}, fmt, compress)
    write_field(case_dir, "0", "Urel", "volVectorField",
                "[0 1 -1 0 0 0 0]", "uniform (0 0 0)", {
                    "walls":
                        "        type            SRFVelocity;\n"
                        "        relative        "
                        f"{'yes' if relative else 'no'};\n"
                        "        inletValue      uniform (0 0 0);\n"
                        "        value           uniform (0 0 0);\n",
                    "frontAndBack": _EMPTY}, fmt, compress)
    return mesh


# ---------------------------------------------------------------------------
# mesh coupling: cyclic rings and channels, jump pairs, the periodic LES
# channel
# ---------------------------------------------------------------------------

_BASIC_SCHEMES = """
ddtSchemes      {{ default Euler; }}
gradSchemes     {{ default Gauss linear; }}
divSchemes      {{ default none; {div} }}
laplacianSchemes {{ default Gauss linear orthogonal; }}
interpolationSchemes {{ default linear; }}
snGradSchemes   {{ default orthogonal; }}
"""


def _basic_dicts(case_dir: str, app: str, end_time: float, delta_t: float,
                 div: str, solver: str, dt_coeff: float):
    """controlDict, fvSchemes, fvSolution (T by `solver`) and DT of a
    laplacianFoam or scalarTransportFoam case."""
    _write(os.path.join(case_dir, "system", "controlDict"),
           foamfile_header("dictionary", "controlDict", "system"), f"""
application {app}; startFrom startTime; startTime 0;
stopAt endTime; endTime {end_time!r}; deltaT {delta_t!r};
writeControl timeStep; writeInterval 100000; writeFormat ascii;
""")
    _write(os.path.join(case_dir, "system", "fvSchemes"),
           foamfile_header("dictionary", "fvSchemes", "system"),
           _BASIC_SCHEMES.format(div=div))
    _write(os.path.join(case_dir, "system", "fvSolution"),
           foamfile_header("dictionary", "fvSolution", "system"), f"""
solvers {{ T {{ {solver} relTol 0; }} }}
SIMPLE {{ nNonOrthogonalCorrectors 0; }}
""")
    _write(os.path.join(case_dir, "constant", "transportProperties"),
           foamfile_header("dictionary", "transportProperties", "constant"),
           f"\nDT              DT [0 2 -1 0 0 0 0] {dt_coeff!r};\n")


def _cell_values(values: np.ndarray) -> str:
    from ..fields.io import _body_value
    return _body_value(np.asarray(values, float), 17)


def cyclic_ring_case(case_dir: str, n: int = 40,
                     end_time: float = 1.0) -> PolyMesh:
    """scalarTransportFoam around a periodic ring (tests/test_cyclic.py's
    case): n cells on 1 x 0.05 x 0.05 m, left and right a cyclic pair,
    the rest empty; a Gaussian blob of T at x = 0.25 advected by U = (1 0
    0) with vanLeer, DT 0, deltaT 0.005, PBiCGStab/DILU to 1e-10."""
    mesh = box_mesh(n, 1, 1, size=(1.0, 0.05, 0.05), patch_spec={
        "xmin": ("left", "cyclic", "right"),
        "xmax": ("right", "cyclic", "left"),
        "ymin": ("sides", "empty"), "ymax": ("sides", "empty"),
        "zmin": ("fb", "empty"), "zmax": ("fb", "empty")})
    write_polymesh(mesh, case_dir)
    _basic_dicts(case_dir, "scalarTransportFoam", end_time, 0.005,
                 "div(phi,T) Gauss vanLeer;",
                 "solver PBiCGStab; preconditioner DILU; tolerance 1e-10;",
                 0.0)
    x = _cell_centres(mesh)[:, 0]
    cyc = "        type            cyclic;\n"
    bnd = {"sides": _EMPTY, "fb": _EMPTY, "left": cyc, "right": cyc}
    write_field(case_dir, "0", "T", "volScalarField", "[0 0 0 1 0 0 0]",
                _cell_values(np.exp(-((x - 0.25) / 0.08) ** 2)), bnd)
    write_field(case_dir, "0", "U", "volVectorField", "[0 1 -1 0 0 0 0]",
                "uniform (1 0 0)", bnd)
    return mesh


def periodic_transport_case(case_dir: str, kind: str = "cyclic",
                            end_time: float = 0.5) -> PolyMesh:
    """tests/test_ami.py's periodic transport channel: 24 x 4 x 1 cells
    on 1 x 0.2 x 0.05 m, inlet and outlet a `cyclic` pair (merged) or, with
    kind='ami', a conformal `cyclicAMI` pair with the translational
    separation; zeroGradient walls; a Gaussian blob of T at x = 0.3
    advected by U = (1 0 0), upwind, DT 0, deltaT 0.005."""
    typ = "cyclicAMI" if kind == "ami" else "cyclic"
    mesh = box_mesh(24, 4, 1, size=(1.0, 0.2, 0.05), patch_spec={
        "xmin": ("inlet", typ), "xmax": ("outlet", typ),
        "ymin": ("walls", "wall"), "ymax": ("walls", "wall"),
        "zmin": ("fb", "empty"), "zmax": ("fb", "empty")})
    for p in mesh.patches:
        if p.name in ("inlet", "outlet"):
            sign = 1.0 if p.name == "inlet" else -1.0
            p.extra["neighbourPatch"] = "outlet" if sign > 0 else "inlet"
            if kind == "ami":
                p.extra["transform"] = "translational"
                p.extra["separationVector"] = (sign, 0.0, 0.0)
    write_polymesh(mesh, case_dir)
    _basic_dicts(case_dir, "scalarTransportFoam", end_time, 0.005,
                 "div(phi,T) Gauss upwind;",
                 "solver PBiCGStab; preconditioner DILU; tolerance 1e-10;",
                 0.0)
    x = _cell_centres(mesh)[:, 0]
    cpl = f"        type            {typ};\n"
    write_field(case_dir, "0", "T", "volScalarField", "[0 0 0 1 0 0 0]",
                _cell_values(np.exp(-((x - 0.3) / 0.08) ** 2)),
                {"walls": _ZG, "fb": _EMPTY, '"(inlet|outlet)"': cpl})
    write_field(case_dir, "0", "U", "volVectorField", "[0 1 -1 0 0 0 0]",
                "uniform (1 0 0)",
                {"walls": _fixed("(1 0 0)"), "fb": _EMPTY,
                 '"(inlet|outlet)"': cpl})
    return mesh


#: the jump BCs of tests/test_jump_bcs.py on the pair's T, by name
JUMP_BCS = {
    "fixedJump": "        type            fixedJump;\n"
                 "        patchType       cyclic;\n"
                 "        jump            uniform 10;\n"
                 "        value           uniform 0;\n",
    "uniformJump": "        type            uniformJump;\n"
                   "        patchType       cyclic;\n"
                   "        jumpTable       constant 10;\n"
                   "        value           uniform 0;\n",
    "fan": "        type            fan;\n"
           "        patchType       cyclic;\n"
           "        jumpTable       polynomial ((100 1)(-50 2));\n"
           "        value           uniform 0;\n",
    # a jumpTable that ramps from 10 at t = 0 to 60 at t = 1
    "uniformJumpRamp": "        type            uniformJump;\n"
                       "        patchType       cyclic;\n"
                       "        jumpTable       table ((0 10) (1 60));\n"
                       "        value           uniform 0;\n",
    # a zero jump: the pair is kept coupled and nothing else changes
    "zeroJump": "        type            fixedJump;\n"
                "        patchType       cyclic;\n"
                "        jump            uniform 0;\n"
                "        value           uniform 0;\n",
    # no jump at all: the pair is merged
    "cyclic": "        type            cyclic;\n",
}


def _jump_channel_mesh(case_dir: str, inout: str = "cyclic") -> PolyMesh:
    """The 24 x 4 x 1-cell channel of tests/test_jump_bcs.py on 1 x 0.2 x
    0.05 m: inlet and outlet a cyclic pair (or, with inout='patch', two
    open patches), walls at y = 0 and 0.2, fb empty."""
    mesh = box_mesh(24, 4, 1, size=(1.0, 0.2, 0.05), patch_spec={
        "xmin": ("inlet", inout), "xmax": ("outlet", inout),
        "ymin": ("walls", "wall"), "ymax": ("walls", "wall"),
        "zmin": ("fb", "empty"), "zmax": ("fb", "empty")})
    if inout == "cyclic":
        for p in mesh.patches:
            if p.name in ("inlet", "outlet"):
                p.extra["neighbourPatch"] = ("outlet" if p.name == "inlet"
                                             else "inlet")
    write_polymesh(mesh, case_dir)
    return mesh


def jump_channel_case(case_dir: str, bc: str = "fixedJump",
                      end_time: float = 30.0,
                      t_seed: int | None = None,
                      u_flow: float | None = None) -> PolyMesh:
    """tests/test_jump_bcs.py's periodic conduction channel: 24 x 4 x 1
    cells on 1 x 0.2 x 0.05 m, inlet and outlet a cyclic pair whose T
    carries JUMP_BCS[bc] (a jump keeps the pair coupled; 'cyclic' merges
    it), zeroGradient walls; laplacianFoam, DT 0.05, deltaT 0.05, PCG/DIC
    to 1e-12. T starts uniform 0, or with t_seed from a numpy-seeded field
    (standard deviation 1). With u_flow, T is carried by the uniform
    velocity (u_flow 0 0), whose U says `cyclic` on the pair:
    scalarTransportFoam, div(phi,T) upwind, PBiCGStab/DILU to 1e-12."""
    mesh = _jump_channel_mesh(case_dir)
    if u_flow is None:
        _basic_dicts(case_dir, "laplacianFoam", end_time, 0.05, "",
                     "solver PCG; preconditioner DIC; tolerance 1e-12;",
                     0.05)
    else:
        _basic_dicts(case_dir, "scalarTransportFoam", end_time, 0.05,
                     "div(phi,T) Gauss upwind;",
                     "solver PBiCGStab; preconditioner DILU; "
                     "tolerance 1e-12;", 0.05)
        u = f"({u_flow!r} 0 0)"
        write_field(case_dir, "0", "U", "volVectorField",
                    "[0 1 -1 0 0 0 0]", f"uniform {u}",
                    {"walls": _fixed(u), "fb": _EMPTY,
                     '"(inlet|outlet)"': JUMP_BCS["cyclic"]})
    t0 = "uniform 0" if t_seed is None else _cell_values(
        np.random.default_rng(t_seed).standard_normal(mesh.n_cells))
    write_field(case_dir, "0", "T", "volScalarField", "[0 0 0 1 0 0 0]", t0,
                {"walls": _ZG, "fb": _EMPTY,
                 '"(inlet|outlet)"': JUMP_BCS[bc]})
    return mesh


#: the p entries of fan_channel_case's pair, by name: a fan whose curve
#: is 30 at zero flow (what the pressure solve evaluates, as in the JAX
#: package: ROADMAP Queue 3), a zero jump, or a merged pair
FAN_P_BCS = {
    "fan": "        type            fan;\n"
           "        patchType       cyclic;\n"
           "        jumpTable       polynomial ((30 0)(100 1)(-50 2));\n"
           "        value           uniform 0;\n",
    "zeroJump": JUMP_BCS["zeroJump"],
    "cyclic": JUMP_BCS["cyclic"],
}

#: U on fan_channel_case's pair: a zero vector jump (a type the JAX
#: package couples on a kept pair) or `cyclic`
FAN_U_BCS = {
    "zeroJump": "        type            fixedJump;\n"
                "        patchType       cyclic;\n"
                "        jump            uniform (0 0 0);\n"
                "        value           uniform (0 0 0);\n",
    "cyclic": JUMP_BCS["cyclic"],
    # a jump in U that follows a table of time: (0 0 0) at t = 0, (2 0 0)
    # at t = 1
    "uniformJumpRamp": "        type            uniformJump;\n"
                       "        patchType       cyclic;\n"
                       "        jumpTable       table ((0 (0 0 0)) "
                       "(1 (2 0 0)));\n"
                       "        value           uniform (0 0 0);\n",
}


def _pimple_channel_dicts(case_dir: str, n_steps: int, delta_t: float,
                          nu: float):
    """controlDict, fvSchemes (Euler, upwind), fvSolution (PCG/DIC p to
    1e-12, smoothSolver U to 1e-12; PIMPLE 1 outer, 2 correctors and PISO
    2 correctors, pRefCell 0) and a laminar transport of the small
    pimpleFoam (or icoFoam) channels."""
    _write(os.path.join(case_dir, "system", "controlDict"),
           foamfile_header("dictionary", "controlDict", "system"), f"""
application pimpleFoam; startFrom startTime; startTime 0;
stopAt endTime; endTime {n_steps * delta_t!r}; deltaT {delta_t!r};
writeControl timeStep; writeInterval 100000; writeFormat ascii;
""")
    _write(os.path.join(case_dir, "system", "fvSchemes"),
           foamfile_header("dictionary", "fvSchemes", "system"), """
ddtSchemes { default Euler; }
gradSchemes { default Gauss linear; }
divSchemes { default none; div(phi,U) Gauss upwind; }
laplacianSchemes { default Gauss linear orthogonal; }
interpolationSchemes { default linear; }
snGradSchemes { default orthogonal; }
""")
    _write(os.path.join(case_dir, "system", "fvSolution"),
           foamfile_header("dictionary", "fvSolution", "system"), """
solvers
{
    p { solver PCG; preconditioner DIC; tolerance 1e-12; relTol 0; }
    pFinal { solver PCG; preconditioner DIC; tolerance 1e-12; relTol 0; }
    U { solver smoothSolver; smoother symGaussSeidel; tolerance 1e-12;
        relTol 0; }
}
PIMPLE { nOuterCorrectors 1; nCorrectors 2;
         nNonOrthogonalCorrectors 0; momentumPredictor yes;
         pRefCell 0; pRefValue 0; }
PISO { nCorrectors 2; nNonOrthogonalCorrectors 0; pRefCell 0;
       pRefValue 0; }
""")
    _write_transport(case_dir, nu)
    _write(os.path.join(case_dir, "constant", "RASProperties"),
           foamfile_header("dictionary", "RASProperties", "constant"),
           "\nRASModel        laminar;\nturbulence      off;\n")


def fan_channel_case(case_dir: str, p_bc: str = "fan",
                     u_bc: str = "zeroJump", n_steps: int = 5,
                     delta_t: float = 0.005,
                     u_seed: int | None = None) -> PolyMesh:
    """A fan in a periodic duct: tests/test_jump_bcs.py's channel with the
    pair carrying FAN_P_BCS[p_bc] on p and FAN_U_BCS[u_bc] on U; no-slip
    walls, U starting at (1 0 0) (with u_seed, plus a numpy-seeded
    in-plane perturbation of standard deviation 0.2), nu 0.01; laminar
    pimpleFoam (Euler, upwind) for n_steps of delta_t."""
    mesh = _jump_channel_mesh(case_dir)
    _pimple_channel_dicts(case_dir, n_steps, delta_t, 0.01)
    u0 = "uniform (1 0 0)"
    if u_seed is not None:
        u = np.zeros((mesh.n_cells, 3))
        u[:, :2] = 0.2 * np.random.default_rng(u_seed).standard_normal(
            (mesh.n_cells, 2))
        u[:, 0] += 1.0
        u0 = _cell_values(u)
    write_field(case_dir, "0", "U", "volVectorField", "[0 1 -1 0 0 0 0]",
                u0,
                {"walls": _fixed("(0 0 0)"), "fb": _EMPTY,
                 '"(inlet|outlet)"': FAN_U_BCS[u_bc]})
    write_field(case_dir, "0", "p", "volScalarField", "[0 2 -2 0 0 0 0]",
                "uniform 0",
                {"walls": _ZG, "fb": _EMPTY,
                 '"(inlet|outlet)"': FAN_P_BCS[p_bc]})
    return mesh


def fan_pressure_channel_case(case_dir: str, n_steps: int = 5,
                              delta_t: float = 0.005) -> PolyMesh:
    """A fan drawing from the ambient into an open duct: the channel of
    tests/test_jump_bcs.py with a fanPressure inlet (direction in, p0 10,
    the curve the table constant/fanCurve) and p 0 at the outlet; U
    pressureInletOutletVelocity in, zeroGradient out, no-slip walls,
    starting at (0.5 0 0), nu 0.01; laminar pimpleFoam (Euler, upwind)
    for n_steps of delta_t."""
    mesh = _jump_channel_mesh(case_dir, "patch")
    _pimple_channel_dicts(case_dir, n_steps, delta_t, 0.01)
    _write(os.path.join(case_dir, "constant", "fanCurve"), "",
           "(\n    (0 0)\n    (0.01 2)\n    (0.05 6)\n)\n")
    write_field(case_dir, "0", "U", "volVectorField", "[0 1 -1 0 0 0 0]",
                "uniform (0.5 0 0)",
                {"inlet": "        type            "
                          "pressureInletOutletVelocity;\n"
                          "        value           uniform (0 0 0);\n",
                 "outlet": _ZG, "walls": _fixed("(0 0 0)"), "fb": _EMPTY})
    write_field(case_dir, "0", "p", "volScalarField", "[0 2 -2 0 0 0 0]",
                "uniform 0",
                {"inlet": "        type            fanPressure;\n"
                          "        direction       in;\n"
                          "        fileName        \"fanCurve\";\n"
                          "        p0              uniform 10;\n"
                          "        value           uniform 10;\n",
                 "outlet": _fixed("0"), "walls": _ZG, "fb": _EMPTY})
    return mesh


def _two_sided_grading(n: int, length: float, ratio: float) -> np.ndarray:
    """n + 1 node coordinates on [0, length], graded toward both ends:
    two halves of n/2 cells whose widths grow geometrically by `ratio`
    (last over first) toward the middle (blockMesh's two blocks with
    simpleGrading ratio and 1/ratio)."""
    half = n // 2
    r = ratio ** (1.0 / (half - 1)) if half > 1 else 1.0
    w = r ** np.arange(half)
    w *= 0.5 * length / w.sum()
    lo = np.concatenate([[0.0], np.cumsum(w)])
    return np.concatenate([lo, length - lo[-2::-1]])


#: OpenFOAM's pimpleFoam/LES/channel395: the bulk velocity the driving
#: pressure gradient holds, the viscosity (Re_tau 395), and the wall
#: grading of each half channel (blockMeshDict simpleGrading 10.7028)
CHANNEL395_UBAR = 0.1335
CHANNEL395_NU = 2e-05
CHANNEL395_GRADING = 10.7028


def periodic_channel_case(case_dir: str, nx: int = 160, ny: int = 100,
                          nz: int = 64, *, n_steps: int = 20,
                          delta_t: float | None = None,
                          ddt: str = "backward", u_seed: int = 0,
                          p_solver: str = "GAMG", fmt: str = "binary",
                          compress: bool = True,
                          write_mesh: bool = True,
                          k_seed: int | None = None) -> PolyMesh:
    """pimpleFoam LES in a periodic channel, after OpenFOAM's
    pimpleFoam/LES/channel395 tutorial: a 4 x 2 x 2 m box, walls at y = 0
    and y = 2 (bottomWall, topWall), cyclic pairs joining x-min to x-max
    (inout1/inout2) and z-min to z-max (sides1/sides2); nx x ny x nz
    cells (160 x 100 x 64 = 1,024,000 by default; the tutorial's
    40 x 50 x 30), each half channel graded 10.7028 toward its wall.
    nu 2e-5; pressureGradientExplicitSource in system/fvOptions holds
    Ubar (0.1335 0 0); LES oneEqEddy with the cubeRootVol delta; ddt
    backward (ddt=); div(phi,U) Gauss linear, div(phi,k) Gauss
    limitedLinear 1, laplacians Gauss linear corrected; p by GAMG
    (p_solver=) with relTol 0.05 (pFinal 0), U and k by smoothSolver
    symGaussSeidel to 1e-5; PIMPLE 1 outer and 2 pressure correctors,
    pRefCell 0. U starts at Ubar plus a numpy-seeded perturbation (u_seed;
    standard deviations 0.1 Ubar streamwise, 0.05 Ubar across), k at
    1e-5 (m/s)^2; both 0 on the walls. deltaT holds the bulk Courant
    number at the tutorial's 0.27 (0.2 s at nx = 40) unless given;
    endTime is n_steps steps; the mesh and the fields are written in
    fmt, gzipped under compress, and the controlDict asks for the same.

    Where it departs from the tutorial: the eddy viscosity is the field
    nut (OpenFOAM 2.3 writes nuSgs) and k starts uniform, not from the
    tutorial's perturbed field; pRefCell is 0 (the tutorial's 1001 is a
    cell of its own mesh). k_seed starts k from a numpy-seeded field
    (10% standard deviation about 1e-5) in place of the uniform one,
    where limitedLinear's r is a ratio of rounding residues that no two
    evaluation orders share."""
    xs = np.linspace(0.0, 4.0, nx + 1)
    ys = _two_sided_grading(ny, 2.0, CHANNEL395_GRADING)
    zs = np.linspace(0.0, 2.0, nz + 1)
    from .unstructured import box_mesh_fast
    mesh = box_mesh_fast(nx, ny, nz, coords=(xs, ys, zs), patch_spec={
        "xmin": ("inout1", "cyclic", "inout2"),
        "xmax": ("inout2", "cyclic", "inout1"),
        "ymin": ("bottomWall", "wall"), "ymax": ("topWall", "wall"),
        "zmin": ("sides1", "cyclic", "sides2"),
        "zmax": ("sides2", "cyclic", "sides1")})
    if write_mesh:
        write_polymesh(mesh, case_dir, fmt=fmt, compress=compress)
    dt = 0.2 * 40 / nx if delta_t is None else delta_t
    _write(os.path.join(case_dir, "system", "controlDict"),
           foamfile_header("dictionary", "controlDict", "system"), f"""
application     pimpleFoam;
startFrom       startTime;
startTime       0;
stopAt          endTime;
endTime         {n_steps * dt!r};
deltaT          {dt!r};
writeControl    timeStep;
writeInterval   {n_steps};
purgeWrite      0;
writeFormat     {fmt};
writePrecision  6;
writeCompression {"compressed" if compress else "uncompressed"};
runTimeModifiable true;
""")
    _write(os.path.join(case_dir, "system", "fvSchemes"),
           foamfile_header("dictionary", "fvSchemes", "system"), f"""
ddtSchemes      {{ default {ddt}; }}
gradSchemes     {{ default Gauss linear; }}
divSchemes
{{
    default         none;
    div(phi,U)      Gauss linear;
    div(phi,k)      Gauss limitedLinear 1;
    div((nuEff*dev(T(grad(U))))) Gauss linear;
}}
laplacianSchemes {{ default Gauss linear corrected; }}
interpolationSchemes {{ default linear; }}
snGradSchemes   {{ default corrected; }}
""")
    p_dict = ("solver GAMG; smoother GaussSeidel; "
              "nCellsInCoarsestLevel 10;" if p_solver == "GAMG"
              else "solver PCG; preconditioner DIC;")
    _write(os.path.join(case_dir, "system", "fvSolution"),
           foamfile_header("dictionary", "fvSolution", "system"), f"""
solvers
{{
    p {{ {p_dict} tolerance 1e-06; relTol 0.05; }}
    pFinal {{ {p_dict} tolerance 1e-06; relTol 0; }}
    "(U|k)"
    {{
        solver          smoothSolver;
        smoother        symGaussSeidel;
        tolerance       1e-05;
        relTol          0;
    }}
    "(U|k)Final"
    {{
        solver          smoothSolver;
        smoother        symGaussSeidel;
        tolerance       1e-05;
        relTol          0;
    }}
}}
PIMPLE
{{
    nOuterCorrectors 1;
    nCorrectors     2;
    nNonOrthogonalCorrectors 0;
    pRefCell        0;
    pRefValue       0;
}}
""")
    _write_transport(case_dir, CHANNEL395_NU)
    _write(os.path.join(case_dir, "constant", "turbulenceProperties"),
           foamfile_header("dictionary", "turbulenceProperties", "constant"),
           """
simulationType  LESModel;
LESModel        oneEqEddy;
turbulence      on;
printCoeffs     on;
delta           cubeRootVol;
oneEqEddyCoeffs
{
    delta           cubeRootVol;
    cubeRootVolCoeffs { deltaCoeff 1; }
}
cubeRootVolCoeffs { deltaCoeff 1; }
""")
    _write(os.path.join(case_dir, "system", "fvOptions"),
           foamfile_header("dictionary", "fvOptions", "system"), f"""
momentumSource
{{
    type            pressureGradientExplicitSource;
    active          on;
    selectionMode   all;
    fields          ( U );
    Ubar            ({CHANNEL395_UBAR} 0 0);
}}
""")
    from ..fields.io import _body_value
    rng = np.random.default_rng(u_seed)
    n = mesh.n_cells
    u = np.stack([CHANNEL395_UBAR * (1.0 + 0.1 * rng.standard_normal(n)),
                  0.05 * CHANNEL395_UBAR * rng.standard_normal(n),
                  0.05 * CHANNEL395_UBAR * rng.standard_normal(n)], 1)
    cyc = "        type            cyclic;\n"
    walls = {"bottomWall": _fixed("(0 0 0)"), "topWall": _fixed("(0 0 0)")}
    cycs = {name: cyc for name in ("inout1", "inout2", "sides1", "sides2")}
    write_field(case_dir, "0", "U", "volVectorField", "[0 1 -1 0 0 0 0]",
                _body_value(u, 17, binary=fmt == "binary"),
                {**walls, **cycs}, fmt, compress)
    write_field(case_dir, "0", "p", "volScalarField", "[0 2 -2 0 0 0 0]",
                "uniform 0", {"bottomWall": _ZG, "topWall": _ZG, **cycs},
                fmt, compress)
    k0 = "uniform 1e-05" if k_seed is None else _body_value(
        1e-5 * (1.0 + 0.1 * np.random.default_rng(k_seed).standard_normal(
            n)), 17, binary=fmt == "binary")
    write_field(case_dir, "0", "k", "volScalarField", "[0 2 -2 0 0 0 0]",
                k0, {"bottomWall": _fixed("0"),
                                  "topWall": _fixed("0"), **cycs},
                fmt, compress)
    write_field(case_dir, "0", "nut", "volScalarField", "[0 2 -1 0 0 0 0]",
                "uniform 0", {"bottomWall": _ZG, "topWall": _ZG, **cycs},
                fmt, compress)
    return mesh
