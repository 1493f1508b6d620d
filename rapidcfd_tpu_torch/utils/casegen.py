"""Case generator — a numpy copy of rapidcfd_tpu/utils/casegen.py's
box_mesh, masked_grid_mesh, cavity_case, pitz_daily_case and write_field,
plus pitz_daily_ico_case (the pitzDaily mesh under the cavity's icoFoam
dictionaries) and tjunction_case (pimpleFoam's T-junction, which the JAX
package has no writer for). These write case files only; the JAX solver
runs the same directories unchanged."""

from __future__ import annotations

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


def masked_grid_mesh(xs, ys, zs, mask, patch_rule) -> PolyMesh:
    """Structured 2D-extruded mesh with blanked cells (backward-facing
    steps, obstacles, T-junctions). mask[i,j] selects active cells;
    patch_rule(i, j, side) -> patch name for each boundary face, where
    side in {xmin,xmax,ymin,ymax,zmin,zmax}. Patch types are given via
    patch_rule.types: dict name->type, their order by patch_rule.order.
    """
    xs, ys, zs = map(np.asarray, (xs, ys, zs))
    nx, ny, nz = len(xs) - 1, len(ys) - 1, len(zs) - 1
    mask = np.asarray(mask, dtype=bool)
    if mask.shape != (nx, ny):
        raise ValueError(f"mask shape {mask.shape} != {(nx, ny)}")

    def nid_full(i, j, k):
        return i + j * (nx + 1) + k * (nx + 1) * (ny + 1)

    cid = np.full((nx, ny, nz), -1, dtype=np.int64)
    n = 0
    for k in range(nz):
        for j in range(ny):
            for i in range(nx):
                if mask[i, j]:
                    cid[i, j, k] = n
                    n += 1

    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    pts_full = np.stack([X.ravel(order="F"), Y.ravel(order="F"),
                         Z.ravel(order="F")], axis=1)

    int_faces, side_faces = [], {}

    def face_nodes(i, j, k, side):
        if side == "xmax":
            return [nid_full(i + 1, j, k), nid_full(i + 1, j + 1, k),
                    nid_full(i + 1, j + 1, k + 1), nid_full(i + 1, j, k + 1)]
        if side == "xmin":
            return [nid_full(i, j, k), nid_full(i, j, k + 1),
                    nid_full(i, j + 1, k + 1), nid_full(i, j + 1, k)]
        if side == "ymax":
            return [nid_full(i, j + 1, k), nid_full(i, j + 1, k + 1),
                    nid_full(i + 1, j + 1, k + 1), nid_full(i + 1, j + 1, k)]
        if side == "ymin":
            return [nid_full(i, j, k), nid_full(i + 1, j, k),
                    nid_full(i + 1, j, k + 1), nid_full(i, j, k + 1)]
        if side == "zmax":
            return [nid_full(i, j, k + 1), nid_full(i + 1, j, k + 1),
                    nid_full(i + 1, j + 1, k + 1), nid_full(i, j + 1, k + 1)]
        return [nid_full(i, j, k), nid_full(i, j + 1, k),
                nid_full(i + 1, j + 1, k), nid_full(i + 1, j, k)]

    def boundary(c, i, j, k, side):
        side_faces.setdefault(patch_rule(i, j, side), []).append(
            (c, face_nodes(i, j, k, side)))

    for k in range(nz):
        for j in range(ny):
            for i in range(nx):
                if not mask[i, j]:
                    continue
                c = cid[i, j, k]
                if i + 1 < nx and mask[i + 1, j]:
                    int_faces.append((c, cid[i + 1, j, k],
                                      face_nodes(i, j, k, "xmax")))
                else:
                    boundary(c, i, j, k, "xmax")
                if i == 0 or not mask[i - 1, j]:
                    boundary(c, i, j, k, "xmin")
                if j + 1 < ny and mask[i, j + 1]:
                    int_faces.append((c, cid[i, j + 1, k],
                                      face_nodes(i, j, k, "ymax")))
                else:
                    boundary(c, i, j, k, "ymax")
                if j == 0 or not mask[i, j - 1]:
                    boundary(c, i, j, k, "ymin")
                if k + 1 < nz:
                    int_faces.append((c, cid[i, j, k + 1],
                                      face_nodes(i, j, k, "zmax")))
                else:
                    boundary(c, i, j, k, "zmax")
                if k == 0:
                    boundary(c, i, j, k, "zmin")

    int_faces.sort(key=lambda t: (t[0], t[1]))
    owners = [t[0] for t in int_faces]
    neighbours = [t[1] for t in int_faces]
    all_faces = [t[2] for t in int_faces]
    patches = []
    for name in patch_rule.order:
        start = len(all_faces)
        for own_c, fpts in side_faces.get(name, []):
            owners.append(own_c)
            all_faces.append(fpts)
        patches.append(BoundaryPatch(name, patch_rule.types[name], start,
                                     len(all_faces) - start))

    # compact points to the used subset
    flat_full = np.array([p for f in all_faces for p in f])
    used = np.unique(flat_full)
    remap = np.full(pts_full.shape[0], -1, dtype=np.int64)
    remap[used] = np.arange(used.size)
    offsets = np.zeros(len(all_faces) + 1, dtype=np.int64)
    np.cumsum([len(f) for f in all_faces], out=offsets[1:])
    return PolyMesh(pts_full[used], remap[flat_full], offsets,
                    np.array(owners, dtype=np.int64),
                    np.array(neighbours, dtype=np.int64), patches)


def _pitz_daily_mesh(scale: int) -> PolyMesh:
    """The backward-facing step (BASELINE config 2's geometry): 12*scale
    upstream and 100*scale downstream columns, 40*scale rows, the
    upstream lower half blanked."""
    h = _STEP_H
    nx_up, nx_dn = 12 * scale, 100 * scale
    ny_half = _NY_HALF * scale
    xs = np.concatenate([np.linspace(-0.0206, 0.0, nx_up + 1)[:-1],
                         np.linspace(0.0, 0.29, nx_dn + 1)])
    ys = np.linspace(-h, h, 2 * ny_half + 1)
    zs = np.array([-0.0005, 0.0005])
    nx, ny = len(xs) - 1, len(ys) - 1
    mask = np.ones((nx, ny), dtype=bool)
    xc = 0.5 * (xs[:-1] + xs[1:])
    yc = 0.5 * (ys[:-1] + ys[1:])
    mask[np.ix_(xc < 0.0, yc < 0.0)] = False

    def rule(i, j, side):
        if side in ("zmin", "zmax"):
            return "frontAndBack"
        if side == "xmin" and i == 0:
            return "inlet"
        if side == "xmax" and i == nx - 1:
            return "outlet"
        if side == "ymax":
            return "upperWall"
        return "lowerWall"
    rule.order = ["inlet", "outlet", "upperWall", "lowerWall",
                  "frontAndBack"]
    rule.types = {"inlet": "patch", "outlet": "patch",
                  "upperWall": "wall", "lowerWall": "wall",
                  "frontAndBack": "empty"}
    return masked_grid_mesh(xs, ys, zs, mask, rule)


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
        if side_ == "xmin" and i == 0:
            return "inlet"
        if side_ == "ymin" and j == 0:
            return "outlet1"
        if side_ == "ymax" and j == ny - 1:
            return "outlet2"
        return "walls"
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
                dims: str, internal: str, boundary: dict[str, str]):
    lines = [f"\ndimensions      {dims};\n",
             f"\ninternalField   {internal};\n",
             "\nboundaryField\n{\n"]
    for pname, bspec in boundary.items():
        lines.append(f"    {pname}\n    {{\n{bspec}    }}\n")
    lines.append("}\n")
    _write(os.path.join(case_dir, time, name),
           foamfile_header(cls, name, time), "".join(lines))
