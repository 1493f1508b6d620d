"""Hex boxes, the perturbed merged-cell polyhedral channel and lattice
detection for masked-grid meshes — numpy copies of
rapidcfd_tpu/utils/unstructured.py: box_mesh_fast (:32), perturb_points
(:182), merge_cells (:209, with `track=` filling the lattice embedding),
_ranges_concat (:314), unstructured_channel_case (:324-471),
unstructured_box (:474-527, curve/grade included) and detect_lattice
(:530-607). The same seed gives the same integer arrays and the same
embedding as the JAX package."""

from __future__ import annotations

import numpy as np

from ..mesh.geometry import cell_centres_and_vols, face_centres_and_areas
from ..mesh.polymesh import BoundaryPatch, PolyMesh
from .dictionary import Dictionary

_SIDES = ("xmin", "xmax", "ymin", "ymax", "zmin", "zmax")


def box_mesh_fast(nx: int, ny: int, nz: int,
                  size=(1.0, 1.0, 1.0), origin=(0.0, 0.0, 0.0),
                  patch_spec: dict | None = None,
                  coords=None) -> PolyMesh:
    """Vectorized structured hex box (numpy; million-cell capable).

    Same mesh contract as casegen.box_mesh: owner-sorted upper-triangular
    internal faces first, then boundary faces grouped into patches by
    patch_spec {side: (name, type)} with sides sharing a name merged.
    coords=(xs, ys, zs) overrides the uniform spacing (graded meshes).
    """
    patch_spec = patch_spec or {s: (s, "patch") for s in _SIDES}
    if coords is not None:
        xs, ys, zs = (np.asarray(c, float) for c in coords)
    else:
        xs = origin[0] + np.linspace(0.0, size[0], nx + 1)
        ys = origin[1] + np.linspace(0.0, size[1], ny + 1)
        zs = origin[2] + np.linspace(0.0, size[2], nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    pts = np.stack([X.ravel(order="F"), Y.ravel(order="F"),
                    Z.ravel(order="F")], axis=1)

    npx, npxy = nx + 1, (nx + 1) * (ny + 1)

    def nid(i, j, k):
        return i + j * npx + k * npxy

    def cid(i, j, k):
        return i + j * nx + k * nx * ny

    own_l, nei_l, quad_l = [], [], []

    # x-internal faces: between cid(i,j,k) and cid(i+1,j,k), i in [0,nx-1)
    if nx > 1:
        i, j, k = np.meshgrid(np.arange(nx - 1), np.arange(ny),
                              np.arange(nz), indexing="ij")
        i, j, k = i.ravel(), j.ravel(), k.ravel()
        ii = i + 1
        own_l.append(cid(i, j, k))
        nei_l.append(cid(i + 1, j, k))
        quad_l.append(np.stack([nid(ii, j, k), nid(ii, j + 1, k),
                                nid(ii, j + 1, k + 1), nid(ii, j, k + 1)],
                               axis=1))
    # y-internal
    if ny > 1:
        i, j, k = np.meshgrid(np.arange(nx), np.arange(ny - 1),
                              np.arange(nz), indexing="ij")
        i, j, k = i.ravel(), j.ravel(), k.ravel()
        jj = j + 1
        own_l.append(cid(i, j, k))
        nei_l.append(cid(i, j + 1, k))
        quad_l.append(np.stack([nid(i, jj, k), nid(i, jj, k + 1),
                                nid(i + 1, jj, k + 1), nid(i + 1, jj, k)],
                               axis=1))
    # z-internal
    if nz > 1:
        i, j, k = np.meshgrid(np.arange(nx), np.arange(ny),
                              np.arange(nz - 1), indexing="ij")
        i, j, k = i.ravel(), j.ravel(), k.ravel()
        kk = k + 1
        own_l.append(cid(i, j, k))
        nei_l.append(cid(i, j, kk))
        quad_l.append(np.stack([nid(i, j, kk), nid(i + 1, j, kk),
                                nid(i + 1, j + 1, kk), nid(i, j + 1, kk)],
                               axis=1))

    own = np.concatenate(own_l) if own_l else np.zeros(0, np.int64)
    nei = np.concatenate(nei_l) if nei_l else np.zeros(0, np.int64)
    quads = (np.concatenate(quad_l, axis=0) if quad_l
             else np.zeros((0, 4), np.int64))
    order = np.lexsort((nei, own))
    own, nei, quads = own[order], nei[order], quads[order]

    # boundary faces per side (node order gives outward normals)
    def side_faces(side):
        # loop orders match casegen.box_mesh exactly: xmin/xmax (k,j),
        # ymin/ymax (k,i), zmin/zmax (j,i) — outer index first
        if side in ("xmin", "xmax"):
            k, j = np.meshgrid(np.arange(nz), np.arange(ny), indexing="ij")
            j, k = j.ravel(), k.ravel()
            if side == "xmin":
                return cid(0, j, k), np.stack(
                    [nid(0, j, k), nid(0, j, k + 1),
                     nid(0, j + 1, k + 1), nid(0, j + 1, k)], axis=1)
            return cid(nx - 1, j, k), np.stack(
                [nid(nx, j, k), nid(nx, j + 1, k),
                 nid(nx, j + 1, k + 1), nid(nx, j, k + 1)], axis=1)
        if side in ("ymin", "ymax"):
            k, i = np.meshgrid(np.arange(nz), np.arange(nx), indexing="ij")
            i, k = i.ravel(), k.ravel()
            if side == "ymin":
                return cid(i, 0, k), np.stack(
                    [nid(i, 0, k), nid(i + 1, 0, k),
                     nid(i + 1, 0, k + 1), nid(i, 0, k + 1)], axis=1)
            return cid(i, ny - 1, k), np.stack(
                [nid(i, ny, k), nid(i, ny, k + 1),
                 nid(i + 1, ny, k + 1), nid(i + 1, ny, k)], axis=1)
        j, i = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
        i, j = i.ravel(), j.ravel()
        if side == "zmin":
            return cid(i, j, 0), np.stack(
                [nid(i, j, 0), nid(i, j + 1, 0),
                 nid(i + 1, j + 1, 0), nid(i + 1, j, 0)], axis=1)
        return cid(i, j, nz - 1), np.stack(
            [nid(i, j, nz), nid(i + 1, j, nz),
             nid(i + 1, j + 1, nz), nid(i, j + 1, nz)], axis=1)

    patch_order: list[str] = []
    patch_type: dict[str, str] = {}
    patch_nbr: dict[str, str] = {}
    patch_sides: dict[str, list[str]] = {}
    for s, spec in patch_spec.items():
        name, typ = spec[0], spec[1]
        if name not in patch_type:
            patch_order.append(name)
            patch_type[name] = typ
            patch_sides[name] = []
            if len(spec) > 2:
                patch_nbr[name] = spec[2]
        patch_sides[name].append(s)

    owners = [own]
    face_quads = [quads]
    patches = []
    start = own.size
    for name in patch_order:
        p_own, p_quads = [], []
        for s in patch_sides[name]:
            o, q = side_faces(s)
            p_own.append(o)
            p_quads.append(q)
        p_own = np.concatenate(p_own)
        p_quads = np.concatenate(p_quads, axis=0)
        owners.append(p_own)
        face_quads.append(p_quads)
        extra = Dictionary()
        if name in patch_nbr:
            extra["neighbourPatch"] = patch_nbr[name]
        patches.append(BoundaryPatch(name, patch_type[name], start,
                                     p_own.size, extra))
        start += p_own.size

    all_own = np.concatenate(owners).astype(np.int64)
    all_quads = np.concatenate(face_quads, axis=0).astype(np.int64)
    nf = all_quads.shape[0]
    offsets = np.arange(nf + 1, dtype=np.int64) * 4
    return PolyMesh(pts, all_quads.ravel(), offsets, all_own,
                    nei.astype(np.int64), patches)


def perturb_points(mesh: PolyMesh, amplitude: float = 0.25,
                   seed: int = 0) -> PolyMesh:
    """Jitter interior nodes by `amplitude` of the local spacing.

    Boundary nodes (any node used by a boundary face) stay fixed so the
    domain shape and wall geometry are exact. The jitter introduces
    non-orthogonality, skewness and non-planar faces — the geometric
    irregularity snappyHexMesh-class meshes have.
    """
    n_int = mesh.n_internal_faces
    b_nodes = np.unique(mesh.face_points[mesh.face_offsets[n_int]:])
    interior = np.ones(mesh.n_points, dtype=bool)
    interior[b_nodes] = False
    # local spacing: min distance over this node's mesh edges would be
    # exact; the global min cell edge is a safe uniform bound
    pts = mesh.points.copy()
    if interior.any():
        # estimate spacing from the first internal face's edge length
        f0 = mesh.face(0)
        h = np.linalg.norm(pts[f0[1]] - pts[f0[0]])
        rng = np.random.default_rng(seed)
        pts[interior] += (rng.uniform(-1.0, 1.0, (int(interior.sum()), 3))
                          * amplitude * h)
    return PolyMesh(pts, mesh.face_points, mesh.face_offsets, mesh.owner,
                    mesh.neighbour, mesh.patches)


def merge_cells(mesh: PolyMesh, fraction: float = 0.05,
                seed: int = 0, track: dict | None = None) -> PolyMesh:
    """Dissolve a random matching of internal faces, merging cell pairs.

    Produces polyhedral cells (10 faces from hex pairs), duplicate
    cell-pair adjacencies, and variable faces-per-cell — the ELL overflow
    path (K > 6) the reference's slow gather path covers
    (lduMatrixATmul.C:42). `fraction` ~ fraction of internal faces
    considered for dissolution; each cell joins at most one merge.
    """
    n_int = mesh.n_internal_faces
    nc = mesh.n_cells
    rng = np.random.default_rng(seed)
    n_cand = max(int(round(fraction * n_int)), 1)
    cand = rng.choice(n_int, size=min(n_cand, n_int), replace=False)

    used = np.zeros(nc, dtype=bool)
    keep = np.zeros(cand.size, dtype=bool)
    own_c = mesh.owner[cand]
    nei_c = mesh.neighbour[cand]
    for idx in range(cand.size):  # greedy matching (host, O(n_cand))
        a, b = own_c[idx], nei_c[idx]
        if not used[a] and not used[b]:
            used[a] = used[b] = True
            keep[idx] = True
    merged_faces = cand[keep]

    # leader = min(owner, neighbour); map both to the leader, then compact
    lead = np.arange(nc, dtype=np.int64)
    a = np.minimum(mesh.owner[merged_faces], mesh.neighbour[merged_faces])
    b = np.maximum(mesh.owner[merged_faces], mesh.neighbour[merged_faces])
    lead[b] = a
    is_leader = lead == np.arange(nc)
    new_id = np.cumsum(is_leader) - 1
    cell_map = new_id[lead]

    drop = np.zeros(mesh.n_faces, dtype=bool)
    drop[merged_faces] = True
    keep_f = ~drop
    own = cell_map[mesh.owner[keep_f]]
    new_n_int = n_int - merged_faces.size
    nei = cell_map[mesh.neighbour[keep_f[:n_int]]]

    # rebuild flat face-point arrays for kept faces
    counts = np.diff(mesh.face_offsets)
    keep_pts = np.repeat(keep_f, counts)
    face_points = mesh.face_points[keep_pts]
    new_counts = counts[keep_f]
    offsets = np.zeros(new_counts.size + 1, dtype=np.int64)
    np.cumsum(new_counts, out=offsets[1:])

    # restore owner<neighbour + owner-sorted order on internal faces
    int_own, int_nei = own[:new_n_int], nei
    flip = int_own > int_nei
    o2 = np.where(flip, int_nei, int_own)
    n2 = np.where(flip, int_own, int_nei)
    order = np.lexsort((n2, o2))
    # flipped ownership reverses node order (outward normal flips)
    fp_list = face_points
    fo = offsets
    if flip.any():
        base = np.arange(fp_list.size, dtype=np.int64)
        f_ids = np.repeat(np.arange(new_counts.size), new_counts)
        pos = base - fo[f_ids]
        is_flip_face = np.zeros(new_counts.size, dtype=bool)
        is_flip_face[:new_n_int] = flip
        sel = is_flip_face[f_ids]
        rev = np.where(sel, fo[f_ids] + new_counts[f_ids] - 1 - pos, base)
        fp_list = fp_list[rev]
    full_order = np.concatenate([order,
                                 np.arange(new_n_int, new_counts.size)])
    starts = fo[:-1][full_order]
    lens = new_counts[full_order]
    face_points2 = fp_list[_ranges_concat(starts, lens)]
    offsets2 = np.zeros(lens.size + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets2[1:])
    own2 = np.concatenate([o2[order], own[new_n_int:]])
    nei2 = n2[order]

    patches = []
    shift = merged_faces.size
    for p in mesh.patches:
        patches.append(BoundaryPatch(p.name, p.type, p.start_face - shift,
                                     p.n_faces, p.extra))
    if track is not None:
        # lattice embedding for the gdia fast path (mesh/gdia.py): the
        # INPUT mesh's cell ids are the lattice slots; record, per slot,
        # its compacted cell and (for merged-away slots) the merge
        # direction, plus the ORIGINAL slot pair of every kept face in
        # the final face order (original ids are owner-sorted, so the
        # pair is (min, max) independent of compact-order flips).
        orig_own_all = mesh.owner[keep_f]
        orig_nei_int = mesh.neighbour[keep_f[:n_int]]
        track["slot_cell"] = cell_map.copy()
        track["ghost_lead"] = lead.copy()
        track["orig_own_int"] = orig_own_all[:new_n_int][order]
        track["orig_nei_int"] = orig_nei_int[order]
        track["orig_own_bnd"] = orig_own_all[new_n_int:]
        # faces flipped to restore compact owner<neighbour order point
        # OPPOSITE to the slot convention (lower slot -> upper slot)
        track["flip_int"] = flip[order].copy()
    return PolyMesh(mesh.points, face_points2, offsets2, own2, nei2,
                    patches)


def _ranges_concat(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Vectorized concatenate of ranges [starts[i], starts[i]+lens[i])."""
    total = int(lens.sum())
    out_starts = np.zeros(lens.size, dtype=np.int64)
    np.cumsum(lens[:-1], out=out_starts[1:])
    idx = np.arange(total, dtype=np.int64)
    f_ids = np.repeat(np.arange(lens.size), lens)
    return starts[f_ids] + (idx - out_starts[f_ids])


def unstructured_channel_case(case_dir: str, nx: int = 40, ny: int = 24,
                              nz: int = 24, *, u_in: float = 10.0,
                              nu: float = 1e-5, model: str = "kOmegaSST",
                              end_time: int = 500,
                              perturb: float = 0.15,
                              merge_fraction: float = 0.04,
                              seed: int = 0, write_mesh: bool = True,
                              p_rel_tol: float = 0.05,
                              lattice_out: dict | None = None,
                              curve: float = 0.0,
                              grade: float = 1.0) -> PolyMesh:
    """simpleFoam channel on a polyhedral perturbed box:
    inlet/outlet in x, walls elsewhere, kOmegaSST + wall functions,
    GAMG pressure. Returns the PolyMesh (pass to Case(pmesh=...) when
    write_mesh=False for million-cell benches). curve/grade produce the
    genuinely non-lattice variant (see unstructured_box)."""
    import os

    from ..mesh.polymesh import write_polymesh
    from .casegen import _write, write_field
    from .dictionary import foamfile_header

    L = (4.0, 1.0, 1.0)
    mesh = unstructured_box(
        nx, ny, nz, size=L, perturb=perturb,
        merge_fraction=merge_fraction, seed=seed,
        lattice_out=lattice_out, curve=curve, grade=grade,
        patch_spec={"xmin": ("inlet", "patch"),
                    "xmax": ("outlet", "patch"),
                    "ymin": ("walls", "wall"), "ymax": ("walls", "wall"),
                    "zmin": ("walls", "wall"), "zmax": ("walls", "wall")})
    if write_mesh:
        write_polymesh(mesh, case_dir)
    os.makedirs(os.path.join(case_dir, "system"), exist_ok=True)
    _write(os.path.join(case_dir, "system", "controlDict"),
           foamfile_header("dictionary", "controlDict", "system"), f"""
application     simpleFoam;
startFrom       startTime;
startTime       0;
stopAt          endTime;
endTime         {end_time};
deltaT          1;
writeControl    timeStep;
writeInterval   10000;
purgeWrite      0;
writeFormat     ascii;
""")
    _write(os.path.join(case_dir, "system", "fvSchemes"),
           foamfile_header("dictionary", "fvSchemes", "system"), """
ddtSchemes      { default steadyState; }
gradSchemes     { default Gauss linear; }
divSchemes
{
    default         none;
    div(phi,U)      Gauss upwind;
    div(phi,k)      Gauss upwind;
    div(phi,omega)  Gauss upwind;
    div(phi,epsilon) Gauss upwind;
    div((nuEff*dev(T(grad(U))))) Gauss linear;
}
laplacianSchemes { default Gauss linear corrected; }
interpolationSchemes { default linear; }
snGradSchemes   { default corrected; }
""")
    _write(os.path.join(case_dir, "system", "fvSolution"),
           foamfile_header("dictionary", "fvSolution", "system"), f"""
solvers
{{
    p
    {{
        solver          PCG;
        preconditioner  GAMG;
        tolerance       1e-06;
        relTol          {p_rel_tol};
    }}
    "(U|k|omega|epsilon)"
    {{
        solver          PBiCGStab;
        preconditioner  DILU;
        tolerance       1e-05;
        relTol          0.1;
    }}
}}
SIMPLE
{{
    nNonOrthogonalCorrectors 1;
    pRefCell        0;
    pRefValue       0;
    residualControl
    {{
        p               1e-4;
        U               1e-5;
        "(k|omega)"     1e-5;
    }}
}}
relaxationFactors
{{
    fields    {{ p 0.3; }}
    equations {{ U 0.7; k 0.7; omega 0.7; epsilon 0.7; }}
}}
""")
    _write(os.path.join(case_dir, "constant", "transportProperties"),
           foamfile_header("dictionary", "transportProperties", "constant"),
           f"\ntransportModel  Newtonian;\nnu              nu "
           f"[ 0 2 -1 0 0 0 0 ] {nu};\n")
    _write(os.path.join(case_dir, "constant", "RASProperties"),
           foamfile_header("dictionary", "RASProperties", "constant"),
           f"\nRASModel        {model};\nturbulence      on;\n")

    k_in = 1.5 * (0.05 * u_in) ** 2
    om_in = 0.09 ** -0.25 * k_in ** 0.5 / (0.1 * L[1])
    zg = "        type            zeroGradient;\n"
    write_field(case_dir, "0", "p", "volScalarField", "[0 2 -2 0 0 0 0]",
                "uniform 0", {
                    "inlet": zg,
                    "outlet": "        type            fixedValue;\n"
                              "        value           uniform 0;\n",
                    "walls": zg})
    write_field(case_dir, "0", "U", "volVectorField", "[0 1 -1 0 0 0 0]",
                f"uniform ({u_in} 0 0)", {
                    "inlet": "        type            fixedValue;\n"
                             f"        value           uniform ({u_in} 0 0);\n",
                    "outlet": zg,
                    "walls": "        type            fixedValue;\n"
                             "        value           uniform (0 0 0);\n"})
    write_field(case_dir, "0", "k", "volScalarField", "[0 2 -2 0 0 0 0]",
                f"uniform {k_in}", {
                    "inlet": "        type            fixedValue;\n"
                             f"        value           uniform {k_in};\n",
                    "outlet": zg,
                    "walls": "        type            kqRWallFunction;\n"
                             f"        value           uniform {k_in};\n"})
    write_field(case_dir, "0", "omega", "volScalarField",
                "[0 0 -1 0 0 0 0]", f"uniform {om_in}", {
                    "inlet": "        type            fixedValue;\n"
                             f"        value           uniform {om_in};\n",
                    "outlet": zg,
                    "walls": "        type            omegaWallFunction;\n"
                             f"        value           uniform {om_in};\n"})
    write_field(case_dir, "0", "nut", "volScalarField", "[0 2 -1 0 0 0 0]",
                "uniform 0", {
                    "inlet": "        type            calculated;\n"
                             "        value           uniform 0;\n",
                    "outlet": "        type            calculated;\n"
                              "        value           uniform 0;\n",
                    "walls": "        type            nutkWallFunction;\n"
                             "        value           uniform 0;\n"})
    return mesh


def channel_stepper(case_dir: str, *, nx: int, ny: int, nz: int,
                    device, dtype, curve: float = 0.0, grade: float = 1.0,
                    ell: bool = False):
    """bench_unstructured.py's set-up of its channel (perturb 0.12, merge
    fraction 0.04, seed 3): the case written without its mesh, the
    PolyMesh and its lattice embedding kept in memory, Case(pmesh=,
    lattice=), kOmegaSST and simplefoam.make_step. The channel takes the
    merged-cell gdia lattice, or with `ell` the padded ELL; the curved or
    graded duct is not a lattice and takes the padded ELL.

    Returns (case, (U, p, phi, turbulence state), step, live cells);
    case.setup_seconds gains "generate"."""
    import time

    from ..models.transport import SinglePhaseTransportModel
    from ..models.turbulence import make_ras_model
    from ..ops import fvc
    from ..solvers import simplefoam
    from ..solvers.case import Case
    from ..solvers.controls import SimpleControl
    lattice = None if ell or curve or grade != 1.0 else {}
    t0 = time.perf_counter()
    pmesh = unstructured_channel_case(
        case_dir, nx=nx, ny=ny, nz=nz, end_time=10 ** 9, perturb=0.12,
        merge_fraction=0.04, seed=3, write_mesh=False, lattice_out=lattice,
        curve=curve, grade=grade)
    t_gen = time.perf_counter() - t0
    case = Case(case_dir, device=device, dtype=dtype, pmesh=pmesh,
                lattice=lattice, gdia_auto=not ell)
    case.setup_seconds = {"generate": t_gen, **case.setup_seconds}
    U, p = case.read_field("U"), case.read_field("p")
    turb = make_ras_model(case, U)
    step = simplefoam.make_step(
        case, SinglePhaseTransportModel(case.transport_properties()), turb,
        SimpleControl(case))
    return (case, (U, p, fvc.flux(case.mesh, U), turb.init_state(U)), step,
            pmesh.n_cells)


def unstructured_box(nx: int, ny: int, nz: int, *,
                     size=(1.0, 1.0, 1.0), origin=(0.0, 0.0, 0.0),
                     patch_spec: dict | None = None,
                     perturb: float = 0.2, merge_fraction: float = 0.04,
                     seed: int = 0, lattice_out: dict | None = None,
                     curve: float = 0.0, grade: float = 1.0
                     ) -> PolyMesh:
    """Polyhedral perturbed box: the unstructured test-mesh entry point.
    Pass lattice_out={} to receive the lattice embedding consumed by the
    gdia gather-free mesh mode (mesh/gdia.py).

    curve > 0 bends the duct into an annular arc of `curve` radians
    (x becomes the azimuthal coordinate) and grade != 1 applies a
    geometric wall-normal grading in y (boundary-layer-style cell-size
    ratio across the height): together with the perturbation and the
    cell merges this produces a mesh that is genuinely NOT a masked
    lattice — detect_lattice rejects it and the general ELL/gather
    path applies (the honest snappyHexMesh-class topology proxy,
    BASELINE config 5)."""
    m = box_mesh_fast(nx, ny, nz, size=size, origin=origin,
                      patch_spec=patch_spec)
    if grade != 1.0 or curve:
        pts = m.points.copy()
        ox, oy, _ = origin
        Lx, Ly, _ = size
        if grade != 1.0:
            # geometric grading: unit coordinate t -> (g^t - 1)/(g - 1)
            t = (pts[:, 1] - oy) / Ly
            g = float(grade)
            pts[:, 1] = oy + Ly * (np.power(g, t) - 1.0) / (g - 1.0)
        if curve:
            theta = (pts[:, 0] - ox) / Lx * float(curve)
            r0 = Lx / float(curve)           # keep arc length ~ Lx
            r = r0 + (pts[:, 1] - oy)
            pts = np.stack([r * np.sin(theta),
                            r * np.cos(theta) - r0, pts[:, 2]], axis=1)
        m = PolyMesh(pts, m.face_points, m.face_offsets, m.owner,
                     m.neighbour, m.patches)
    if perturb:
        m = perturb_points(m, amplitude=perturb, seed=seed)
    if merge_fraction:
        m = merge_cells(m, fraction=merge_fraction, seed=seed + 1,
                        track=lattice_out)
    elif lattice_out is not None:
        nc = m.n_cells
        lattice_out["slot_cell"] = np.arange(nc, dtype=np.int64)
        lattice_out["ghost_lead"] = np.arange(nc, dtype=np.int64)
        lattice_out["orig_own_int"] = m.owner[:m.n_internal_faces].copy()
        lattice_out["orig_nei_int"] = m.neighbour.copy()
        lattice_out["orig_own_bnd"] = m.owner[m.n_internal_faces:].copy()
        lattice_out["flip_int"] = np.zeros(m.n_internal_faces, dtype=bool)
    if lattice_out is not None:
        lattice_out["shape"] = (nz, ny, nx)
    return m


def _cluster_coords(v: np.ndarray, span: float):
    """Sorted unique cluster centres of a coordinate array (gap-based:
    values closer than 1e-6*span merge). Returns (centres, index-of-v)."""
    order = np.argsort(v)
    sv = v[order]
    tol = 1e-6 * max(span, 1e-300)
    brk = np.nonzero(np.diff(sv) > tol)[0]
    starts = np.concatenate([[0], brk + 1])
    ends = np.concatenate([brk + 1, [sv.size]])
    centres = np.array([sv[s:e].mean() for s, e in zip(starts, ends)])
    cluster_of_sorted = np.zeros(sv.size, np.int64)
    cluster_of_sorted[starts[1:]] = 1
    cluster_of_sorted = np.cumsum(cluster_of_sorted)
    out = np.empty(v.size, np.int64)
    out[order] = cluster_of_sorted
    return centres, out


def detect_lattice(mesh: PolyMesh) -> dict | None:
    """Recover a box-lattice embedding from an axis-aligned masked-grid
    mesh (forward steps, T-junctions, obstacles: a uniform-or-graded grid
    MINUS blanked cells). Returns the lattice dict consumed by
    build_gdia_mesh_arrays (dead slots marked), or None when the mesh is
    not of this class or is a full box (no dead slot)."""
    n_cells = mesh.n_cells
    if n_cells == 0:
        return None
    if any(p.type in ("cyclicAMI", "cyclicACMI") for p in mesh.patches):
        return None
    Cf, Sf = face_centres_and_areas(mesh)
    C, _ = cell_centres_and_vols(mesh, Cf, Sf)
    spans = C.max(axis=0) - C.min(axis=0)
    centres, idx = zip(*(_cluster_coords(C[:, a], float(spans.max()))
                         for a in range(3)))
    nx, ny, nz = (len(c) for c in centres)
    n_lat = nx * ny * nz
    if n_lat < n_cells or n_lat > 8 * n_cells:
        return None
    slot = idx[0] + idx[1] * nx + idx[2] * nx * ny
    if np.unique(slot).size != n_cells:
        return None
    n_int = mesh.n_internal_faces
    so = slot[mesh.owner[:n_int]]
    sn = slot[mesh.neighbour]
    d = sn - so
    if not np.isin(np.abs(d), [1, nx, nx * ny]).all():
        return None
    flip = d < 0
    slot_cell = np.zeros(n_lat, np.int64)
    slot_cell[slot] = np.arange(n_cells)
    dead = np.ones(n_lat, bool)
    dead[slot] = False
    if not dead.any():
        return None
    return {
        "shape": (nz, ny, nx),
        "slot_cell": slot_cell,
        "ghost_lead": np.arange(n_lat, dtype=np.int64),
        "orig_own_int": np.where(flip, sn, so),
        "orig_nei_int": np.where(flip, so, sn),
        "orig_own_bnd": slot[mesh.owner[n_int:]],
        "flip_int": flip,
        "dead": dead,
    }
