"""The shift-MAC kernel of the port (rapidcfd_tpu_torch/ops/gdia_mac.py)
against the JAX package's rapidcfd_tpu/ops/pallas_gdia.py.

Inputs come from numpy with a fixed seed and go through both packages:

- fp64: the port's plain version against the JAX XLA fallback at 1e-12
  relative to max|out| (same operation order; differences are last-bit
  rounding of the pad/slice/FMA chain);
- fp32: against the Pallas kernel `_mac_pallas` itself, run in interpret
  mode on the CPU, at 1e-5 relative (fp32 rounding only);
- the CUDA kernel against the plain version, on the card only (marked
  gpu; skips without a card).

The edge cases (`_EDGES`) are those the kernel's launcher must handle:
n % 4 in {1, 2, 3}, contiguous views at storage offset 1 (misaligned
pointers), |off| >= n, K = 1 with C = 2, n under one tile or one pack, the
3-D K = 7 sets (one with offsets +-4096) and the generic instantiation
(K = 8, C = 5).
"""

import numpy as np
import pytest
import torch

from rapidcfd_tpu.ops import pallas_gdia
from rapidcfd_tpu_torch.ops import gdia_mac

# lattice offsets: 2-D (K = 5, the pitzDaily slice) and 3-D (K = 7)
_OFFSETS = {5: (-41, -1, 0, 1, 41), 7: (-410, -41, -1, 0, 1, 41, 410)}


# (id, K, C, n, offsets, storage offset of the port's x and coeffs)
_EDGES = [
    ("n_mod4_1", 5, 1, 4001, _OFFSETS[5], 0),
    ("n_mod4_2", 5, 3, 4002, _OFFSETS[5], 0),
    ("n_mod4_3", 5, 1, 4003, _OFFSETS[5], 0),
    ("storage_offset_1", 5, 3, 4000, _OFFSETS[5], 1),
    ("off_ge_n", 5, 3, 1000, (-5000, -1000, -1, 0, 1001), 0),
    ("K1_C2", 1, 2, 2000, (3,), 0),
    ("n_under_tile", 5, 1, 100, (-10, -1, 0, 1, 10), 0),
    ("n_under_pack", 5, 3, 1, (-10, -1, 0, 1, 10), 0),
    ("3d_K7", 7, 3, 20 * 15 * 10, (-300, -20, -1, 0, 1, 20, 300), 0),
    ("3d_4096", 7, 1, 64 * 64 * 2, (-4096, -64, -1, 0, 1, 64, 4096), 0),
    ("generic_K8_C5", 8, 5, 3001, (-50, -7, -2, -1, 0, 1, 2, 50), 0),
]
_EDGE_IDS = [e[0] for e in _EDGES]


def _inputs(K, C, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(dtype)
    coeffs = rng.standard_normal((K, C, n)).astype(dtype)
    return x, coeffs


def _port_views(x, coeffs, shift, device="cpu"):
    """The numpy inputs as torch tensors on `device` that are contiguous
    views at storage offset `shift`."""
    xb = torch.zeros(x.size + shift, dtype=torch.from_numpy(x).dtype,
                     device=device)
    cb = torch.zeros(coeffs.size + shift, dtype=xb.dtype, device=device)
    xb[shift:] = torch.from_numpy(x)
    cb[shift:] = torch.from_numpy(coeffs).reshape(-1)
    xt, ct = xb[shift:], cb[shift:].view(coeffs.shape)
    assert xt.is_contiguous() and xt.storage_offset() == shift
    return xt, ct


def _rel_err(out, ref):
    return np.abs(out - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("K", [5, 7])
@pytest.mark.parametrize("C", [1, 3])
def test_plain_matches_jax_fallback_fp64(K, C):
    n = 4000 + 7                      # not a multiple of any block size
    x, coeffs = _inputs(K, C, n, np.float64, seed=K * 10 + C)
    offs = _OFFSETS[K]
    ref = np.asarray(pallas_gdia.shift_mac_cols(x, coeffs, offs))
    out = gdia_mac.shift_mac_cols(torch.from_numpy(x),
                                  torch.from_numpy(coeffs), offs).numpy()
    assert out.shape == (C, n)
    assert _rel_err(out, ref) <= 1e-12


@pytest.mark.parametrize("C", [1, 3])
def test_plain_matches_pallas_interpret_fp32(C):
    K = 5
    n = 3000 + 5
    x, coeffs = _inputs(K, C, n, np.float32, seed=C)
    offs = _OFFSETS[K]
    ref = np.asarray(pallas_gdia.shift_mac_cols(x, coeffs, offs,
                                                interpret=True))
    out = gdia_mac.shift_mac_cols(torch.from_numpy(x),
                                  torch.from_numpy(coeffs), offs).numpy()
    assert ref.shape == out.shape == (C, n)
    assert _rel_err(out, ref) <= 1e-5


@pytest.mark.parametrize("edge", _EDGES, ids=_EDGE_IDS)
def test_plain_matches_jax_fallback_fp64_edges(edge):
    _, K, C, n, offs, shift = edge
    x, coeffs = _inputs(K, C, n, np.float64, seed=n)
    ref = np.asarray(pallas_gdia.shift_mac_cols(x, coeffs, offs))
    out = gdia_mac.shift_mac_cols(*_port_views(x, coeffs, shift),
                                  offs).numpy()
    assert out.shape == (C, n)
    assert _rel_err(out, ref) <= 1e-12


@pytest.mark.parametrize("edge", _EDGES, ids=_EDGE_IDS)
def test_plain_matches_pallas_interpret_fp32_edges(edge):
    _, K, C, n, offs, shift = edge
    x, coeffs = _inputs(K, C, n, np.float32, seed=n + 1)
    ref = np.asarray(pallas_gdia.shift_mac_cols(x, coeffs, offs,
                                                interpret=True))
    out = gdia_mac.shift_mac_cols(*_port_views(x, coeffs, shift),
                                  offs).numpy()
    assert ref.shape == out.shape == (C, n)
    assert _rel_err(out, ref) <= 1e-5


def test_baseline_refuses_cpu_tensors():
    """The baseline kernel takes no CPU tensor: only shift_mac_cols has a
    plain path, and the baseline exists only as a kernel."""
    x, coeffs = _inputs(5, 1, 100, np.float32)
    with pytest.raises(ValueError):
        gdia_mac.shift_mac_cols_baseline(torch.from_numpy(x),
                                         torch.from_numpy(coeffs),
                                         _OFFSETS[5])


def test_offsets_array_built_once_per_tuple():
    import ctypes
    offs = (-41, -1, 0, 1, 41)
    addr = gdia_mac._offsets_arg(offs)
    assert gdia_mac._offsets_arg(tuple(offs)) == addr
    assert gdia_mac._offsets_arg(list(offs)) == addr
    assert list((ctypes.c_longlong * 5).from_address(addr)) == list(offs)
    assert gdia_mac._offsets_arg(offs[:4]) != addr


def test_cpu_tensor_takes_plain_version_without_launch():
    x, coeffs = _inputs(5, 3, 500, np.float64)
    before = sum(gdia_mac.LAUNCHES_BY_KC.values())
    out = gdia_mac.shift_mac_cols(torch.from_numpy(x),
                                  torch.from_numpy(coeffs), _OFFSETS[5])
    plain = gdia_mac.shift_mac_cols_plain(torch.from_numpy(x),
                                          torch.from_numpy(coeffs),
                                          _OFFSETS[5])
    assert sum(gdia_mac.LAUNCHES_BY_KC.values()) == before
    assert torch.equal(out, plain)


@pytest.mark.parametrize("bad", ["shape", "dtype", "contiguity", "offsets"])
def test_wrapper_rejects_bad_inputs(bad):
    x = torch.zeros(100, dtype=torch.float64)
    coeffs = torch.zeros(5, 3, 100, dtype=torch.float64)
    offs = _OFFSETS[5]
    if bad == "shape":
        x = torch.zeros(99, dtype=torch.float64)
    elif bad == "dtype":
        x = x.float()
    elif bad == "contiguity":
        x = torch.zeros(100, 2, dtype=torch.float64)[:, 0]
    else:
        offs = offs[:4]
    with pytest.raises((ValueError, TypeError)):
        gdia_mac.shift_mac_cols(x, coeffs, offs)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-13)])
def test_cuda_kernel_matches_plain(dtype, tol):
    """On the card: the sm_90a kernel against the plain version at the
    pitzDaily x5 slice shape (FMA contraction is the only difference)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator().manual_seed(0)
    n, offs = 112000, (-560, -1, 0, 1, 560)
    x = torch.randn(n, generator=g, dtype=dtype)
    coeffs = torch.randn(5, 3, n, generator=g, dtype=dtype)
    ref = gdia_mac.shift_mac_cols_plain(x, coeffs, offs)
    before = sum(gdia_mac.LAUNCHES_BY_KC.values())
    out = gdia_mac.shift_mac_cols(x.cuda(), coeffs.cuda(), offs)
    torch.cuda.synchronize()
    assert sum(gdia_mac.LAUNCHES_BY_KC.values()) == before + 1
    assert (out.cpu() - ref).abs().max() <= tol * ref.abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-13)])
@pytest.mark.parametrize("edge", _EDGES, ids=_EDGE_IDS)
def test_cuda_kernel_matches_plain_edges(edge, dtype, tol):
    """On the card: the kernel (which counts one launch) and the baseline
    kernel (which does not) against the plain version at the edges."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _, K, C, n, offs, shift = edge
    x, coeffs = _inputs(K, C, n, np.float32 if dtype == torch.float32
                        else np.float64, seed=n)
    ref = gdia_mac.shift_mac_cols_plain(torch.from_numpy(x),
                                        torch.from_numpy(coeffs), offs)
    xc, cc = _port_views(x, coeffs, shift, device="cuda")
    before = dict(gdia_mac.LAUNCHES_BY_KC)
    outs = {"kernel": gdia_mac.shift_mac_cols(xc, cc, offs)}
    assert gdia_mac.LAUNCHES_BY_KC.get((K, C), 0) \
        == before.get((K, C), 0) + 1
    outs["baseline"] = gdia_mac.shift_mac_cols_baseline(xc, cc, offs)
    torch.cuda.synchronize()
    assert gdia_mac.LAUNCHES_BY_KC.get((K, C), 0) \
        == before.get((K, C), 0) + 1
    for name, out in outs.items():
        assert out.shape == (C, n), name
        assert (out.cpu() - ref).abs().max() <= tol * ref.abs().max(), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-13)])
@pytest.mark.parametrize("C", [3, 1])
def test_cuda_kernel_matches_plain_channel_k7(C, dtype, tol):
    """On the card: the K = 7 forms at the polyhedral channel's lattice
    (160x80x80, offsets 0, +-1, +-160, +-12800), counted once by (K, C)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator().manual_seed(C)
    n, offs = 160 * 80 * 80, (-12800, -160, -1, 0, 1, 160, 12800)
    x = torch.randn(n, generator=g, dtype=dtype)
    coeffs = torch.randn(7, C, n, generator=g, dtype=dtype)
    ref = gdia_mac.shift_mac_cols_plain(x, coeffs, offs)
    before = gdia_mac.LAUNCHES_BY_KC.get((7, C), 0)
    out = gdia_mac.shift_mac_cols(x.cuda(), coeffs.cuda(), offs)
    torch.cuda.synchronize()
    assert gdia_mac.LAUNCHES_BY_KC.get((7, C), 0) == before + 1
    assert out.shape == (C, n)
    assert (out.cpu() - ref).abs().max() <= tol * ref.abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-13)])
@pytest.mark.parametrize("C", [3, 1])
def test_cuda_kernel_matches_plain_forward_step(C, dtype, tol):
    """On the card: both K = 5 forms at the forward step's lattice at
    scale 16 (960 x 256, offsets 0, +-1, +-960), the shape rhoCentralFoam
    launches them at (C = 3 in every reconstruction's gradient, C = 1 in
    its viscous div(tauMC)), counted once by (K, C)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator().manual_seed(10 + C)
    n, offs = 960 * 256, (-960, -1, 0, 1, 960)
    x = torch.randn(n, generator=g, dtype=dtype)
    coeffs = torch.randn(5, C, n, generator=g, dtype=dtype)
    ref = gdia_mac.shift_mac_cols_plain(x, coeffs, offs)
    before = gdia_mac.LAUNCHES_BY_KC.get((5, C), 0)
    out = gdia_mac.shift_mac_cols(x.cuda(), coeffs.cuda(), offs)
    torch.cuda.synchronize()
    assert gdia_mac.LAUNCHES_BY_KC.get((5, C), 0) == before + 1
    assert out.shape == (C, n)
    assert (out.cpu() - ref).abs().max() <= tol * ref.abs().max()


@pytest.fixture(scope="module")
def duct_planes(tmp_path_factory):
    """The Gauss planes of the full-size porous duct (448 x 48 x 48, n =
    1,032,192, offsets 0, +-1, +-448, +-21,504), built on the card in
    fp64 from the writer's in-memory mesh and gdia embedding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from rapidcfd_tpu_torch.solvers.case import Case
    from rapidcfd_tpu_torch.utils.casegen import porous_duct_case
    from rapidcfd_tpu_torch.utils.logging import captured
    d = str(tmp_path_factory.mktemp("duct"))
    lat = {}
    with captured():
        pm = porous_duct_case(d, write_mesh=False, lattice_out=lat)
        case = Case(d, device=torch.device("cuda"), dtype=torch.float64,
                    pmesh=pm, lattice=lat)
    return case.mesh.gauss


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-13)])
@pytest.mark.parametrize("C", [3, 1])
def test_cuda_kernel_matches_plain_porous_duct(duct_planes, C, dtype, tol):
    """On the card: both K = 7 forms on the porous duct's own planes (C =
    3 for kEpsilon's and div_dev_t_grad's gradients and grad(p), C = 1
    for div_dev_t_grad's contractions), counted once by (K, C)."""
    planes = duct_planes
    assert tuple(planes.offsets) == (-21504, -448, -1, 0, 1, 448, 21504)
    coeffs = (planes.coeffs if C == 3 else planes.coeffs_i[1]).to(dtype)
    n = coeffs.shape[-1]
    assert n == 448 * 48 * 48 and coeffs.shape == (7, C, n)
    g = torch.Generator(device="cuda").manual_seed(20 + C)
    x = torch.randn(n, generator=g, device="cuda", dtype=dtype)
    ref = gdia_mac.shift_mac_cols_plain(x, coeffs, planes.offsets)
    before = gdia_mac.LAUNCHES_BY_KC.get((7, C), 0)
    out = gdia_mac.shift_mac_cols(x, coeffs, planes.offsets)
    torch.cuda.synchronize()
    assert gdia_mac.LAUNCHES_BY_KC.get((7, C), 0) == before + 1
    assert out.shape == (C, n)
    assert (out - ref).abs().max() <= tol * ref.abs().max()
