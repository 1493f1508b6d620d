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
"""

import numpy as np
import pytest
import torch

from rapidcfd_tpu.ops import pallas_gdia
from rapidcfd_tpu_torch.ops import gdia_mac

# lattice offsets: 2-D (K = 5, the pitzDaily slice) and 3-D (K = 7)
_OFFSETS = {5: (-41, -1, 0, 1, 41), 7: (-410, -41, -1, 0, 1, 41, 410)}


def _inputs(K, C, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(dtype)
    coeffs = rng.standard_normal((K, C, n)).astype(dtype)
    return x, coeffs


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


def test_cpu_tensor_takes_plain_version_without_launch():
    x, coeffs = _inputs(5, 3, 500, np.float64)
    before = gdia_mac.LAUNCHES
    out = gdia_mac.shift_mac_cols(torch.from_numpy(x),
                                  torch.from_numpy(coeffs), _OFFSETS[5])
    plain = gdia_mac.shift_mac_cols_plain(torch.from_numpy(x),
                                          torch.from_numpy(coeffs),
                                          _OFFSETS[5])
    assert gdia_mac.LAUNCHES == before
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
    before = gdia_mac.LAUNCHES
    out = gdia_mac.shift_mac_cols(x.cuda(), coeffs.cuda(), offs)
    torch.cuda.synchronize()
    assert gdia_mac.LAUNCHES == before + 1
    assert (out.cpu() - ref).abs().max() <= tol * ref.abs().max()
