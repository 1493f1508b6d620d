"""Shift-MAC over the gdia lattice: the port of ops/pallas_gdia.py.

    out[c, s] = sum_k coeffs[k, c, s] * x[s + offsets[k]]

with x read as zero outside [0, n), x (n,), coeffs (K, C, n) -> (C, n).

`shift_mac_cols` keeps the JAX signature. A CUDA tensor goes to the hand
kernel in csrc/shift_mac.cu (built with nvcc on first use into _build/,
loaded with ctypes, launched on the current stream); a CPU tensor goes to
`shift_mac_cols_plain`, the pad-and-slice FMA of pallas_gdia.py:110-117.
There is no fallback from one to the other: a CUDA tensor either launches
the kernel or raises.

`LAUNCHES` counts kernel launches (only where the kernel is launched), so
a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch
import torch.nn.functional as F

_SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                    "shift_mac.cu")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "_build")
_MAX_K = 8
_FN = {torch.float32: "shift_mac_f32", torch.float64: "shift_mac_f64"}

#: number of kernel launches since the last reset (set it to 0 to reset)
LAUNCHES = 0

_LIB = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the shift-MAC "
                           "kernel is built from csrc/shift_mac.cu")
    return found


def build() -> str:
    """Compile csrc/shift_mac.cu for sm_90a into _build/ (keyed by the
    source hash, so an edited source rebuilds) and return the library
    path. A finished build is reused."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    lib = os.path.join(_BUILD_DIR, f"shift_mac_{digest}.so")
    if os.path.isfile(lib):
        return lib
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
           "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-o", tmp, _SRC]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def _load():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        for name in _FN.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(x: torch.Tensor, coeffs: torch.Tensor, offsets) -> None:
    if coeffs.dim() != 3:
        raise ValueError(f"coeffs must be (K, C, n), got {tuple(coeffs.shape)}")
    K, C, n = coeffs.shape
    if x.dim() != 1 or x.shape[0] != n:
        raise ValueError(f"x must be ({n},), got {tuple(x.shape)}")
    if len(offsets) != K or not 1 <= K <= _MAX_K:
        raise ValueError(f"need 1 <= K == len(offsets) <= {_MAX_K}, got "
                         f"K={K}, offsets={tuple(offsets)}")
    if x.dtype != coeffs.dtype or x.dtype not in _FN:
        raise TypeError(f"x and coeffs must share float32 or float64, got "
                        f"{x.dtype} and {coeffs.dtype}")
    if x.device != coeffs.device:
        raise ValueError(f"x on {x.device}, coeffs on {coeffs.device}")
    if not (x.is_contiguous() and coeffs.is_contiguous()):
        raise ValueError("x and coeffs must be contiguous")


def shift_mac_cols_plain(x: torch.Tensor, coeffs: torch.Tensor,
                         offsets) -> torch.Tensor:
    """Plain torch version: pad x, then one slice and one (C, n) FMA per
    offset in ascending k (pallas_gdia.py:110-117)."""
    n = coeffs.shape[2]
    D = max(1, max(abs(o) for o in offsets))
    xp = F.pad(x, (D, D))
    acc = None
    for k, o in enumerate(offsets):
        term = coeffs[k] * xp[D + o:D + o + n][None, :]
        acc = term if acc is None else acc + term
    return acc


def shift_mac_cols(x: torch.Tensor, coeffs: torch.Tensor,
                   offsets) -> torch.Tensor:
    """out[c] = sum_k coeffs[k, c, :] * shift(x, offsets[k]), zero-filled
    outside [0, n). x (n,), coeffs (K, C, n) -> (C, n)."""
    _check(x, coeffs, offsets)
    if x.device.type == "cpu":
        return shift_mac_cols_plain(x, coeffs, offsets)
    if x.device.type != "cuda":
        raise ValueError(f"shift_mac_cols: no kernel for device {x.device}")
    K, C, n = coeffs.shape
    out = torch.empty((C, n), dtype=x.dtype, device=x.device)
    offs = (ctypes.c_longlong * K)(*(int(o) for o in offsets))
    fn = getattr(_load(), _FN[x.dtype])
    with torch.cuda.device(x.device):      # launch on the tensors' card
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), coeffs.data_ptr(), out.data_ptr(), n, K, C,
                ctypes.cast(offs, ctypes.c_void_p), stream)
    if rc != 0:
        raise RuntimeError(f"shift_mac kernel launch failed: CUDA error {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out
