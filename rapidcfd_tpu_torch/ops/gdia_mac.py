"""Shift-MAC over the gdia lattice: the port of ops/pallas_gdia.py.

    out[c, s] = sum_k coeffs[k, c, s] * x[s + offsets[k]]

with x read as zero outside [0, n), x (n,), coeffs (K, C, n) -> (C, n),
1 <= K <= 8, any C >= 1 and any integer offsets, fp32 or fp64.

`shift_mac_cols` keeps the JAX signature. A CUDA tensor goes to the hand
kernel in csrc/shift_mac.cu (built with nvcc on first use into _build/,
loaded with ctypes, launched on the current stream); a CPU tensor goes to
`shift_mac_cols_plain`, the pad-and-slice FMA of pallas_gdia.py:110-117.
There is no fallback from one to the other: a CUDA tensor either launches
the kernel or raises.

The kernel is memory-bound, and one call is little more than a launch's
worth of device time, so its design (the source's note says more) keeps
every load of a thread in flight at once with few instructions around
them: on the lattice stencil (offsets -1, 0, 1 in the middle, the others
multiples of 4 cells in fp32, 2 in fp64) and for the forms the paths use,
(K, C) in {5, 7} x {1, 3}, each thread owns 4 cells in fp32 (2 in fp64),
reads coefficient rows and x and writes outputs 16 bytes at a time, and
takes x at +-1 from the adjacent lanes. Every other case (misaligned
views, n % 4 != 0, other offsets, K or C) takes the source's generic
kernel, one cell per thread. The launcher in the source picks the kernel
and the grid. This module's host path is kept short, since a call's host
time is several times its device time: a launch is one packed argument
(the source's `Call`), the offsets array is built once per offsets
tuple, the entry points are resolved once per dtype, and the source
switches the device only when x is not on the current one.

`shift_mac_cols_baseline` runs the baseline kernel the source keeps for
timing (one thread per cell, as the kernel was first written) on the same
inputs; `chip_smoke.py` times it against `shift_mac_cols`. It does not
count.

`LAUNCHES_BY_KC` counts kernel launches of `shift_mac_cols` (only where
the kernel is launched) by (K, C): K offsets (5 on a 2-D lattice, 7 on a
3-D one) and C coefficient rows (3: the Gauss gradient, 1: the divergence
contraction), so a run can show that its main path went through the
kernel in each form; `reset_launches()` empties it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile

import torch
import torch.nn.functional as F

_SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                    "shift_mac.cu")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "_build")
_MAX_K = 8
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

#: kernel launches since the last reset_launches(), by (K, C): the
#: offsets and the coefficient rows per call
LAUNCHES_BY_KC: dict[tuple[int, int], int] = {}


def reset_launches():
    LAUNCHES_BY_KC.clear()


_LIB = None
_STREAM = None           # device index -> its current stream's handle
_FNS: dict = {}          # dtype -> (kernel entry, baseline kernel entry)
_OFFSETS: dict = {}      # offsets tuple -> (ctypes array, its address)
# the source's `Call`: x, coeffs, out, n, offsets, stream; K, C, device
# (and the struct's tail padding)
_PACK_CALL = struct.Struct("<6q3i4x").pack


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
    path. A finished build is reused. ptxas's report (registers, shared
    memory and spills of every kernel) is kept beside the library
    (`build_report`)."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    lib = os.path.join(_BUILD_DIR, f"shift_mac_{digest}.so")
    if os.path.isfile(lib):
        return lib
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
           "-std=c++17", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
           "-o", tmp, _SRC]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stderr}")
        with open(lib[:-3] + ".ptxas.txt", "w") as f:
            f.write(res.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def build_report() -> str:
    """ptxas's report of the current build (builds first if needed)."""
    with open(build()[:-3] + ".ptxas.txt") as f:
        return f.read()


def _load():
    global _LIB, _STREAM
    if _LIB is None:
        _STREAM = torch._C._cuda_getCurrentRawStream
        lib = ctypes.CDLL(build())
        for dtype, suffix in _SUFFIX.items():
            fns = (getattr(lib, f"shift_mac_{suffix}"),
                   getattr(lib, f"shift_mac_ref_{suffix}"))
            for fn in fns:
                fn.argtypes = [ctypes.c_char_p]
                fn.restype = ctypes.c_int
            _FNS[dtype] = fns
        _LIB = lib
    return _LIB


def _check(x: torch.Tensor, coeffs: torch.Tensor, offsets) -> None:
    shape = coeffs.shape
    if len(shape) != 3:
        raise ValueError(f"coeffs must be (K, C, n), got {tuple(shape)}")
    if x.ndim != 1 or x.shape[0] != shape[2]:
        raise ValueError(f"x must be ({shape[2]},), got {tuple(x.shape)}")
    K = shape[0]
    if len(offsets) != K or not 1 <= K <= _MAX_K:
        raise ValueError(f"need 1 <= K == len(offsets) <= {_MAX_K}, got "
                         f"K={K}, offsets={tuple(offsets)}")
    if x.dtype is not coeffs.dtype or x.dtype not in _SUFFIX:
        raise TypeError(f"x and coeffs must share float32 or float64, got "
                        f"{x.dtype} and {coeffs.dtype}")
    if x.get_device() != coeffs.get_device():
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


def _offsets_arg(offsets) -> int:
    """Address of a long long array of the offsets, built once per tuple
    (and kept alive by the cache)."""
    key = offsets if type(offsets) is tuple else tuple(offsets)
    hit = _OFFSETS.get(key)
    if hit is None:
        arr = (ctypes.c_longlong * len(key))(*(int(o) for o in key))
        # setdefault: of two threads building the same array, both get the
        # one the cache keeps
        hit = _OFFSETS.setdefault(key, (arr, ctypes.addressof(arr)))
    return hit[1]


def _launch(x, coeffs, offsets, baseline) -> torch.Tensor:
    """One launch on x's card (the source switches to it when it is not
    the current one), on its current stream: the kernel, or the baseline
    kernel."""
    if not x.is_cuda:
        raise ValueError(f"shift_mac_cols: no kernel for device {x.device}")
    if not _FNS:
        _load()
    K, C, n = coeffs.shape
    out = coeffs.new_empty((C, n))
    dev = x.get_device()
    rc = _FNS[x.dtype][baseline](_PACK_CALL(
        x.data_ptr(), coeffs.data_ptr(), out.data_ptr(), n,
        _offsets_arg(offsets), _STREAM(dev), K, C, dev))
    if rc != 0:
        raise RuntimeError(f"shift_mac kernel launch failed: CUDA error {rc}")
    return out


def shift_mac_cols(x: torch.Tensor, coeffs: torch.Tensor,
                   offsets) -> torch.Tensor:
    """out[c] = sum_k coeffs[k, c, :] * shift(x, offsets[k]), zero-filled
    outside [0, n). x (n,), coeffs (K, C, n) -> (C, n)."""
    _check(x, coeffs, offsets)
    if not x.is_cuda and x.device.type == "cpu":
        return shift_mac_cols_plain(x, coeffs, offsets)
    out = _launch(x, coeffs, offsets, False)
    K, C = coeffs.shape[0], out.shape[0]
    LAUNCHES_BY_KC[K, C] = LAUNCHES_BY_KC.get((K, C), 0) + 1
    return out


def shift_mac_cols_baseline(x: torch.Tensor, coeffs: torch.Tensor,
                            offsets) -> torch.Tensor:
    """The same function through the baseline kernel (CUDA tensors only),
    for timing against `shift_mac_cols`, which never runs it. Not counted
    in LAUNCHES_BY_KC."""
    _check(x, coeffs, offsets)
    return _launch(x, coeffs, offsets, True)
