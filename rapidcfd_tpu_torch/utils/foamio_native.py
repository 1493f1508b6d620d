"""ctypes bindings of the host parser csrc/foamio.cpp (the port's copy of
rapidcfd_tpu/utils/foamio_native.py).

The library is built with g++ at first use into rapidcfd_tpu_torch/_build/
(keyed by the source hash, as the shift-MAC kernel is). Each entry point
returns None when the library cannot be built or the text does not parse
to the expected count; the caller (mesh/polymesh.py) then takes its numpy
parse, the plain version, and says so in the log (`parser_status`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                    "foamio.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "_build")

_LIB = None
#: why the library is unavailable (None while it loads)
_ERROR: str | None = None


def build() -> str:
    """Compile csrc/foamio.cpp with g++ -O3 into _build/ and return the
    library path (a finished build of the same source is reused)."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    lib = os.path.join(_BUILD_DIR, f"foamio_{digest}.so")
    if os.path.isfile(lib):
        return lib
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([cxx, "-O3", "-shared", "-fPIC", "-o", tmp,
                              _SRC], capture_output=True, text=True,
                             timeout=120)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}): "
                               f"{res.stderr[-2000:]}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def get_lib():
    """The loaded library (building it if needed), or None when it cannot
    be built; `parser_status` says which."""
    global _LIB, _ERROR
    if _LIB is not None or _ERROR is not None:
        return _LIB
    try:
        lib = ctypes.CDLL(build())
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        _ERROR = str(e).splitlines()[0] if str(e) else type(e).__name__
        return None
    i64p = ctypes.POINTER(ctypes.c_longlong)
    lib.foam_parse_scalars.restype = ctypes.c_long
    lib.foam_parse_scalars.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_double),
        ctypes.c_long]
    lib.foam_parse_labels.restype = ctypes.c_long
    lib.foam_parse_labels.argtypes = [
        ctypes.c_char_p, ctypes.c_long, i64p, ctypes.c_long]
    lib.foam_parse_faces.restype = ctypes.c_long
    lib.foam_parse_faces.argtypes = [
        ctypes.c_char_p, ctypes.c_long, i64p, ctypes.c_long, i64p,
        ctypes.c_long]
    _LIB = lib
    return _LIB


def parser_status() -> str:
    """'native' when the library is loaded, else why the numpy parse
    runs."""
    return "native" if get_lib() is not None else \
        f"numpy (the native parser is unavailable: {_ERROR})"


def _bytes(text) -> bytes:
    return text if isinstance(text, bytes) else text.encode("latin-1")


def parse_scalars(text, expected: int) -> np.ndarray | None:
    """`expected` doubles from whitespace/paren-separated text."""
    lib = get_lib()
    if lib is None:
        return None
    raw = _bytes(text)
    out = np.empty(expected, dtype=np.float64)
    n = lib.foam_parse_scalars(
        raw, len(raw), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        expected)
    return out if n == expected else None


def parse_labels(text, expected: int) -> np.ndarray | None:
    """`expected` integer labels."""
    lib = get_lib()
    if lib is None:
        return None
    raw = _bytes(text)
    out = np.empty(expected, dtype=np.int64)
    n = lib.foam_parse_labels(
        raw, len(raw),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), expected)
    return out if n == expected else None


def parse_faces(text, n_faces: int):
    """A face list body -> (flat labels, offsets), or None."""
    lib = get_lib()
    if lib is None:
        return None
    raw = _bytes(text)
    i64p = ctypes.POINTER(ctypes.c_longlong)
    sizes = np.empty(n_faces, dtype=np.int64)
    max_flat = max(64, 4 * n_faces)
    while True:
        flat = np.empty(max_flat, dtype=np.int64)
        n = lib.foam_parse_faces(raw, len(raw), sizes.ctypes.data_as(i64p),
                                 n_faces, flat.ctypes.data_as(i64p),
                                 max_flat)
        if n != -2:
            break
        max_flat *= 2
    if n != n_faces:
        return None
    offsets = np.zeros(n_faces + 1, dtype=np.int64)
    np.cumsum(sizes, out=offsets[1:])
    return flat[:offsets[-1]].copy(), offsets
