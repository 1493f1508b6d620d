"""OpenFOAM binary-format stream layer: read/write `format binary`
files (+ transparent gzip), matching the reference byte-for-byte (the
port's copy of rapidcfd_tpu/utils/foambin.py).

Reference format contract:
- OSstream::write(const char*, streamsize) frames every binary block as
  `(` raw-bytes `)` (src/OpenFOAM/db/IOstreams/Sstreams/OSstream.C);
- UListIO.C's binary branch emits `\\n<N>\\n` before the block, so a
  contiguous list serializes as `\\nN\\n(<N*sizeof(T) bytes>)`;
- scalars are IEEE doubles, labels 32-bit ints by default (WM_LABEL_SIZE
  64 handled by width detection against the closing paren);
- faces in binary are CompactIOList: an offsets labelList followed by
  the flattened labelList (CompactIOList.C:operator<<, class word
  `faceCompactIOList`);
- gzip compression wraps the whole file (IFstream/gzstream;
  `writeCompression compressed`).

The FoamFile header and all dictionary structure stay ascii; only list
payloads are raw. decode_binary_dict() rewrites a binary dictionary
file into parseable ascii text with `__binK__` placeholder words and a
stash of the extracted numpy arrays, so the ordinary tokenizer handles
everything else (#include, macros, subdicts) unchanged.
"""

from __future__ import annotations

import gzip
import os
import re

import numpy as np

#: components per OpenFOAM List<T> element (binary payloads are doubles)
NCOMP = {"scalar": 1, "vector": 3, "symmTensor": 6,
         "sphericalTensor": 1, "tensor": 9}

_FORMAT_RE = re.compile(rb"format\s+(\w+)\s*;")


def read_raw(path: str) -> bytes:
    """File bytes; falls back to `<path>.gz` (decompressed)."""
    if os.path.isfile(path):
        with open(path, "rb") as f:
            raw = f.read()
        if raw[:2] == b"\x1f\x8b":  # gzip magic despite plain name
            return gzip.decompress(raw)
        return raw
    gz = path + ".gz"
    if os.path.isfile(gz):
        with gzip.open(gz, "rb") as f:
            return f.read()
    raise FileNotFoundError(path)


def is_binary(raw: bytes) -> bool:
    m = _FORMAT_RE.search(raw[:2048])
    return bool(m) and m.group(1) == b"binary"


_COUNT_RE = re.compile(rb"(\d+)\s*\(")


_ARCH_RE = re.compile(rb'arch\s+"([^"]*)"\s*;')


def arch_widths(raw: bytes) -> tuple[int | None, int]:
    """(label bytes, scalar bytes) from a binary file's `arch` header entry
    (`"LSB;label=32;scalar=64"`, as the reference writes it). Without the
    entry: (None, 8), labels then detected by width. A big-endian file or a
    width other than 32 or 64 bits is refused by name."""
    m = _ARCH_RE.search(raw[:2048])
    if not m:
        return None, 8
    arch = m.group(1).decode("latin-1")
    parts = dict(kv.split("=", 1) for kv in arch.split(";") if "=" in kv)
    if "MSB" in arch.split(";"):
        raise NotImplementedError(f"binary file of arch '{arch}': "
                                  "big-endian (MSB) payloads are not read")
    label = int(parts.get("label", 32))
    scalar = int(parts.get("scalar", 64))
    if label not in (32, 64) or scalar not in (32, 64):
        raise NotImplementedError(
            f"binary file of arch '{arch}': label={label}, scalar={scalar} "
            "(32 or 64 bits are read)")
    return label // 8, scalar // 8


def scan_list(raw: bytes, pos: int, ncomp: int, dtype_char: str,
              width: int | None = None):
    """Scan the next `N (raw)` binary list at/after pos.
    dtype_char 'f' = floats (doubles unless width=4); 'i' = labels (width
    auto-detected against the closing paren unless given). Returns (np
    array (N,) or (N,ncomp), end_pos)."""
    m = _COUNT_RE.search(raw, pos)
    if not m:
        raise ValueError("binary list: no count/paren found")
    n = int(m.group(1))
    start = m.end()
    kind = "f" if dtype_char == "f" else "i"
    if n == 0:
        # empty list: `0 ( )` possibly with whitespace
        end = start
        while raw[end:end + 1] in (b" ", b"\n", b"\t", b"\r"):
            end += 1
        dt = np.dtype(f"<{kind}{width or (8 if kind == 'f' else 4)}")
        arr = np.empty((0, ncomp) if ncomp > 1 else (0,), dt)
        return arr, end + 1
    if width is not None:
        widths = (width,)
    else:
        widths = (8,) if kind == "f" else (4, 8)
    for w in widths:
        end = start + n * ncomp * w
        if end < len(raw) and raw[end:end + 1] == b")":
            arr = np.frombuffer(raw, np.dtype(f"<{kind}{w}"),
                                count=n * ncomp, offset=start)
            if ncomp > 1:
                arr = arr.reshape(n, ncomp)
            return arr, end + 1
    raise ValueError(
        f"binary list of {n} x {ncomp} {dtype_char}: closing paren not "
        f"at any candidate width {widths}")


def fmt_list(arr: np.ndarray) -> bytes:
    """Serialize a contiguous array as the reference's binary list
    (`\\nN\\n(raw)`). Floats as doubles, ints as 32-bit labels."""
    a = np.ascontiguousarray(arr)
    n = a.shape[0]
    if a.dtype.kind == "f":
        a = a.astype("<f8", copy=False)
    else:
        a = a.astype("<i4", copy=False)
    return b"\n%d\n(" % n + a.tobytes() + b")"


_NONUNIF_RE = re.compile(
    rb"nonuniform\s+List<(\w+)>\s*(\d+)\s*\(")


def decode_binary_dict(raw: bytes):
    """Rewrite a binary dictionary file (field files: internalField +
    per-patch values) into ascii text with `__binK__` placeholders.
    Returns (text, stash) where stash maps placeholder -> numpy array."""
    label_w, scalar_w = arch_widths(raw)
    parts = []
    stash = {}
    pos = 0
    k = 0
    while True:
        m = _NONUNIF_RE.search(raw, pos)
        if not m:
            break
        typ = m.group(1).decode()
        n = int(m.group(2))
        ncomp = NCOMP.get(typ)
        dchar, width = "f", scalar_w
        if ncomp is None:
            if typ != "label":
                raise NotImplementedError(
                    f"binary List<{typ}> not supported")
            ncomp, dchar, width = 1, "i", label_w
        arr, end = scan_list(raw, m.start(2), ncomp, dchar, width)
        key = f"__bin{k}__"
        k += 1
        stash[key] = arr
        parts.append(raw[pos:m.start()].decode("latin-1"))
        parts.append(f"nonuniform List<{typ}> {n} {key}")
        pos = end
    parts.append(raw[pos:].decode("latin-1"))
    text = "".join(parts)
    # the header must not claim binary to downstream consumers
    text = re.sub(r"format\s+binary\s*;", "format ascii;", text, count=1)
    return text, stash
