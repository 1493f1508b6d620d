"""OpenFOAM-format dictionary parser (the port's copy of
rapidcfd_tpu/utils/dictionary.py).

Reads the reference's case-file format (system/controlDict, fvSchemes,
fvSolution, constant/*Properties, field files) so stock OpenFOAM cases load
unmodified. Capability parity with the reference's
src/OpenFOAM/db/dictionary (recursive keyword->entry store, ``#include``,
``$macro`` expansion, quoted-regex keyword matching); ``#codeStream`` and
``#calc`` are accepted but rejected with a clear error (deferred — see
SURVEY.md §7.3).

This is a host-side, read-once component: parse cost is irrelevant to the
TPU hot path, so it is plain Python. Heavy numeric payloads (nonuniform
field lists, polyMesh files) take a numpy fast path in mesh/field readers.
"""

from __future__ import annotations

import os
import re
from typing import Any, Iterator


class ParseError(Exception):
    pass


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_PUNCT = set("{};")
_COMMENT_LINE = "//"


class _Str(str):
    """A quoted string token (used for regex keywords)."""
    __slots__ = ()


def tokenize(text: str, *, path: str | None = None,
             include_dirs: tuple[str, ...] = ()) -> Iterator[Any]:
    """Yield tokens: int/float, str (word), _Str (quoted), or punct chars."""
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c in " \t\r\n":
            i += 1
            continue
        if c == "/" and text.startswith("//", i):
            j = text.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "/" and text.startswith("/*", i):
            j = text.find("*/", i + 2)
            if j < 0:
                raise ParseError(f"unterminated block comment in {path}")
            i = j + 2
            continue
        if c == '"':
            j = i + 1
            while j < n and text[j] != '"':
                j += 2 if text[j] == "\\" else 1
            if j >= n:
                raise ParseError(f"unterminated string in {path}")
            yield _Str(text[i + 1:j])
            i = j + 1
            continue
        if c in "{};()[]":
            yield c
            i += 1
            continue
        if c == "#":
            # directive word, e.g. #include
            j = i + 1
            while j < n and (text[j].isalnum() or text[j] == "_"):
                j += 1
            directive = text[i:j]
            i = j
            if directive in ("#include", "#includeIfPresent",
                             "#sinclude", "#includeEtc"):
                # consume the quoted filename
                while i < n and text[i] in " \t\r\n":
                    i += 1
                if i >= n or text[i] != '"':
                    raise ParseError(f"{directive} expects quoted file ({path})")
                j = text.index('"', i + 1)
                fname = text[i + 1:j]
                i = j + 1
                inc = _resolve_include(fname, path, include_dirs)
                if inc is None:
                    if directive in ("#includeIfPresent", "#sinclude"):
                        continue
                    raise ParseError(f"#include file not found: {fname} "
                                     f"(from {path})")
                with open(inc) as f:
                    yield from tokenize(f.read(), path=inc,
                                        include_dirs=include_dirs)
                continue
            if directive == "#inputMode":
                # consume the mode word and ignore (merge semantics default)
                while i < n and text[i] in " \t\r\n":
                    i += 1
                j = i
                while j < n and not text[j].isspace() and text[j] != ";":
                    j += 1
                i = j
                continue
            if directive in ("#codeStream", "#calc"):
                raise ParseError(
                    f"{directive} (runtime-compiled dictionary entries) is "
                    f"not supported by rapidcfd_tpu ({path}); replace with a "
                    f"literal value")
            yield directive
            continue
        # word or number: consume to whitespace / punct, tracking paren depth
        j = i
        depth = 0
        while j < n:
            ch = text[j]
            if ch in " \t\r\n" or ch in '{};"' or ch == "[" or ch == "]":
                break
            if ch == "(":
                depth += 1
            elif ch == ")":
                if depth == 0:
                    break
                depth -= 1
            elif ch == "/" and (text.startswith("//", j)
                                or text.startswith("/*", j)):
                break
            j += 1
        tok = text[i:j]
        i = j
        yield _coerce(tok)


def _coerce(tok: str):
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok


def _resolve_include(fname: str, path: str | None,
                     include_dirs: tuple[str, ...]) -> str | None:
    fname = fname.replace("$FOAM_CASE", include_dirs[0] if include_dirs else ".")
    cands = []
    if os.path.isabs(fname):
        cands.append(fname)
    else:
        if path:
            cands.append(os.path.join(os.path.dirname(path), fname))
        cands += [os.path.join(d, fname) for d in include_dirs]
    for c in cands:
        if os.path.isfile(c):
            return c
    return None


# ---------------------------------------------------------------------------
# Dictionary
# ---------------------------------------------------------------------------

class Dictionary(dict):
    """Ordered keyword->entry store with OpenFOAM lookup semantics.

    Values are: scalars, words (str), lists, nested Dictionary, or tuples of
    mixed tokens (multi-token primitive entries, e.g. ``Gauss linear`` ->
    ("Gauss", "linear")). Quoted keywords act as regexes during lookup,
    mirroring dictionary::lookupEntryPtr's pattern matching.
    """

    def lookup(self, key: str, default=None, *, required: bool = False):
        if key in self and not isinstance(self._key_obj(key), _Str):
            return self[key]
        # regex keys (insertion order; OpenFOAM matches patterns after exacts)
        for k, v in self.items():
            if isinstance(k, _Str) and re.fullmatch(str(k), key):
                return v
        if key in self:  # a _Str key looked up literally
            return self[key]
        if required:
            raise KeyError(f"keyword '{key}' not found in dictionary "
                           f"(keys: {list(self.keys())})")
        return default

    def _key_obj(self, key):
        for k in self.keys():
            if k == key:
                return k
        return None

    def lookup_or(self, key: str, default):
        v = self.lookup(key)
        return default if v is None else v

    def subdict(self, key: str, required: bool = True) -> "Dictionary":
        v = self.lookup(key, required=required)
        if v is None:
            return Dictionary()
        if not isinstance(v, Dictionary):
            raise ParseError(f"entry '{key}' is not a sub-dictionary")
        return v

    def scalar(self, key: str, default=None) -> float:
        v = self.lookup(key)
        if v is None:
            if default is None:
                raise KeyError(f"scalar '{key}' not found")
            return float(default)
        if isinstance(v, (tuple, list)) and len(v) and v[0] == "uniform":
            v = v[1]
        return float(v)

    def word(self, key: str, default=None) -> str:
        v = self.lookup(key)
        if v is None:
            if default is None:
                raise KeyError(f"word '{key}' not found")
            return default
        if isinstance(v, (tuple, list)):
            v = v[0]
        return str(v)

    def boolean(self, key: str, default: bool = False) -> bool:
        v = self.lookup(key)
        if v is None:
            return default
        if isinstance(v, (tuple, list)):
            v = v[0]
        return str(v) in ("yes", "true", "on", "1", "True") or v is True or v == 1


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

class _TokenStream:
    def __init__(self, toks):
        self._toks = list(toks)
        self._i = 0

    def peek(self):
        return self._toks[self._i] if self._i < len(self._toks) else None

    def next(self):
        t = self.peek()
        self._i += 1
        return t

    def expect(self, tok):
        t = self.next()
        if t != tok:
            raise ParseError(f"expected '{tok}', got '{t}'")
        return t

    @property
    def exhausted(self):
        return self._i >= len(self._toks)


def _parse_list(ts: _TokenStream):
    """Parse after consuming '('. Returns a Python list."""
    out = []
    while True:
        t = ts.peek()
        if t is None:
            raise ParseError("unterminated list")
        if t == ")":
            ts.next()
            return out
        out.append(_parse_item(ts))


def _parse_item(ts: _TokenStream):
    t = ts.next()
    if t == "(":
        return _parse_list(ts)
    if t == "[":
        dims = []
        while ts.peek() != "]":
            dims.append(ts.next())
        ts.next()
        from .dimensions import DimensionSet, parse_named_units
        if all(isinstance(x, (int, float)) for x in dims):
            return DimensionSet.of(*dims)
        return parse_named_units(dims)
    if t == "{":
        return _parse_dict_body(ts)
    return t


def _parse_entry_value(ts: _TokenStream, scope: list):
    """Tokens after a keyword, up to ';' (primitive) or a '{...}' subdict."""
    if ts.peek() == "{":
        ts.next()
        return _parse_dict_body(ts, scope)
    items = []
    while True:
        t = ts.peek()
        if t is None:
            raise ParseError("unterminated entry (missing ';')")
        if t == ";":
            ts.next()
            break
        items.append(_expand_macro(_parse_item(ts), scope))
    if len(items) == 1:
        return items[0]
    return tuple(items)


def _expand_macro(item, scope: list):
    if isinstance(item, str) and not isinstance(item, _Str) \
            and item.startswith("$"):
        name = item[1:].lstrip("{").rstrip("}")
        for d in reversed(scope):
            if name in d:
                return d[name]
        raise ParseError(f"macro ${name} not found in scope")
    return item


def _parse_dict_body(ts: _TokenStream, scope: list | None = None,
                     toplevel: bool = False) -> Dictionary:
    d = Dictionary()
    scope = (scope or []) + [d]
    while True:
        t = ts.peek()
        if t is None or t == "}":
            if t == "}":
                ts.next()
            elif not toplevel:
                raise ParseError("unterminated sub-dictionary (missing '}')")
            return d
        key = ts.next()
        if key == "#remove":
            victim = ts.next()
            ts.expect(";")
            d.pop(victim, None)
            continue
        if not isinstance(key, str):
            raise ParseError(f"expected keyword, got {key!r}")
        d[key] = _parse_entry_value(ts, scope)


def parse_dictionary(text: str, *, path: str | None = None,
                     include_dirs: tuple[str, ...] = ()) -> Dictionary:
    ts = _TokenStream(tokenize(text, path=path, include_dirs=include_dirs))
    d = _parse_dict_body(ts, toplevel=True)
    if not ts.exhausted:
        raise ParseError(f"trailing tokens: {ts.peek()!r}")
    return d


def parse_file(path: str, *, include_dirs: tuple[str, ...] = ()) -> Dictionary:
    """Parse a dictionary file: ascii, gzip-compressed (.gz fallback),
    or `format binary` (list payloads extracted into a stash of numpy
    arrays reachable as d.binstash, placeholder words `__binK__` in the
    parsed entries — reference: IFstream/gzstream + binary list blocks,
    gpuListIO.C:15-35)."""
    from . import foambin
    raw = foambin.read_raw(path)
    stash = None
    if foambin.is_binary(raw):
        text, stash = foambin.decode_binary_dict(raw)
    else:
        text = raw.decode("latin-1")
    case_dir = os.path.dirname(os.path.dirname(os.path.abspath(path)))
    dirs = tuple(include_dirs) or (case_dir,)
    d = parse_dictionary(text, path=path, include_dirs=dirs)
    d.pop("FoamFile", None)
    if stash:
        d.binstash = stash
    return d


def foamfile_header(cls: str, obj: str, location: str = "",
                    fmt: str = "ascii", arch: str = "") -> str:
    """The FoamFile header; arch (binary files) is the reference's
    `"LSB;label=32;scalar=64"` word."""
    loc = f'    location    "{location}";\n' if location else ""
    arch_ = f'    arch        "{arch}";\n' if arch else ""
    return (
        "FoamFile\n{\n"
        "    version     2.0;\n"
        f"    format      {fmt};\n"
        f"{arch_}"
        f"    class       {cls};\n"
        f"{loc}"
        f"    object      {obj};\n"
        "}\n"
    )
