"""rapidcfd_tpu_torch — the PyTorch/CUDA port of rapidcfd_tpu.

Mirrors the JAX package's module paths and function names (the JAX
package is the reference and stays as it is). Plain tensor code is
PyTorch; every Pallas kernel of the JAX package becomes a hand-written
Hopper kernel under ``csrc/`` with a plain torch version beside it.

Device and dtype policy:

- a device is always passed explicitly (``resolve_device``); asking for
  ``cuda`` on a machine without a card raises, nothing moves to the CPU
  quietly;
- the float width follows the JAX dispatcher (rapidcfd_tpu/__main__.py:
  115-153): icoFoam runs fp32 by default, ``-precision fp64`` overrides.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

_DTYPES = {"fp32": torch.float32, "fp64": torch.float64}

#: solvers whose default width is fp64 (the JAX dispatcher's X64_DEFAULT);
#: none of them is ported yet, so every ported solver defaults to fp32
X64_DEFAULT: frozenset = frozenset()


def resolve_device(name) -> torch.device:
    """torch.device for `name` ('cuda', 'cuda:0', 'cpu' or a device).
    Raises when a CUDA device is asked for and none is available."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device '{name}' requested but "
                           "torch.cuda.is_available() is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device '{name}' (cuda or cpu)")
    return dev


def solver_dtype(solver: str, precision: str | None = None) -> torch.dtype:
    """Float width of a solver run: `precision` ('fp32'|'fp64') if given,
    else the solver's default."""
    if precision is None:
        precision = "fp64" if solver in X64_DEFAULT else "fp32"
    if precision not in _DTYPES:
        raise ValueError(f"precision must be fp32 or fp64, got {precision}")
    return _DTYPES[precision]
