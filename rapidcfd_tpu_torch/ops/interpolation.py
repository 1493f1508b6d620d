"""Face interpolation of cell fields (port of rapidcfd_tpu/ops/
interpolation.py:22-75 and set_current_dt). Every scheme reduces to owner
weights w on internal faces (faceVal = w*own + (1-w)*nei). This slice
ports linear and upwind."""

from __future__ import annotations

import torch

from ..fields.field import SurfaceField, VolField
from ..mesh.mesharrays import MeshArrays


def _unwrap(scheme):
    """('bounded', inner) is an fvm-only marker; interpolation uses the
    inner scheme."""
    if isinstance(scheme, tuple) and len(scheme) == 2 \
            and scheme[0] == "bounded":
        return scheme[1]
    return scheme


def _linear(mesh, vf, phi):
    return mesh.weights


def _upwind(mesh, vf, phi):
    if phi is None:
        raise ValueError("upwind interpolation requires a flux field")
    return (phi.data[:mesh.n_internal] >= 0.0).to(mesh.weights.dtype)


SCHEMES = {"linear": _linear, "upwind": _upwind}


def scheme_weights(mesh: MeshArrays, vf: VolField, scheme="linear",
                   phi: SurfaceField | None = None) -> torch.Tensor:
    """Owner weights on internal faces (used by fvm::div assembly)."""
    scheme = _unwrap(scheme)
    name, args = (scheme[0], scheme[1:]) if isinstance(scheme, tuple) \
        else (scheme, ())
    fn = SCHEMES.get(name)
    if fn is None:
        raise NotImplementedError(
            f"interpolation scheme '{name}' is not ported yet (ported: "
            f"{', '.join(sorted(SCHEMES))})")
    return fn(mesh, vf, phi, *args)


def interpolate_internal(mesh: MeshArrays, vf: VolField, scheme="linear",
                         phi: SurfaceField | None = None) -> torch.Tensor:
    """Internal-face values by the named scheme."""
    from .fvc import face_own_nei
    w = scheme_weights(mesh, vf, scheme, phi)
    own, nei = face_own_nei(mesh, vf.data)
    if own.dim() > w.dim():
        w = w.reshape(w.shape + (1,) * (own.dim() - w.dim()))
    return w * own + (1.0 - w) * nei


#: the running solver's current time step, for Courant-based schemes
#: (CoBlended in the JAX package; none of them is ported yet)
_CURRENT_DT = None


def set_current_dt(dt):
    """Expose dt to Courant-based schemes. The solver step calls it before
    assembling convection terms."""
    global _CURRENT_DT
    _CURRENT_DT = dt
