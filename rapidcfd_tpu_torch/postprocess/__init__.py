"""Run-time postprocessing: the functionObjects of controlDict (port of
rapidcfd_tpu/postprocess/)."""

from .functionobjects import FunctionObject, FunctionObjectList

__all__ = ["FunctionObject", "FunctionObjectList"]
