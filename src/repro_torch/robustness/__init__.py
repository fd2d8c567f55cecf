"""Fault tolerance: deterministic fault injection, epoch-granular
checkpoint/resume, serving degradation support (counterpart of
``repro/robustness``)."""
from .checkpoint import RunCheckpointer
from .faults import FaultPlan, InjectedCrash, flip_bit, truncate_file

__all__ = ["FaultPlan", "InjectedCrash", "RunCheckpointer", "flip_bit",
           "truncate_file"]
