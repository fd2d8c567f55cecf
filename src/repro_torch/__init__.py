"""PyTorch/CUDA port of the EAT-DistGNN system (``src/repro`` is the JAX
reference it is held against).

The package mirrors ``repro``'s subpackages so each module's counterpart is
found under the same name.  It imports ``torch``, numpy and scipy, never
``jax`` or ``repro``: the framework-free host modules are copied in, not
imported.  Entry points run on the CUDA card unless the caller passes
``device="cpu"``; hand-written Hopper kernels live in ``csrc/`` and are
built with ``nvcc`` at first use (``kernels/build.py``).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
