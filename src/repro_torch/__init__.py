"""PyTorch / CUDA port of the ``repro`` package, for an NVIDIA H100.

Same sub-packages and module names as the JAX reference (``src/repro``), so
a reader finds the counterpart of every function.  This package imports
``torch``, ``numpy`` and the standard library, and nothing of ``jax`` or
``repro``.  Entry points run on the card unless the caller passes
``device="cpu"``.
"""

__all__ = ["configs", "core", "kernels", "models", "runtime", "launch",
           "convert", "benchmarks"]
