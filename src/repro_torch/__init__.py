"""PyTorch/CUDA port of the Puffin-backed vector index system.

Mirrors ``repro`` (the JAX reference) module by module; each module's
reference sits at the same relative path.  Imports ``torch`` and numpy,
never ``jax`` or ``repro``.  Entry points run on CUDA unless the caller
passes ``device="cpu"``.
"""
