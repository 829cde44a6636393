"""repro_torch — the PyTorch/CUDA port of the ICOA system (`repro`).

A package beside the JAX reference, module for module: api/, core/,
transport/, agents/, data/ mirror their `repro` twins, and kernels/ holds
the hand-written Hopper kernels (csrc/*.cu) that replace the Pallas TPU
kernels, each with its plain PyTorch version.  It imports torch and numpy
only — never jax, never repro.
"""
__version__ = "0.1.0"
