"""EZLDA on PyTorch and CUDA: the port of the ``repro`` (JAX) package.

Imports ``torch`` and NumPy only, never ``jax`` or ``repro``. Entry
points run on the CUDA card unless given ``device="cpu"``.
"""
