"""Bitmap Filter exact set similarity joins, ported to PyTorch and CUDA.

The JAX package ``repro`` is the reference; this package gives the same
answers on the same inputs.  It imports neither JAX nor ``repro``.
"""
