"""Compute ops: scalar oracles (ground truth), JAX fills and their CUDA
kernels, traceback.

The oracles are slow, obviously-correct NumPy/Python implementations that
replicate the reference's algorithms *including their quirks* (documented
per-function).  Every fill is validated against them.
"""
