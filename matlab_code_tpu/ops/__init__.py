"""Operator library: tensor kernels, dense linear algebra, proximal operators.

Everything here is jit-compatible, batched, and shaped statically so XLA can
hand the matmuls to its GEMM libraries and fuse the elementwise work around
them.
"""
