"""PyTorch/CUDA port of the ``repro`` package (the JAX reference).

It imports torch, never JAX, and nothing of ``repro``: what it needs of the
reference it keeps as its own copy.  Its hot kernels are hand-written CUDA
for Hopper (``kernels/csrc``), each beside a plain PyTorch version that the
CPU runs and the card-side checks compare against.
"""
