"""PyTorch/CUDA port of the ELI system (the JAX package ``repro`` is the
reference).  Imports torch and numpy only; the two scan kernels are
hand-written CUDA for Hopper (``csrc/``), built with ``nvcc`` at first use.
"""
