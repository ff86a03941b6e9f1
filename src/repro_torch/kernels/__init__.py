"""CUDA kernels for Hopper (``csrc/*.cu``), with their plain PyTorch versions.

K1 ``boolmm``, K2 ``minplus``, K3/K4 ``spmv``; ``ops`` dispatches by device
and keeps the launch counters; ``build`` compiles the sources with ``nvcc``
at first use.  Importing this package builds nothing.
"""
