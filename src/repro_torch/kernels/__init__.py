"""CUDA kernels for Hopper (``csrc/*.cu``), with their plain PyTorch versions.

K1 ``boolmm``, K2 ``minplus`` (min-plus and max-plus), K3-K6 ``spmv``
(bool, min-plus, plus-times, max-plus); ``ops`` dispatches by device, keeps
the launch counters and holds the dense plus-times product (``torch.matmul``
in full f32); ``build`` compiles the sources with ``nvcc`` at first use.  Importing this package builds nothing.
"""
