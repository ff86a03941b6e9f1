"""CUDA kernels for Hopper (``csrc/*.cu``), with their plain PyTorch versions.

K1 ``boolmm``, K2 ``minplus`` (min-plus and max-plus), K3-K7 ``spmv``
(bool, min-plus, plus-times, max-plus, tile-skip min-plus), K8 ``relax``
(the fused min-plus step, merge and per-row flags) for the Datalog paths;
K9 ``flash_attention`` (forward GQA attention with causal, window and
softcap masks) and K10 ``rglru_scan`` (the RG-LRU recurrence) for the LM
prefill.  ``ops`` dispatches by device, keeps the launch counters and
holds the dense plus-times product (``torch.matmul`` in full f32);
``build`` compiles the sources with ``nvcc`` at first use.  Importing this
package builds nothing.
"""
