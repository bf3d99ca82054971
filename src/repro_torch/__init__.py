"""PyTorch + CUDA port of the billion-scale knapsack solver.

The host-fed sync-SCD bucketed solve (``core.prefetch.solve_streaming_host``)
runs on an NVIDIA Hopper card through two hand-written CUDA kernels
(``kernels/csrc/scd_fused.cu``); on the CPU every kernel wrapper runs its
plain PyTorch version (``kernels/ref.py``). This package imports neither
JAX nor the JAX reference package ``repro``.
"""
