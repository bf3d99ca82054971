"""PyTorch + CUDA port of the billion-scale knapsack solver.

The host-fed production driver (``core.prefetch.solve_streaming_host``:
sync SCD or DD over virtual slots, with screening, checkpoint and resume,
the fault layer and the phase tracer) and the resident single-device
solve of the sparse and dense GKP (``core.solver.solve``) run on an NVIDIA
Hopper card through hand-written CUDA kernels (``kernels/csrc/``); on the
CPU every kernel wrapper runs its plain PyTorch version
(``kernels/ref.py``). This package imports neither JAX nor the JAX
reference package ``repro``.
"""
