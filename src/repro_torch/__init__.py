"""PyTorch port of the isolation-aware scheduling framework.

Module paths mirror the JAX reference package ``repro``: the host
scheduling stack (workload, latency model, GHA compiler, runtime
policies, the scalar engine) is carried over as NumPy code, and the
structure-of-arrays Monte-Carlo engine runs as torch ops on an NVIDIA
GPU, with its ladder-grant step as a hand-written CUDA kernel
(``csrc/ladder_grant.cu``).

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; without a CUDA device they raise.  The package
imports ``torch`` and ``numpy`` and nothing of JAX.
"""
