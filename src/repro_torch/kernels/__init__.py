"""Hand-written Hopper kernels for the zoo's compute hot spots.

Each kernel module holds a wrapper that launches a CUDA kernel from
``csrc/`` for tensors on the card and runs the kernel's plain torch
version for tensors on the CPU; ``ops.py`` is the dispatch layer the
models call and ``ref.py`` holds the plain oracles.

Kernels:
* ``flash_attention`` — GQA flash attention (causal, sliding window,
  logit softcap, query/key offsets and a ragged valid key count).
* ``moe_gmm`` — the MoE expert FFN over capacity buckets, gate-up-down
  fused so the hidden block stays on chip.

The SSD and RG-LRU kernels are not ported yet (ROADMAP B3, B4).
"""
from . import ops, ref

__all__ = ["ops", "ref"]
