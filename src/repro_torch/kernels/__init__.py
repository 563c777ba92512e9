"""Hand-written Hopper kernels for the zoo's compute hot spots.

Each kernel module holds a wrapper that launches a CUDA kernel from
``csrc/`` for tensors on the card and runs the kernel's plain torch
version for tensors on the CPU; ``ops.py`` is the dispatch layer the
models call and ``ref.py`` holds the plain oracles.

Kernels:
* ``flash_attention`` — GQA flash attention (causal, sliding window,
  logit softcap, query/key offsets, a ragged valid key count and ring
  caches' key positions; head dim up to 256).
* ``moe_gmm`` — the MoE expert FFN over capacity buckets, gate-up-down
  fused so the hidden block stays on chip.
* ``ssd`` — Mamba-2's SSD intra-chunk part (``ops.ssd_chunked`` adds
  the inter-chunk scan).
* ``rglru`` — the RG-LRU gates and recurrence in one pass.
"""
from . import ops, ref

__all__ = ["ops", "ref"]
