"""Model zoo, every arch of the reference's: the decoder LM's dense and MoE
attention stacks (GQA or MLA attention, sliding windows, softcaps,
qk-norm, shared experts, leading dense layers), the Mamba-2 stack and the
RG-LRU / local-attention hybrid, and the codebook and patch frontends,
with attention, the expert FFN, the SSD intra-chunk part and the RG-LRU
scan on the hand-written kernels of :mod:`repro_torch.kernels`.
"""
from .config import ModelConfig
from .convert import params_from_reference
from .lm import LM, init_params

__all__ = [
    "ModelConfig",
    "LM",
    "init_params",
    "params_from_reference",
]
