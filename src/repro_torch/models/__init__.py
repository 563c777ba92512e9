"""Model zoo, the part the port carries: the decoder LM's dense and MoE
attention stacks (phi4-mini, granite-moe), the Mamba-2 stack (mamba2) and
the RG-LRU / local-attention hybrid (recurrentgemma), with attention, the
expert FFN, the SSD intra-chunk part and the RG-LRU scan on the
hand-written kernels of :mod:`repro_torch.kernels`.
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
