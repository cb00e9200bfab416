"""Sliding-DFT phase vocoder."""
from flan_tpu_torch.spv.spv import SPV, spv_forward, spv_inverse

__all__ = ["SPV", "spv_forward", "spv_inverse"]
