"""Phase-vocoder algorithm surface."""
from flan_tpu_torch.pv.pv import PV

__all__ = ["PV"]
