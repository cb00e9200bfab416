"""Time-domain entry point."""
from flan_tpu_torch.audio.audio import Audio

__all__ = ["Audio"]
