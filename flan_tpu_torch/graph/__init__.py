from flan_tpu_torch.graph.graph import (ALL_PLANES, Graph, WaveformMode,
                                        write_bmp)
__all__ = ["Graph", "WaveformMode", "ALL_PLANES", "write_bmp"]
