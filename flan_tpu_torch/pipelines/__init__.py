"""Streamed pipelines: audio -> audio in O(chunk) device memory."""
from flan_tpu_torch.pipelines.stretch import pv_stretch_pipeline
from flan_tpu_torch.pipelines.streamed import (pv_morph_pipeline,
                                               pv_repitch_pipeline,
                                               streamed_pv_process)

__all__ = ["pv_stretch_pipeline", "pv_repitch_pipeline",
           "pv_morph_pipeline", "streamed_pv_process"]
