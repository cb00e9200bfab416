"""flan_tpu_torch: the PyTorch / CUDA port of flan_tpu.

Runs on an NVIDIA GPU (Hopper kernels in csrc/) and on the CPU (the
kernels' plain PyTorch versions). It imports torch and never jax; the JAX
package flan_tpu stays the reference the port is tested against.

This slice covers the phase-vocoder time-stretch class path
(Audio.load_from_file -> convert_to_PV -> PV.stretch -> convert_to_audio)
and the SPV round trip (Audio.convert_to_SPV -> SPV.convert_to_audio).
"""
from flan_tpu_torch.audio.audio import Audio
from flan_tpu_torch.core.audio_buffer import (AudioBuffer, AudioFormat,
                                              SndfileStrings)
from flan_tpu_torch.core.pv_buffer import PVBuffer, PVFormat
from flan_tpu_torch.func import interpolators
from flan_tpu_torch.func.function import (Function, Function2d, as_function,
                                          as_function2d)
from flan_tpu_torch.pv.pv import PV
from flan_tpu_torch.spv.spv import SPV

__version__ = "0.1.0"

__all__ = [
    "Audio", "AudioBuffer", "AudioFormat", "SndfileStrings",
    "PV", "PVBuffer", "PVFormat", "SPV",
    "Function", "Function2d", "as_function", "as_function2d",
    "interpolators",
]
