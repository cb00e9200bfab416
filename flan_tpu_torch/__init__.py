"""flan_tpu_torch: the PyTorch / CUDA port of flan_tpu.

Runs on an NVIDIA GPU (Hopper kernels in csrc/) and on the CPU (the
kernels' plain PyTorch versions). Host data goes to the card unless the
caller names a device (`device="cpu"`). It imports torch and never jax;
the JAX package flan_tpu stays the reference the port is tested against.

The port covers:
- the phase-vocoder time-stretch class path (Audio.load_from_file ->
  convert_to_PV -> PV.stretch -> convert_to_audio) and the rest of the PV
  class: .flan files, frame utilities, repitch and modify_frequency, and
  the algorithms of pv/algorithms.py (select, freeze, replace / subtract
  amplitudes, synthesize, octaves and harmonics, shape, n loudest
  partials, resonate and perturb, whose recurrences run on the scan
  kernels), and the rest of the PV family: desample, smear_time,
  time_extrapolate, stretch_spline (its spline's band solve on the scan
  kernel), the quad modify, and get_salience (the salience histogram
  kernel), get_contours and prism;
- the Function layer (constants, callables, their arithmetic, the seeded
  distributions) and Pipe;
- the streamed pipelines, audio -> audio in O(chunk) device memory:
  pv_stretch_pipeline (the headline 2x stretch), pv_repitch_pipeline,
  pv_morph_pipeline and streamed_pv_process (pipelines/);
- the SPV round trip and its algorithms (Audio.convert_to_SPV /
  convert_to_ms_SPV -> SPV.repitch / modify_frequency ->
  convert_to_audio / convert_to_lr_audio), kernels B1 and B2;
- the SQPV constant-Q round trip and its algorithms
  (Audio.convert_to_SQPV / convert_to_ms_SQPV -> SQPV.repitch /
  modify_pitch / select -> convert_to_audio / convert_to_lr_audio),
  kernels B3 and B4;
- the IIR filter and dynamics path (Audio.filter_1pole_* /
  filter_2pole_* / filter_comb / shift_frequency / halfband_* ->
  compress / apply_adsr_envelope), whose recurrences run on the scan
  kernels (counterparts of T1/T2); T3, the lowering probe, is a kernel on
  no path (ops/probe_kernels.py);
- the synthesis family and the granular engine (Audio.synthesize_*,
  texture, texture_effect, granulate, psola, delay) and the Wavetable,
  with three kernels of their own: JAX's threefry bits (ops/random.py),
  the fixed-point mod-1 cycle scan (ops/cycle_scan.py) and the granular
  overlap-add (ops/grain_mix.py);
- files: Audio.load_from_file / save_to_file read and write WAV, FLAC,
  AIFF/AIFF-C, Ogg/Vorbis, AU, CAF, Wave64 and MP3 (io/), and the
  prefetching loader stages clips onto the card from pinned memory on a
  stream of its own (io/loader.py);
- Spectrum, the Graph renderer and the convert_to_graph / save_to_bmp
  family of Audio, PV, SQPV, Function and Wavetable (graph/);
- the command line, python -m flan_tpu_torch (cli.py).
"""
from flan_tpu_torch.audio import Audio
from flan_tpu_torch.core.audio_buffer import (AudioBuffer, AudioFormat,
                                              SndfileStrings)
from flan_tpu_torch.core.pv_buffer import PVBuffer, PVFormat
from flan_tpu_torch.func import interpolators
from flan_tpu_torch.func.function import (Function, Function2d, adsr,
                                          as_function, as_function2d,
                                          waveforms)
from flan_tpu_torch.func.function_sample import (FunctionSample,
                                                 FunctionSample2d)
from flan_tpu_torch.func.pipe import Pipe
from flan_tpu_torch.pipelines import (pv_morph_pipeline, pv_repitch_pipeline,
                                      pv_stretch_pipeline,
                                      streamed_pv_process)
from flan_tpu_torch.graph import Graph, WaveformMode
from flan_tpu_torch.pv import PV
from flan_tpu_torch.spectrum import Spectrum
from flan_tpu_torch.spv.spv import SPV
from flan_tpu_torch.sqpv.sqpv import SQPV
from flan_tpu_torch.utils.geometry import Color, Interval, Rect, View
from flan_tpu_torch.wavetable import PitchMode, SnapMode, Wavetable

__version__ = "0.1.0"

__all__ = [
    "Audio", "AudioBuffer", "AudioFormat", "SndfileStrings",
    "PV", "PVBuffer", "PVFormat", "SPV", "SQPV",
    "Function", "Function2d", "adsr", "as_function", "as_function2d",
    "interpolators", "Pipe", "pv_stretch_pipeline", "pv_repitch_pipeline",
    "pv_morph_pipeline", "streamed_pv_process", "Wavetable", "SnapMode",
    "PitchMode", "Graph", "WaveformMode", "Color", "Interval", "Rect",
    "View", "FunctionSample", "FunctionSample2d", "Spectrum", "waveforms",
]
