"""Time-domain entry point: binds the method groups onto Audio, as
flan_tpu/audio/__init__.py does (each group a module of plain functions)."""
from flan_tpu_torch.audio import combination as _combination
from flan_tpu_torch.audio import filters as _filters
from flan_tpu_torch.audio import information as _information
from flan_tpu_torch.audio import spatial as _spatial
from flan_tpu_torch.audio import synthesis as _synthesis
from flan_tpu_torch.audio import temporal as _temporal
from flan_tpu_torch.audio import volume as _volume
from flan_tpu_torch.audio.audio import Audio


def _bind(module, names):
    for name in names:
        setattr(Audio, name, getattr(module, name))


_bind(_temporal, [
    "modify_boundaries_frames", "modify_boundaries", "cut", "cut_frames",
    "fade", "fade_frames", "remove_edge_silence", "get_loud_chunks",
    "remove_silence", "split_at_times", "split_with_lengths",
    "split_with_equal_lengths", "rearrange", "random_chunks", "repitch",
    "iterate", "delay", "stereo_delay",
])
_bind(_information, [
    "get_local_wavelength", "get_local_wavelengths",
    "get_average_wavelength", "get_local_frequency",
    "get_local_frequencies", "get_amplitude_envelope",
    "get_frequency_envelope",
])
_bind(_spatial, ["pan", "widen", "stereo_spatialize", "filter_pinna"])
_bind(_synthesis, ["texture", "texture_effect", "granulate", "psola"])
for _name in ("synthesize_waveform", "synthesize_white_noise",
              "synthesize_pink_noise", "synthesize_spectrum",
              "synthesize_impulse", "synthesize_grains",
              "synthesize_trainlets", "synthesize_pulsars"):
    setattr(Audio, _name, staticmethod(getattr(_synthesis, _name)))
_bind(_volume, ["waveshape", "add_moisture", "compress",
                "apply_adsr_envelope", "apply_ar_envelope"])
_bind(_filters, [
    "filter_1pole_lowpass", "filter_1pole_highpass", "filter_1pole_split",
    "filter_1pole_lowshelf", "filter_1pole_highshelf",
    "filter_1pole_repeat_low", "filter_1pole_repeat_high",
    "filter_2pole_lowpass", "filter_2pole_bandpass", "filter_2pole_highpass",
    "filter_2pole_notch", "filter_2pole_split", "filter_2pole_lowshelf",
    "filter_2pole_bandshelf", "filter_2pole_highshelf",
    "filter_1pole_multinotch", "filter_2pole_multinotch", "filter_comb",
    "halfband_modulate", "shift_frequency", "halfband_multiply",
])
Audio.convolve = _combination.convolve
Audio.mix = staticmethod(_combination.mix)
Audio.join = staticmethod(_combination.join)
Audio.select = staticmethod(_combination.select)

__all__ = ["Audio"]
