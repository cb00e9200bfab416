"""Audio -> Graph and PV -> Graph conversions (flan_tpu/graph/
conversions.py; reference: src/flan/Conversions/AudioGraph.cpp,
PVGraph.cpp).

The pixels are rendered on the host by graph/graph.py. What crosses from
the device is only what the render reads, and the arithmetic that decides
a pixel runs on the host in the JAX package's numpy, so a render gives
the same bits whatever the device:
- pv_convert_to_graph takes the window's max and gathers the magnitudes
  at the frames and bins the render samples on the PV's device (both are
  exact on any device) and copies only those values; the indices, the
  sqrt(m / max) and the float64 log2 are the host's.
- audio_convert_to_spectrum_graph keeps its rFFT and its smoothing
  convolution on the Audio's device and copies the smoothed rows.
"""
from __future__ import annotations

import numpy as np
import torch

from flan_tpu_torch.core.types import power_of_2_container
from flan_tpu_torch.graph.graph import Graph, WaveformMode
from flan_tpu_torch.utils.geometry import Color, Interval, Rect


def _big_time_jump(w: float) -> float:
    """pow(4, floor(log2(w)/2 - 0.5)) in f32 (AudioGraph.cpp:41,
    PVGraph.cpp:40)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.power(
            np.float32(4.0),
            np.floor(np.log2(np.float32(w)) / np.float32(2)
                     - np.float32(0.5))))


def audio_convert_to_graph(self, interval=None, width: int = -1,
                           height: int = -1,
                           mode: str = WaveformMode.SYMMETRIC,
                           timeline_scale: float = 0.0) -> Graph:
    """Pixel-golden vs the compiled reference (AudioGraph.cpp:15-53):
    the interval crops the VIEW only - the waveforms are always drawn
    over the full-length rect {0,-1,length,1}; big ticks carry '1.000'
    labels (pow(scale_base=1, x))."""
    g = Graph(width, height)
    if self.is_null():
        return g
    if interval is None:
        interval = Interval(0.0, -1.0)
    if interval.x2 == -1:
        interval = Interval(interval.x1, self.length)
    g.fill_image(Color.from_hsv(0, 0, 0.04))
    g.add_full_split_view_y(
        Rect(interval.x1, -1.0, interval.x2, 1.0), self.num_channels)
    g.draw_waveforms(list(self.to_numpy()), Rect(0.0, -1.0, self.length, 1.0),
                     0, mode)
    if timeline_scale > 0:
        big = _big_time_jump(interval.w)
        g.draw_x_ticks(big / 4.0, 1.0, 1.0, int(timeline_scale / 2), 0,
                       -1, Color.from_hsv(0, 0, 0.6), 0.0)
        g.draw_x_ticks(big, 1.0, 1.0, int(timeline_scale), 0, -1,
                       Color.from_hsv(0, 0, 1.0), timeline_scale)
    return g


def audio_save_to_bmp(self, filename: str, interval=None, width: int = -1,
                      height: int = -1) -> None:
    audio_convert_to_graph(self, interval, width, height).save_image(
        filename)


def audio_convert_to_spectrum_graph(self, width: int = -1,
                                    height: int = -1,
                                    smoothing_frames: int = 128) -> Graph:
    """Log-frequency smoothed magnitude spectrum (reference
    AudioGraph.cpp:55-131): rfft magnitudes taken as an Audio,
    hann-convolved (normalize=true, so the pow(m/max, 0.5) scaling is a
    plain sqrt), then sampled per pixel column as a continuous function
    bin = trunc(2^x / (sr/n)); the bounds guard uses the convolved length,
    so bins past the raw spectrum read the smoothing tail (upstream quirk,
    AudioGraph.cpp:104-107)."""
    from flan_tpu_torch.audio.audio import Audio
    from flan_tpu_torch.ops.windows import hann_window
    g = Graph(width, height)
    if self.is_null():
        return g
    spectrum_log = float(np.log2(np.float32(self.sample_rate)
                                 / np.float32(2.0)))
    g.add_full_split_view_y(Rect(4.0, -0.1, spectrum_log, 1.1),
                            self.num_channels)
    g.fill_image(Color.from_hsv(0, 0, 0.05))
    g.draw_log_grid_x(1.0, 2, color=Color.from_hsv(0, 0, 0.1))
    g.draw_linear_grid_y(0.1, color=Color.from_hsv(0, 0, 0.1))
    g.draw_linear_grid_x(1.0, color=Color.from_hsv(0, 0, 0.25))

    n = power_of_2_container(self.num_frames)
    mags = torch.abs(torch.fft.rfft(self.data, n=n, dim=-1)).to(torch.float32)
    spectrum = Audio(data=mags, sample_rate=self.sample_rate)
    win = Audio(data=hann_window(max(smoothing_frames, 2),
                                 self.device)[None],
                sample_rate=self.sample_rate)
    spectrum = spectrum.convolve(win)          # normalize=true default
    max_mag = float(spectrum.get_max_sample_magnitude())
    spec = spectrum.to_numpy()                 # the smoothed rows cross
    with np.errstate(invalid="ignore"):
        spec = np.power(spec / np.float32(max(max_mag, 1e-30)),
                        np.float32(0.5)).astype(np.float32)
    L = spec.shape[-1]
    div = np.float32(self.sample_rate) / np.float32(n)

    def make_cf(c):
        def f(x, _row=spec[c]):
            freq = np.power(np.float32(2.0), np.asarray(x, np.float32))
            b = np.trunc(freq / div).astype(np.int64)
            ok = (b >= 0) & (b < L)
            return np.where(ok, _row[np.clip(b, 0, L - 1)],
                            np.float32(0.0)).astype(np.float32)
        return f

    g.draw_waveforms([make_cf(c) for c in range(self.num_channels)],
                     Rect(4.0, -1.0, spectrum_log, 1.0), 0,
                     WaveformMode.DIRECT)
    g.draw_axes(color=Color.white())
    g.draw_x_ticks(1.0, 0.0, 2.0, 6, 6, -1, Color.white(), 12.0)
    return g


def audio_save_spectrum_to_bmp(self, filename: str, width: int = -1,
                               height: int = -1,
                               smoothing_frames: int = 128) -> None:
    audio_convert_to_spectrum_graph(self, width, height,
                                    smoothing_frames).save_image(filename)


def gather_to_host(plane: torch.Tensor, i: np.ndarray,
                   j: np.ndarray) -> np.ndarray:
    """plane[i, j] as host numpy for host index grids i, j of one shape:
    the distinct rows and columns are gathered on the plane's device and
    only that block is copied."""
    iu, iinv = np.unique(i, return_inverse=True)
    ju, jinv = np.unique(j, return_inverse=True)
    rows = torch.from_numpy(iu).to(plane.device)
    cols = torch.from_numpy(ju).to(plane.device)
    block = plane.index_select(0, rows).index_select(1, cols).cpu().numpy()
    return block[iinv.reshape(i.shape), jinv.reshape(j.shape)]


def pv_convert_to_graph(self, domain=None, width: int = -1,
                        height: int = -1,
                        timeline_scale: float = 0.0) -> Graph:
    """HSV-magnitude spectrogram, pixel-golden vs the compiled
    reference (PVGraph.cpp:6-49): the value field is the continuous
    function sqrt(|MF(trunc frames/bins)| / max) * log2(2 + freq)/4
    sampled per subsample (log2 of the subsample frequency, in double as
    the reference's unqualified log2 is); the normalizing max runs over
    the domain's clamped frame/bin window exclusive of its end row and
    column, with the end==0 -> full-range quirk (PVBuffer.cpp:408-426)."""
    g = Graph(width, height)
    if self.is_null():
        return g
    if domain is None:
        domain = Rect(0, 0, -1, -1)
    if domain.x2 == -1:
        domain = Rect(domain.x1, domain.y1, self.length, domain.y2)
    if domain.y2 == -1:
        # get_height() = bin_to_frequency(num_bins): one past the last bin
        # (PVBuffer.cpp:391-394)
        domain = Rect(domain.x1, domain.y1, domain.x2,
                      self.bin_to_frequency(self.num_bins))
    F, B = self.num_frames, self.num_bins
    _sr = np.float32(self.sample_rate)
    _hop = np.float32(self.hop_size)
    _bw = np.float32(self.sample_rate) / np.float32(self.dft_size)
    start_frame = int(np.clip(int(np.float32(domain.x1) * _sr / _hop), 0,
                              F - 1))
    end_frame = int(np.clip(int(np.float32(domain.x2) * _sr / _hop), 0,
                            F - 1))
    start_bin = int(np.clip(int(np.float32(domain.y1) / _bw), 0, B - 1))
    end_bin = int(np.clip(int(np.float32(domain.y2) / _bw), 0, B - 1))
    if end_frame == 0:
        end_frame = F
    if end_bin == 0:
        end_bin = B
    win = self.mag[:, start_frame:end_frame, start_bin:end_bin]
    max_mag = float(win.abs().max()) if win.numel() else 0.0

    g.add_full_split_view_y(domain, self.num_channels)
    if max_mag != 0:
        sr32 = np.float32(self.sample_rate)
        hop32 = np.float32(self.hop_size)
        binw32 = np.float32(self.sample_rate) / np.float32(self.dft_size)

        def make_f(c):
            def f(x, y, _m=self.mag[c]):
                i = np.trunc(np.asarray(x, np.float32) * sr32
                             / hop32).astype(np.int64)
                j = np.trunc(np.asarray(y, np.float32)
                             / binw32).astype(np.int64)
                # reference indexes unchecked (PVGraph.cpp:26); clamp
                m = np.abs(gather_to_host(_m, np.clip(i, 0, F - 1),
                                          np.clip(j, 0, B - 1)))
                s = np.sqrt(m / np.float32(max_mag)).astype(np.float32)
                two_plus = (np.float32(2.0)
                            + np.asarray(y, np.float32))   # f32 add,
                return (s.astype(np.float64)               # f64 log2
                        * np.log2(two_plus.astype(np.float64))
                        / 4.0).astype(np.float32)
            return f

        g.draw_spectrograms(
            [make_f(c) for c in range(self.num_channels)],
            Rect(0, 0, self.length, self.bin_to_frequency(self.num_bins)))
    if timeline_scale > 0:
        big = _big_time_jump(domain.w)
        g.draw_x_ticks(big / 4.0, domain.y2, 1.0,
                       int(timeline_scale / 2), 0, -1,
                       Color.from_hsv(0, 0, 0.6), 0.0)
        g.draw_x_ticks(big, domain.y2, 1.0, int(timeline_scale), 0, -1,
                       Color.from_hsv(0, 0, 1.0), timeline_scale)
    return g


def pv_save_to_bmp(self, filename: str, domain=None, width: int = -1,
                   height: int = -1) -> None:
    pv_convert_to_graph(self, domain, width, height).save_image(filename)
