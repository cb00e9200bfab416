"""RIFF ".flan" phase-vocoder file codec, numpy only.

Adapted from flan_tpu/io/flan_format.py without its native fast path:
importing that module pulls in the JAX package, which this package never
imports. Byte-compatible with the reference's PV interchange format
(reference: src/flan/PV/PVBuffer.h:85-113 spec; PVBuffer.cpp save at :99,
load at :216). Layout: RIFF/"PV\\0\\0" header; "fmt " chunk with
(u16 formatting=1, u16 channels, u32 frames, u32 bins, u32 sample_rate,
u32 hop, u32 window_size, u32 bit_depth=24, u16 window_id=1); "data" chunk
of 24-bit little-endian signed ints in channel->frame->bin order,
interleaved (mag, freq) per bin. Magnitudes are scaled by 1/dft_size and
frequencies by 1/sample_rate before quantisation by 2^23 with truncation
toward zero.
"""
from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

_LIMIT = float(1 << 23)


def _pack_i24(vals: np.ndarray) -> np.ndarray:
    """int32 array -> [N, 3] little-endian 24-bit bytes."""
    out = np.empty((vals.size, 3), dtype=np.uint8)
    flat = vals.reshape(-1)
    out[:, 0] = flat & 0xFF
    out[:, 1] = (flat >> 8) & 0xFF
    out[:, 2] = (flat >> 16) & 0xFF
    return out


def _unpack_i24(raw: np.ndarray) -> np.ndarray:
    """[N, 3] bytes -> int32 with sign extension."""
    vals = (raw[:, 0].astype(np.int32)
            | (raw[:, 1].astype(np.int32) << 8)
            | (raw[:, 2].astype(np.int32) << 16))
    return np.where(vals >= (1 << 23), vals - (1 << 24), vals)


def write_flan(path: str, mag: np.ndarray, freq: np.ndarray,
               sample_rate: float, hop_size: int, window_size: int) -> None:
    """Save [channels, frames, bins] mag/freq arrays as a .flan file."""
    mag = np.asarray(mag, dtype=np.float32)
    freq = np.asarray(freq, dtype=np.float32)
    num_channels, num_frames, num_bins = mag.shape
    dft_size = 2 * (num_bins - 1)
    # quantise bit-exactly like the reference save loop
    # (PVBuffer.cpp:112-113): float32 division and clamp, then widen to
    # float64, scale by 2^23, truncate toward zero
    m_q = np.trunc(np.clip(mag / np.float32(dft_size), -1.0, 1.0)
                   .astype(np.float64) * _LIMIT).astype(np.int32)
    f_q = np.trunc(np.clip(freq / np.float32(sample_rate), -1.0, 1.0)
                   .astype(np.float64) * _LIMIT).astype(np.int32)
    # interleave (m, f) per bin in channel->frame->bin order
    data_bytes = _pack_i24(np.stack([m_q, f_q], axis=-1)).tobytes()

    fmt_body = struct.pack(
        "<HHIIIIIIH", 1, num_channels, num_frames, num_bins,
        int(round(sample_rate)), int(hop_size), int(window_size), 24, 1)
    riff_body = (b"PV\x00\x00"
                 + b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body
                 + b"data" + struct.pack("<I", len(data_bytes)) + data_bytes)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4) + riff_body)


def read_flan(path: str) -> Tuple[np.ndarray, np.ndarray, float, int, int]:
    """Load a .flan file -> (mag, freq, sample_rate, hop_size, window_size)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[0:4] != b"RIFF" or blob[8:10] != b"PV":
        raise ValueError(f"Not a .flan RIFF/PV file: {path}")
    if blob[12:16] != b"fmt ":
        raise ValueError(f"{path}: missing fmt chunk")
    (fmt_size,) = struct.unpack_from("<I", blob, 16)
    (formatting, num_channels, num_frames, num_bins, sample_rate, hop_size,
     window_size, bit_depth, window_id) = struct.unpack_from(
         "<HHIIIIIIH", blob, 20)
    if formatting != 1 or bit_depth != 24 or window_id != 1:
        raise ValueError(f"{path}: unsupported .flan formatting")
    pos = 20 + fmt_size
    if blob[pos:pos + 4] != b"data":
        raise ValueError(f"{path}: missing data chunk")
    (data_size,) = struct.unpack_from("<I", blob, pos + 4)
    count = num_channels * num_frames * num_bins
    if data_size != 6 * count or pos + 8 + data_size > len(blob):
        raise ValueError(f"{path}: data chunk of {data_size} bytes for "
                         f"{count} frame-bins")
    raw = np.frombuffer(blob, dtype=np.uint8, count=data_size,
                        offset=pos + 8)
    dft_size = 2 * (num_bins - 1)
    # bit-exact with the reference load lambda (PVBuffer.cpp:260-266):
    # round int/2^23 to float32 BEFORE the float32 multiply by the scale
    vals = (_unpack_i24(raw.reshape(-1, 3)).astype(np.float64)
            / _LIMIT).astype(np.float32)
    inter = vals.reshape(num_channels, num_frames, num_bins, 2)
    mag = inter[..., 0] * np.float32(dft_size)
    freq = inter[..., 1] * np.float32(sample_rate)
    return mag, freq, float(sample_rate), int(hop_size), int(window_size)
