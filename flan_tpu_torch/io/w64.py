"""Sony Wave64 (.w64) codec (pure host-side Python).

The reference reads and writes every libsndfile format
(reference: src/flan/Audio/AudioBuffer.cpp:86-117); the codec stays on the
host and hands the device one array. Wave64 is RIFF with 64-bit
plumbing: every chunk id is a 16-byte GUID whose first four bytes are
the classic fourcc, sizes are little-endian int64 that INCLUDE the
24-byte chunk header, and chunks are 8-byte aligned. The 'fmt ' body is
a standard little-endian WAVEFORMATEX, so sample encode/decode is
shared with io/wav.py.

Copied from flan_tpu/io/w64.py as numpy only: this package never
imports the JAX package.
"""
from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from flan_tpu_torch.io.wav import (WAVE_FORMAT_EXTENSIBLE,
                                   WAVE_FORMAT_IEEE_FLOAT, _decode_samples,
                                   _encode_samples)

# GUID byte layout: little-endian data1/2/3 + 8 raw bytes, so the
# fourcc lands verbatim in the first four bytes.
_RIFF = b"riff\x2E\x91\xCF\x11\xA5\xD6\x28\xDB\x04\xC1\x00\x00"
_WAVE = b"wave\xF3\xAC\xD3\x11\x8C\xD1\x00\xC0\x4F\x8E\xDB\x8A"
_FMT = b"fmt \xF3\xAC\xD3\x11\x8C\xD1\x00\xC0\x4F\x8E\xDB\x8A"
_DATA = b"data\xF3\xAC\xD3\x11\x8C\xD1\x00\xC0\x4F\x8E\xDB\x8A"

def read_w64(path: str) -> Tuple[np.ndarray, float]:
    """.w64 file -> (float32 [channels, frames], sample_rate)."""
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < 40 or blob[:16] != _RIFF or blob[24:40] != _WAVE:
        raise ValueError(f"{path}: not a Wave64 file")
    pos = 40
    fmt = None
    data = None
    while pos + 24 <= len(blob):
        guid = blob[pos:pos + 16]
        size = struct.unpack("<q", blob[pos + 16:pos + 24])[0]
        if size < 24:
            raise ValueError(f"{path}: malformed Wave64 chunk size")
        body = blob[pos + 24:pos + size]
        if guid == _FMT:
            tag, nch, sr, _br, _ba, bits = struct.unpack(
                "<HHIIHH", body[:16])
            if tag == WAVE_FORMAT_EXTENSIBLE and len(body) >= 26:
                # actual format is the first 2 bytes of the SubFormat
                # GUID (cbSize at 16:18, valid bits 18:20, mask 20:24)
                tag = struct.unpack("<H", body[24:26])[0]
            fmt = (tag, nch, sr, bits)
        elif guid == _DATA:
            data = body
        pos += (size + 7) & ~7            # 8-byte chunk alignment
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt or data chunk")
    tag, nch, sr, bits = fmt
    return _decode_samples(data, tag, bits, nch), float(sr)


def write_w64(path: str, data: np.ndarray, sample_rate: float,
              bits: int = 0) -> None:
    """float32 [channels, frames] -> .w64.

    bits: 0 (default) writes lossless little-endian float32, mirroring
    save_to_file's float32-WAV default; 16/24/32 write integer PCM with
    the WAV codec's scale/clamp conventions (shared encoder).
    """
    data = np.asarray(data, np.float32)
    nch, _ = data.shape
    sr = int(round(sample_rate))
    if bits == 0:
        tag, depth = WAVE_FORMAT_IEEE_FLOAT, 32
    else:
        tag, depth = 1, bits              # WAVE_FORMAT_PCM
    body = _encode_samples(data, tag == WAVE_FORMAT_IEEE_FLOAT, depth)
    block = nch * depth // 8
    fmt_body = struct.pack("<HHIIHH", tag, nch, sr, sr * block, block,
                           depth)

    def chunk(guid: bytes, payload: bytes) -> bytes:
        raw = guid + struct.pack("<q", 24 + len(payload)) + payload
        return raw + b"\x00" * (-len(raw) % 8)

    chunks = chunk(_FMT, fmt_body) + chunk(_DATA, body)
    total = 40 + len(chunks)              # riff size spans the whole file
    with open(path, "wb") as f:
        f.write(_RIFF + struct.pack("<q", total) + _WAVE + chunks)
