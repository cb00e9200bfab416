"""Sun/NeXT .au codec (pure host-side Python, numpy inner loops).

The reference reads and writes every libsndfile format
(reference: src/flan/Audio/AudioBuffer.cpp:86-117); the codec stays on the
host and hands the device one array. The .au container is the
simplest of the family: one big-endian 24+ byte header
(magic ".snd", data offset, data size, encoding id, sample rate,
channel count) followed by interleaved big-endian frames.

Supported encodings (the libsndfile AU set minus G.72x ADPCM):
  1 = G.711 mu-law      2 = int8        3 = int16
  4 = int24             5 = int32       6 = float32     7 = float64
  27 = G.711 A-law
Scaling conventions match io/wav.py (2^(bits-1) full scale).

Copied from flan_tpu/io/au.py as numpy only: this package never
imports the JAX package.
"""
from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

_MAGIC = b".snd"
_UNKNOWN_SIZE = 0xFFFFFFFF


def _mulaw_decode(raw: bytes) -> np.ndarray:
    """G.711 mu-law bytes -> float32 in [-1, 1) (x/32768 convention)."""
    u = ~np.frombuffer(raw, dtype=np.uint8)
    sign = u & 0x80
    exp = (u.astype(np.int32) >> 4) & 0x07
    mant = u.astype(np.int32) & 0x0F
    mag = ((mant << 3) + 0x84 << exp) - 0x84
    val = np.where(sign != 0, -mag, mag)
    return val.astype(np.float32) / 32768.0


def _alaw_decode(raw: bytes) -> np.ndarray:
    """G.711 A-law bytes -> float32 in [-1, 1) (x/32768 convention)."""
    a = np.frombuffer(raw, dtype=np.uint8) ^ 0x55
    sign = a & 0x80
    exp = (a.astype(np.int32) >> 4) & 0x07
    mant = a.astype(np.int32) & 0x0F
    mag = np.where(exp == 0, (mant << 4) + 8,
                   ((mant << 4) + 0x108) << (exp - 1))
    # A-law's sign convention is the OPPOSITE of mu-law's: after the
    # 0x55 XOR, a SET sign bit means positive (G.711 table: byte 0xD5
    # decodes to +8, 0x55 to -8)
    val = np.where(sign != 0, mag, -mag)
    return val.astype(np.float32) / 32768.0


_ENCODING_BYTES = {1: 1, 2: 1, 3: 2, 4: 3, 5: 4, 6: 4, 7: 8, 27: 1}


def read_au(path: str) -> Tuple[np.ndarray, float]:
    """.au file -> (float32 [channels, frames], sample_rate)."""
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < 24 or blob[:4] != _MAGIC:
        raise ValueError(f"{path}: not a Sun/NeXT .au file")
    offset, size, enc, sr, nch = struct.unpack(">IIIII", blob[4:24])
    if offset < 24 or nch < 1:
        raise ValueError(f"{path}: malformed .au header")
    raw = blob[offset:]
    if size != _UNKNOWN_SIZE:
        raw = raw[:size]
    if enc == 1:
        x = _mulaw_decode(raw)
    elif enc == 2:
        x = np.frombuffer(raw, dtype=np.int8).astype(np.float32) / 128.0
    elif enc == 3:
        x = np.frombuffer(raw, dtype=">i2").astype(np.float32) / 32768.0
    elif enc == 4:
        b = np.frombuffer(raw, dtype=np.uint8)
        n = len(b) // 3
        b = b[: n * 3].reshape(n, 3)
        vals = ((b[:, 0].astype(np.int32) << 16)
                | (b[:, 1].astype(np.int32) << 8)
                | b[:, 2].astype(np.int32))
        vals = np.where(vals >= (1 << 23), vals - (1 << 24), vals)
        x = vals.astype(np.float32) / float(1 << 23)
    elif enc == 5:
        x = np.frombuffer(raw, dtype=">i4").astype(np.float32) / float(
            1 << 31)
    elif enc == 6:
        x = np.frombuffer(raw, dtype=">f4").astype(np.float32)
    elif enc == 7:
        x = np.frombuffer(raw, dtype=">f8").astype(np.float32)
    elif enc == 27:
        x = _alaw_decode(raw)
    else:
        raise ValueError(f"{path}: unsupported .au encoding {enc}")
    num_frames = len(x) // nch
    x = x[: num_frames * nch].reshape(num_frames, nch)
    return np.ascontiguousarray(x.T), float(sr)


def write_au(path: str, data: np.ndarray, sample_rate: float,
             bits: int = 0) -> None:
    """float32 [channels, frames] -> .au.

    bits: 0 (default) writes lossless big-endian float32 (encoding 6),
    mirroring save_to_file's float32-WAV default; 8/16/24/32 write
    big-endian integer PCM with the WAV codec's scale/clamp conventions.
    """
    data = np.asarray(data, np.float32)
    nch, _ = data.shape
    interleaved = np.ascontiguousarray(data.T)
    if bits == 0:
        enc, body = 6, interleaved.astype(">f4").tobytes()
    else:
        clipped = np.clip(interleaved, -1.0, 1.0)
        if bits == 8:
            enc = 2
            body = np.clip(np.round(clipped * 128.0), -128,
                           127).astype(np.int8).tobytes()
        elif bits == 16:
            enc = 3
            body = np.clip(np.round(clipped * 32768.0), -32768,
                           32767).astype(">i2").tobytes()
        elif bits == 24:
            enc = 4
            q = np.clip(np.round(clipped * float(1 << 23)), -(1 << 23),
                        (1 << 23) - 1).astype(np.int32).reshape(-1)
            out = np.empty((q.size, 3), np.uint8)
            out[:, 0] = (q >> 16) & 0xFF
            out[:, 1] = (q >> 8) & 0xFF
            out[:, 2] = q & 0xFF
            body = out.tobytes()
        elif bits == 32:
            # float64 clamp: 2^31-1 is unrepresentable in float32 (see
            # io/wav.py's documented full-scale sign-flip pitfall)
            enc = 5
            body = np.clip(np.round(clipped.astype(np.float64)
                                    * float(1 << 31)),
                           -(2.0 ** 31), (1 << 31) - 1).astype(
                ">i4").tobytes()
        else:
            raise ValueError(f"Unsupported .au write bit depth: {bits}")
    header = _MAGIC + struct.pack(">IIIII", 24, len(body), enc,
                                  int(round(sample_rate)), nch)
    with open(path, "wb") as f:
        f.write(header + body)
