"""AIFF / AIFF-C codec (pure host-side Python, numpy inner loops).

The reference reads and writes every libsndfile format
(reference: src/flan/Audio/AudioBuffer.cpp:86-117); the codec stays on the
host and hands the device one array. This covers the AIFF family:
big-endian IFF containers with a COMM chunk (channel count, frame count,
bit depth, 80-bit extended sample rate) and an SSND chunk of interleaved
PCM. AIFF-C adds a compression tag: 'NONE' (big-endian PCM), 'sowt'
(little-endian 16-bit, the classic Mac variant), and 'fl32'/'FL32'
(big-endian IEEE float32).

Scaling conventions match io/wav.py exactly (2^(bits-1) full
scale; 8-bit AIFF is SIGNED, unlike WAV's unsigned 8-bit).

Copied from flan_tpu/io/aiff.py as numpy only: this package never
imports the JAX package.
"""
from __future__ import annotations

import math
import struct
from typing import Tuple

import numpy as np


def _f80_to_float(b: bytes) -> float:
    """80-bit IEEE 754 extended (the COMM sample-rate field) -> float."""
    sign = b[0] >> 7
    exp = ((b[0] & 0x7F) << 8) | b[1]
    mant = int.from_bytes(b[2:10], "big")
    if exp == 0 and mant == 0:
        return 0.0
    val = mant / float(1 << 63) * 2.0 ** (exp - 16383)
    return -val if sign else val


def _float_to_f80(x: float) -> bytes:
    if x == 0.0:
        return b"\x00" * 10
    sign = 0x8000 if x < 0 else 0
    m, e = math.frexp(abs(x))          # |x| = m * 2^e, m in [0.5, 1)
    exp = e - 1 + 16383
    mant = int(m * float(1 << 64))     # [2^63, 2^64)
    return struct.pack(">H", sign | exp) + mant.to_bytes(8, "big")


def _decode_pcm_be(raw: bytes, bits: int, num_channels: int,
                   little_endian: bool = False,
                   is_float: bool = False) -> np.ndarray:
    order = "<" if little_endian else ">"
    if is_float:
        x = np.frombuffer(raw, dtype=order + "f4").astype(np.float32)
    elif bits == 8:
        x = np.frombuffer(raw, dtype=np.int8).astype(np.float32) / 128.0
    elif bits == 16:
        x = np.frombuffer(raw, dtype=order + "i2").astype(
            np.float32) / 32768.0
    elif bits == 24:
        b = np.frombuffer(raw, dtype=np.uint8)
        n = len(b) // 3
        b = b[: n * 3].reshape(n, 3)
        if little_endian:
            b = b[:, ::-1]
        vals = ((b[:, 0].astype(np.int32) << 16)
                | (b[:, 1].astype(np.int32) << 8)
                | b[:, 2].astype(np.int32))
        vals = np.where(vals >= (1 << 23), vals - (1 << 24), vals)
        x = vals.astype(np.float32) / float(1 << 23)
    elif bits == 32:
        x = np.frombuffer(raw, dtype=order + "i4").astype(
            np.float32) / float(1 << 31)
    else:
        raise ValueError(f"Unsupported AIFF bit depth: {bits}")
    num_frames = len(x) // num_channels
    x = x[: num_frames * num_channels].reshape(num_frames, num_channels)
    return np.ascontiguousarray(x.T)


def read_aiff(path: str) -> Tuple[np.ndarray, float]:
    """AIFF/AIFF-C file -> (float32 [channels, frames], sample_rate)."""
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < 12 or blob[:4] != b"FORM" or blob[8:12] not in (
            b"AIFF", b"AIFC"):
        raise ValueError(f"{path}: not an AIFF/AIFF-C file")
    is_aifc = blob[8:12] == b"AIFC"
    pos = 12
    comm = None
    ssnd = None
    comp = b"NONE"
    while pos + 8 <= len(blob):
        cid = blob[pos:pos + 4]
        size = struct.unpack(">I", blob[pos + 4:pos + 8])[0]
        body = blob[pos + 8:pos + 8 + size]
        if cid == b"COMM":
            nch, nframes, bits = struct.unpack(">hIh", body[:8])
            sr = _f80_to_float(body[8:18])
            if is_aifc and len(body) >= 22:
                comp = body[18:22]
            comm = (nch, nframes, bits, sr)
        elif cid == b"SSND":
            offset, _block = struct.unpack(">II", body[:8])
            ssnd = body[8 + offset:]
        pos += 8 + size + (size & 1)   # chunks are word-aligned
    if comm is None or ssnd is None:
        raise ValueError(f"{path}: missing COMM or SSND chunk")
    nch, nframes, bits, sr = comm
    if comp in (b"NONE", b"none"):
        data = _decode_pcm_be(ssnd, bits, nch)
    elif comp == b"sowt":
        data = _decode_pcm_be(ssnd, bits, nch, little_endian=True)
    elif comp in (b"fl32", b"FL32"):
        data = _decode_pcm_be(ssnd, 32, nch, is_float=True)
    else:
        raise ValueError(
            f"{path}: unsupported AIFF-C compression {comp!r}")
    return data[:, :nframes], float(sr)


def write_aiff(path: str, data: np.ndarray, sample_rate: float,
               bits: int = 0) -> None:
    """float32 [channels, frames] -> AIFF (int PCM) or AIFF-C fl32.

    bits: 0 (default) writes lossless big-endian float32 as AIFF-C
    'fl32', mirroring save_to_file's float32-WAV default; 8/16/24/32
    write integer-PCM AIFF with the WAV codec's scale/clamp conventions.
    """
    data = np.asarray(data, np.float32)
    nch, nframes = data.shape
    interleaved = np.ascontiguousarray(data.T)
    if bits == 0:
        body = interleaved.astype(">f4").tobytes()
        ssize = 32
    else:
        clipped = np.clip(interleaved, -1.0, 1.0)
        if bits == 8:
            q = np.clip(np.round(clipped * 128.0), -128, 127).astype(np.int8)
            body = q.tobytes()
        elif bits == 16:
            body = np.clip(np.round(clipped * 32768.0), -32768,
                           32767).astype(">i2").tobytes()
        elif bits == 24:
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
            body = np.clip(np.round(clipped.astype(np.float64)
                                    * float(1 << 31)),
                           -(2.0 ** 31), (1 << 31) - 1).astype(
                ">i4").tobytes()
        else:
            raise ValueError(f"Unsupported AIFF write bit depth: {bits}")
        ssize = bits

    is_aifc = bits == 0
    if is_aifc:
        comm_body = (struct.pack(">hIh", nch, nframes, ssize)
                     + _float_to_f80(sample_rate)
                     + b"fl32" + b"\x00\x00")   # empty pascal string, padded
    else:
        comm_body = (struct.pack(">hIh", nch, nframes, ssize)
                     + _float_to_f80(sample_rate))
    chunks = []
    if is_aifc:
        chunks.append(b"FVER" + struct.pack(">II", 4, 0xA2805140))
    chunks.append(b"COMM" + struct.pack(">I", len(comm_body)) + comm_body)
    ssnd_body = struct.pack(">II", 0, 0) + body
    chunks.append(b"SSND" + struct.pack(">I", len(ssnd_body)) + ssnd_body)
    payload = b"".join(c + (b"\x00" if len(c) & 1 else b"") for c in chunks)
    form_type = b"AIFC" if is_aifc else b"AIFF"
    with open(path, "wb") as f:
        f.write(b"FORM" + struct.pack(">I", 4 + len(payload)) + form_type
                + payload)
